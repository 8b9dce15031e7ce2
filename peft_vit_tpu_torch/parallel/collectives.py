"""The collectives over the process group (counterpart of
``peft_vit_tpu/parallel/collectives.py``), replacing the reference's comm
layer (utils/comm.py:12-154):

* ``psum_mean`` / ``reduce_mean_metrics`` / ``mean_all_reduce``: the mean
  over the group (the ``_meter_reduce`` all_reduce,
  lib/core/function.py:271-279, and the gradients' all-reduce of DDP);
  ``sum_all_reduce`` and ``max_all_reduce``: the sum and the maximum (the
  norms of ZeRO-1's slices, the static int8 scales' absmax);
  ``sum_over_group``: the sum with its gradient (the BN moments and the
  DropBlock count of the global batch);
* ``gather_features``: the all-gather that keeps the gradient (the
  reference's gather_tensors, utils/comm.py:138-154, under the CLIP
  contrastive loss at clip_openai.py:551-552): its backward is the sum
  reduce-scatter, as the JAX ``all_gather`` transposes to ``psum_scatter``;
* ``copy_to_model`` / ``reduce_from_model``: Megatron's ``f`` (identity
  forward, sum all-reduce backward) and ``g`` (sum all-reduce forward,
  identity backward) over the model group, which GSPMD places for the JAX
  package's tensor-parallel rules;
* ``sp_all_gather`` / ``sp_reduce_scatter``: sequence parallelism's ``f``
  and ``g`` on the token axis (dim 1) over the model group (Megatron-SP;
  GSPMD places them for the JAX package's ``act_sharding``): the all-gather,
  whose backward is the reduce-scatter, and the reduce-scatter, whose
  backward is the all-gather; ``sp_split`` (this rank's token slice, the
  backward an all-gather) after the embedding and ``sp_gather`` (every
  token, the backward this rank's own slice: every model rank computes the
  same head and loss) before the head;
* ``p2p``: a send to and a receive from neighbouring ranks in one
  ``batch_isend_irecv`` (GPipe's activations and their gradients);
* ``roll_rows``: ``torch.roll(x, 1, 0)`` of the global batch whose rows
  this rank holds (mixup's partner rows);
* ``host_allgather`` / ``allgather_ragged``: host arrays of every process
  (the pickled-byte all_gather, utils/comm.py:67-106).

Each acts on the default group (``utils.dist.init_distributed``) or the
subgroup ``group`` (a mesh axis's); without a group the collective raises,
as ``torch.distributed`` does, except ``allgather_ragged``, which returns a
lone process's array as the JAX function does.  The rows of a gather are in
rank order.  Every tensor they return is contiguous (a strided leaf would
take other GEMM algorithms downstream), and each may be captured in a
``engine.train.StepGraph``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import dist as _dist


def psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the group (no gradient)."""
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.div_(dist.get_world_size(group))


def mean_all_reduce(xs: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The group's mean of each tensor of ``xs`` (one call a tensor; no
    gradient)."""
    return [psum_mean(x, group) for x in xs]


def sum_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group (no gradient)."""
    return _sum(x.detach(), group)


def max_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group (no gradient)."""
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def reduce_mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: psum_mean(v) for k, v in metrics.items()}


def _collective(name: str, old: str):
    """``torch.distributed``'s collective ``name``, or its older name ``old``
    (the same signature) where this torch predates it."""
    return getattr(dist, name, None) or getattr(dist, old)


def all_gather_dim(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    _collective("all_gather_single", "all_gather_into_tensor")(out, x, group=group)
    # contiguous: a strided leaf would take other GEMM algorithms downstream
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the group's ``x`` (the
    blocks in rank order)."""
    x = x.movedim(dim, 0).contiguous()
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"a dim of {x.shape[0]} does not split over {n} processes")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _collective("reduce_scatter_single", "reduce_scatter_tensor")(out, x, op=dist.ReduceOp.SUM,
                                                                 group=group)
    return out.movedim(0, dim).contiguous()


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats):
        return all_gather_dim(feats, 0)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, 0)


def gather_features(feats: torch.Tensor) -> torch.Tensor:
    """The group's feature rows, gathered along dim 0 in rank order, with
    the gradient flowing home to each rank's own rows (summed over the
    ranks' losses)."""
    return _GatherFeatures.apply(feats)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


class _SumOverGroup(torch.autograd.Function):
    """The sum over the group, forward and backward: every rank's output is
    the sum of every rank's input, so the gradient of an input is the sum
    of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def sum_over_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group, with its gradient (the data group's
    sums of a step over it: ``utils.dist.data_shard``'s ``sum_fn``)."""
    return _SumOverGroup.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, the sum over the model group
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the sum over the model group forward, the identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous(), None


def copy_to_model(x: torch.Tensor, group=None) -> torch.Tensor:
    """``f`` at the input of a column-parallel region."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group=None) -> torch.Tensor:
    """``g`` after a row-parallel product: the sum of the ranks' partial
    products."""
    return _ReduceFromModel.apply(x, group)


def _token_slice(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the token axis (dim 1), contiguous."""
    n = dist.get_world_size(group)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} tokens do not split over {n} ranks")
    size = x.shape[1] // n
    return x.narrow(1, dist.get_rank(group) * size, size).contiguous()


class _SPAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, 1, ctx.group), None


class _SPReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, 1, ctx.group), None


class _SPSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _token_slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, 1, ctx.group), None


class _SPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim(x, 1, group)

    @staticmethod
    def backward(ctx, g):
        return _token_slice(g, ctx.group), None


def sp_all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sequence parallelism's ``f``: every rank's tokens (dim 1, rank order);
    the backward sums the ranks' gradients and scatters the tokens."""
    return _SPAllGather.apply(x, group)


def sp_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sequence parallelism's ``g``: this rank's tokens of the sum of the
    ranks' partial products; the backward gathers the tokens."""
    return _SPReduceScatter.apply(x, group)


def sp_split(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's token slice of a sequence every rank holds whole (the
    embedding's output); the backward gathers the slices' gradients, so that
    every rank's embedding gets the whole gradient."""
    return _SPSplit.apply(x, group)


def sp_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every token before the head, which every rank then computes alike;
    the backward keeps this rank's own slice of the (equal) gradients: a sum
    would count the head's gradient once a rank."""
    return _SPGather.apply(x, group)


def p2p(send: Optional[torch.Tensor] = None, dst: Optional[int] = None,
        recv: Optional[torch.Tensor] = None, src: Optional[int] = None, group=None) -> None:
    """Send ``send`` to the group's rank ``dst`` and receive into ``recv``
    from its rank ``src`` (either may be None), in one ``batch_isend_irecv``,
    and wait for both."""
    ops = []
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), _global(dst, group), group))
    if recv is not None:
        ops.append(dist.P2POp(dist.irecv, recv, _global(src, group), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _global(rank: int, group) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def roll_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """``torch.roll(x, 1, 0)`` of the global batch of the group's rows
    (rank order): this rank's rows shifted down by one, its first row the
    previous rank's last (the last rank's, on rank 0).  No gradient."""
    last = all_gather_dim(x[-1:].detach(), 0, group)
    prev = last[(dist.get_rank(group) - 1) % dist.get_world_size(group)]
    return torch.cat([prev[None], x[:-1]], 0)


def host_allgather(x) -> np.ndarray:
    """Every process's array, stacked on a new leading axis in rank order
    (``multihost_utils.process_allgather``)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, np.asarray(x))
    return np.stack(out)


def allgather_ragged(x) -> np.ndarray:
    """Per-process arrays that may differ in leading length, concatenated in
    rank order: padded to the longest for the gather, then trimmed.  A lone
    process gets its own array back."""
    x = np.asarray(x)
    if _dist.world_size() <= 1:
        return x
    counts = host_allgather(np.asarray([x.shape[0]], np.int64)).reshape(-1)
    padded = np.zeros((int(counts.max()),) + x.shape[1:], x.dtype)
    padded[: x.shape[0]] = x
    stacked = host_allgather(padded)
    return np.concatenate([stacked[p, : int(c)] for p, c in enumerate(counts)])
