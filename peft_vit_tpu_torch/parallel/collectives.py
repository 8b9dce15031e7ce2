"""The collectives over the process group (counterpart of
``peft_vit_tpu/parallel/collectives.py``), replacing the reference's comm
layer (utils/comm.py:12-154):

* ``psum_mean`` / ``reduce_mean_metrics``: the mean over the group (the
  ``_meter_reduce`` all_reduce, lib/core/function.py:271-279);
* ``gather_features``: the all-gather that keeps the gradient (the
  reference's gather_tensors, utils/comm.py:138-154, under the CLIP
  contrastive loss at clip_openai.py:551-552): its backward is the sum
  reduce-scatter, as the JAX ``all_gather`` transposes to ``psum_scatter``;
* ``host_allgather`` / ``allgather_ragged``: host arrays of every process
  (the pickled-byte all_gather, utils/comm.py:67-106).

Each acts on the default group (``utils.dist.init_distributed``); without
one the collective raises, as ``torch.distributed`` does, except
``allgather_ragged``, which returns a lone process's array as the JAX
function does.  The rows of a gather are in rank order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..utils import dist as _dist


def psum_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the group (no gradient)."""
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    return y.div_(dist.get_world_size())


def reduce_mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: psum_mean(v) for k, v in metrics.items()}


def _collective(name: str, old: str):
    """``torch.distributed``'s collective ``name``, or its older name ``old``
    (the same signature) where this torch predates it."""
    return getattr(dist, name, None) or getattr(dist, old)


def all_gather_dim(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((dist.get_world_size() * x.shape[0], *x.shape[1:]))
    _collective("all_gather_single", "all_gather_into_tensor")(out, x)
    # contiguous: a strided leaf would take other GEMM algorithms downstream
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the group's ``x`` (the
    blocks in rank order)."""
    x = x.movedim(dim, 0).contiguous()
    n = dist.get_world_size()
    if x.shape[0] % n:
        raise ValueError(f"a dim of {x.shape[0]} does not split over {n} processes")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _collective("reduce_scatter_single", "reduce_scatter_tensor")(out, x, op=dist.ReduceOp.SUM)
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
