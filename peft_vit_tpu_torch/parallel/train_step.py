"""The sharded training and eval steps (counterpart of
``peft_vit_tpu/parallel/train_step.py``), the analog of the reference's DDP
step (lib/core/function.py:46-170), with Megatron's tensor parallelism over
the mesh's ``model`` axis.

Each process holds its rows of the global batch (``mesh.shard_batch``: its
data index's rows) and the trainable state.  It computes its rows' mean loss
and gradient; the gradients are all-reduced over the data group as a mean,
which is the JAX step's gradient of the global mean when the shards are
equal, and every process applies the same ``engine.train.sgd_update``.

``zero1=True`` (ZeRO-1) keeps each momentum buffer split over the data axis
along ``mesh.zero_dim`` (a leaf with no such dim stays whole): the gradient
is reduce-scattered along that dim, the process updates its slice of the
momentum and of the leaf, and the leaf is all-gathered.  The result is the
replicated step's.

A ``model`` degree above 1 runs Megatron's tensor parallelism over the model
group (``models.layers.tensor_parallel``): ``place`` cuts every leaf by
``mesh.tp_cut``, the trainable ones, their momentum and the frozen tower's.
The JAX spec ``P(None, "model")`` of ``in_proj``'s kernel names a contiguous
block of its output columns, which holds q and part of k on one device;
GSPMD computes the unsplit model whatever the layout, but the port's
attention kernels need whole heads, so ``in_proj`` holds the rank's heads of
q, of k and of v (three blocks of rows, one from each third).  ``out_proj``
holds those heads' columns, ``c_fc`` and ``c_proj`` split rows and columns
contiguously, and a LoRA B matrix (the MoE gate's experts with it) is cut as
the rows it adds to.  Megatron's ``f`` stands at the input of each
column-parallel region (``in_proj``, each LoRA B: A's gradient sums over the
heads) and ``g`` after each row-parallel product, the bias added once after
the sum.  Tensor parallelism covers the ViT with every PEFT hook and int8,
in fp32 and bf16: the hooks run on the rank's heads (the RPB table and
LePE's ``get_v`` cut by heads, the kron deltas' columns of those heads, the
reference layouts gathered over the model group first;
``models.layers.MultiHeadAttention``), the adapters and Compacter after
``g`` on the whole activations, the prompts in every rank's sequence.  The
int8 GEMMs equal the unsplit ones bit for bit (``ops.int8``'s row- and
column-parallel ops: the global row scale and the int32 sum over the model
group), so the quantized tree is cut after it is quantized
(``mesh.tp_cut``).  The gradients of the replicated leaves are equal on
every model rank, except those a rank's heads alone see (``tp_partial``:
the kron leaves, the shared qkv adapter), which are summed over the model
group.  The stacked block layout is cut layer by layer
(``mesh.stack_lead``).

``sequence_parallel=True`` (``TPU.SEQUENCE_PARALLEL``, Megatron-SP; the JAX
package's ``act_sharding`` of the inter-block activations over the model
axis) runs the same cut leaves with the tokens cut over the model group
between the regions: ``f`` is the token all-gather at each region's entry
(LoRA A then runs on the gathered tokens), ``g`` the token reduce-scatter
after ``out_proj`` and ``c_proj``, the row-parallel biases added on the
token slice; the ViT cuts the tokens after the embedding and gathers them
before the head (``collectives.sp_split`` / ``sp_gather``).  The gradients of
the block leaves that stay whole (``sp_partial``: the LayerNorms, the
row-parallel biases, LoRA A, the MoE gate, the hooks' leaves) are then this
rank's part, from its tokens or its heads, and so is the deep prompts'
(only the rank that holds a prompt's position replaces it); they are summed
over the model group before the data group's mean.  The cut leaves'
gradients are whole on their rank, and the embedding's, the shallow
prompts' and the head's are equal on every model rank.

On the card each step is a ``engine.train.StepGraph`` replay, its
collectives captured with it; the group's communicator is made by one eager
collective before the capture.  A capture that fails raises.  The CPU
(gloo) runs the step eagerly.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..engine import train as _train
from ..engine.train import ApplyFn, PerExampleCriterion, TrainCellState, make_eval_fn, sgd_update
from ..models.layers import MultiHeadAttention, tensor_parallel
from ..peft.masks import merge_params
from .collectives import (ModelComm, all_gather_dim, copy_to_model, psum_mean,
                          reduce_from_model, reduce_scatter_dim, sp_all_gather, sp_gather,
                          sp_reduce_scatter, sp_split, sum_all_reduce)
from .mesh import Mesh, stack_lead, tp_cut, tp_slice, tp_unslice, zero_dim

Tensors = Dict[str, torch.Tensor]


def check_tensor_parallel(model: nn.Module, model_degree: int) -> None:
    """Raise unless tensor parallelism over ``model_degree`` ranks covers
    ``model``: a ViT classifier whose heads split over the ranks."""
    from ..models.vit import VisionTransformer

    backbone = getattr(model, "backbone", model)
    if not isinstance(backbone, VisionTransformer):
        raise NotImplementedError(
            f"tensor parallelism covers the ViT, not a {type(backbone).__name__} (ROADMAP §1, "
            "parallelism (tensor parallelism beyond the ViT))")
    for m in model.modules():
        if isinstance(m, MultiHeadAttention) and m.heads % model_degree:
            raise ValueError(f"{m.heads} heads do not split over {model_degree} ranks")


def _zero_slice(t: torch.Tensor, dim, mesh: Mesh) -> torch.Tensor:
    size = t.shape[dim] // mesh.data
    return t.narrow(dim, mesh.rank * size, size)


def tp_context(mesh: Mesh, sequence_parallel: bool = False):
    """The context of a forward over ``mesh``: Megatron's ``f`` and ``g``
    over its model group (with ``sequence_parallel`` the token all-gather and
    reduce-scatter, and the token split and gather around the blocks), or
    nothing without a model axis."""
    if mesh.model == 1:
        return contextlib.nullcontext()
    group = mesh.model_group
    comm = ModelComm(group, bool(sequence_parallel))
    if sequence_parallel:
        return tensor_parallel(*(functools.partial(fn, group=group) for fn in (
            sp_all_gather, sp_reduce_scatter, sp_split, sp_gather)), comm=comm)
    return tensor_parallel(functools.partial(copy_to_model, group=group),
                           functools.partial(reduce_from_model, group=group), comm=comm)


def sp_partial(name: str) -> bool:
    """Whether the gradient of the leaf ``name`` under sequence parallelism
    is this rank's part of it: a block leaf that ``tp_cut`` leaves whole
    sees only this rank's tokens (the LayerNorms, the row-parallel biases,
    the adapters) or its heads (LoRA A, the MoE gate, the kron leaves, the
    shared qkv adapter); the deep prompts only the rank that holds their
    positions."""
    return ((".blocks." in f".{name}" and tp_cut(name, ()) is None)
            or name.endswith("deep_prompt_embeddings"))


def tp_partial(name: str) -> bool:
    """Whether the gradient of the leaf ``name`` under tensor parallelism
    (the tokens whole) is this rank's part of it: a replicated leaf that only
    this rank's heads read, the kron leaves and the shared qkv adapter's."""
    leaf = name.rsplit(".", 1)[-1]
    return ".attn." in name and (leaf in ("phm_rule", "phmb") or leaf.startswith(
        ("W_left", "W_right")) or ".qkv_adapter." in name)


def tp_place(mesh: Mesh, tensors: Tensors) -> Tensors:
    """This model rank's part of each leaf of ``tensors`` (``tp_cut``;
    differentiable: a whole leaf's gradient gets this rank's part)."""
    return {k: tp_slice(v, tp_cut(k, tuple(v.shape)), mesh.model_rank, mesh.model,
                        stack_lead(k))
            for k, v in tensors.items()}


def tp_gather(mesh: Mesh, tensors: Tensors) -> Tensors:
    """The whole leaves from the model ranks' parts (a collective over the
    model group; ``tp_place``'s inverse)."""
    if mesh.model == 1:
        return dict(tensors)
    out = {}
    for k, v in tensors.items():
        cut = tp_cut(k, ())
        if cut is None:
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(mesh.model)]
        dist.all_gather(parts, v.contiguous(), group=mesh.model_group)
        out[k] = tp_unslice(parts, cut, stack_lead(k))
    return out


def make_sharded_train_step(apply_fn: ApplyFn, criterion: PerExampleCriterion, mesh: Mesh,
                            momentum: float = 0.9, nesterov: bool = True, zero1: bool = False,
                            model: Optional[nn.Module] = None, sequence_parallel: bool = False):
    """``(train_step, place)``:

    * ``train_step(state, frozen, x, y, lr, wd) -> (state, loss)``: one SGD
      step on this process's rows ``x``, ``y``; the loss returned is the
      group's mean;
    * ``place(state, frozen) -> (state, frozen)``: under a model axis every
      leaf cut to this rank's part (``frozen`` with the cut frozen leaves of
      ``model`` added), then with ``zero1`` each momentum buffer cut to this
      process's slice of the data axis.

    ``model`` (the module ``apply_fn`` runs) is needed under a model axis;
    ``sequence_parallel`` cuts the tokens over it too (see the module
    docstring)."""
    if mesh.model > 1:
        if model is None:
            raise ValueError("tensor parallelism needs the model (to cut its frozen leaves)")
        check_tensor_parallel(model, mesh.model)
    seq = bool(sequence_parallel) and mesh.model > 1
    group = mesh.data_group
    dims = {}

    def dim_of(name: str, t: torch.Tensor):
        if name not in dims:
            dims[name] = zero_dim(tuple(t.shape), mesh.data) if zero1 else None
        return dims[name]

    def body(trainable: Tensors, buf: Tensors, step: int, frozen, x, y, lr, wd):
        leaves = {k: v.detach().requires_grad_() for k, v in trainable.items()}
        with tp_context(mesh, seq):
            logits = apply_fn(merge_params(leaves, frozen), x, True)
        loss = criterion(logits.to(torch.float32), y).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        with torch.no_grad():
            part, part_g = {}, {}
            for (k, v), g in zip(trainable.items(), grads):
                g = torch.zeros_like(v) if g is None else g
                partial = sp_partial(k) if seq else mesh.model > 1 and tp_partial(k)
                if partial:  # the model group's tokens or heads
                    g = sum_all_reduce(g, mesh.model_group)
                dim = dim_of(k, v)
                if dim is None:
                    part[k], part_g[k] = v, psum_mean(g, group)
                else:
                    part[k] = _zero_slice(v, dim, mesh)
                    part_g[k] = reduce_scatter_dim(g, dim, group).div_(mesh.data)
            new = sgd_update(part_g, TrainCellState(part, buf, step), lr, wd, momentum, nesterov)
            out = {k: (t if dim_of(k, t) is None else all_gather_dim(t, dim_of(k, t), group))
                   for k, t in new.trainable.items()}
        return out, new.momentum, psum_mean(loss, group)

    graphs: dict = {}

    def train_step(state: TrainCellState, frozen: Tensors, x, y, lr, wd):
        lr = torch.as_tensor(lr, dtype=torch.float32).to(x.device)
        wd = torch.as_tensor(wd, dtype=torch.float32).to(x.device)
        if not _train.runs_captured(x):
            trainable, buf, loss = body(state.trainable, state.momentum, state.step, frozen,
                                        x, y, lr, wd)
            return TrainCellState(trainable, buf, state.step + 1, state.bn), loss

        def fn(inputs):
            trainable, buf, loss = body(inputs["trainable"], inputs["momentum"], 0, frozen,
                                        inputs["x"], inputs["y"], inputs["lr"], inputs["wd"])
            with torch.no_grad():  # the new state back into the static buffers
                for part, new in (("trainable", trainable), ("momentum", buf)):
                    for k, t in new.items():
                        inputs[part][k].copy_(t)
            return loss

        if not graphs:  # the communicator exists before the first capture
            dist.barrier()
        inputs = {"trainable": state.trainable, "momentum": state.momentum, "x": x, "y": y,
                  "lr": lr, "wd": wd}
        graph = _train._graph(graphs, ("sharded step", x.shape[0]), fn, inputs,
                              tuple(frozen.values()))
        loss = graph(**inputs).clone()
        held = graph.inputs
        return TrainCellState({k: v.detach().clone() for k, v in held["trainable"].items()},
                              {k: v.clone() for k, v in held["momentum"].items()},
                              state.step + 1, state.bn), loss

    def place(state: TrainCellState, frozen: Tensors):
        if mesh.model > 1:
            own = {k: p.detach() for k, p in model.named_parameters()
                   if k not in state.trainable and tp_cut(k, tuple(p.shape)) is not None}
            frozen = tp_place(mesh, {**own, **frozen})
            state = state._replace(trainable=tp_place(mesh, state.trainable),
                                   momentum=tp_place(mesh, state.momentum))
        buf = {k: (v if dim_of(k, v) is None else _zero_slice(v, dim_of(k, v), mesh).clone())
               for k, v in state.momentum.items()}
        return state._replace(momentum=buf), frozen

    return train_step, place


def make_sharded_eval_step(apply_fn: ApplyFn, mesh: Mesh):
    """``eval_step(trainable, frozen, x) -> logits`` of this process's rows
    ``x`` (the JAX step's output, sharded over the batch: gather them with
    ``collectives.all_gather_dim``), on the leaves ``place`` cut under a model
    axis.  On the card each call is a graph replay
    (``engine.train.make_eval_fn``)."""
    evals: dict = {}

    def tp_apply(variables, x, train):
        with tp_context(mesh):
            return apply_fn(variables, x, train)

    def eval_step(trainable: Tensors, frozen: Tensors, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n not in evals:
            evals[n] = make_eval_fn(tp_apply, n)
        return evals[n](trainable, frozen, x)

    return eval_step
