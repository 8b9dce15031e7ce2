"""The data-parallel training and eval steps (counterpart of
``peft_vit_tpu/parallel/train_step.py``), the analog of the reference's DDP
step (lib/core/function.py:46-170).

Each process holds its rows of the global batch (``mesh.shard_batch``) and
the whole trainable state.  It computes its rows' mean loss and gradient;
the gradients are all-reduced as a mean, which is the JAX step's gradient of
the global mean when the shards are equal, and every process applies the
same ``engine.train.sgd_update``.

``zero1=True`` (ZeRO-1) keeps each momentum buffer split over the data axis
along ``mesh.zero_dim`` (a leaf with no such dim stays whole): the gradient
is reduce-scattered along that dim, the process updates its slice of the
momentum and of the leaf, and the leaf is all-gathered.  The result is the
replicated step's.

On the card each step is a ``engine.train.StepGraph`` replay, its
collectives captured with it; the group's communicator is made by one eager
collective before the capture.  A capture that fails raises.  The CPU
(gloo) runs the step eagerly.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from ..engine import train as _train
from ..engine.train import ApplyFn, PerExampleCriterion, TrainCellState, make_eval_fn, sgd_update
from ..peft.masks import merge_params
from .collectives import all_gather_dim, psum_mean, reduce_scatter_dim
from .mesh import Mesh, zero_dim

Tensors = Dict[str, torch.Tensor]


def _zero_slice(t: torch.Tensor, dim, mesh: Mesh) -> torch.Tensor:
    size = t.shape[dim] // mesh.data
    return t.narrow(dim, mesh.rank * size, size)


def make_sharded_train_step(apply_fn: ApplyFn, criterion: PerExampleCriterion, mesh: Mesh,
                            momentum: float = 0.9, nesterov: bool = True, zero1: bool = False):
    """``(train_step, place)``:

    * ``train_step(state, frozen, x, y, lr, wd) -> (state, loss)``: one SGD
      step on this process's rows ``x``, ``y``; the loss returned is the
      group's mean;
    * ``place(state, frozen) -> (state, frozen)``: with ``zero1``, each
      momentum buffer cut to this process's slice."""
    dims = {}

    def dim_of(name: str, t: torch.Tensor):
        if name not in dims:
            dims[name] = zero_dim(tuple(t.shape), mesh.data) if zero1 else None
        return dims[name]

    def body(trainable: Tensors, buf: Tensors, step: int, frozen, x, y, lr, wd):
        leaves = {k: v.detach().requires_grad_() for k, v in trainable.items()}
        logits = apply_fn(merge_params(leaves, frozen), x, True)
        loss = criterion(logits.to(torch.float32), y).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        with torch.no_grad():
            part, part_g = {}, {}
            for (k, v), g in zip(trainable.items(), grads):
                g = torch.zeros_like(v) if g is None else g
                dim = dim_of(k, v)
                if dim is None:
                    part[k], part_g[k] = v, psum_mean(g)
                else:
                    part[k] = _zero_slice(v, dim, mesh)
                    part_g[k] = reduce_scatter_dim(g, dim).div_(mesh.data)
            new = sgd_update(part_g, TrainCellState(part, buf, step), lr, wd, momentum, nesterov)
            out = {k: (t if dim_of(k, t) is None else all_gather_dim(t, dim_of(k, t)))
                   for k, t in new.trainable.items()}
        return out, new.momentum, psum_mean(loss)

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
        buf = {k: (v if dim_of(k, v) is None else _zero_slice(v, dim_of(k, v), mesh).clone())
               for k, v in state.momentum.items()}
        return state._replace(momentum=buf), frozen

    return train_step, place


def make_sharded_eval_step(apply_fn: ApplyFn, mesh: Mesh):
    """``eval_step(trainable, frozen, x) -> logits`` of this process's rows
    ``x`` (the JAX step's output, sharded over the batch: gather them with
    ``collectives.all_gather_dim``).  On the card each call is a graph
    replay (``engine.train.make_eval_fn``)."""
    del mesh
    evals: dict = {}

    def eval_step(trainable: Tensors, frozen: Tensors, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n not in evals:
            evals[n] = make_eval_fn(apply_fn, n)
        return evals[n](trainable, frozen, x)

    return eval_step
