"""GPipe over the mesh's ``pipe`` axis (counterpart of
``peft_vit_tpu/parallel/pipeline.py``).

The stacked block leaves (``models.vit.StackedBlocks``: (L, ...)) are
reshaped to (S, L/S, ...) (``stage_params``), stage s runs layers
[s L/S, (s + 1) L/S), and the batch streams through the stages as M
microbatches (rows [m B/M, (m + 1) B/M)).  The JAX schedule is M + S - 1
ticks over a ring in which every stage computes every tick, the bubble
ticks on garbage that is never collected, and the last stage's outputs are
broadcast to every pipe rank.  The port computes the same function: a
process knows its stage on the host, so it runs only the ticks where it
holds a microbatch, and its outputs and gradients equal the JAX ones (whose
bubble ticks get a zero cotangent).

The schedule is explicit, forward and backward (``pipeline_apply``): every
microbatch forward through each stage, the stage's input, leaves and output
kept; then the microbatches backward in reverse order, each stage receiving
its output's gradient, running ``torch.autograd.grad`` on its kept graph and
sending its input's gradient on.  Point-to-point transfers never run inside
autograd's engine, whose order could differ between two ranks and deadlock
them.  A stage's leaf gradients are summed over the microbatches in that
reverse order.

The transport is a parameter: ``GroupRing`` (this process runs its stage of
the pipe group, neighbours joined by ``collectives.p2p``, the outputs
broadcast from the last stage) or ``LocalRing`` (one process runs the S
stages in turn, the same arithmetic stage by stage: the card check's
stand-in for a group of S cards).

``vit_pipeline_forward`` runs a classifier whose ViT backbone is stacked:
the embedding (``stop_layer=0``) and the head (``start_layer=L``) through
the module itself, the blocks through ``pipeline_apply``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from .collectives import p2p

STACK_PREFIX = "backbone.blocks.block."

Tensors = Dict[str, torch.Tensor]


def stage_params(stacked: Tensors, n_stages: int) -> Tensors:
    """(L, ...) block stacks -> (S, L/S, ...) (views)."""
    out = {}
    for k, x in stacked.items():
        if x.shape[0] % n_stages:
            raise ValueError(f"{k}: {x.shape[0]} layers do not split into {n_stages} stages")
        out[k] = x.reshape(n_stages, x.shape[0] // n_stages, *x.shape[1:])
    return out


def unstage_params(staged: Tensors) -> Tensors:
    """(S, L/S, ...) -> (L, ...)."""
    return {k: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]) for k, x in staged.items()}


class LocalRing(NamedTuple):
    """The S stages in turn in this process."""

    n_stages: int

    @property
    def stages(self) -> Sequence[int]:
        return range(self.n_stages)


class GroupRing(NamedTuple):
    """This process's stage, its rank in the pipe ``group`` of ``n_stages``
    processes."""

    group: object
    n_stages: int

    @property
    def stage(self) -> int:
        return dist.get_rank(self.group)

    @property
    def stages(self) -> Sequence[int]:
        return (self.stage,)


def _chunk(block_fn, leaves: Tensors, h: torch.Tensor) -> torch.Tensor:
    """A stage's L/S layers: each leaf's per-layer views by one unbind."""
    views = {k: v.unbind(0) for k, v in leaves.items()}
    for i in range(len(next(iter(views.values())))):
        h = block_fn({k: v[i] for k, v in views.items()}, h)
    return h


class _Pipeline(torch.autograd.Function):
    """The schedule of the stages ``transport.stages`` on ``x`` and the
    stages' leaves (``params``: each stage's leaves in ``names`` order, the
    stages in turn)."""

    @staticmethod
    def forward(ctx, block_fn, names, transport, microbatches, x, *params):
        stages, n_stages, k = list(transport.stages), transport.n_stages, len(names)
        local = isinstance(transport, LocalRing)
        need = ctx.needs_input_grad
        track = any(need[4:])
        xs = x.chunk(microbatches, 0)
        kept, outs = {}, []
        for j in range(microbatches):
            h = xs[j]
            for i, s in enumerate(stages):
                if s > 0 and not local:  # the previous stage's output
                    h = torch.empty_like(xs[j])
                    p2p(recv=h, src=s - 1, group=transport.group)
                with torch.set_grad_enabled(track):
                    h_in = h.detach().requires_grad_(track and (s > 0 or need[4]))
                    leaves = {n: p.detach().requires_grad_(need[5 + i * k + c])
                              for c, (n, p) in enumerate(zip(names, params[i * k:(i + 1) * k]))}
                    h_out = _chunk(block_fn, leaves, h_in)
                if track:
                    kept[s, j] = (h_in, leaves, h_out)
                h = h_out.detach()
                if s < n_stages - 1 and not local:
                    p2p(send=h, dst=s + 1, group=transport.group)
            if stages[-1] == n_stages - 1:
                outs.append(h)
        if outs:
            out = torch.cat(outs)
        else:
            out = torch.empty((x.shape[0], *xs[0].shape[1:]), dtype=x.dtype, device=x.device)
        if not local:  # the last stage's outputs on every pipe rank
            dist.broadcast(out, dist.get_global_rank(transport.group, n_stages - 1),
                           group=transport.group)
        ctx.names, ctx.transport, ctx.kept = names, transport, kept
        ctx.microbatches, ctx.x_rows = microbatches, [t.shape[0] for t in xs]
        ctx.n_params = len(params)
        return out

    @staticmethod
    def backward(ctx, g_out):
        transport, names, kept = ctx.transport, ctx.names, ctx.kept
        stages, n_stages, k = list(transport.stages), transport.n_stages, len(names)
        local = isinstance(transport, LocalRing)
        need = ctx.needs_input_grad
        gs = g_out.split(ctx.x_rows, 0)
        grads = [None] * ctx.n_params
        dx = [None] * ctx.microbatches
        for j in reversed(range(ctx.microbatches)):
            g = None
            for i in reversed(range(len(stages))):
                s = stages[i]
                h_in, leaves, h_out = kept.pop((s, j))
                if s == n_stages - 1:
                    g = gs[j]
                elif not local:  # the next stage's input gradient
                    g = torch.empty_like(h_out)
                    p2p(recv=g, src=s + 1, group=transport.group)
                wrt = [h_in] if h_in.requires_grad else []
                idx = [i * k + c for c, n in enumerate(names) if leaves[n].requires_grad]
                wrt += [leaves[names[c - i * k]] for c in idx]
                # the stage's vector-Jacobian product as the gradient of the
                # scalar <h_out, g> (d/dh_out = 1 * g, exactly): autograd.grad
                # with a gradient tensor imports sympy for its shape check,
                # seconds in a fresh process's first step
                with torch.enable_grad():
                    got = (torch.autograd.grad((h_out * g).sum(), wrt, allow_unused=True)
                           if wrt else ())
                got = list(got)
                g_in = got.pop(0) if h_in.requires_grad else None
                for c, d in zip(idx, got):
                    d = torch.zeros_like(leaves[names[c - i * k]]) if d is None else d
                    grads[c] = d if grads[c] is None else grads[c] + d
                g = torch.zeros_like(h_in) if g_in is None else g_in
                if s > 0 and not local:
                    p2p(send=g, dst=s - 1, group=transport.group)
            if stages[0] == 0:
                dx[j] = g
        dx_all = None
        if need[4]:
            dx_all = (torch.cat(dx) if stages[0] == 0
                      else torch.zeros_like(g_out))  # only stage 0 reads x
        return (None, None, None, None, dx_all, *grads)


def pipeline_apply(block_fn: Callable[[Tensors, torch.Tensor], torch.Tensor], staged: Tensors,
                   x: torch.Tensor, *, microbatches: int, transport) -> torch.Tensor:
    """``x`` (B, ...) through all S * (L/S) layers, pipelined over
    ``transport``'s stages (``LocalRing`` or ``GroupRing``).

    ``block_fn(layer_leaves, h) -> h`` applies one layer; ``staged`` is
    ``stage_params(stacked, S)`` (each leaf (S, L/S, ...); a ``GroupRing``
    process reads only its own stage's slice, so its gradient lands there).
    B must divide into ``microbatches``.  Returns the (B, ...) activations
    after the stack on every pipe rank, differentiable in ``x`` (stage 0's
    input gradient; zeros on the other ranks) and in ``staged``."""
    if x.shape[0] % microbatches:
        raise ValueError(f"a batch of {x.shape[0]} does not split into {microbatches} "
                         "microbatches")
    names = list(staged)
    params = [staged[n][s] for s in transport.stages for n in names]
    return _Pipeline.apply(block_fn, names, transport, microbatches, x, *params)


def vit_pipeline_forward(model: nn.Module, variables: Tensors, x: torch.Tensor, *,
                         microbatches: int, transport, train: bool = True) -> torch.Tensor:
    """The logits of an ``ImageClassifier`` whose ViT backbone is stacked
    (``scan_layers``), the block stack pipelined over ``transport``.

    The embedding (``stop_layer=0``) and the head (``start_layer=L``) run
    through the module itself on every pipe rank; the stacked leaves
    (``backbone.blocks.block.*``, from ``variables`` over the model's own)
    are staged and applied by ``pipeline_apply``.  The PEFT deltas live in
    the block leaves and ride the same pipeline."""
    bk = model.backbone
    if not getattr(bk, "scan_layers", False):
        raise ValueError("vit_pipeline_forward needs a scan_layers=True backbone "
                         "(stacked blocks)")
    variables = {**dict(model.named_parameters()), **dict(variables)}
    stacked = {k[len(STACK_PREFIX):]: v for k, v in variables.items()
               if k.startswith(STACK_PREFIX)}
    staged = stage_params(stacked, transport.n_stages)
    block = bk.blocks.block
    model.train(train)
    backbone = {k[len("backbone."):]: v for k, v in variables.items()
                if k.startswith("backbone.")}
    tokens = functional_call(bk, backbone, (x,), {"stop_layer": 0})
    tokens = pipeline_apply(lambda p, h: functional_call(block, p, (h,)), staged, tokens,
                            microbatches=microbatches, transport=transport)
    return functional_call(model, variables, (tokens,), {"start_layer": bk.layers})
