"""Train/eval engine (counterpart of ``peft_vit_tpu/engine/train.py``).

The same functional shape as the JAX engine, on name-keyed dicts of tensors
in place of pytrees:

* The model is applied through ``make_apply_fn(model)``:
  ``apply_fn(variables, x, train)`` runs ``model`` with the tensors named in
  ``variables`` substituted (``torch.func.functional_call``); every tensor
  it does not name is the module's own.  A train step names the trainable
  leaves and the BN statistics; the frozen tower stays in the module.
* Only the trainable leaves require a gradient (``peft.split_params``), so
  autograd never computes a frozen weight's gradient.
* ``sgd_update`` is the reference few-shot recipe exactly: SGD + momentum
  0.9 + nesterov + coupled weight decay (``torch.optim.SGD`` semantics),
  with the step-decay schedule ``step_decay_lr``.  It is a pure function of
  dicts, not a ``torch.optim`` object, so that it updates a round's cells at
  once.
* A sweep round's cells train together (``cells=True``, the counterpart of
  the JAX engine's ``jax.vmap`` of its epoch): every leaf of the state, and
  each BN statistic, carries a leading cell axis, and lr and wd are one per
  cell.  The forward runs under ``torch.func.vmap`` over that axis; the
  frozen tower and the images are shared, so a frozen GEMM sees the rows of
  every cell at once from the first trainable leaf on, and the kernels'
  batching rules launch once for the round.  The gradient is that of the sum
  of the cells' losses, taken outside the vmap: the cells' leaves are
  disjoint, so each gets its own.
* Few-shot datasets are device-resident tensors; an epoch is a loop over a
  shuffled index matrix, not a host DataLoader.  On the card every step (and
  every eval batch) is a CUDA-graph replay (``StepGraph``, the counterpart of
  ``jax.jit`` over the epoch's ``lax.scan``): captured once per shape, its
  static inputs the batch's row indices, lr and wd (the gather runs inside
  the graph).  The CPU runs the same step eagerly.
* The int8 frozen tower: the tree of ``ops.int8.quantize_frozen_tree`` and
  the static activation scales travel in a step's ``frozen`` dict, named
  after the ``Int8Dense`` buffers they substitute.  ``calibrate`` makes the
  scales from one train-mode forward (per cell in a round), and
  ``make_epoch_fn`` can renew them on each epoch's first batch.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, vmap
from torch.utils._pytree import tree_map

from ..models.layers import collect_activation_stats
from ..ops import launch_counts
from ..ops.int8 import activation_scales_from_stats
from ..peft.masks import merge_params
from ..utils import resolve_device

Tensors = Dict[str, torch.Tensor]
Scalar = Union[float, torch.Tensor]
# per-example criterion: (logits (B, C) fp32, target (B,) or (B, C)) -> (B,)
PerExampleCriterion = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# apply_fn(variables, x, train) -> logits
ApplyFn = Callable[[Mapping[str, torch.Tensor], torch.Tensor, bool], torch.Tensor]

#: headroom of the static activation scales over the calibration batch's
#: absmax: the PEFT deltas feed the residual stream, so the layers' input
#: ranges drift between recalibrations
INT8_CALIB_MARGIN = 1.5
# the Int8Dense buffers a quantized tree or a set of scales substitutes
_INT8_STATE = (".w_i8", ".s_w", ".wt_i8", ".s_wt", ".s_x")


def ce_per_example(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    if target.dim() == 1:
        ce = -logp.gather(-1, target.clamp_min(0)[:, None])[:, 0]
        # a negative label (unannotated or corrupt data) must never wrap to
        # the last class: poison the loss instead
        return torch.where(target < 0, torch.full_like(ce, float("inf")), ce)
    return -(target.to(torch.float32) * logp).sum(dim=-1)


def bce_per_example(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCEWithLogits mean-over-classes per example (multilabel datasets)."""
    t = target.to(torch.float32)
    return -(t * F.logsigmoid(logits) + (1.0 - t) * F.logsigmoid(-logits)).mean(dim=-1)


class TrainCellState(NamedTuple):
    """State of one sweep cell: the trainable leaves, their SGD momentum
    buffers, the step count and, with channel BN, the running statistics
    (each cell trains its own copy).  A round's state has the same names,
    each tensor stacked over the round's cells on a leading axis."""

    trainable: Tensors
    momentum: Tensors
    step: int
    bn: Optional[Tensors] = None


def init_cell_state(trainable: Mapping[str, torch.Tensor],
                    bn: Optional[Mapping[str, torch.Tensor]] = None) -> TrainCellState:
    """Fresh state over copies of ``trainable`` (and ``bn``), zero momentum."""
    leaves = {k: v.detach().clone() for k, v in trainable.items()}
    return TrainCellState(
        trainable=leaves,
        momentum={k: torch.zeros_like(v) for k, v in leaves.items()},
        step=0,
        bn=None if bn is None else {k: v.detach().clone() for k, v in bn.items()},
    )


def _per_cell(s: Scalar, p: torch.Tensor) -> Scalar:
    """A (cells,) tensor of per-cell scalars shaped to broadcast against the
    stacked leaf ``p``; a Python or 0-dim scalar as it is."""
    if torch.is_tensor(s) and s.dim() == 1:
        return s.reshape(-1, *([1] * (p.dim() - 1)))
    return s


@torch.no_grad()
def sgd_update(
    grads: Mapping[str, torch.Tensor],
    state: TrainCellState,
    lr: Scalar,
    wd: Scalar,
    momentum: float = 0.9,
    nesterov: bool = True,
    lr_scale: Optional[Mapping[str, Scalar]] = None,
) -> TrainCellState:
    """torch.optim.SGD: g += wd*p; buf = mu*buf + g;
    step uses g + mu*buf when nesterov else buf.

    ``lr_scale``: optional per-leaf multiplier of ``lr``.  ``lr`` and ``wd``
    may be (cells,) tensors for a round's stacked state, one per cell.
    Returns a new state; no tensor of ``state`` is written."""
    p_new, buf_new = {}, {}
    for name, p in state.trainable.items():
        g = grads[name] + _per_cell(wd, p) * p
        buf = momentum * state.momentum[name] + g
        step = g + momentum * buf if nesterov else buf
        rate = lr if lr_scale is None else lr * lr_scale[name]
        p_new[name] = p - _per_cell(rate, p) * step
        buf_new[name] = buf
    return state._replace(trainable=p_new, momentum=buf_new, step=state.step + 1)


def step_decay_lr(base_lr: Union[float, Sequence[float]], epoch: int,
                  schedule: Sequence[int]) -> torch.Tensor:
    """The reference's adjust_learning_rate: x0.1 at each milestone reached,
    in fp32 as the JAX engine computes it (a sequence of base rates, one per
    cell, gives one rate per cell)."""
    lr = torch.tensor(base_lr, dtype=torch.float32)
    for m in schedule:
        if epoch >= m:
            lr = lr * 0.1
    return lr


def make_apply_fn(model: nn.Module) -> ApplyFn:
    """``apply_fn(variables, x, train)``: ``model(x)`` in train or eval mode
    with the parameters and buffers named in ``variables`` substituted.
    Train-mode BN updates the statistics tensors it is given in place."""

    def apply_fn(variables, x, train):
        model.train(train)
        return functional_call(model, dict(variables), (x,))

    return apply_fn


def calibrate(model: nn.Module, apply_fn: ApplyFn, variables: Mapping[str, torch.Tensor],
              x: torch.Tensor, margin: float = INT8_CALIB_MARGIN) -> Tensors:
    """The static activation scales of ``model``'s ``Int8Dense`` layers from
    one train-mode forward of the batch ``x`` in calibration mode:
    ``{<module>.s_x: max(amax * margin / 127, 1e-8)}``, ready to merge into a
    step's ``frozen``.  As in the JAX trainer, the forward runs on the
    parameters alone, each weight quantized per call: a quantized tree or
    earlier scales in ``variables`` are left out.  Train-mode BN runs on
    copies of the statistics, so its update is discarded."""
    variables = {k: v for k, v in variables.items() if not k.endswith(_INT8_STATE)}
    for name, buf in model.named_buffers():
        variables[name] = variables.get(name, buf).clone()
    with torch.no_grad(), collect_activation_stats(model) as stats:
        apply_fn(variables, x, True)
    return activation_scales_from_stats(stats, margin)


def make_train_step(
    apply_fn: ApplyFn,
    criterion: PerExampleCriterion,
    momentum: float = 0.9,
    nesterov: bool = True,
    lr_scale: Optional[Mapping[str, Scalar]] = None,
    has_bn: bool = False,
    cells: bool = False,
):
    """One SGD step on one batch: ``step(state, frozen, bx, by, bv, lr, wd,
    cell_frozen=None) -> (state, loss)``.

    The loss is the ``bv``-weighted mean of the per-example criterion over
    fp32 logits, ``sum(per * w) / max(sum(w), 1)`` (``bv=None``: every row
    counts).  With ``has_bn`` the step runs train-mode BN on a copy of
    ``state.bn`` and returns the blended statistics in the new state.
    ``cell_frozen`` names frozen tensors of the cell itself (the static
    activation scales), merged into ``frozen``.

    ``cells``: ``state`` is a round's (see the module docstring), ``lr`` and
    ``wd`` one per cell or shared, ``cell_frozen`` stacked over the cells;
    the forward runs under ``torch.func.vmap`` over the cell axis with
    ``frozen`` and the batch shared, the loss returned is one per cell, and
    the gradient is that of their sum.  A random operation inside the
    forward (training-mode drop path) raises under the vmap."""

    def loss_of(trainable, bn, own, frozen, bx, by, bv):
        variables = merge_params(trainable, {**frozen, **own})
        if has_bn:
            variables.update(bn)
        logits = apply_fn(variables, bx, True)
        per = criterion(logits.to(torch.float32), by)
        if bv is None:
            return per.mean()
        w = bv.to(torch.float32)
        return (per * w).sum() / w.sum().clamp_min(1.0)

    def step(state: TrainCellState, frozen, bx, by, bv, lr, wd, cell_frozen=None):
        trainable = {k: v.requires_grad_() for k, v in state.trainable.items()}
        new_bn = {k: v.clone() for k, v in state.bn.items()} if has_bn else None
        own = dict(cell_frozen or {})
        if cells:
            loss = vmap(lambda t, b, o: loss_of(t, b, o, frozen, bx, by, bv),
                        in_dims=(0, 0 if has_bn else None, 0))(trainable, new_bn, own)
        else:
            loss = loss_of(trainable, new_bn, own, frozen, bx, by, bv)
        # a leaf the forward does not read (KAdaptation's phmb, the adapters
        # of the blocks AdapterDrop skips) gets a zero gradient, as in JAX:
        # weight decay still moves it
        grads = torch.autograd.grad(loss.sum(), list(trainable.values()), allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(trainable.items(), grads)}
        state = sgd_update(grads, state, lr, wd, momentum, nesterov, lr_scale)
        return state._replace(bn=new_bn), loss.detach()

    return step


class StepGraph:
    """A function of static tensors captured as a CUDA graph.

    ``fn(inputs)`` (``inputs`` a dict of tensors or of dicts of tensors) runs
    ``WARMUP`` times on a side stream, which builds the kernels and lets the
    libraries choose their plans, and is then captured on the buffers of
    ``inputs``' clones (``self.inputs``).  A call copies the tensors it is
    given into those buffers and replays the graph; it returns the graph's
    outputs, which the next replay overwrites.  Every other tensor ``fn``
    reads (the frozen tower, the dataset) is read in place: ``keep`` holds
    them, so that their memory outlives the graph.  Nothing in ``fn`` may
    wait for the host.  A capture that fails raises: there is no eager
    fallback.  The cyclic garbage collector is off during the capture.

    A kernel wrapper counts a launch when ``fn`` calls it, so it counts
    during the warm-up and the capture, never during a replay.
    ``launches`` keeps what the capture counted (``ops.launch_counts``): the
    kernels every replay launches; ``replays`` counts the replays."""

    WARMUP = 2

    def __init__(self, fn, inputs, keep: Sequence[torch.Tensor] = ()):
        self.keep = tuple(keep)
        self.inputs = tree_map(lambda t: t.detach().clone(), inputs)
        self.replays = 0
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                fn(self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        # No cyclic garbage collection during the capture: a dead graph it
        # freed there (an earlier StepGraph in a reference cycle) would be
        # destroyed while the stream captures, which CUDA forbids, and this
        # capture would fail.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fn(self.inputs)
        finally:
            if collecting:
                gc.enable()
        self.launches = {k: n - before[k] for k, n in launch_counts().items()}

    def holds(self, keep: Sequence[torch.Tensor]) -> bool:
        """Whether the graph reads exactly these tensors in place."""
        return len(keep) == len(self.keep) and all(a is b for a, b in zip(keep, self.keep))

    @torch.no_grad()
    def __call__(self, **inputs):
        for name, value in inputs.items():
            if isinstance(value, Mapping):
                for k, t in value.items():
                    self.inputs[name][k].copy_(t)
            else:
                self.inputs[name].copy_(value)
        self._replay()
        self.replays += 1
        return self.outputs

    def _replay(self) -> None:
        self.graph.replay()


def runs_captured(t: torch.Tensor) -> bool:
    """Whether the engine runs work on ``t`` as CUDA-graph replays: on the
    card."""
    return t.device.type == "cuda"


def _graph(graphs: dict, key, fn, inputs, keep) -> StepGraph:
    """The graph of ``key`` in ``graphs``, captured anew when there is none
    or when it reads other tensors in place than ``keep``."""
    graph = graphs.get(key)
    if graph is None or not graph.holds(keep):
        graphs.pop(key, None)  # free the old graph's memory before the capture
        graph = graphs[key] = StepGraph(fn, inputs, keep)
    return graph


def _cell(tensors: Optional[Mapping[str, torch.Tensor]], i: int):
    return None if tensors is None else {k: v[i] for k, v in tensors.items()}


def _cells_of(stacked: Mapping[str, torch.Tensor]) -> int:
    return next(iter(stacked.values())).shape[0]


def make_epoch_fn(
    apply_fn: ApplyFn,
    criterion: PerExampleCriterion,
    batch_size: int,
    momentum: float = 0.9,
    nesterov: bool = True,
    lr_scale: Optional[Mapping[str, Scalar]] = None,
    has_bn: bool = False,
    calibrate_model: Optional[nn.Module] = None,
    cells: bool = False,
    graphs: Optional[dict] = None,
):
    """One training epoch over device-resident tensors:
    ``epoch_fn(state, frozen, x, y, valid, perm, lr, wd) -> (state, mean loss)``.

    x: (n, ...) with n a multiple of ``batch_size`` (see ``pad_dataset``);
    ``valid`` masks padded rows out of the loss; ``perm`` is the epoch's
    shuffled row order, taken ``batch_size`` rows at a time.  ``frozen``
    names frozen tensors to substitute ({}: the module's own).

    ``cells``: the state is a round's (``make_train_step``), ``lr`` and
    ``wd`` one per cell, and the mean loss one per cell.

    On the card each step is a replay of a ``StepGraph`` captured on the
    epoch's first batch, kept in ``graphs`` under ``("step", cells, batch)``
    (``cells`` the round's size; a dict the caller owns and drops with its
    engine, which its epoch and eval functions may share; None: the epoch
    fn's own) and captured anew only for another shape, dataset or frozen tree.
    Its static inputs are the state, the batch's row indices, lr and wd
    (copied in as device tensors) and the static scales.  The CPU runs the
    same step eagerly (``runs_captured``).

    ``calibrate_model`` (the module behind ``apply_fn``) asks for the static
    int8 recipe: every epoch starts by calibrating the activation scales on
    its first batch (``calibrate`` at ``INT8_CALIB_MARGIN``, per cell in a
    round, outside the graph) and trains on them.  Stale scales saturate as
    the adapters move the residual stream, and destroy convergence."""
    step = make_train_step(apply_fn, criterion, momentum, nesterov, lr_scale, has_bn, cells)
    graphs = {} if graphs is None else graphs

    def scales_for(state: TrainCellState, frozen, bx) -> Tensors:
        def one(trainable, bn):
            variables = merge_params(trainable, frozen)
            if has_bn:
                variables.update(bn)
            return calibrate(calibrate_model, apply_fn, variables, bx)

        if not cells:
            return one(state.trainable, state.bn)
        per = [one(_cell(state.trainable, i), _cell(state.bn, i))
               for i in range(_cells_of(state.trainable))]
        return {k: torch.stack([p[k] for p in per]) for k in per[0]}

    def epoch_fn(state: TrainCellState, frozen, x, y, valid, perm, lr, wd):
        nb = x.shape[0] // batch_size
        idxs = torch.as_tensor(perm, device=x.device).reshape(nb, batch_size)
        lr = torch.as_tensor(lr, dtype=torch.float32).to(x.device)
        wd = torch.as_tensor(wd, dtype=torch.float32).to(x.device)
        scales = {}
        if calibrate_model is not None:
            scales = scales_for(state, frozen, x[idxs[0]])
        if not runs_captured(x):
            losses = []
            for idx in idxs:
                state, loss = step(state, frozen, x[idx], y[idx], valid[idx], lr, wd, scales)
                losses.append(loss)
            return state, torch.stack(losses).mean(0)

        def body(inputs):
            now = TrainCellState(inputs["trainable"], inputs["momentum"], 0, inputs["bn"])
            idx = inputs["idx"]
            new, loss = step(now, frozen, x[idx], y[idx], valid[idx], inputs["lr"],
                             inputs["wd"], inputs["scales"])
            with torch.no_grad():  # the new state back into the static buffers
                for part in ("trainable", "momentum", "bn"):
                    for k, t in (getattr(new, part) or {}).items():
                        inputs[part][k].copy_(t)
            return loss

        inputs = {"trainable": state.trainable, "momentum": state.momentum,
                  "bn": state.bn or {}, "scales": scales, "idx": idxs[0], "lr": lr, "wd": wd}
        key = ("step", _cells_of(state.trainable) if cells else None, batch_size)
        graph = _graph(graphs, key, body, inputs, (x, y, valid, *frozen.values()))
        losses = []
        for i, idx in enumerate(idxs):
            loss = graph(**inputs) if i == 0 else graph(idx=idx)
            losses.append(loss.clone())
        held = graph.inputs
        state = TrainCellState(
            trainable={k: v.detach().clone() for k, v in held["trainable"].items()},
            momentum={k: v.clone() for k, v in held["momentum"].items()},
            step=state.step + nb,
            bn={k: v.clone() for k, v in held["bn"].items()} if has_bn else None,
        )
        return state, torch.stack(losses).mean(0)

    return epoch_fn


def make_eval_fn(apply_fn: ApplyFn, batch_size: int, has_bn: bool = False, cells: bool = False,
                 graphs: Optional[dict] = None):
    """Batched inference over a device-resident tensor: returns logits,
    (cells, n, C) for a round's stacked ``trainable`` (``cells``) under
    ``torch.func.vmap``, else (n, C).

    With ``has_bn`` the eval runs on the running statistics ``bn``.  On the
    card each batch is a ``StepGraph`` replay (kept in ``graphs`` under
    ``("eval", cells, batch)``), its static inputs the trainable leaves, the
    statistics and the batch's row indices; the CPU runs it eagerly."""
    graphs = {} if graphs is None else graphs

    def forward(trainable, bn, frozen, bx):
        variables = merge_params(trainable, frozen)
        if has_bn:
            variables.update(bn)
        return apply_fn(variables, bx, False)

    @torch.no_grad()
    def eval_fn(trainable, frozen, x, bn=None):
        nb = x.shape[0] // batch_size
        idxs = torch.arange(nb * batch_size, device=x.device).reshape(nb, batch_size)

        def body(inputs):
            with torch.no_grad():
                bx = x[inputs["idx"]]
                if cells:
                    return vmap(lambda t, b: forward(t, b, frozen, bx),
                                in_dims=(0, 0 if has_bn else None))(
                        inputs["trainable"], inputs["bn"] if has_bn else None)
                return forward(inputs["trainable"], inputs["bn"], frozen, bx)

        inputs = {"trainable": dict(trainable), "bn": dict(bn or {}), "idx": idxs[0]}
        if runs_captured(x):
            key = ("eval", _cells_of(trainable) if cells else None, batch_size)
            graph = _graph(graphs, key, body, inputs, (x, *frozen.values()))
            logits = [(graph(**inputs) if i == 0 else graph(idx=idx)).clone()
                      for i, idx in enumerate(idxs)]
        else:
            logits = [body({**inputs, "idx": idx}) for idx in idxs]
        return torch.cat(logits, dim=1 if cells else 0)

    return eval_fn


class ArrayTask(NamedTuple):
    """A device-resident classification task (few-shot scale), padded to
    whole batches."""

    x_train: torch.Tensor
    y_train: torch.Tensor
    valid_train: torch.Tensor
    x_val: torch.Tensor
    y_val: torch.Tensor
    valid_val: torch.Tensor


def pad_dataset(x: np.ndarray, y: np.ndarray, batch: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (x, y) to a multiple of ``batch``; returns (x, y, valid).

    Pad rows CYCLE the dataset (row i % n) rather than repeating row 0: the
    loss masks them out either way, but train-mode channel BN sees every row
    of the batch, and cycled padding keeps its statistics distributed like
    the data."""
    n = x.shape[0]
    m = max(1, -(-n // batch)) * batch
    if m == n:
        return x, y, np.ones(n, bool)
    reps = np.concatenate([np.arange(n), np.arange(m - n) % n])
    valid = np.concatenate([np.ones(n, bool), np.zeros(m - n, bool)])
    return x[reps], y[reps], valid


def make_array_task(x_train, y_train, x_val, y_val, batch_size: int, device=None) -> ArrayTask:
    """Pad both splits to whole batches and put them on ``device`` (None:
    the card)."""
    device = resolve_device(device)
    xt, yt, vt = pad_dataset(np.asarray(x_train), np.asarray(y_train), batch_size)
    xv, yv, vv = pad_dataset(np.asarray(x_val), np.asarray(y_val), batch_size)
    return ArrayTask(*(torch.as_tensor(a, device=device) for a in (xt, yt, vt, xv, yv, vv)))


def masked_accuracy(logits: torch.Tensor, y: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent over valid rows."""
    correct = (logits.argmax(dim=-1) == y) & valid
    return 100.0 * correct.sum() / valid.sum().clamp_min(1)
