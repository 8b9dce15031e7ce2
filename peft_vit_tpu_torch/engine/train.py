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
  dicts, not a ``torch.optim`` object, so that a sweep can batch it over
  cells.
* Few-shot datasets are device-resident tensors; an epoch is a loop over a
  shuffled index matrix, not a host DataLoader.
* The int8 frozen tower: the tree of ``ops.int8.quantize_frozen_tree`` and
  the static activation scales travel in a step's ``frozen`` dict, named
  after the ``Int8Dense`` buffers they substitute.  ``calibrate`` makes the
  scales from one train-mode forward, and ``make_epoch_fn`` can renew them
  on each epoch's first batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..models.layers import collect_activation_stats
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
    (each cell trains its own copy)."""

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

    ``lr_scale``: optional per-leaf multiplier of ``lr``.  Returns a new
    state; no tensor of ``state`` is written."""
    p_new, buf_new = {}, {}
    for name, p in state.trainable.items():
        g = grads[name] + wd * p
        buf = momentum * state.momentum[name] + g
        step = g + momentum * buf if nesterov else buf
        rate = lr if lr_scale is None else lr * lr_scale[name]
        p_new[name] = p - rate * step
        buf_new[name] = buf
    return state._replace(trainable=p_new, momentum=buf_new, step=state.step + 1)


def step_decay_lr(base_lr: float, epoch: int, schedule: Sequence[int]) -> torch.Tensor:
    """The reference's adjust_learning_rate: x0.1 at each milestone reached,
    in fp32 as the JAX engine computes it."""
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
):
    """One SGD step on one batch: ``step(state, frozen, bx, by, bv, lr, wd)
    -> (state, loss)``.

    The loss is the ``bv``-weighted mean of the per-example criterion over
    fp32 logits, ``sum(per * w) / max(sum(w), 1)`` (``bv=None``: every row
    counts).  With ``has_bn`` the step runs train-mode BN on a copy of
    ``state.bn`` and returns the blended statistics in the new state."""

    def step(state: TrainCellState, frozen, bx, by, bv, lr, wd):
        trainable = {k: v.requires_grad_() for k, v in state.trainable.items()}
        variables = merge_params(trainable, frozen)
        new_bn = state.bn
        if has_bn:
            new_bn = {k: v.clone() for k, v in state.bn.items()}
            variables.update(new_bn)
        logits = apply_fn(variables, bx, True)
        per = criterion(logits.to(torch.float32), by)
        if bv is None:
            loss = per.mean()
        else:
            w = bv.to(torch.float32)
            loss = (per * w).sum() / w.sum().clamp_min(1.0)
        grads = torch.autograd.grad(loss, list(trainable.values()))
        state = sgd_update(dict(zip(trainable, grads)), state, lr, wd, momentum, nesterov,
                           lr_scale)
        return state._replace(bn=new_bn), loss.detach()

    return step


def make_epoch_fn(
    apply_fn: ApplyFn,
    criterion: PerExampleCriterion,
    batch_size: int,
    momentum: float = 0.9,
    nesterov: bool = True,
    lr_scale: Optional[Mapping[str, Scalar]] = None,
    has_bn: bool = False,
    calibrate_model: Optional[nn.Module] = None,
):
    """One training epoch over device-resident tensors:
    ``epoch_fn(state, frozen, x, y, valid, perm, lr, wd) -> (state, mean loss)``.

    x: (n, ...) with n a multiple of ``batch_size`` (see ``pad_dataset``);
    ``valid`` masks padded rows out of the loss; ``perm`` is the epoch's
    shuffled row order, taken ``batch_size`` rows at a time.  ``frozen``
    names frozen tensors to substitute ({}: the module's own).

    ``calibrate_model`` (the module behind ``apply_fn``) asks for the static
    int8 recipe: every epoch starts by calibrating the activation scales on
    its first batch (``calibrate`` at ``INT8_CALIB_MARGIN``) and trains on them.
    Stale scales saturate as the adapters move the residual stream, and
    destroy convergence."""
    step = make_train_step(apply_fn, criterion, momentum, nesterov, lr_scale, has_bn)

    def epoch_fn(state: TrainCellState, frozen, x, y, valid, perm, lr, wd):
        nb = x.shape[0] // batch_size
        idxs = torch.as_tensor(perm, device=x.device).reshape(nb, batch_size)
        if calibrate_model is not None:
            variables = merge_params(state.trainable, frozen)
            if has_bn:
                variables.update(state.bn)
            scales = calibrate(calibrate_model, apply_fn, variables, x[idxs[0]])
            frozen = {**frozen, **scales}
        losses = []
        for idx in idxs:
            state, loss = step(state, frozen, x[idx], y[idx], valid[idx], lr, wd)
            losses.append(loss)
        return state, torch.stack(losses).mean()

    return epoch_fn


def make_eval_fn(apply_fn: ApplyFn, batch_size: int, has_bn: bool = False):
    """Batched inference over a device-resident tensor: returns logits.

    With ``has_bn`` the eval runs on the running statistics ``bn``."""

    @torch.no_grad()
    def eval_fn(trainable, frozen, x, bn=None):
        variables = merge_params(trainable, frozen)
        if has_bn:
            variables.update(bn)
        nb = x.shape[0] // batch_size
        logits = [apply_fn(variables, bx, False)
                  for bx in x.reshape(nb, batch_size, *x.shape[1:])]
        return torch.cat(logits).reshape(nb * batch_size, -1)

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
