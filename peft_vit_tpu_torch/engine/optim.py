"""Optimizers and learning-rate schedules (counterpart of
``peft_vit_tpu/engine/optim.py``).

The JAX package builds an optax chain over the trainable tree; here the same
chain is plain arithmetic on name-keyed tensor dicts, written with
``torch._foreach_*`` over the leaf lists (PyTorch's multi-tensor idiom, the
counterpart of XLA fusing optax's ``tree_map``).  The arithmetic is optax's,
not ``torch.optim``'s, operation for operation:

* ``clip_by_global_norm``: one norm over every trainable leaf; leaves scale
  by max_norm / norm when the norm reaches max_norm;
* SGD: coupled weight decay (``g + wd * p``) on the ``no_weight_decay_mask``
  leaves, or LARC (which takes the weight decay itself and sees the raw
  ||g||), then ``trace``: t = g + mu t, the update t, or g + mu t with
  nesterov;
* adam and adamw/timm: the same chain (a quirk of the JAX package kept
  here): ``scale_by_adam`` (eps outside the root, after bias correction),
  then the decoupled weight decay ``u + wd * p``;
* rmsprop: ``scale_by_rms`` (g * rsqrt(nu + eps), nu from 0), the weight
  decay, then ``trace`` without nesterov;
* ``TWO_LR``: the backbone's updates times 0.1;
* the learning rate: the update times -schedule(step), added to the leaf.

The schedules are functions of the step count (an int or a tensor) returning
an fp32 tensor on the count's device, so that a captured step reads its rate
from the step it holds, never from a number baked into the capture.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch

from ..models.convert import jax_path
from .ema import swalr_schedule

Tensors = Dict[str, torch.Tensor]
Count = Union[int, torch.Tensor]
Schedule = Callable[[Count], torch.Tensor]


def _count(count: Count) -> torch.Tensor:
    return torch.as_tensor(count).to(torch.float32)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` with ``b`` as an fp32 tensor: a CUDA tensor divided by a
    Python number is multiplied by the reciprocal, which moves the last bit."""
    return a / _f32(b, a)


# ---------------------------------------------------------------------------
# weight-decay / lr grouping masks


_NO_WD_DEFAULT = ("bias", "/ln_", "norm", "bn", "class_embedding",
                  "positional_embedding", "logit_scale")


def no_weight_decay_mask(params: Mapping[str, torch.Tensor],
                         without_wd_list: Sequence[str] = ()) -> Dict[str, bool]:
    """True where weight decay applies (the reference ``set_wd``,
    lib/optim/build.py:19-88), over the JAX package's paths of the leaves
    (``models.convert.jax_path``): bias, LayerNorm, BatchNorm and GroupNorm
    leaves and the ``WITHOUT_WD_LIST`` substrings get none, and
    'depthwise' excludes depthwise-conv kernels by shape (OIHW with one
    input channel a group and more than one output channel)."""
    keys = tuple(without_wd_list) or _NO_WD_DEFAULT
    depthwise = "depthwise" in keys

    def decays(name: str, v: torch.Tensor) -> bool:
        path = jax_path(name, v.dim()).lower()
        if any(s in path for s in keys):
            return False
        if depthwise and v.dim() == 4 and v.shape[1] == 1 and v.shape[0] > 1:
            return False
        return True

    return {k: decays(k, v) for k, v in params.items()}


def backbone_lr_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True for backbone leaves (0.1x lr under TWO_LR), False for the head."""
    return {k: not k.startswith("classifier.") for k in params}


# ---------------------------------------------------------------------------
# schedules


def step_decay_schedule(base_lr: float, milestones, steps_per_epoch: int,
                        gamma: float = 0.1) -> Schedule:
    """lr x gamma for each milestone epoch passed (the reference few-shot
    ``adjust_learning_rate``), the JAX function's arithmetic: the first
    product in double precision, the later ones in fp32."""
    milestones = sorted(int(m) for m in milestones)

    def schedule(count):
        count = torch.as_tensor(count)
        epoch = torch.div(count, max(steps_per_epoch, 1), rounding_mode="floor")
        lr = None
        for m in milestones:
            if lr is None:
                lr = torch.where(epoch >= m, _f32(base_lr * gamma, count), _f32(base_lr, count))
            else:
                lr = torch.where(epoch >= m, lr * gamma, lr)
        return _f32(base_lr, count) if lr is None else lr

    return schedule


def warmup_cosine_schedule(base_lr: float, total_steps: int, warmup_steps: int = 0,
                           warmup_factor: float = 0.001, end_lr: float = 0.0,
                           warmup_method: str = "linear") -> Schedule:
    """WarmupCosineLR (lib/scheduler/warmup_lr.py:59-135), the reference's
    exact semantics: the warmup factor multiplies a cosine that runs from
    step 0, lr(t) = wf(t) * (end + 0.5 (base - end) (1 + cos(pi t / total)))."""

    def schedule(count):
        count = _count(count)
        if warmup_method == "constant":
            wf = torch.where(count < warmup_steps, _f32(warmup_factor, count), _f32(1.0, count))
        else:
            alpha = _div(count, float(max(warmup_steps, 1)))
            wf = torch.where(count < warmup_steps, warmup_factor * (1 - alpha) + alpha,
                             _f32(1.0, count))
        cos = end_lr + 0.5 * (base_lr - end_lr) * (
            1.0 + torch.cos(_div(math.pi * count, float(max(total_steps, 1)))))
        return wf * cos

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """``optax.cosine_decay_schedule(init_value, decay_steps)`` (alpha 0,
    exponent 1)."""

    def schedule(count):
        count = torch.clamp(_count(count), max=float(decay_steps))
        return init_value * (0.5 * (1 + torch.cos(_div(math.pi * count, float(decay_steps)))))

    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda count: _f32(value, torch.as_tensor(count))


def cyclic_schedule(base_lr: float, max_lr: float, step_size_up: int, step_size_down: int = 0,
                    mode: str = "triangular", gamma: float = 1.0) -> Schedule:
    """torch.optim.lr_scheduler.CyclicLR semantics: triangular, triangular2
    and exp_range."""
    down = step_size_down or step_size_up
    period = step_size_up + down

    def schedule(count):
        count = _count(count)
        cycle = torch.floor(1.0 + _div(count, float(period)))
        pos = count - (cycle - 1.0) * period
        frac = torch.where(pos < step_size_up, _div(pos, float(step_size_up)),
                           1.0 - _div(pos - step_size_up, float(down)))
        amp = max_lr - base_lr
        if mode == "triangular2":
            amp = _f32(amp, count) / (2.0 ** (cycle - 1.0))
        elif mode == "exp_range":
            amp = amp * torch.pow(_f32(gamma, count), count)
        return base_lr + amp * torch.clamp(frac, 0.0, 1.0)

    return schedule


def build_lr_schedule(cfg, steps_per_epoch: int) -> Schedule:
    """The schedule ``TRAIN.LR_SCHEDULER.METHOD`` names: step / multistep
    (``TRAIN.SCHEDULE`` epochs), cosine / cosineannealing, warmupcosine /
    warmup_cosine (``WARMUP_EPOCH``, ``WARMUP_FACTOR``), constant, cyclic /
    cycliclr (``MAX_LR``, ``STEP_SIZE_UP``, ``STEP_SIZE_DOWN``,
    ``CYCLIC_MODE``, ``CYCLIC_GAMMA``), swalr / swa (the ``SWA`` group)."""
    method = str(cfg.TRAIN.LR_SCHEDULER.METHOD).lower()
    base_lr = float(cfg.TRAIN.LR)
    total = max(int(cfg.TRAIN.END_EPOCH) * steps_per_epoch, 1)
    args = cfg.TRAIN.LR_SCHEDULER
    if method in ("step", "multistep"):
        return step_decay_schedule(base_lr, cfg.TRAIN.SCHEDULE or [], steps_per_epoch)
    if method in ("cosine", "cosineannealing"):
        return cosine_decay_schedule(base_lr, total)
    if method in ("warmupcosine", "warmup_cosine"):
        warmup_epochs = float(args.get("WARMUP_EPOCH", 5))
        return warmup_cosine_schedule(
            base_lr, total, warmup_steps=int(warmup_epochs * steps_per_epoch),
            warmup_factor=float(args.get("WARMUP_FACTOR", 0.001)))
    if method == "constant":
        return constant_schedule(base_lr)
    if method in ("cyclic", "cycliclr"):
        return cyclic_schedule(
            base_lr, float(args.get("MAX_LR", base_lr * 10)), int(args.get("STEP_SIZE_UP", 2000)),
            int(args.get("STEP_SIZE_DOWN", 0)), str(args.get("CYCLIC_MODE", "triangular")),
            float(args.get("CYCLIC_GAMMA", 1.0)))
    if method in ("swalr", "swa"):
        swa = cfg.SWA
        return swalr_schedule(
            base_lr, base_lr * float(swa.LR_RATIO),
            max(int(swa.BEGIN_EPOCH), 0) * steps_per_epoch,
            max(int(swa.ANNEAL_EPOCHS), 1) * steps_per_epoch, str(swa.ANNEAL_STRATEGY))
    raise ValueError(f"Unknown LR scheduler {method!r}")


# ---------------------------------------------------------------------------
# the chain


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: one norm over every leaf."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    coef = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return torch._foreach_mul(grads, coef)


def larc(grads: List[torch.Tensor], params: List[torch.Tensor], wds: Sequence[float],
         learning_rate: float, trust_coefficient: float = 0.02, clip: bool = True,
         eps: float = 1e-8) -> List[torch.Tensor]:
    """LARC (lib/optim/LARC.py:82-109), per leaf with its weight decay wd:
    adaptive = trust ||p|| / (||g|| + ||p|| wd + eps) on the RAW gradient;
    clip mode scales by min(adaptive / lr, 1); the update is
    (g + wd p) * scale, or g untouched (no decay) where either norm is 0."""
    pn = torch.stack(torch._foreach_norm(params))
    gn = torch.stack(torch._foreach_norm(grads))
    # made on the device (a captured step may not copy a host list there)
    wd = torch.stack([torch.full((), w, dtype=torch.float32, device=pn.device) for w in wds])
    adaptive = trust_coefficient * pn / (gn + pn * wd + eps)
    scale = torch.clamp(_div(adaptive, learning_rate), max=1.0) if clip else adaptive
    active = (pn > 0) & (gn > 0)
    return [torch.where(active[i], (g + w * p) * scale[i], g)
            for i, (g, p, w) in enumerate(zip(grads, params, wds))]


class Optimizer:
    """The chain of ``build_optimizer`` over the trainable leaves ``names``.

    ``init(params)`` gives the state, a flat dict of tensors (the trace, the
    Adam or RMS moments and Adam's count, keyed ``<slot>.<leaf>``; empty for
    plain SGD); ``step(params, grads, state, count)`` applies one update to
    ``params`` and ``state`` in place, the rate ``schedule(count)``, and
    returns that rate.  Nothing waits for the host."""

    def __init__(self, name: str, names: Sequence[str], schedule: Schedule, wd: float = 0.0,
                 momentum: float = 0.0, nesterov: bool = False, clip_norm: float = 0.0,
                 use_larc: bool = False, larc_lr: float = 1.0, rms_decay: float = 0.9,
                 wd_mask: Optional[Mapping[str, bool]] = None,
                 backbone_mask: Optional[Mapping[str, bool]] = None):
        if name not in ("sgd", "adam", "adamw", "timm", "rmsprop"):
            raise ValueError(f"Unknown optimizer {name!r}")
        self.name = "adam" if name in ("adamw", "timm") else name
        self.names = list(names)
        self.schedule = schedule
        self.wd, self.momentum, self.nesterov = float(wd), float(momentum), bool(nesterov)
        self.clip_norm, self.use_larc, self.larc_lr = float(clip_norm), bool(use_larc), larc_lr
        self.rms_decay = float(rms_decay)
        wd_mask = wd_mask or {k: True for k in self.names}
        self.decayed = [i for i, k in enumerate(self.names) if wd_mask[k]]
        self.backbone = ([i for i, k in enumerate(self.names) if backbone_mask[k]]
                         if backbone_mask is not None else None)

    def _slots(self) -> List[str]:
        if self.name == "adam":
            return ["mu", "nu"]
        if self.name == "rmsprop":
            return ["nu"] + (["trace"] if self.momentum else [])
        return ["trace"] if self.momentum else []

    def init(self, params: Mapping[str, torch.Tensor]) -> Tensors:
        state = {f"{slot}.{k}": torch.zeros_like(params[k]) for slot in self._slots()
                 for k in self.names}
        if self.name == "adam":
            state["count"] = torch.zeros((), dtype=torch.int32,
                                         device=params[self.names[0]].device)
        return state

    def _decay(self, g: List[torch.Tensor], p: List[torch.Tensor]) -> List[torch.Tensor]:
        """g + wd * p on the decayed leaves (optax ``add_decayed_weights``)."""
        if not self.wd or not self.decayed:
            return g
        g = list(g)
        sub = torch._foreach_add([g[i] for i in self.decayed],
                                 torch._foreach_mul([p[i] for i in self.decayed], self.wd))
        for i, t in zip(self.decayed, sub):
            g[i] = t
        return g

    def _trace(self, g: List[torch.Tensor], state: Tensors, nesterov: bool) -> List[torch.Tensor]:
        t = [state[f"trace.{k}"] for k in self.names]
        torch._foreach_mul_(t, self.momentum)
        torch._foreach_add_(t, g)
        if nesterov:
            return torch._foreach_add(g, torch._foreach_mul(t, self.momentum))
        return t

    def _adam(self, g: List[torch.Tensor], state: Tensors, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> List[torch.Tensor]:
        mu = [state[f"mu.{k}"] for k in self.names]
        nu = [state[f"nu.{k}"] for k in self.names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, sq)
        count = state["count"]
        count.add_(1)
        c = count.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, c), c)
        bc2 = 1 - torch.pow(_f32(b2, c), c)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, eps)
        return torch._foreach_div(torch._foreach_div(mu, bc1), denom)

    def _rms(self, g: List[torch.Tensor], state: Tensors, eps: float = 1e-8) -> List[torch.Tensor]:
        nu = [state[f"nu.{k}"] for k in self.names]
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(sq, 1 - self.rms_decay)
        torch._foreach_mul_(nu, self.rms_decay)
        torch._foreach_add_(nu, sq)
        return [torch.rsqrt(n + eps) * x for n, x in zip(nu, g)]

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             state: Tensors, count: torch.Tensor) -> torch.Tensor:
        p = [params[k] for k in self.names]
        g = [grads[k] for k in self.names]
        if self.clip_norm > 0.0:
            g = clip_by_global_norm(g, self.clip_norm)
        if self.name == "sgd":
            if self.use_larc:
                wds = [self.wd if i in set(self.decayed) else 0.0 for i in range(len(p))]
                g = larc(g, p, wds, self.larc_lr)
            else:
                g = self._decay(g, p)
            if self.momentum:
                g = self._trace(g, state, self.nesterov)
        elif self.name == "adam":
            g = self._decay(self._adam(g, state), p)
        else:
            g = self._decay(self._rms(g, state), p)
            if self.momentum:
                g = self._trace(g, state, False)
        if self.backbone:
            sub = torch._foreach_mul([g[i] for i in self.backbone], 0.1)
            g = list(g)
            for i, t in zip(self.backbone, sub):
                g[i] = t
        lr = self.schedule(count)
        torch._foreach_add_(p, torch._foreach_mul(g, -lr))
        return lr


def build_optimizer(cfg, trainable: Mapping[str, torch.Tensor], steps_per_epoch: int = 1,
                    schedule: Optional[Schedule] = None) -> Optimizer:
    """The chain of ``TRAIN.OPTIMIZER`` (sgd, adam, adamw / timm, rmsprop)
    over ``trainable``: ``TRAIN.CLIP_GRAD_NORM``, ``LARC``, ``WD`` with
    ``WITHOUT_WD_LIST``, ``MOMENTUM``, ``NESTEROV``, ``GAMMA1`` (rmsprop's
    decay) and ``TWO_LR``, at the rate of ``schedule`` (default
    ``build_lr_schedule``)."""
    t = cfg.TRAIN
    if schedule is None:
        schedule = build_lr_schedule(cfg, steps_per_epoch)
    return Optimizer(
        str(t.OPTIMIZER).lower(), list(trainable), schedule, wd=float(t.WD),
        momentum=float(t.MOMENTUM), nesterov=bool(t.NESTEROV),
        clip_norm=float(t.CLIP_GRAD_NORM), use_larc=bool(t.LARC), larc_lr=float(t.LR),
        rms_decay=float(t.GAMMA1), wd_mask=no_weight_decay_mask(trainable, t.WITHOUT_WD_LIST),
        backbone_mask=backbone_lr_mask(trainable) if bool(t.TWO_LR) else None)
