"""EMA and SWA of the trainable leaves (counterpart of
``peft_vit_tpu/engine/ema.py``).

Reference: full_shot/main/lib/utils/ema.py:7-79 (the per-step shadow blend)
and tools/train.py:125-287 + tools/swa_finetune.py
(torch.optim.swa_utils.AveragedModel + SWALR).  Both track the trainable
leaves only.  The updates are in place: a captured step writes its state
buffers.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


class EmaState(NamedTuple):
    shadow: Tensors
    decay: float  # an fp32 value


def ema_init(params: Mapping[str, torch.Tensor], decay: float) -> EmaState:
    return EmaState({k: v.detach().clone() for k, v in params.items()},
                    float(np.float32(decay)))


@torch.no_grad()
def ema_update_(shadow: Tensors, params: Mapping[str, torch.Tensor], decay: float) -> None:
    """shadow = decay * shadow + (1 - decay) * param, the (1 - decay) in fp32
    as the JAX function computes it."""
    names = list(shadow)
    s = [shadow[k] for k in names]
    rest = float(np.float32(1.0) - np.float32(decay))
    torch._foreach_mul_(s, decay)
    torch._foreach_add_(s, torch._foreach_mul([params[k].to(shadow[k].dtype) for k in names],
                                              rest))


class SwaState(NamedTuple):
    average: Tensors
    count: torch.Tensor  # int32: the number of models averaged


def swa_init(params: Mapping[str, torch.Tensor]) -> SwaState:
    first = next(iter(params.values()))
    return SwaState({k: v.detach().clone() for k, v in params.items()},
                    torch.zeros((), dtype=torch.int32, device=first.device))


@torch.no_grad()
def swa_update_(state: SwaState, params: Mapping[str, torch.Tensor],
                on: torch.Tensor) -> None:
    """The running equal-weight average (AveragedModel):
    avg = (avg * n + p) / (n + 1), n += 1, where the bool tensor ``on`` holds
    (the JAX step's ``lax.cond`` on the epoch, as a device flag)."""
    names = list(state.average)
    avg = [state.average[k] for k in names]
    n = state.count.to(torch.float32)
    new = torch._foreach_add(torch._foreach_mul(avg, n),
                             [params[k].to(state.average[k].dtype) for k in names])
    new = torch._foreach_div(new, n + 1)
    for a, b in zip(avg, new):
        a.copy_(torch.where(on, b, a))
    state.count.add_(on.to(torch.int32))


def swalr_schedule(base_lr: float, swa_lr: float, begin_step: int, anneal_steps: int,
                   strategy: str = "cos"):
    """SWALR: anneal from the running lr to ``swa_lr`` over ``anneal_steps``
    after ``begin_step`` (the ``SWA.LR_RATIO`` / ``ANNEAL_*`` keys), cosine or
    linear; a function of the step count returning an fp32 tensor."""

    def schedule(count):
        count = torch.as_tensor(count)
        span = torch.full((), float(max(anneal_steps, 1)), dtype=torch.float32,
                          device=count.device)
        t = torch.clamp((count - begin_step).to(torch.float32) / span, 0.0, 1.0)
        f = 0.5 * (1.0 + torch.cos(math.pi * (1.0 - t))) if strategy == "cos" else t
        return base_lr + (swa_lr - base_lr) * f

    return schedule
