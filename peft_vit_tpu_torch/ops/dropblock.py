"""DropBlock (Ghiasi et al. 2018; counterpart of
``peft_vit_tpu/ops/dropblock.py``).

The JAX op is XLA, with no Pallas kernel, so this is plain PyTorch:

* the effective keep probability anneals linearly from 1 toward the target
  as training progresses, ``kp(t) = 1 - t (1 - keep_prob)``, with ``t`` the
  training progress in [0, 1] (``scheduled_keep_prob``);
* a Bernoulli(gamma) draw at the valid block centers,
  ``gamma = (1 - kp) W^2 / bs^2 / (W - bs + 1)^2``, the centers
  ``bs//2 <= i < W - (bs-1)//2`` (the map must be square), expanded to
  bs x bs squares by a stride-1 min-pool (``-max_pool2d(-m)`` over a map
  padded with ones, ``(bs//2, (bs-1)//2)`` on each axis); at bs == W one
  center decides the whole map;
* the renormalization ``x * mask * mask.numel() / max(mask.sum(), 1)``;
* per-stage targets ``1 - (1 - keep_prob) / 4^(4 - i)`` for stage i in
  1 ... 4 (``stage_keep_prob``).

Tensors are NCHW.  The uniform noise comes from an explicit
``torch.Generator`` or is given (``noise``, NCHW), so that a test can pin
the JAX package's draw.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import dist as _dist


def stage_keep_prob(keep_prob: float, stage: int) -> float:
    """The DropBlock target of the 1-indexed ``stage``
    (``AUG.DROPBLOCK_LAYERS``'s numbering): shallower stages drop less."""
    return 1.0 - (1.0 - float(keep_prob)) / 4.0 ** (4 - stage)


def scheduled_keep_prob(keep_prob: float,
                        progress: Union[float, torch.Tensor]) -> Union[float, torch.Tensor]:
    """The linear anneal 1 -> ``keep_prob`` at ``progress``, in fp32: a
    0-dim tensor on progress's device for a tensor (a captured step's,
    computed on the card), the same fp32 number as a float for a number (no
    host-to-device copy)."""
    if torch.is_tensor(progress):
        return 1.0 - progress.to(torch.float32).clamp(0.0, 1.0) * (1.0 - keep_prob)
    p = np.float32(min(max(float(progress), 0.0), 1.0))
    return float(np.float32(1.0) - p * np.float32(1.0 - keep_prob))


def drop_block(x: torch.Tensor, *, block_size: int, keep_prob: Union[float, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One DropBlock draw over the NCHW ``x`` at the already scheduled
    ``keep_prob`` (a number or a 0-dim fp32 tensor).  The uniform draw is
    ``noise`` (x's shape) when given, else ``torch.rand`` from
    ``generator`` on x's device.  At ``keep_prob`` 1 the mask is all ones
    and the op is the identity."""
    n, c, h, w = x.shape
    if h != w:
        raise ValueError(f"DropBlock requires H == W (dropblock.py:35-36); got {h}x{w}")
    bs = min(int(block_size), w)
    def const(v: float) -> torch.Tensor:
        # a number as a tensor made on the device (no host-to-device copy in
        # a captured step); a divisor so, as a CUDA tensor divided by a
        # Python number is multiplied by its reciprocal, which rounds
        # otherwise than JAX's division
        return torch.full((), float(v), dtype=torch.float32, device=x.device)

    kp = (keep_prob.to(device=x.device, dtype=torch.float32) if torch.is_tensor(keep_prob)
          else const(keep_prob))
    gamma = (1.0 - kp) * w**2 / const(bs**2) / const((w - bs + 1) ** 2)
    if noise is None:
        # under a data shard, the global batch's draw cut to this rank's rows
        noise = _dist.draw_rows(lambda s: torch.rand(s, generator=generator, dtype=torch.float32,
                                                     device=x.device), x.shape)
    i = torch.arange(w, device=x.device)
    valid_1d = (i >= bs // 2) & (i < w - (bs - 1) // 2)
    valid = valid_1d[:, None] & valid_1d[None, :]
    kept = (~(valid & (noise.to(torch.float32) < gamma))).to(torch.float32)
    if bs == w:
        # one center decides the whole map
        mask = kept.reshape(n, c, h * w).amin(dim=2)[:, :, None, None].expand(n, c, h, w)
    else:
        lo, hi = bs // 2, (bs - 1) // 2
        padded = F.pad(kept, (lo, hi, lo, hi), value=1.0)
        mask = -F.max_pool2d(-padded, bs, stride=1)
    numel, kept_sum = mask.numel(), mask.sum()
    if _dist.current_shard() is not None:  # the global batch's mask
        numel = numel // n * _dist.data_rows()
        kept_sum = _dist.sum_over_data(kept_sum)
    scale = const(numel) / kept_sum.clamp_min(1.0)
    return (x * mask.to(x.dtype)) * scale.to(x.dtype)
