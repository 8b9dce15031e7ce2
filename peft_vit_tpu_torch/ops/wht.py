"""The fast Walsh-Hadamard transform (WHT) of the Fastfood intrinsic-dimension
reparameterization (counterpart of ``peft_vit_tpu/ops/wht.py``).

Reference math: full_shot/main/intrinsic/fastfood.py:81-121
(``fast_walsh_hadamard_torched``): log2(d) butterfly stages of ``[a+b; a-b]``
over a power-of-two vector, optionally normalized to the orthonormal H.

Two forms, as in the JAX package, both plain PyTorch (the JAX package runs
XLA here, no Pallas kernel):

* ``wht_matmul``: the product with the dense fp32 H_d, made once per length
  and device.  It runs in IEEE fp32, never TF32: the forward and the
  backward (the transpose of H is H) each scope the setting to their own
  product (``_ieee_fp32``), and nothing sets it for the process.
* ``wht_butterfly``: the O(d log d) butterfly, one stage of reshaped adds
  and subtracts at a time.

``wht`` takes the product up to ``DENSE_MAX`` and the butterfly beyond.
The JAX package's split (4,096) was chosen for the TPU's MXU; this one
comes from the card: ``chip_smoke.py::wht_split_timing`` times both forms
on one vector at each length (``PERF.md`` §6).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

#: the longest vector ``wht`` transforms by the dense product (the butterfly
#: beyond): the lengths where the product was faster on the H100
#: (``chip_smoke.py::wht_split_timing``)
DENSE_MAX = 4096

_MATRICES: Dict[Tuple[int, str, bool], torch.Tensor] = {}


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _check_length(d: int) -> None:
    if not _is_pow2(d):
        raise ValueError(f"WHT length must be a power of two, got {d}")


@contextlib.contextmanager
def _ieee_fp32():
    """fp32 products in IEEE fp32 for the body only (TF32 off), the flag put
    back after it."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _hadamard_matrix(d: int, device: torch.device, normalize: bool) -> torch.Tensor:
    """The dense Hadamard matrix H_d in fp32, divided by sqrt(d) (the JAX
    package's matrix) and, unnormalized, multiplied back by sqrt(d) as the
    JAX package does (so its entries are the JAX entries, within an ulp of
    +-1).  Made once per (d, device, normalize)."""
    key = (d, str(device), normalize)
    h = _MATRICES.get(key)
    if h is None:
        h = torch.ones((1, 1), dtype=torch.float32)
        while h.shape[0] < d:
            h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
        root = torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
        h = h / root
        if not normalize:
            h = h * root
        h = _MATRICES[key] = h.to(device)
    return h


class _DenseWHT(torch.autograd.Function):
    """x @ H with H symmetric: the backward is g @ H.  Both products in IEEE
    fp32."""

    @staticmethod
    def forward(ctx, x, h):
        ctx.save_for_backward(h)
        with _ieee_fp32():
            return x @ h

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        with _ieee_fp32():
            return g @ h, None


def wht_matmul(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """The WHT of the last axis of ``x`` (power-of-two length) as a product
    with the dense fp32 H; fp32 out."""
    d = x.shape[-1]
    _check_length(d)
    return _DenseWHT.apply(x.to(torch.float32), _hadamard_matrix(d, x.device, normalize))


def wht_butterfly(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """The butterfly WHT of the last axis of ``x`` (power-of-two length):
    stage i pairs the elements ``d >> (i + 1)`` apart; fp32 out."""
    d = x.shape[-1]
    _check_length(d)
    lead = x.shape[:-1]
    y = x.to(torch.float32)
    for i in range(d.bit_length() - 1):
        z = y.reshape(*lead, -1, 2, d >> (i + 1))
        a, b = z[..., 0, :], z[..., 1, :]
        y = torch.stack([a + b, a - b], dim=-2).reshape(*lead, d)
    if normalize:
        # made on the device: a captured step may copy no host number there
        y = y / torch.sqrt(torch.full((), float(d), dtype=torch.float32, device=y.device))
    return y


def wht(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """The WHT of the last axis: the dense product up to ``DENSE_MAX``, the
    butterfly beyond."""
    d = x.shape[-1]
    _check_length(d)
    if d <= DENSE_MAX:
        return wht_matmul(x, normalize)
    return wht_butterfly(x, normalize)
