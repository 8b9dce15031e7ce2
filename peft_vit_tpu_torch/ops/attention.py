"""Multi-head attention for the H100.

Counterpart of ``peft_vit_tpu/ops/attention.py``.  Operands keep the JAX
layout: q, k, v are (B, H, N, D), the additive bias is (H, N, N) (or
(B, H, N, N) for the plain reference), lse is (B, H, 1, N).

* ``attention_reference`` — plain PyTorch ``softmax(q k^T * scale + bias) v``
  (the JAX reference, ``attention_reference``).
* ``flash_attention_fwd`` — the wrapper of the hand-written CUDA kernel
  ``csrc/flash_attn_fwd.cu``, the counterpart of the Pallas flash forward
  ``_flash_fwd_kernel``.  A CUDA tensor launches the kernel or raises; a
  CPU tensor runs the kernel's plain version.
* ``multi_head_attention`` — what the model calls: the plain path on the
  CPU, the kernel on the card for every shape.  The JAX dispatcher's
  choice of XLA below N = 2048 was measured on a TPU and is not carried
  over.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

from . import _build

KERNEL_HEAD_DIM = 64  # the CUDA kernel's only head dim


def _scores(
    q: torch.Tensor,
    k: torch.Tensor,
    bias: Optional[torch.Tensor],
    scale: float,
    acc: torch.dtype,
) -> torch.Tensor:
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(acc)  # (H, N, N) broadcasts over the batch
    return s


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softmax_fp32: bool = True,
) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v.

    q, k, v: (B, H, N, D).  bias: (H, Nq, Nk), (B, H, Nq, Nk) or None.
    ``softmax_fp32=False`` keeps the scores in the compute dtype.  The
    scores of bf16 operands are exact fp32 products summed in fp32, as
    ``preferred_element_type=float32`` gives in JAX; the probabilities are
    cast to v's dtype for the second product.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = torch.float32 if softmax_fp32 else q.dtype
    p = torch.softmax(_scores(q, k, bias, scale, acc), dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def _flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    scale: float,
    return_lse: bool,
):
    """The kernel's plain version: the fp32-softmax reference, and the
    log-sum-exp of its fp32 scores."""
    out = attention_reference(q, k, v, bias, scale)
    if not return_lse:
        return out
    lse = torch.logsumexp(_scores(q, k, bias, scale, torch.float32), dim=-1)
    return out, lse.unsqueeze(2)


def _check_operands(q, k, v, bias) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, N, D), got shape {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if bias is not None:
        _, h, n, _ = q.shape
        if tuple(bias.shape) != (h, n, n):
            raise ValueError(f"bias must be (H, N, N) = {(h, n, n)}, got {tuple(bias.shape)}")
        if bias.device != q.device:
            raise ValueError(f"bias is on {bias.device}, q on {q.device}")
        if bias.dtype not in (torch.float32, q.dtype):
            raise TypeError(f"bias dtype {bias.dtype} is neither float32 nor q's {q.dtype}")


def _kernel_library() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd")
    if not getattr(lib, "_argtypes_set", False):
        ptr = ctypes.c_void_p
        lib.flash_attn_fwd.argtypes = [
            ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ptr,
        ]
        lib.flash_attn_fwd.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Flash-attention forward: ``softmax(scale * q k^T + bias) v``.

    q, k, v: (B, H, N, D) contiguous, bf16 or fp32; bias: (H, N, N) or None.
    Returns o (B, H, N, D) in q's dtype and, with ``return_lse``, the fp32
    log-sum-exp (B, H, 1, N).

    CUDA tensors launch ``csrc/flash_attn_fwd.cu`` (D = 64) on the current
    stream and count the launch in ``flash_attention_fwd.launches``; any
    operand the kernel does not take raises.  CPU tensors run the plain
    version and launch nothing.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_operands(q, k, v, bias)
    if q.device.type == "cpu":
        return _flash_attention_plain(q, k, v, bias, float(scale), return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bfloat16 or float32, got {q.dtype}")
    b, h, n, d = q.shape
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {KERNEL_HEAD_DIM}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if bias is not None:
        bias = bias.to(torch.float32)
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")

    lib = _kernel_library()
    out = torch.empty_like(q)
    lse = (
        torch.empty((b, h, 1, n), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    err = lib.flash_attn_fwd(
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, n, d, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash_attn_fwd launch failed: {lib.flash_attn_error_string(err).decode()}"
        )
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softmax_fp32: bool = True,
    batch_chunk: int = 0,
) -> torch.Tensor:
    """Attention over (B, H, N, D) operands with an optional (H, N, N) bias.

    CUDA tensors go to the flash kernel (which always keeps the softmax in
    fp32).  CPU tensors take ``attention_reference``; ``batch_chunk > 0``
    computes it in batch slices of that size, as the JAX package does when
    there is no bias and the batch divides evenly.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return flash_attention_fwd(q, k, v, bias, scale)
    b = q.shape[0]
    if batch_chunk and bias is None and b > batch_chunk and b % batch_chunk == 0:
        return torch.cat(
            [
                attention_reference(qc, kc, vc, None, scale, softmax_fp32)
                for qc, kc, vc in zip(
                    q.split(batch_chunk), k.split(batch_chunk), v.split(batch_chunk)
                )
            ]
        )
    return attention_reference(q, k, v, bias, scale, softmax_fp32)
