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
* ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv`` — the wrappers
  of the two backward kernels of ``csrc/flash_attn_bwd.cu``, the
  counterparts of ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``.
* ``flash_attention`` — the differentiable attention: a
  ``torch.autograd.Function`` whose forward is the forward kernel (saving
  its lse) and whose backward is the two backward kernels, as the JAX
  ``custom_vjp`` around the flash path.  A bias is a forward-only operand.
* ``multi_head_attention`` — what the model calls: ``attention_reference``
  on the CPU (torch differentiates it), ``flash_attention`` on the card for
  every shape.  The JAX dispatcher's choice of XLA below N = 2048 was
  measured on a TPU and is not carried over.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from . import _build

KERNEL_HEAD_DIM = 64  # the CUDA kernel's only head dim


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """fp32 for bf16 and fp32 operands; float64 operands stay float64."""
    return torch.promote_types(q.dtype, torch.float32)


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
    acc = _acc_dtype(q) if softmax_fp32 else q.dtype
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
    lse = torch.logsumexp(_scores(q, k, bias, scale, _acc_dtype(q)), dim=-1)
    return out, lse.unsqueeze(2)


def _bwd_p_ds(q, k, v, do, lse, delta, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """p = exp(scale q k^T - lse) and ds = p o (dO v^T - delta), each rounded
    to the operand dtype as the kernels round them, returned in the
    accumulation dtype."""
    acc = _acc_dtype(q)
    p = torch.exp(_scores(q, k, None, scale, acc) - lse.to(acc).transpose(-1, -2))
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    ds = p * (dp - delta.to(acc).transpose(-1, -2))
    return p.to(q.dtype).to(acc), ds.to(q.dtype).to(acc)


def _bwd_dq_plain(q, k, v, do, lse, delta, scale) -> torch.Tensor:
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, scale)
    return (scale * torch.matmul(ds, k.to(ds.dtype))).to(q.dtype)


def _bwd_dkv_plain(q, k, v, do, lse, delta, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, scale)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.to(ds.dtype))
    dv = torch.matmul(p.transpose(-1, -2), do.to(p.dtype))
    return dk.to(q.dtype), dv.to(q.dtype)


def _row_dot(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO o O) in the accumulation dtype, (B, H, 1, N)."""
    acc = _acc_dtype(o)
    return (do.to(acc) * o.to(acc)).sum(dim=-1).unsqueeze(2)


def _flash_attention_bwd_plain(q, k, v, o, lse, do, scale):
    """The backward kernels' plain version: ``(dq, dk, dv)`` from the saved
    lse, step by step as the kernels compute them::

        p  = exp(scale q k^T - lse)      delta = rowsum(dO o O)
        dv = p^T dO                      ds = p o (dO v^T - delta)
        dq = scale ds k                  dk = scale ds^T q

    with p cast to the operand dtype before ``dv`` and ds before ``dq`` and
    ``dk``; every sum is fp32."""
    delta = _row_dot(do, o)
    dq = _bwd_dq_plain(q, k, v, do, lse, delta, scale)
    return (dq, *_bwd_dkv_plain(q, k, v, do, lse, delta, scale))


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


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# device, operands ..., B, H, N, D, scale, is_bf16, stream
_SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "flash_attn_fwd": {
        "flash_attn_fwd": [_INT, *[_PTR] * 6, *[_INT] * 4, _FLOAT, _INT, _PTR],
    },
    "flash_attn_bwd": {
        "flash_attn_bwd_dq": [_INT, *[_PTR] * 7, *[_INT] * 4, _FLOAT, _INT, _PTR],
        "flash_attn_bwd_dkv": [_INT, *[_PTR] * 8, *[_INT] * 4, _FLOAT, _INT, _PTR],
    },
}


def _kernel_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded, its functions' signatures set."""
    lib = _build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_kernel_operands(what: str, named: Sequence[Tuple[str, torch.Tensor]]) -> None:
    """What every kernel asks of its operands (the first is (B, H, N, D))."""
    q = named[0][1]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bfloat16 or float32, got {q.dtype}")
    if q.shape[-1] != KERNEL_HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {KERNEL_HEAD_DIM}, got {q.shape[-1]}")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {q.device}")
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.flash_attn_error_string(err).decode()}")


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
    _check_kernel_operands("flash_attention_fwd", (("q", q), ("k", k), ("v", v)))
    b, h, n, d = q.shape
    if bias is not None:
        bias = bias.to(torch.float32)
        if not bias.is_contiguous():
            raise ValueError("bias must be contiguous")

    lib = _kernel_library("flash_attn_fwd")
    out = torch.empty_like(q)
    lse = (
        torch.empty((b, h, 1, n), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    err = lib.flash_attn_fwd(
        _device_index(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, n, d, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, "flash_attn_fwd")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def _check_bwd_operands(q, k, v, do, lse, delta) -> None:
    _check_operands(q, k, v, None)
    if do.shape != q.shape:
        raise ValueError(f"do shape {tuple(do.shape)} != q shape {tuple(q.shape)}")
    if do.dtype != q.dtype:
        raise TypeError(f"do dtype {do.dtype} != q dtype {q.dtype}")
    b, h, n, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, 1, n):
            raise ValueError(f"{name} must be (B, H, 1, N) = {(b, h, 1, n)}, got {tuple(t.shape)}")
    for name, t in (("do", do), ("lse", lse), ("delta", delta)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _launch_bwd(fn_name: str, q, k, v, do, lse, delta, scale, n_out: int):
    """Checks shared by the two backward wrappers, then one launch writing
    ``n_out`` gradients of q's shape and dtype."""
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got {t.dtype}")
    _check_kernel_operands(
        fn_name, (("q", q), ("k", k), ("v", v), ("do", do), ("lse", lse), ("delta", delta)))
    lib = _kernel_library("flash_attn_bwd")
    outs = tuple(torch.empty_like(q) for _ in range(n_out))
    b, h, n, d = q.shape
    err = getattr(lib, fn_name)(
        _device_index(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), *(t.data_ptr() for t in outs),
        b, h, n, d, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, fn_name)
    return outs


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
) -> torch.Tensor:
    """``dq = scale * (p o (dO v^T - delta)) k`` with ``p = exp(scale q k^T - lse)``.

    q, k, v, do: (B, H, N, D) contiguous, bf16 or fp32; lse (the forward's)
    and delta = rowsum(dO o O): (B, H, 1, N) fp32.  Returns dq in q's dtype.

    CUDA tensors launch ``flash_attn_bwd_dq`` of ``csrc/flash_attn_bwd.cu``
    (D = 64) on the current stream and count the launch in
    ``flash_attention_bwd_dq.launches``; any operand the kernel does not
    take raises.  CPU tensors run the plain version and launch nothing.
    """
    _check_bwd_operands(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return _bwd_dq_plain(q, k, v, do, lse, delta, float(scale))
    (dq,) = _launch_bwd("flash_attn_bwd_dq", q, k, v, do, lse, delta, scale, 1)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dk = scale * (p o (dO v^T - delta))^T q`` and ``dv = p^T dO``.

    Operands as ``flash_attention_bwd_dq``; returns ``(dk, dv)`` in q's
    dtype.  CUDA tensors launch ``flash_attn_bwd_dkv`` and count the launch
    in ``flash_attention_bwd_dkv.launches``; CPU tensors run the plain
    version and launch nothing.
    """
    _check_bwd_operands(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return _bwd_dkv_plain(q, k, v, do, lse, delta, float(scale))
    dk, dv = _launch_bwd("flash_attn_bwd_dkv", q, k, v, do, lse, delta, scale, 2)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward kernel with its lse saved; backward through the dq and dk/dv
    kernels (the bias-free path, as the JAX ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attention_fwd(q, k, v, None, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()  # arrives as the transposed view of the head merge
        delta = _row_dot(do, out)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable flash attention, ``softmax(scale * q k^T + bias) v``.

    With a gradient required of q, k or v the forward saves
    ``(q, k, v, o, lse)`` and the backward launches the dq and dk/dv
    kernels; without one it is ``flash_attention_fwd`` and saves nothing.
    A bias while any operand (or the bias) requires a gradient raises
    ``NotImplementedError``: there is no fallback.  CPU tensors run the
    kernels' plain versions, forward and backward.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    operands = (q, k, v) if bias is None else (q, k, v, bias)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in operands)):
        return flash_attention_fwd(q, k, v, bias, scale)
    if bias is not None:
        raise NotImplementedError(
            "the flash backward has no bias path: the bias-gradient kernel (K7) "
            "is not ported; a bias is a forward-only operand"
        )
    return _FlashAttention.apply(q, k, v, float(scale))


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

    CUDA tensors go to ``flash_attention``, forward and backward (the
    kernels always keep the softmax in fp32).  CPU tensors take
    ``attention_reference``, which torch differentiates; ``batch_chunk > 0``
    computes it in batch slices of that size, as the JAX package does when
    there is no bias and the batch divides evenly.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return flash_attention(q, k, v, bias, scale)
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
