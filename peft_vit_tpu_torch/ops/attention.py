"""Multi-head attention for the H100.

Counterpart of ``peft_vit_tpu/ops/attention.py``.  Operands keep the JAX
layout: q, k, v are (B, H, N, D), lse is (B, H, 1, N).  The additive bias is
(H, N, N), shared by the batch, or (C, H, N, N) with C dividing B: batch
element b reads cell ``b // (B // C)`` (a sweep round's cells, each with its
own relative position table, folded into the batch); the plain reference
also takes (B, H, N, N).

* ``attention_reference`` — plain PyTorch ``softmax(q k^T * scale + bias) v``
  (the JAX reference, ``attention_reference``).
* ``flash_attention_fwd`` — the wrapper of the hand-written CUDA kernel
  ``csrc/flash_attn_fwd.cu``, the counterpart of the Pallas flash forward
  ``_flash_fwd_kernel``.  A CUDA tensor launches the kernel or raises; a
  CPU tensor runs the kernel's plain version.
* ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv`` — the wrappers
  of the two backward kernels of ``csrc/flash_attn_bwd.cu``, the
  counterparts of ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``,
  with the bias added where they recompute p.  The dq kernel also computes
  delta = rowsum(dO o O), which the JAX wrapper computes in XLA before the
  kernels, and hands it to the dk/dv kernel.
* ``attention_bias_grad`` — the wrapper of ``csrc/attn_bias_grad.cu``, the
  bias gradient dbias = sum over each cell's batch of p o (dO v^T - delta).
  It has no Pallas counterpart: with a bias the JAX package leaves the
  kernels for the XLA VJP of ``attention_reference``
  (``_attention_bias_vjp_bwd``).
* ``flash_attention`` — the differentiable attention: a
  ``torch.autograd.Function`` whose forward is the forward kernel (saving
  its lse) and whose backward is the two backward kernels for q, k and v and
  the bias-gradient kernel for the bias, as the JAX ``custom_vjp``s around
  the flash path and the bias path.
* ``fused_short_attention_fwd`` / ``fused_short_attention_bwd`` — the
  wrappers of the two kernels of ``csrc/fused_short_attn.cu``, the
  counterparts of the Pallas fused short-sequence pair ``_short_fwd_kernel``
  and ``_short_bwd_kernel``: whole-row softmax with p normalised before it is
  rounded, and a backward that computes delta itself and folds the scale
  into ds before rounding it.
* ``fused_short_attention`` — their ``torch.autograd.Function``, as the JAX
  ``custom_vjp`` around the fused pair.
* ``multi_head_attention`` — what the model calls.  ``use_fused=True`` with
  no bias and N <= 1024 takes ``fused_short_attention`` on the card and on
  the CPU (the JAX dispatcher's rule; the CPU runs the plain versions, as
  the JAX package runs the Pallas pair in interpret mode).  Otherwise
  ``attention_reference`` on the CPU (torch differentiates it) and
  ``flash_attention`` on the card for every shape, with or without a bias.
  The JAX dispatcher's choice of XLA below N = 2048 was measured on a TPU
  and is not carried over; so the card refuses ``softmax_fp32=False``
  (``TPU.BF16_SOFTMAX``), which only that XLA path honours.
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


def _bias_cells(bias: torch.Tensor) -> int:
    """C of a (C, H, N, N) bias; 1 for an (H, N, N) one."""
    return 1 if bias.dim() == 3 else bias.shape[0]


def _batch_bias(bias: torch.Tensor, b: int) -> torch.Tensor:
    """The bias as the batch of ``b`` reads it: an (H, N, N) bias broadcasts
    over the batch, cell c of a (C, H, N, N) bias serves batch elements
    c B / C .. (c + 1) B / C - 1."""
    if bias.dim() == 3:
        return bias
    return bias.repeat_interleave(b // bias.shape[0], dim=0)


def _scores(
    q: torch.Tensor,
    k: torch.Tensor,
    bias: Optional[torch.Tensor],
    scale: float,
    acc: torch.dtype,
) -> torch.Tensor:
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + _batch_bias(bias, q.shape[0]).to(acc)
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

    q, k, v: (B, H, N, D).  bias: (H, Nq, Nk), (C, H, Nq, Nk) with C dividing
    B (cell c for batch elements c B / C ..), or None.
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


def _bwd_p_ds_acc(q, k, v, do, lse, delta, scale, bias=None):
    """p = exp(scale q k^T + bias - lse) and ds = p o (dO v^T - delta) in the
    accumulation dtype, unrounded."""
    acc = _acc_dtype(q)
    p = torch.exp(_scores(q, k, bias, scale, acc) - lse.to(acc).transpose(-1, -2))
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    return p, p * (dp - delta.to(acc).transpose(-1, -2))


def _bwd_p_ds(q, k, v, do, lse, delta, scale, bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """p and ds of ``_bwd_p_ds_acc``, each rounded to the operand dtype as
    the kernels round them, returned in the accumulation dtype."""
    acc = _acc_dtype(q)
    p, ds = _bwd_p_ds_acc(q, k, v, do, lse, delta, scale, bias)
    return p.to(q.dtype).to(acc), ds.to(q.dtype).to(acc)


def _row_dot(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO o O) in the accumulation dtype, (B, H, 1, N): the
    plain version of the delta that the dq kernel computes."""
    acc = _acc_dtype(o)
    return (do.to(acc) * o.to(acc)).sum(dim=-1).unsqueeze(2)


def _bwd_dq_plain(q, k, v, do, lse, o, scale, bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dq, delta)``: delta from dO and O, then dq from it."""
    delta = _row_dot(do, o)
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, scale, bias)
    return (scale * torch.matmul(ds, k.to(ds.dtype))).to(q.dtype), delta


def _bwd_dkv_plain(q, k, v, do, lse, delta, scale, bias=None) -> Tuple[torch.Tensor, torch.Tensor]:
    p, ds = _bwd_p_ds(q, k, v, do, lse, delta, scale, bias)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q.to(ds.dtype))
    dv = torch.matmul(p.transpose(-1, -2), do.to(p.dtype))
    return dk.to(q.dtype), dv.to(q.dtype)


def _bias_grad_plain(q, k, v, do, lse, scale, bias, delta=None, o=None) -> torch.Tensor:
    """The bias-gradient kernel's plain version: ds = p o (dO v^T - delta)
    unrounded in the accumulation dtype (delta = rowsum(dO o O) from ``o``
    when ``delta`` is None), summed over the batch elements of each bias
    cell; the bias's shape, in the accumulation dtype."""
    if delta is None:
        delta = _row_dot(do, o)
    _, ds = _bwd_p_ds_acc(q, k, v, do, lse, delta, scale, bias)
    return ds.unflatten(0, (_bias_cells(bias), -1)).sum(1).reshape(bias.shape)


def _flash_attention_bwd_plain(q, k, v, o, lse, do, scale, bias=None):
    """The backward kernels' plain version: ``(dq, dk, dv)`` from the saved
    lse, step by step as the kernels compute them::

        p  = exp(scale q k^T + bias - lse)      delta = rowsum(dO o O)
        dv = p^T dO                             ds = p o (dO v^T - delta)
        dq = scale ds k                         dk = scale ds^T q

    with p cast to the operand dtype before ``dv`` and ds before ``dq`` and
    ``dk``; every sum is fp32.  delta comes out of the dq step, as the dq
    kernel writes it for the dk/dv kernel."""
    dq, delta = _bwd_dq_plain(q, k, v, do, lse, o, scale, bias)
    return (dq, *_bwd_dkv_plain(q, k, v, do, lse, delta, scale, bias))


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
        b, h, n, _ = q.shape
        if tuple(bias.shape[-3:]) != (h, n, n) or bias.dim() not in (3, 4):
            raise ValueError(f"bias must be (H, N, N) = {(h, n, n)} or (C, H, N, N), got "
                             f"{tuple(bias.shape)}")
        if bias.dim() == 4 and (bias.shape[0] == 0 or b % bias.shape[0]):
            raise ValueError(f"a (C, H, N, N) bias needs C dividing the batch {b}, got C = "
                             f"{bias.shape[0]}")
        if bias.device != q.device:
            raise ValueError(f"bias is on {bias.device}, q on {q.device}")
        if bias.dtype not in (torch.float32, q.dtype):
            raise TypeError(f"bias dtype {bias.dtype} is neither float32 nor q's {q.dtype}")


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# device, operands ..., B, H, N, D, [bias cells C,] scale, is_bf16, stream
_SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "flash_attn_fwd": {
        "flash_attn_fwd": [_INT, *[_PTR] * 6, *[_INT] * 5, _FLOAT, _INT, _PTR],
    },
    "flash_attn_bwd": {
        "flash_attn_bwd_dq": [_INT, *[_PTR] * 9, *[_INT] * 5, _FLOAT, _INT, _PTR],
        "flash_attn_bwd_dkv": [_INT, *[_PTR] * 9, *[_INT] * 5, _FLOAT, _INT, _PTR],
    },
    "attn_bias_grad": {
        "attn_bias_grad": [_INT, *[_PTR] * 9, *[_INT] * 5, _FLOAT, _INT, _PTR],
    },
    "fused_short_attn": {
        "fused_short_attn_fwd": [_INT, *[_PTR] * 5, *[_INT] * 4, _FLOAT, _INT, _PTR],
        "fused_short_attn_bwd": [_INT, *[_PTR] * 9, *[_INT] * 4, _FLOAT, _INT, _PTR],
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

    q, k, v: (B, H, N, D) contiguous, bf16 or fp32; bias: (H, N, N), (C, H,
    N, N) with C dividing B (the kernel reads it in fp32), or None.
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
    bias = _kernel_bias(bias)

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
        b, h, n, d, 1 if bias is None else _bias_cells(bias), float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, "flash_attn_fwd")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def _kernel_bias(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The bias as the kernels read it: fp32, contiguous."""
    if bias is None:
        return None
    bias = bias.to(torch.float32)
    if not bias.is_contiguous():
        raise ValueError("bias must be contiguous")
    return bias


def _check_bwd_operands(q, k, v, do, named_rows, named_full=(), bias=None) -> None:
    """The operands of a backward wrapper: q, k, v and do, the (B, H, N, D)
    tensors of ``named_full`` (o), the (B, H, 1, N) rows of ``named_rows``
    (lse, delta) and the bias as the forward took it."""
    _check_operands(q, k, v, bias)
    for name, t in (("do", do), *named_full):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    b, h, n, _ = q.shape
    for name, t in named_rows:
        if tuple(t.shape) != (b, h, 1, n):
            raise ValueError(f"{name} must be (B, H, 1, N) = {(b, h, 1, n)}, got {tuple(t.shape)}")
    for name, t in (("do", do), *named_full, *named_rows):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _launch_bwd(fn_name: str, named, rows, outs, scale: float, bias=None,
                library: str = "flash_attn_bwd") -> None:
    """Checks shared by the backward wrappers, then one launch: ``named``
    the (B, H, N, D) operands in the kernel's order (None: an absent one),
    then the fp32 rows ``rows`` it reads (None: an absent one), the bias and
    the tensors ``outs`` it writes."""
    for name, t in rows:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on the card, got {t.dtype}")
    _check_kernel_operands(fn_name, [(n, t) for n, t in (*named, *rows) if t is not None])
    bias = _kernel_bias(bias)
    lib = _kernel_library(library)
    q = named[0][1]
    b, h, n, d = q.shape
    err = getattr(lib, fn_name)(
        _device_index(q),
        *(None if t is None else t.data_ptr() for _, t in (*named, *rows)),
        None if bias is None else bias.data_ptr(), *(t.data_ptr() for t in outs),
        b, h, n, d, 1 if bias is None else _bias_cells(bias), float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, fn_name)


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, o: torch.Tensor, scale: float, bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dq, delta)``: ``delta = rowsum(dO o O)`` and
    ``dq = scale * (p o (dO v^T - delta)) k`` with
    ``p = exp(scale q k^T + bias - lse)``.

    q, k, v, do, o (the forward's output): (B, H, N, D) contiguous, bf16 or
    fp32; lse (the forward's): (B, H, 1, N) fp32; bias: the forward's, or
    None.  Returns dq in q's dtype and delta (B, H, 1, N) fp32, the operand
    of ``flash_attention_bwd_dkv``.

    CUDA tensors launch ``flash_attn_bwd_dq`` of ``csrc/flash_attn_bwd.cu``
    (D = 64) on the current stream, which computes delta itself, and count
    the launch in ``flash_attention_bwd_dq.launches``; any operand the
    kernel does not take raises.  CPU tensors run the plain version and
    launch nothing.
    """
    _check_bwd_operands(q, k, v, do, (("lse", lse),), (("o", o),), bias)
    if q.device.type == "cpu":
        return _bwd_dq_plain(q, k, v, do, lse, o, float(scale), bias)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse, dtype=torch.float32)
    _launch_bwd("flash_attn_bwd_dq", (("q", q), ("k", k), ("v", v), ("do", do), ("o", o)),
                (("lse", lse),), (delta, dq), scale, bias)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, scale: float, bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dk = scale * (p o (dO v^T - delta))^T q`` and ``dv = p^T dO``.

    q, k, v, do, lse, bias as ``flash_attention_bwd_dq``; delta (B, H, 1, N)
    fp32 as it returns it.  Returns ``(dk, dv)`` in q's dtype.  CUDA tensors
    launch ``flash_attn_bwd_dkv`` and count the launch in
    ``flash_attention_bwd_dkv.launches``; CPU tensors run the plain version
    and launch nothing.
    """
    rows = (("lse", lse), ("delta", delta))
    _check_bwd_operands(q, k, v, do, rows, (), bias)
    if q.device.type == "cpu":
        return _bwd_dkv_plain(q, k, v, do, lse, delta, float(scale), bias)
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch_bwd("flash_attn_bwd_dkv", (("q", q), ("k", k), ("v", v), ("do", do)), rows,
                (dk, dv), scale, bias)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def attention_bias_grad(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, scale: float, bias: torch.Tensor,
    delta: Optional[torch.Tensor] = None, o: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The attention bias's gradient: ``dbias[c] = sum over the batch
    elements b of cell c of p_b o (dO_b v_b^T - delta_b)`` with
    ``p = exp(scale q k^T + bias - lse)``, ds unrounded and summed in fp32
    (the XLA VJP of the JAX package's bias path sums the fp32 ds over the
    batch likewise).

    q, k, v, do: (B, H, N, D) contiguous, bf16 or fp32; lse: (B, H, 1, N)
    fp32; bias: the forward's, (H, N, N) or (C, H, N, N); delta: (B, H, 1, N)
    fp32 as ``flash_attention_bwd_dq`` returns it, or None, and then ``o``
    (the forward's output), from which the kernel computes delta itself.
    Returns dbias in the bias's shape, fp32 (the plain version: the
    accumulation dtype of q).

    CUDA tensors launch ``attn_bias_grad`` of ``csrc/attn_bias_grad.cu``
    (D = 64) on the current stream and count the launch in
    ``attention_bias_grad.launches``; any operand the kernel does not take
    raises.  CPU tensors run the plain version and launch nothing."""
    if (delta is None) == (o is None):
        raise ValueError("give the bias gradient delta or o, one of the two")
    rows = (("lse", lse),) + ((("delta", delta),) if delta is not None else ())
    _check_bwd_operands(q, k, v, do, rows, (("o", o),) if o is not None else (), bias)
    if q.device.type == "cpu":
        return _bias_grad_plain(q, k, v, do, lse, float(scale), bias, delta, o)
    dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    # the kernel's order: q, k, v, dO, o, lse, delta, bias, dbias
    _launch_bwd("attn_bias_grad", (("q", q), ("k", k), ("v", v), ("do", do), ("o", o)),
                (("lse", lse), ("delta", delta)), (dbias,), scale, bias,
                library="attn_bias_grad")
    attention_bias_grad.launches += 1
    return dbias


attention_bias_grad.launches = 0


def _needs_grad(*operands: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands)


def _fold_cells(cells: int, in_dims, operands):
    """The operands of a batching rule with the cell axis folded into the
    batch: (cells, B, ...) -> (cells * B, ...), contiguous.  An operand that
    is not batched is expanded to every cell first."""
    out = []
    for t, dim in zip(operands, in_dims):
        t = t.expand(cells, *t.shape) if dim is None else t.movedim(dim, 0)
        out.append(t.reshape(cells * t.shape[1], *t.shape[2:]).contiguous())
    return out


def _unfold_cells(cells: int, outputs):
    """The outputs of a folded launch with the cell axis taken out again:
    ``(outputs, out_dims)`` as a batching rule returns them."""
    outs = tuple(None if t is None else t.unflatten(0, (cells, -1)) for t in outputs)
    return outs, tuple(None if t is None else 0 for t in outs)


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, with its lse when a gradient is asked for
    (``with_lse``); backward through the dq and dk/dv kernels where q, k or v
    needs a gradient and through the bias-gradient kernel where the bias
    does (``ctx.needs_input_grad``: nothing launches for the other), as the
    JAX ``custom_vjp``s of the flash path and, with a bias, of the XLA path.
    Under ``torch.func.vmap`` the batching rule folds the vmapped axis (a
    sweep round's cells) into the batch, and a batched bias into the bias's
    cells, and launches the same kernels once, so autograd and the backward
    see the folded tensors."""

    @staticmethod
    def forward(q, k, v, bias, scale, with_lse):
        if with_lse:
            return flash_attention_fwd(q, k, v, bias, scale, return_lse=True)
        return flash_attention_fwd(q, k, v, bias, scale), None

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias, scale, with_lse = inputs
        out, lse = output
        if with_lse:
            ctx.mark_non_differentiable(lse)
            ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.set_materialize_grads(False)  # lse's cotangent stays None: no zeros launched
        ctx.scale = scale

    @staticmethod
    def backward(ctx, do, _dlse):
        if do is None:  # no cotangent (grads are not materialized)
            return None, None, None, None, None, None
        q, k, v, out, lse, bias = ctx.saved_tensors
        do = do.contiguous()  # arrives as the transposed view of the head merge
        b32 = None if bias is None else bias.to(torch.float32).contiguous()
        dq = dk = dv = dbias = delta = None
        if any(ctx.needs_input_grad[:3]):
            dq, delta = flash_attention_bwd_dq(q, k, v, do, lse, out, ctx.scale, b32)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.scale, b32)
        if ctx.needs_input_grad[3]:
            # delta from the dq kernel where it ran, else the kernel computes it from o;
            # the cotangent in the bias's dtype, as the JAX VJP returns it
            dbias = attention_bias_grad(q, k, v, do, lse, ctx.scale, b32, delta,
                                        None if delta is not None else out).to(bias.dtype)
        return dq, dk, dv, dbias, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, bias, scale, with_lse):
        cells = info.batch_size
        # under the vmap the caller cannot see whether its operands need a
        # gradient; the unwrapped tensors tell
        with_lse = with_lse or _needs_grad(q, k, v, bias)
        q, k, v = _fold_cells(cells, in_dims[:3], (q, k, v))
        if bias is not None and in_dims[3] is not None:
            # (cells, [C,] H, N, N) -> (cells C, H, N, N): cell i's rows of the
            # folded batch read its own bias
            bias = bias.movedim(in_dims[3], 0)
            bias = bias.reshape(-1, *bias.shape[-3:]).contiguous()
        return _unfold_cells(cells, _FlashAttention.apply(q, k, v, bias, scale, with_lse))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable flash attention, ``softmax(scale * q k^T + bias) v``.

    bias: (H, N, N) or (C, H, N, N) with C dividing B, in fp32 or q's dtype,
    or None.  With a gradient required of q, k, v or the bias the forward
    saves ``(q, k, v, o, lse, bias)``; the backward launches the dq and
    dk/dv kernels when q, k or v requires one and the bias-gradient kernel
    when the bias does, its result in the bias's dtype.  Without one it is
    ``flash_attention_fwd`` and saves nothing.  Under ``torch.func.vmap`` (a
    sweep round's cells) every kernel launches once for all cells, the
    vmapped axis folded into the batch and a batched bias into its cells.
    CPU tensors run the kernels' plain versions, forward and backward.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bias, float(scale), _needs_grad(q, k, v, bias))[0]


# ---------------------------------------------------------------------------
# Fused short-sequence attention (the Pallas ``_short_fwd_kernel`` and
# ``_short_bwd_kernel``)

FUSED_MAX_SEQ = 1024  # the JAX dispatcher's bound for the fused pair


def _fused_short_fwd_plain(q, k, v, scale: float, return_lse: bool):
    """The forward kernel's plain version, step by step as the Pallas kernel::

        s = scale q k^T (fp32)   m = max s   p = exp(s - m)   l = sum p
        o = ((p / l) -> v's dtype) v, summed in fp32     lse = m + log l

    The probabilities are normalised before they are rounded (the flash
    forward rounds the unnormalised p and divides at the end)."""
    acc = _acc_dtype(q)
    s = _scores(q, k, None, scale, acc)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul((p / l).to(v.dtype).to(acc), v.to(acc)).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).transpose(-1, -2)


def _fused_short_bwd_plain(q, k, v, o, lse, do, scale: float):
    """The backward kernel's plain version: ``(dq, dk, dv)`` step by step as
    the Pallas kernel::

        p  = exp(scale q k^T - lse)     dv = (p -> dtype)^T dO
        dp = dO v^T                     delta = rowsum(dO o O)
        ds = (scale p (dp - delta)) -> dtype
        dq = ds k                       dk = ds^T q

    every sum fp32, every gradient in the operand dtype.  The scale is folded
    into ds before it is rounded (the flash backward scales after the
    product)."""
    acc = _acc_dtype(q)
    p = torch.exp(_scores(q, k, None, scale, acc) - lse.to(acc).transpose(-1, -2))
    dv = torch.matmul(p.to(do.dtype).to(acc).transpose(-1, -2), do.to(acc))
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    delta = (do.to(acc) * o.to(acc)).sum(dim=-1, keepdim=True)
    ds = (scale * p * (dp - delta)).to(k.dtype).to(acc)
    dq = torch.matmul(ds, k.to(acc))
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def fused_short_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Fused short-sequence attention forward: ``softmax(scale * q k^T) v``
    with the probabilities normalised before they are rounded.

    q, k, v: (B, H, N, D) contiguous, bf16 or fp32.  Returns o (B, H, N, D)
    in q's dtype and, with ``return_lse``, the fp32 log-sum-exp (B, H, 1, N).

    CUDA tensors launch ``fused_short_attn_fwd`` of
    ``csrc/fused_short_attn.cu`` (D = 64) on the current stream and count the
    launch in ``fused_short_attention_fwd.launches``; any operand the kernel
    does not take raises.  CPU tensors run the plain version and launch
    nothing.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    _check_operands(q, k, v, None)
    if q.device.type == "cpu":
        return _fused_short_fwd_plain(q, k, v, float(scale), return_lse)
    _check_kernel_operands("fused_short_attention_fwd", (("q", q), ("k", k), ("v", v)))
    b, h, n, d = q.shape
    lib = _kernel_library("fused_short_attn")
    out = torch.empty_like(q)
    lse = (
        torch.empty((b, h, 1, n), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    err = lib.fused_short_attn_fwd(
        _device_index(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, n, d, float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, "fused_short_attn_fwd")
    fused_short_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


fused_short_attention_fwd.launches = 0


def fused_short_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of the fused short-sequence attention from the
    forward's o and lse and the cotangent dO; delta = rowsum(dO o O) is
    computed inside the kernel.

    q, k, v, o, do: (B, H, N, D) contiguous, bf16 or fp32; lse: (B, H, 1, N)
    fp32.  CUDA tensors launch ``fused_short_attn_bwd`` (one launch, D = 64)
    and count it in ``fused_short_attention_bwd.launches``; any operand the
    kernel does not take raises.  CPU tensors run the plain version.
    """
    _check_bwd_operands(q, k, v, do, (("lse", lse),), (("o", o),))
    if q.device.type == "cpu":
        return _fused_short_bwd_plain(q, k, v, o, lse, do, float(scale))
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32 on the card, got {lse.dtype}")
    _check_kernel_operands(
        "fused_short_attention_bwd",
        (("q", q), ("k", k), ("v", v), ("o", o), ("do", do), ("lse", lse)))
    lib = _kernel_library("fused_short_attn")
    b, h, n, _ = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    err = lib.fused_short_attn_bwd(
        _device_index(q),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, n, q.shape[-1], float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, lib, "fused_short_attn_bwd")
    fused_short_attention_bwd.launches += 1
    return dq, dk, dv


fused_short_attention_bwd.launches = 0


class _FusedShortAttention(torch.autograd.Function):
    """The fused forward, with its o and lse saved when a gradient is asked
    for; the backward is one launch of the fused backward (the JAX
    ``custom_vjp`` of ``_attention_fused_short``).  Under ``torch.func.vmap``
    the vmapped axis is folded into the batch, as for ``_FlashAttention``."""

    @staticmethod
    def forward(q, k, v, scale, with_lse):
        if with_lse:
            return fused_short_attention_fwd(q, k, v, scale, return_lse=True)
        return fused_short_attention_fwd(q, k, v, scale), None

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, with_lse = inputs
        out, lse = output
        if with_lse:
            ctx.mark_non_differentiable(lse)
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.set_materialize_grads(False)  # as in _FlashAttention
        ctx.scale = scale

    @staticmethod
    def backward(ctx, do, _dlse):
        if do is None:  # as in _FlashAttention
            return None, None, None, None, None
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()  # arrives as the transposed view of the head merge
        return (*fused_short_attention_bwd(q, k, v, out, lse, do, ctx.scale), None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale, with_lse):
        with_lse = with_lse or _needs_grad(q, k, v)  # as in _FlashAttention.vmap
        q, k, v = _fold_cells(info.batch_size, in_dims[:3], (q, k, v))
        return _unfold_cells(info.batch_size,
                             _FusedShortAttention.apply(q, k, v, scale, with_lse))


def fused_short_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable fused short-sequence attention (no bias).

    With a gradient required of q, k or v the forward saves
    ``(q, k, v, o, lse)`` and the backward launches the fused backward once;
    without one only the forward kernel runs.  CPU tensors run the kernels'
    plain versions, forward and backward.  Under ``torch.func.vmap`` each
    kernel launches once for all cells, as ``flash_attention``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FusedShortAttention.apply(q, k, v, float(scale), _needs_grad(q, k, v))[0]


def takes_fused(use_fused: Optional[bool], bias: Optional[torch.Tensor], n: int) -> bool:
    """The JAX dispatcher's rule for the fused pair: asked for (``None`` is
    off), no bias, and N <= 1024."""
    return bool(use_fused) and bias is None and n <= FUSED_MAX_SEQ


def check_softmax_fp32(device_type: str, softmax_fp32: bool) -> None:
    """The card's attention kernels keep the softmax in fp32; a bf16 softmax
    (``TPU.BF16_SOFTMAX``, ``softmax_fp32=False``) exists only on the JAX
    package's XLA path, so the card refuses it rather than compute other
    numbers.  The CPU honours the flag."""
    if device_type == "cuda" and not softmax_fp32:
        raise NotImplementedError(
            "softmax_fp32=False (TPU.BF16_SOFTMAX) is not supported on the card: the "
            "attention kernels keep an fp32 softmax; unset TPU.BF16_SOFTMAX"
        )


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softmax_fp32: bool = True,
    batch_chunk: int = 0,
    use_fused: Optional[bool] = None,
) -> torch.Tensor:
    """Attention over (B, H, N, D) operands with an optional (H, N, N) bias.

    ``use_fused`` with no bias and N <= 1024 goes to ``fused_short_attention``
    (the kernels on the card, their plain versions on the CPU; the softmax is
    fp32 there whatever ``softmax_fp32`` says, as in the JAX package).
    Otherwise CUDA tensors go to ``flash_attention``, forward and backward,
    and ``softmax_fp32=False`` raises (``check_softmax_fp32``); CPU tensors
    take ``attention_reference``, which torch differentiates, and
    ``batch_chunk > 0`` computes it in batch slices of that size, as the JAX
    package does when there is no bias and the batch divides evenly.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if takes_fused(use_fused, bias, q.shape[-2]):
        return fused_short_attention(q, k, v, scale)
    check_softmax_fp32(q.device.type, softmax_fp32)
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
