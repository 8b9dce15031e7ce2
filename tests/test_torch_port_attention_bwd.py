"""The port's flash-attention backward (peft_vit_tpu_torch.ops.attention)
against the JAX package, fp32 on the CPU, same inputs from a numpy seed:

* ``_flash_attention_bwd_plain``, the plain version of the two CUDA backward
  kernels, against the Pallas backward kernels run in interpret mode and
  against ``jax.vjp`` of ``attention_reference``;
* the wrappers' interface, ``flash_attention_bwd_dq(q, k, v, do, lse, o,
  scale) -> (dq, delta)`` and ``flash_attention_bwd_dkv(q, k, v, do, lse,
  delta, scale) -> (dk, dv)``, against the Pallas kernels, and its delta
  against the XLA rowsum the JAX wrapper computes before them;
* the ``flash_attention`` autograd Function against ``jax.grad`` through the
  JAX flash path, and ``torch.autograd.gradcheck`` in fp64;
* the wrappers' guards.

Tolerance atol = rtol = 1e-5 against the Pallas kernels (the same arithmetic
from the same lse; XLA, the Pallas interpreter and torch sum in other
orders), 5e-5 against the reference's VJP (a different formula: it
differentiates the softmax instead of recomputing p from the lse).  Over
the six cases of the first test the largest |diff| / (atol + rtol |ref|) is
0.09, at 1 and at 6 torch threads."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peft_vit_tpu.ops.attention import _flash_attention_bwd, _flash_attention_fwd
from peft_vit_tpu.ops.attention import attention_reference as jax_reference
from peft_vit_tpu.ops.attention import multi_head_attention as jax_mha
from peft_vit_tpu_torch.ops import attention as port
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_VJP = dict(atol=5e-5, rtol=5e-5)
B, H, D = 2, 3, 64


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal((B, H, n, D)).astype(np.float32) for _ in range(4))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.mark.parametrize("scale", [None, 1.0])
@pytest.mark.parametrize("n", [197, 50, 33])
def test_plain_backward_matches_pallas_kernels_and_reference_vjp(n, scale):
    q, k, v, do = _inputs(n, seed=n)
    if scale == 1.0:
        q = q * np.float32(D**-0.5)  # the post-scaled q of the flagship's path
    s = D**-0.5 if scale is None else scale
    jq, jk, jv, jdo = _j(q, k, v, do)
    o, lse = _flash_attention_fwd(jq, jk, jv, None, s, block_q=128, block_k=128,
                                  interpret=True, return_lse=True)
    want = _flash_attention_bwd(jq, jk, jv, o, lse, jdo, s, 128, 128, True)
    _, vjp = jax.vjp(lambda a, b, c: jax_reference(a, b, c, None, s), jq, jk, jv)
    want_vjp = vjp(jdo)

    tq, tk, tv, tdo = _t(q, k, v, do)
    got = port._flash_attention_bwd_plain(
        tq, tk, tv, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse)), tdo, s)
    for name, g, w, w2 in zip(("dq", "dk", "dv"), got, want, want_vjp):
        assert g.shape == (B, H, n, D) and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w2), err_msg=name, **TOL_VJP)


def test_wrappers_on_cpu_run_the_plain_version_from_the_ports_own_lse():
    q, k, v, do = _t(*_inputs(50, seed=1))
    s = 0.2
    o, lse = port.flash_attention_fwd(q, k, v, None, s, return_lse=True)
    dq, delta = port.flash_attention_bwd_dq(q, k, v, do, lse, o, s)
    dk, dv = port.flash_attention_bwd_dkv(q, k, v, do, lse, delta, s)
    want = port._flash_attention_bwd_plain(q, k, v, o, lse, do, s)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.testing.assert_close(delta, port._row_dot(do, o), rtol=0, atol=0)
    assert delta.shape == (B, H, 1, 50) and delta.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [197, 33])
def test_plain_dq_delta_matches_the_xla_rowsum_of_the_jax_wrapper(n, dtype):
    """The delta that the dq kernel now computes is the one the JAX wrapper
    computes in XLA before its kernels: ``sum(g.astype(f32) * out.astype(f32),
    -1)[:, :, None, :]``; both are fp32 sums of the same products."""
    q, k, v, do = _inputs(n, seed=20 + n)
    o = _inputs(n, seed=40 + n)[0]
    jdt = getattr(jnp, dtype)
    g, out = jnp.asarray(do).astype(jdt), jnp.asarray(o).astype(jdt)
    want = jnp.sum(g.astype(jnp.float32) * out.astype(jnp.float32), axis=-1)[:, :, None, :]
    tdt = getattr(torch, dtype)
    tq, tk, tv, tdo, to = (t.to(tdt) for t in _t(q, k, v, do, o))
    lse = torch.zeros(B, H, 1, n)
    _, delta = port.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, to, D**-0.5)
    assert delta.shape == (B, H, 1, n) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("scale", [None, 1.0])
@pytest.mark.parametrize("n", [197, 50])
def test_wrappers_match_the_pallas_kernels(n, scale):
    """dq, dk and dv through the two wrappers, delta handed from the first
    to the second, against the Pallas backward kernels in interpret mode fed
    the same o and lse."""
    q, k, v, do = _inputs(n, seed=60 + n)
    if scale == 1.0:
        q = q * np.float32(D**-0.5)
    s = D**-0.5 if scale is None else scale
    jq, jk, jv, jdo = _j(q, k, v, do)
    o, lse = _flash_attention_fwd(jq, jk, jv, None, s, block_q=128, block_k=128,
                                  interpret=True, return_lse=True)
    want = _flash_attention_bwd(jq, jk, jv, o, lse, jdo, s, 128, 128, True)
    tq, tk, tv, tdo = _t(q, k, v, do)
    to, tlse = torch.from_numpy(np.array(o)), torch.from_numpy(np.array(lse))
    dq, delta = port.flash_attention_bwd_dq(tq, tk, tv, tdo, tlse, to, s)
    dk, dv = port.flash_attention_bwd_dkv(tq, tk, tv, tdo, tlse, delta, s)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.shape == (B, H, n, D) and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_plain_backward_rounds_p_and_ds_to_bf16_operands():
    """bf16 operands: p and ds are rounded to bf16 before their products and
    the sums are fp32, so the result equals the fp32 formula fed the rounded
    p and ds, exactly."""
    q, k, v, do = (t.to(torch.bfloat16) for t in _t(*_inputs(33, seed=2)))
    s = D**-0.5
    o, lse = port.flash_attention_fwd(q, k, v, None, s, return_lse=True)
    dq, dk, dv = port._flash_attention_bwd_plain(q, k, v, o, lse, do, s)
    f = lambda t: t.float()
    p = torch.exp(s * f(q) @ f(k).transpose(-1, -2) - lse.transpose(-1, -2))
    delta = (f(do) * f(o)).sum(-1, keepdim=True)
    ds = (p * (f(do) @ f(v).transpose(-1, -2) - delta)).to(torch.bfloat16).float()
    p = p.to(torch.bfloat16).float()
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    torch.testing.assert_close(dq, (s * ds @ f(k)).to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(dk, (s * ds.transpose(-1, -2) @ f(q)).to(torch.bfloat16),
                               rtol=0, atol=0)
    torch.testing.assert_close(dv, (p.transpose(-1, -2) @ f(do)).to(torch.bfloat16),
                               rtol=0, atol=0)


@pytest.mark.parametrize("scale", [None, 1.0])
def test_function_gradients_match_jax_grad_through_the_flash_path(scale):
    """A non-trivial cotangent: the loss is sum(out * w) for a random w."""
    n = 50
    q, k, v, w = _inputs(n, seed=7)
    if scale == 1.0:
        q = q * np.float32(D**-0.5)
    jw = jnp.asarray(w)
    want = jax.grad(
        lambda a, b, c: jnp.sum(jax_mha(a, b, c, scale=scale, use_flash=True,
                                        interpret=True) * jw),
        argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = port.flash_attention(tq, tk, tv, None, scale)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(w))
    for name, g, x in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), err_msg=name, **TOL)
    assert port.flash_attention_fwd.launches == 0
    assert port.flash_attention_bwd_dq.launches == 0
    assert port.flash_attention_bwd_dkv.launches == 0


def test_function_takes_a_transposed_cotangent():
    """The gradient that reaches the Function in the model is the transposed
    view of the head merge; the backward makes it contiguous."""
    q, k, v, w = _t(*_inputs(33, seed=8))
    q.requires_grad_()
    out = port.flash_attention(q, k, v)
    merged = out.transpose(1, 2).reshape(B, 33, H * D)
    (got,) = torch.autograd.grad(merged, q, w.transpose(1, 2).reshape(B, 33, H * D))
    (want,) = torch.autograd.grad(port.attention_reference(q, k, v), q, w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_function_gradcheck_fp64():
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 5, 4))).requires_grad_()
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: port.flash_attention(a, b, c, None, 0.7), (q, k, v))


def test_function_without_a_gradient_saves_nothing():
    q, k, v, _ = _t(*_inputs(33, seed=10))
    out = port.flash_attention(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        out = port.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None
    torch.testing.assert_close(out, port.attention_reference(q, k, v), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("who", ["q", "bias"])
def test_bias_with_a_gradient_raises(who):
    """A bias with a gradient runs the bias path (dq, dk, dv with the bias and
    the bias's own gradient: ``test_torch_port_rpb.py`` holds them against
    the JAX package); what raises is a bias the kernels do not take, a
    (C, H, N, N) one whose C does not divide the batch, whichever operand
    needs the gradient."""
    q, k, v, _ = _t(*_inputs(33, seed=11))
    bias = torch.zeros(3, H, 33, 33)  # B = 2
    (q if who == "q" else bias).requires_grad_()
    with pytest.raises(ValueError, match="C dividing the batch"):
        port.flash_attention(q, k, v, bias)
    # an (H, N, N) bias with a gradient runs, forward and backward
    shared = torch.zeros(H, 33, 33, requires_grad=who == "bias")
    out = port.flash_attention(q, k, v, shared)
    wrt = [t for t in (q, shared) if t.requires_grad]
    assert all(bool(torch.isfinite(g).all()) for g in torch.autograd.grad(out.sum(), wrt))
    # forward-only: fine without a gradient
    assert port.flash_attention(q.detach(), k, v, shared.detach()).shape == q.shape


def test_multi_head_attention_on_the_cpu_keeps_the_reference():
    q, k, v, w = _t(*_inputs(33, seed=12))
    q.requires_grad_()
    out = port.multi_head_attention(q, k, v)
    assert "FlashAttention" not in type(out.grad_fn).__name__
    torch.autograd.grad(out, q, w)


@pytest.mark.parametrize("wrapper", ["dq", "dkv"])
@pytest.mark.parametrize(
    "bad,match",
    [("head_dim", "head dim"), ("fp16", "bfloat16 or float32"),
     ("non_contiguous", "contiguous"), ("do_shape", "do shape"),
     ("lse_shape", r"lse must be \(B, H, 1, N\)"), ("do_dtype", "do dtype"),
     ("lse_dtype", "float32 on the card")],
)
def test_backward_wrappers_reject_what_the_kernels_do_not_take(wrapper, bad, match):
    """On the ``meta`` device, where a tensor reaches the kernel's checks as
    a CUDA tensor would: each bad operand is named before the device is.
    The dq wrapper takes o where the dk/dv wrapper takes delta."""
    n, d = 8, 64
    dev = "meta"
    if bad == "head_dim":
        d = 48  # the kernels take head dims 32 and 64
    dtype = torch.float16 if bad == "fp16" else torch.float32
    q, k, v, do, o = (torch.zeros(1, 2, n, d, dtype=dtype, device=dev) for _ in range(5))
    lse, delta = (torch.zeros(1, 2, 1, n, device=dev) for _ in range(2))
    if bad == "non_contiguous":
        k = torch.zeros(1, 2, d, n, device=dev).transpose(-1, -2)
    elif bad == "do_shape":
        do = torch.zeros(1, 2, n + 1, d, device=dev)
    elif bad == "lse_shape":
        lse = torch.zeros(1, 2, n, device=dev)
    elif bad == "do_dtype":
        do = do.to(torch.bfloat16)
    elif bad == "lse_dtype":
        lse = lse.to(torch.bfloat16)
    if wrapper == "dq":
        fn, last = port.flash_attention_bwd_dq, o
    else:
        fn, last = port.flash_attention_bwd_dkv, delta
    with pytest.raises((ValueError, TypeError), match=match):
        fn(q, k, v, do, lse, last, 1.0)
    # good operands get as far as the device check, and no further
    good = [torch.zeros(1, 2, n, 64, device=dev) for _ in range(4)]
    stats = torch.zeros(1, 2, 1, n, device=dev)
    last = torch.zeros(1, 2, n, 64, device=dev) if wrapper == "dq" else stats
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fn(*good, stats, last, 1.0)


@pytest.mark.parametrize(
    "bad,match",
    [("shape", "o shape"), ("dtype", "o dtype"), ("device", "o is on"),
     ("non_contiguous", "o must be contiguous")],
)
def test_dq_wrapper_rejects_an_o_the_kernel_does_not_take(bad, match):
    """o, which the dq kernel reads for delta, is checked as q is: shape,
    dtype, device, and (on the way to the kernel) contiguity."""
    n, dev = 8, "meta"
    q, k, v, do = (torch.zeros(1, 2, n, 64, device=dev) for _ in range(4))
    lse = torch.zeros(1, 2, 1, n, device=dev)
    o = {"shape": lambda: torch.zeros(1, 2, n, 32, device=dev),
         "dtype": lambda: torch.zeros(1, 2, n, 64, dtype=torch.bfloat16, device=dev),
         "device": lambda: torch.zeros(1, 2, n, 64),
         "non_contiguous": lambda: torch.zeros(1, 2, 64, n, device=dev).transpose(-1, -2)}[bad]()
    with pytest.raises((ValueError, TypeError), match=match):
        port.flash_attention_bwd_dq(q, k, v, do, lse, o, 1.0)
