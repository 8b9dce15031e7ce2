"""The port's int8 ops (``peft_vit_tpu_torch.ops.int8``) against the JAX
package's (``peft_vit_tpu.ops.int8``) on the CPU, from the same numpy inputs.

The quantizers and the plain forwards repeat the JAX arithmetic step by step
(IEEE division, round half to even, an exact integer sum, two multiplies in
the same order), so codes, scales and outputs are held to EQUALITY, in fp32
and in bf16.  Gradients are dense matmuls summed in another order by XLA and
torch: 1e-5 in fp32.  A weight is (K, N) in the JAX package and (N, K) in the
port, so every weight crosses transposed.  On the CPU the port's kernel
wrappers run the kernel's plain version and launch nothing."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peft_vit_tpu.ops import int8 as jint8
from peft_vit_tpu_torch.ops import int8 as pint8

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 dense products, another summation order
DTYPES = [("float32", jnp.float32, torch.float32), ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _np(t):
    return t.detach().to(torch.float32).numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


def _activation(seed, shape=(3, 13, 64)):
    """Random rows plus the corner cases: an all-zero row, an outlier row, and
    a row whose values sit exactly on .5 steps of its scale (absmax 127 gives
    scale 1)."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 1] = 0.0
    x[1, 2] *= 100.0
    k = shape[-1]
    x[-1, 3] = ((np.arange(k) % 255) - 127) / 2.0
    x[-1, 3, 0] = 127.0
    return x


def _weight(seed, k=64, n=48):
    """A JAX-layout (K, N) weight with one all-zero output channel."""
    w = np.random.RandomState(seed).standard_normal((k, n)).astype(np.float32) * 0.1
    w[:, 5] = 0.0
    return w


def _both(x, jdt, tdt):
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


# ---------------------------------------------------------------- quantizers


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_quantize_rows_codes_and_scales_equal_jax(name, jdt, tdt):
    jx, tx = _both(_activation(0), jdt, tdt)
    want_q, want_s = jint8.quantize_rows(jx)
    got_q, got_s = pint8.quantize_rows(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert (got_q[0, 1] == 0).all() and got_s[0, 1].item() == np.float32(1e-8)
    if tdt == torch.float32:  # the .5 row rounds half to even
        halves = _activation(0)[2, 3]
        np.testing.assert_array_equal(got_q[2, 3].numpy(), np.round(halves).astype(np.int8))
        assert 0.5 in np.abs(halves - np.trunc(halves))


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_quantize_cols_codes_and_scales_equal_jax(name, jdt, tdt):
    """JAX: per-column scales of the (K, N) kernel; the port: per-row scales of
    the (N, K) weight, the codes (N, K) with K contiguous."""
    w = _weight(1)
    want_q, want_s = jint8.quantize_cols(jnp.asarray(w, jdt))
    got_q, got_s = pint8.quantize_cols(torch.from_numpy(w.T.copy()).to(tdt))
    assert got_q.shape == (48, 64) and got_q.is_contiguous() and got_s.shape == (48,)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q).T)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s).reshape(-1))
    # the transposed pair of the dx product: contiguous along N
    want_qt, want_st = jint8.quantize_cols(jnp.asarray(w, jdt).T)
    got_qt, got_st = pint8.quantize_cols(torch.from_numpy(w.T.copy()).to(tdt).t())
    assert got_qt.shape == (64, 48) and got_qt.is_contiguous()
    np.testing.assert_array_equal(got_qt.numpy(), np.asarray(want_qt).T)
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st).reshape(-1))


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_quantize_static_codes_equal_jax_and_saturate(name, jdt, tdt):
    x = _activation(2)
    jx, tx = _both(x, jdt, tdt)
    for divisor in (1.0, 8.0):  # calibrated; too small a scale: most codes saturate
        s = np.float32(np.abs(x[0]).max() / 127.0 / divisor)
        want = jint8.quantize_static(jx, jnp.float32(s))
        got = pint8.quantize_static(tx, torch.tensor(s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.abs().max() == 127
    assert (got[1, 2].abs() == 127).float().mean() > 0.9  # the outlier row clips


# ---------------------------------------------------------------- forwards


def _check_forwards_equal_jax(x, w, jdt, tdt):
    """``int8_matmul``, ``_prequant_forward`` and ``_static_forward`` (at a
    scale that leaves headroom and one that saturates) equal JAX's."""
    jx, tx = _both(x, jdt, tdt)
    jw, tw = jnp.asarray(w, jdt), torch.from_numpy(w.T.copy()).to(tdt)
    got = pint8.int8_matmul(tx, tw)
    assert got.dtype == tdt and got.shape == (*x.shape[:-1], w.shape[1])
    assert not got.requires_grad
    np.testing.assert_array_equal(_np(got), _np(jint8.int8_matmul(jx, jw)))

    jq, js = jint8.quantize_cols(jw)
    tq, ts = pint8.quantize_cols(tw)
    np.testing.assert_array_equal(_np(pint8._prequant_forward(tx, tq, ts)),
                                  _np(jint8._prequant_forward(jx, jq, js)))
    for divisor in (1.0, 8.0):
        s = np.float32(np.abs(x[0]).max() * 1.5 / 127.0 / divisor)
        np.testing.assert_array_equal(
            _np(pint8._static_forward(tx, tq, ts, torch.tensor(s))),
            _np(jint8._static_forward(jx, jq, js, jnp.float32(s))))
    assert (pint8._prequant_forward(tx, tq, ts)[0, 1] == 0).all()  # the zero row


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_int8_matmul_and_plain_forwards_equal_jax(name, jdt, tdt):
    _check_forwards_equal_jax(_activation(3), _weight(4), jdt, tdt)


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("k", [192, 3072])
def test_plain_forwards_equal_jax_at_the_kernels_k_edges(k, name, jdt, tdt):
    """The plain forwards the card holds K6 to, against JAX at the K the
    kernel treats specially: a half-filled last 128-byte code slab (192) and
    the largest code tile (3072), at a small M."""
    _check_forwards_equal_jax(_activation(11 + k, (2, 5, k)), _weight(12 + k, k, 64), jdt, tdt)


def test_plain_forward_matches_the_pallas_kernel_in_interpret_mode():
    """The Pallas kernel itself (``use_pallas=True``), run on the CPU in TPU
    interpret mode at an M that is no multiple of 8.  The interpreter's dot
    and XLA's agree to 2.4e-7 of values of order 1 (one fp32 rounding of the
    rescale); held at 1e-6."""
    from jax.experimental.pallas import tpu as pltpu

    x = np.random.RandomState(5).standard_normal((2, 13, 64)).astype(np.float32)
    w = _weight(6, 64, 256)
    jq, js = jint8.quantize_cols(jnp.asarray(w))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jint8._prequant_forward(jnp.asarray(x), jq, js, use_pallas=True))
    tq, ts = pint8.quantize_cols(torch.from_numpy(w.T.copy()))
    got = pint8._prequant_forward(torch.from_numpy(x), tq, ts).numpy()
    assert got.shape == want.shape == (2, 13, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_wrappers_run_the_plain_version_on_the_cpu_and_launch_nothing():
    x, w = torch.from_numpy(_activation(7)), torch.from_numpy(_weight(8).T.copy())
    q, s = pint8.quantize_cols(w)
    before = pint8.int8_gemm_dynamic.launches, pint8.int8_gemm_static.launches
    assert torch.equal(pint8.int8_gemm_dynamic(x, q, s), pint8._prequant_forward(x, q, s))
    s_x = torch.tensor(0.05)
    assert torch.equal(pint8.int8_gemm_static(x, q, s, s_x), pint8._static_forward(x, q, s, s_x))
    assert (pint8.int8_gemm_dynamic.launches, pint8.int8_gemm_static.launches) == before
    with pytest.raises(ValueError, match="do not agree"):
        pint8.int8_gemm_dynamic(x[..., :32], q, s)
    with pytest.raises(TypeError, match="int8"):
        pint8.int8_gemm_dynamic(x, q.float(), s)
    with pytest.raises(ValueError, match="one scale"):
        pint8.int8_gemm_static(x, q, s, torch.ones(2))


@pytest.mark.parametrize("variant", ["no_products", "no_quantize"])
def test_split_bench_patches_name_the_kernels_source(variant):
    """``bench_int8_split.py`` times builds of ``csrc/int8_gemm.cu`` with its
    products or its quantize cut out by text patches: each patched line is in
    the source exactly once, so the split times the kernel as it stands."""
    import bench_int8_split
    from peft_vit_tpu_torch.ops import _build

    source = (_build.CSRC_DIR / "int8_gemm.cu").read_text()
    for old, new in bench_int8_split.VARIANTS[variant]:
        assert source.count(old) == 1 and old != new


def test_the_kernel_takes_a_cuda_tensor_or_raises():
    """No fallback: what is not a CUDA tensor of a shape and type the kernel
    takes raises before any launch."""
    x = torch.zeros(4, 64)
    q, s = torch.zeros(64, 64, dtype=torch.int8), torch.ones(64)
    with pytest.raises(ValueError, match="CUDA"):
        pint8._launch(x, q, s, None)


# ---------------------------------------------------------------- gradients

OPS = ["bf16_bwd", "prequant", "prequant_i8bwd", "static", "static_i8bwd"]


def _run_jax(op, x, w, g, s_x):
    w_i8, s_w = jint8.quantize_cols(w)
    wt_i8, s_wt = jint8.quantize_cols(w.T)
    fn = {
        "bf16_bwd": lambda x, w: jint8.int8_matmul_bf16_bwd(x, w),
        "prequant": lambda x, w: jint8.int8_prequant_matmul(x, w, w_i8, s_w),
        "prequant_i8bwd": lambda x, w: jint8.int8_prequant_matmul_i8bwd(
            x, w, w_i8, s_w, wt_i8, s_wt),
        "static": lambda x, w: jint8.int8_static_matmul(x, w, w_i8, s_w, s_x),
        "static_i8bwd": lambda x, w: jint8.int8_static_matmul_i8bwd(
            x, w, w_i8, s_w, wt_i8, s_wt, s_x),
    }[op]
    y, vjp = jax.vjp(fn, x, w)
    return (y, *vjp(g))


def _run_port(op, x, w, g, s_x, w_requires_grad=True):
    x = x.clone().requires_grad_()
    w = w.clone().requires_grad_(w_requires_grad)
    with torch.no_grad():
        w_i8, s_w = pint8.quantize_cols(w)
        wt_i8, s_wt = pint8.quantize_cols(w.t())
    y = {
        "bf16_bwd": lambda: pint8.int8_matmul_bf16_bwd(x, w),
        "prequant": lambda: pint8.int8_prequant_matmul(x, w, w_i8, s_w),
        "prequant_i8bwd": lambda: pint8.int8_prequant_matmul_i8bwd(x, w, w_i8, s_w, wt_i8, s_wt),
        "static": lambda: pint8.int8_static_matmul(x, w, w_i8, s_w, s_x),
        "static_i8bwd": lambda: pint8.int8_static_matmul_i8bwd(
            x, w, w_i8, s_w, wt_i8, s_wt, s_x),
    }[op]()
    grads = torch.autograd.grad(y, (x, w) if w_requires_grad else (x,), g, allow_unused=True)
    return (y, *grads), (w_i8, s_w, wt_i8, s_wt)


@pytest.mark.parametrize("op", OPS)
def test_op_forward_and_gradients_match_jax_vjp(op):
    """Forward equal; dx and the trainable w's dense dw against ``jax.vjp``.
    The int8 dx of the ``_i8bwd`` pair is the quantized product itself, so it
    is held to equality, and to ``_prequant_forward(g, wt_i8, s_wt)``."""
    rng = np.random.RandomState(9)
    x = _activation(10, (2, 7, 64))
    w = _weight(11)
    g = rng.standard_normal((2, 7, 48)).astype(np.float32)
    s = np.float32(np.abs(x[0]).max() / 127.0)
    want = _run_jax(op, jnp.asarray(x), jnp.asarray(w), jnp.asarray(g), jnp.float32(s))
    got, (w_i8, s_w, wt_i8, s_wt) = _run_port(
        op, torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(g),
        torch.tensor(s))
    y, dx, dw = got
    np.testing.assert_array_equal(_np(y), _np(want[0]))
    if op.endswith("i8bwd"):
        np.testing.assert_array_equal(_np(dx), _np(want[1]))
        assert torch.equal(dx, pint8._prequant_forward(torch.from_numpy(g), wt_i8, s_wt))
    else:
        np.testing.assert_allclose(_np(dx), _np(want[1]), **GRAD_TOL)
        np.testing.assert_allclose(_np(dx), g @ w.T, **GRAD_TOL)  # the dense cotangent
    np.testing.assert_allclose(_np(dw), _np(want[2]).T, **GRAD_TOL)
    np.testing.assert_allclose(
        _np(dw), g.reshape(-1, 48).T @ x.reshape(-1, 64), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("op", OPS)
def test_op_gradients_in_bf16_keep_the_operands_dtype(op):
    """bf16 operands: forward equal to JAX's; dx and dw come back in bf16 and
    agree with JAX's bf16 cotangents to two bf16 steps of the largest value
    (2^-7: both round an fp32-accumulated product to bf16 once)."""
    rng = np.random.RandomState(12)
    x, w = _activation(13, (2, 7, 64)), _weight(14)
    g = rng.standard_normal((2, 7, 48)).astype(np.float32)
    s = np.float32(np.abs(x[0]).max() / 127.0)
    bf = jnp.bfloat16
    want = _run_jax(op, jnp.asarray(x, bf), jnp.asarray(w, bf), jnp.asarray(g, bf),
                    jnp.float32(s))
    got, _ = _run_port(op, torch.from_numpy(x).bfloat16(), torch.from_numpy(w.T.copy()).bfloat16(),
                       torch.from_numpy(g).bfloat16(), torch.tensor(s))
    y, dx, dw = got
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(y), _np(want[0]))
    for a, b in ((dx, want[1]), (dw, jnp.asarray(want[2]).T)):
        assert np.abs(_np(a) - _np(b)).max() <= 2.0**-7 * np.abs(_np(b)).max()


@pytest.mark.parametrize("op", OPS)
def test_frozen_weight_gets_no_gradient_and_saves_no_activation(op):
    """A frozen w: no dw is computed and x is not kept for it; the quantized
    tensors and scales never get a gradient."""
    x = torch.from_numpy(_activation(15, (2, 7, 64)))
    w = torch.from_numpy(_weight(16).T.copy())
    g = torch.ones(2, 7, 48)
    s_x = torch.tensor(0.03, requires_grad=True)
    xg = x.clone().requires_grad_()
    w_i8, s_w = pint8.quantize_cols(w)
    wt_i8, s_wt = pint8.quantize_cols(w.t())
    s_w, s_wt = s_w.requires_grad_(), s_wt.requires_grad_()
    args = {"bf16_bwd": (None, None, None, None, None),
            "prequant": (w_i8, s_w, None, None, None),
            "prequant_i8bwd": (w_i8, s_w, wt_i8, s_wt, None),
            "static": (w_i8, s_w, None, None, s_x),
            "static_i8bwd": (w_i8, s_w, wt_i8, s_wt, s_x)}[op]
    y = pint8._Int8Matmul.apply(xg, w, *args)
    saved_x, saved_w, saved_wt, _ = y.grad_fn.saved_tensors
    assert saved_x is None  # only dw needs x
    assert (saved_w is None) == op.endswith("i8bwd") and (saved_wt is None) != op.endswith("i8bwd")
    grads = torch.autograd.grad(y, (xg, s_w, s_wt, s_x), g, allow_unused=True)
    assert grads[0] is not None and all(t is None for t in grads[1:])
    # nothing requires a gradient: nothing is saved, nothing is recorded
    y0 = pint8._Int8Matmul.apply(x, w, *(None if a is None else a.detach() for a in args))
    assert y0.grad_fn is None and torch.equal(y0, y.detach())


# ---------------------------------------------------------------- scales from statistics


@pytest.mark.parametrize("margin", [1.0, 1.5])
def test_activation_scales_from_stats_match_jax(margin):
    stats = {
        "backbone": {"blocks_0": {"attn": {
            "in_proj": {"amax": (np.float32(3.25), np.float32(7.5))},  # a sown tuple
            "amax_q": np.float32(2.0), "amax_k": np.float32(1e-12),
            "out_proj": {"amax": np.float32(0.0), "other": np.float32(9.0)}}}}}
    want = jint8.activation_scales_from_stats(
        jax.tree_util.tree_map(jnp.asarray, stats), margin=margin)
    attn = want["backbone"]["blocks_0"]["attn"]
    got = pint8.activation_scales_from_stats({
        "backbone.blocks.0.attn.in_proj.amax": torch.tensor([3.25, 7.5]),
        "backbone.blocks.0.attn.amax_q": torch.tensor(2.0),
        "backbone.blocks.0.attn.amax_k": torch.tensor(1e-12),
        "backbone.blocks.0.attn.out_proj.amax": torch.tensor(0.0),
        "backbone.blocks.0.attn.out_proj.other": torch.tensor(9.0),
    }, margin=margin)
    assert set(got) == {"backbone.blocks.0.attn.in_proj.s_x", "backbone.blocks.0.attn.s_q",
                        "backbone.blocks.0.attn.s_k", "backbone.blocks.0.attn.out_proj.s_x"}
    for name, ref in (("in_proj.s_x", attn["in_proj"]["s_x"]), ("s_q", attn["s_q"]),
                      ("s_k", attn["s_k"]), ("out_proj.s_x", attn["out_proj"]["s_x"])):
        t = got["backbone.blocks.0.attn." + name]
        assert t.dtype == torch.float32 and t.dim() == 0
        assert t.item() == np.float32(ref), name
    assert got["backbone.blocks.0.attn.out_proj.s_x"].item() == np.float32(1e-8)
