"""The port's attention (peft_vit_tpu_torch.ops.attention) against the JAX
package: the plain reference, the CPU dispatch, and the Pallas flash
forward kernel run in interpret mode, at head dims 32 (Swin's windows, N =
49) and 64; the backward (dq, dk, dv, dbias) against ``jax.vjp``.  All fp32
on the CPU, same inputs from a numpy seed; tolerance atol = rtol = 1e-5
(fp32 accumulation order differs between XLA, the Pallas interpreter and
torch)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peft_vit_tpu.ops.attention import _flash_attention_fwd
from peft_vit_tpu.ops.attention import attention_reference as jax_reference
from peft_vit_tpu_torch.ops import _build
from peft_vit_tpu_torch.ops import attention as port

TOL = dict(atol=1e-5, rtol=1e-5)
# the last two of each head dim sit at the card forward's split: one product
# per row up to N = 256, streamed key tiles beyond; (2, 6, 49, 32) is a Swin
# block's window fold (N = 49, head dim 32)
SHAPES = [(2, 3, 64, 32), (2, 3, 197, 64), (1, 2, 256, 64), (1, 2, 257, 64),
          (2, 6, 49, 32), (1, 2, 257, 32)]


def _inputs(shape, seed, with_bias):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    b, h, n, _ = shape
    bias = rng.standard_normal((h, n, n)).astype(np.float32) if with_bias else None
    return q, k, v, bias


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("fn", ["attention_reference", "multi_head_attention"])
@pytest.mark.parametrize("scale", [None, 1.0])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_reference(fn, scale, with_bias, shape):
    q, k, v, bias = _inputs(shape, seed=shape[2] + 7 * with_bias, with_bias=with_bias)
    want = jax_reference(_j(q), _j(k), _j(v), _j(bias), scale)
    got = getattr(port, fn)(_t(q), _t(k), _t(v), _t(bias), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batch_chunk_matches_jax_reference():
    q, k, v, _ = _inputs((4, 3, 197, 64), seed=3, with_bias=False)
    want = jax_reference(_j(q), _j(k), _j(v))
    got = port.multi_head_attention(_t(q), _t(k), _t(v), batch_chunk=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_out_and_lse_match_pallas_kernel(with_bias, shape):
    """The kernel's plain version (what a CPU tensor runs) against the Pallas
    flash forward itself, out and lse."""
    q, k, v, bias = _inputs(shape, seed=11 + with_bias, with_bias=with_bias)
    scale = shape[-1] ** -0.5
    want_o, want_lse = _flash_attention_fwd(
        _j(q), _j(k), _j(v), _j(bias), scale, block_q=128, block_k=128,
        interpret=True, return_lse=True,
    )
    before = port.flash_attention_fwd.launches
    got_o, got_lse = port.flash_attention_fwd(
        _t(q), _t(k), _t(v), _t(bias), scale, return_lse=True
    )
    assert port.flash_attention_fwd.launches == before  # CPU: no kernel
    assert got_lse.shape == (shape[0], shape[1], 1, shape[2])
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_cell_biases_match_pallas_kernel_per_cell():
    """A (C, H, N, N) bias at head dim 32 (a round of 3 Swin cells, each
    with its own table): batch element b reads cell b // (B / C); each cell's
    slice against the Pallas flash forward with that cell's bias."""
    rng = np.random.RandomState(21)
    c, per, h, n, d = 3, 2, 4, 49, 32
    q, k, v = (rng.standard_normal((c * per, h, n, d)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((c, h, n, n)).astype(np.float32)
    got_o, got_lse = port.flash_attention_fwd(_t(q), _t(k), _t(v), _t(bias), d**-0.5,
                                              return_lse=True)
    for i in range(c):
        sl = slice(i * per, (i + 1) * per)
        want_o, want_lse = _flash_attention_fwd(
            _j(q[sl]), _j(k[sl]), _j(v[sl]), _j(bias[i]), d**-0.5, block_q=128, block_k=128,
            interpret=True, return_lse=True)
        np.testing.assert_allclose(got_o[sl].numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(got_lse[sl].numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("cells", [0, 1, 3])
@pytest.mark.parametrize("d", [32, 64])
def test_backward_matches_jax_vjp(d, cells):
    """dq, dk, dv and dbias of ``flash_attention`` (the kernels' plain
    versions) against ``jax.vjp`` of the JAX reference, each cell's slice
    with its own bias (cells 0: no bias; 1: one (H, N, N) bias), at head
    dims 32 and 64 and a ragged N; tolerance atol = rtol = 1e-4 (a backward
    sums twice as many products)."""
    rng = np.random.RandomState(31 + d + cells)
    per, h, n = 2, 3, 49
    b = per * max(cells, 1)
    q, k, v, do = (rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(4))
    bias = (rng.standard_normal((cells, h, n, n)).astype(np.float32) if cells else None)
    port_bias = None if bias is None else (bias[0] if cells == 1 else bias)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    if port_bias is not None:
        leaves.append(_t(np.ascontiguousarray(port_bias)).requires_grad_())
    got = torch.autograd.grad(
        port.flash_attention(*leaves[:3], leaves[3] if len(leaves) > 3 else None, 0.2),
        leaves, torch.from_numpy(do))
    tol = dict(atol=1e-4, rtol=1e-4)
    for i in range(max(cells, 1)):
        sl = slice(i * per, (i + 1) * per)
        args = [_j(q[sl]), _j(k[sl]), _j(v[sl])] + ([_j(bias[i])] if cells else [])
        f = (lambda a, b_, c_, bb: jax_reference(a, b_, c_, bb, 0.2)) if cells else (
            lambda a, b_, c_: jax_reference(a, b_, c_, None, 0.2))
        _, vjp = jax.vjp(f, *args)
        want = vjp(jnp.asarray(do[sl]))
        for name, g, w in zip(("dq", "dk", "dv"), got[:3], want[:3]):
            np.testing.assert_allclose(g[sl].numpy(), np.asarray(w), err_msg=name, **tol)
        if cells:
            g = got[3] if cells == 1 else got[3][i]
            np.testing.assert_allclose(g.numpy(), np.asarray(want[3]), err_msg="dbias", **tol)


def test_kernel_wrapper_refuses_a_head_dim_it_is_not_built_at():
    """The kernels are built at head dims 32 and 64, the fused pair at 64:
    a D = 48 operand is refused before any launch (no padding to 64)."""
    for what, dims in (("flash_attention_fwd", port.KERNEL_HEAD_DIMS),
                       ("fused_short_attention_fwd", port.FUSED_HEAD_DIMS)):
        with pytest.raises(ValueError, match="head dim"):
            port._check_kernel_operands(what, (("q", torch.zeros(1, 2, 8, 48)),), dims)
    with pytest.raises(ValueError, match="head dim 64"):
        port._check_kernel_operands("fused_short_attention_fwd",
                                    (("q", torch.zeros(1, 2, 8, 32)),), port.FUSED_HEAD_DIMS)
    assert port.KERNEL_HEAD_DIMS == (32, 64)


def test_cpu_tensors_never_count_a_launch():
    q, k, v, bias = _inputs((1, 2, 33, 64), seed=5, with_bias=True)
    before = port.flash_attention_fwd.launches
    port.flash_attention_fwd(_t(q), _t(k), _t(v), _t(bias))
    port.multi_head_attention(_t(q), _t(k), _t(v), _t(bias))
    assert port.flash_attention_fwd.launches == before == 0


@pytest.mark.parametrize(
    "bad",
    ["k_shape", "v_dtype", "bias_shape", "bias_dtype", "meta_device"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 2, 8, 64)
    k, v, bias = q.clone(), q.clone(), None
    if bad == "k_shape":
        k = torch.zeros(1, 2, 9, 64)
    elif bad == "v_dtype":
        v = v.double()
    elif bad == "bias_shape":
        bias = torch.zeros(2, 8, 9)
    elif bad == "bias_dtype":
        bias = torch.zeros(2, 8, 8, dtype=torch.float64)
    elif bad == "meta_device":
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises((ValueError, TypeError)):
        port.flash_attention_fwd(q, k, v, bias)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def _gen_wgmma():
    """``csrc/gen_wgmma.py`` loaded as a module (it is a script, not a package
    module)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("gen_wgmma", _build.CSRC_DIR / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


def test_wgmma_header_is_the_generators_output():
    """``csrc/wgmma_sm90.cuh`` (the kernels' wgmma instructions) is what
    ``csrc/gen_wgmma.py`` writes: one m64nNk16 product for every width
    N = 8 .. 256 the resident design dispatches to, the P V product, and
    K6's s8 products."""
    text = _gen_wgmma().render()
    assert (_build.CSRC_DIR / "wgmma_sm90.cuh").read_text() == text
    for n in range(8, 257, 8):
        assert f"m64n{n}k16.f32.bf16.bf16" in text
    assert "m64n64k16.f32.bf16.bf16" in text and "p, 1, 1, 1;" in text
    # the register-A product at the two head dims (P V and the backward's)
    for n in (32, 64):
        start = text.index(f"void wgmma_rs_n{n}_tb(float (&d)[{n // 2}]")
        body = text[start:text.index("\n}\n", start)]
        assert f"m64n{n}k16.f32.bf16.bf16" in body and "p, 1, 1, 1;" in body


@pytest.mark.parametrize("n", _gen_wgmma().S8_WIDTHS)
def test_wgmma_s8_products_name_their_shape_and_accumulators(n):
    """Each emitted s8 product (K6) is ``m64n{n}k32.s32.s8.s8`` with n / 2
    int32 accumulators bound read-write as ``"+r"``, both operands by
    descriptor and no scale or transpose immediates (the integer form has
    none)."""
    text = _gen_wgmma().render()
    start = text.index(f"void wgmma_ss_s8<{n}>(")
    body = text[start:text.index("\n}\n", start)]
    assert f"int (&d)[{n // 2}]" in body
    assert f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 " in body
    assert body.count('"+r"(d[') == n // 2 and '"+f"' not in body
    for i in range(n // 2):
        assert f'"+r"(d[{i}])' in body
    assert f"%{n // 2}, %{n // 2 + 1}, p;" in body  # desc_a, desc_b, scale_d only
