"""The port's fused short-sequence attention (the plain versions of the K4
and K5 kernels of ``csrc/fused_short_attn.cu``) against the JAX package's
Pallas pair ``_short_fwd_kernel`` / ``_short_bwd_kernel`` run in interpret
mode, as ``tests/test_ops.py`` runs them, on the CPU from the same numpy
inputs; ``multi_head_attention(use_fused=True)`` gradients against
``jax.grad`` of the JAX call; the dispatch rule; the card's refusal of a bf16
softmax.

Tolerances: fp32 1e-5 (the same formula; XLA, the Pallas interpreter and
torch sum in other orders).  bf16 2e-2 of the largest value: both round the
normalised p, ds and every output to bf16 once, and a sum landing across a
rounding boundary moves an element by one bf16 step (2^-8 of its size)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peft_vit_tpu.ops.attention import _fused_short_bwd, _fused_short_fwd
from peft_vit_tpu.ops.attention import multi_head_attention as jax_mha
from peft_vit_tpu_torch.ops import attention as port

SHAPES = [(2, 3, 197, 64), (1, 2, 50, 32), (2, 2, 130, 16)]
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, seed, n=4):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _close(got: torch.Tensor, want, dtype: str):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_pair_matches_pallas_kernels(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    arrs = _inputs(shape, seed=shape[2])
    arrs[0] *= np.float32(shape[-1] ** -0.5)  # the post-scaled q of the model's call
    scale = 1.0 if shape[2] == 197 else shape[-1] ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in arrs)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in arrs)
    jo, jlse = _fused_short_fwd(jq, jk, jv, None, scale, True, return_lse=True)
    o, lse = port.fused_short_attention_fwd(tq, tk, tv, scale, return_lse=True)
    assert o.dtype == tdt and lse.dtype == torch.float32 and lse.shape == (*shape[:2], 1, shape[2])
    _close(o, jo, dtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5, rtol=1e-5)
    # the backward from the same o and lse in both
    want = _fused_short_bwd(jq, jk, jv, jo, jlse, jdo, scale, True)
    o_j = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(tdt)
    lse_j = torch.from_numpy(np.array(jlse))
    got = port.fused_short_attention_bwd(tq, tk, tv, o_j, lse_j, tdo, scale)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        _close(g, w, dtype)


@pytest.mark.parametrize("shape", SHAPES[1:] + [(2, 2, 67, 32)])
def test_gradients_match_jax_grad(shape):
    """The autograd Function through the dispatcher against ``jax.grad`` of
    the JAX dispatcher's fused path (interpret mode), fp32."""
    q, k, v, w = _inputs(shape, seed=11 + shape[2])

    def jax_loss(q_, k_, v_):
        return jnp.sum(jnp.cos(jax_mha(q_, k_, v_, use_fused=True, interpret=True)) * w)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port.multi_head_attention(tq, tk, tv, use_fused=True)
    loss = (torch.cos(out) * torch.from_numpy(w)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)


def test_forward_matches_jax_dispatcher():
    q, k, v = _inputs((2, 3, 197, 64), seed=3, n=3)
    want = jax_mha(*(jnp.asarray(a) for a in (q, k, v)), use_fused=True, interpret=True)
    got = port.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)), use_fused=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_fused_function_saves_only_with_a_gradient(monkeypatch):
    calls = []
    monkeypatch.setattr(port, "fused_short_attention_bwd",
                        lambda *a: calls.append("bwd") or port._fused_short_bwd_plain(*a))
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 2, 20, 16), seed=5, n=3))
    with torch.no_grad():
        assert port.fused_short_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_()
    port.fused_short_attention(qg, k, v).sum().backward()
    assert calls == ["bwd"] and qg.grad is not None


@pytest.mark.parametrize("case,want", [
    ("fused", True), ("bias", False), ("long", False), ("none", False), ("false", False),
    ("edge", True),
])
def test_dispatch_rule(case, want, monkeypatch):
    """use_fused with no bias and N <= 1024 takes the fused pair; a bias, N >
    1024, use_fused None (off) or False take the path they take today."""
    n = {"long": 1025, "edge": 1024}.get(case, 33)
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 1, n, 16), seed=n, n=3))
    bias = torch.zeros((1, n, n)) if case == "bias" else None
    use_fused = {"none": None, "false": False}.get(case, True)
    took = []
    monkeypatch.setattr(port, "fused_short_attention",
                        lambda *a, **kw: took.append(1) or port.attention_reference(*a[:3]))
    out = port.multi_head_attention(q, k, v, bias, use_fused=use_fused)
    assert bool(took) == want and out.shape == q.shape
    assert port.takes_fused(use_fused, bias, n) == want


def test_softmax_fp32_false_is_refused_on_the_card_only():
    with pytest.raises(NotImplementedError, match="BF16_SOFTMAX"):
        port.check_softmax_fp32("cuda", False)
    port.check_softmax_fp32("cuda", True)
    port.check_softmax_fp32("cpu", False)
    # the CPU honours the flag: a bf16 softmax differs from the fp32 one
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs((1, 2, 40, 16), 9, 3))
    lo = port.multi_head_attention(q, k, v, softmax_fp32=False)
    hi = port.multi_head_attention(q, k, v)
    assert not torch.equal(lo, hi)
    # the fused pair keeps an fp32 softmax whatever the flag, as in the JAX package
    assert torch.equal(port.multi_head_attention(q, k, v, softmax_fp32=False, use_fused=True),
                       port.multi_head_attention(q, k, v, use_fused=True))


def test_wrappers_check_operands():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 2, 20, 16), seed=7))
    with pytest.raises(ValueError, match="shape"):
        port.fused_short_attention_fwd(q, k[:, :, :10], v)
    o, lse = port.fused_short_attention_fwd(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        port.fused_short_attention_bwd(q, k, v, o, lse[..., :5], do, 0.25)
    with pytest.raises(TypeError, match="dtype"):
        port.fused_short_attention_bwd(q, k, v, o.double(), lse, do, 0.25)
