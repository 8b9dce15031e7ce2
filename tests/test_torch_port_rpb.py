"""RPB through the port against the JAX package, on the CPU: the attention
bias path of ``peft_vit_tpu_torch.ops.attention`` (the plain versions of the
forward kernel with a bias, of the backward kernels with it, and of the
bias-gradient kernel, which a CPU tensor runs) and the relative position
bias hook of ``models.layers.MultiHeadAttention``.

* the plain forward with a bias against the Pallas flash forward in
  interpret mode with the same bias, and against the JAX reference;
* dq, dk, dv and dbias of ``flash_attention`` against ``jax.vjp`` of the
  JAX ``attention_reference`` with the bias (the XLA VJP the JAX package
  takes with a bias, ``_attention_bias_vjp_bwd``), at one bias (C = 1) and
  at a sweep round's per-cell biases (C = 3) under ``torch.func.vmap``
  against a loop over the cells;
* the RPB ``MultiHeadAttention`` against the golden fixtures
  (``rpb_attention.npz``, ``refexec_rpb_attention.npz``; atol = rtol = 1e-5,
  as ``tests/test_golden_quirks.py`` holds the JAX module) and against the
  JAX module's forward and table gradient, with and without a prefix of
  class token and prompts;
* the table's round trip through the converter, its deterministic gather
  backward, the bias-gradient wrapper's interface.

Tolerances, fp32: atol = rtol = 1e-5 against the Pallas kernel and the
JAX module (the same arithmetic summed in other orders), 5e-5 against the
reference's VJP (another formula: it differentiates the softmax where the
port recomputes p from the lse and takes delta = rowsum(dO o O)), as
``tests/test_torch_port_attention_bwd.py`` holds the bias-free backward."""

import numpy as np
import pytest
import torch
from torch.func import vmap

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.models import layers as jax_layers
from peft_vit_tpu.ops.attention import _flash_attention_fwd
from peft_vit_tpu.ops.attention import attention_reference as jax_reference
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu_torch.models import layers as port_layers
from peft_vit_tpu_torch.models.convert import load_jax_variables, params_from_jax, params_to_jax
from peft_vit_tpu_torch.ops import attention as port
from peft_vit_tpu_torch.peft import PEFTSpec

TOL = dict(atol=1e-5, rtol=1e-5)
TOL_VJP = dict(atol=5e-5, rtol=5e-5)
H, D = 3, 64
GOLDEN = "tests/golden"


def _inputs(b, n, seed, cells=0):
    """q, k, v, dO (B, H, N, D) and a bias, (H, N, N) or (cells, H, N, N)."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.standard_normal((b, H, n, D)).astype(np.float32) for _ in range(4))
    shape = (cells, H, n, n) if cells else (H, n, n)
    return q, k, v, do, rng.standard_normal(shape).astype(np.float32)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.mark.parametrize("n", [33, 197])
def test_plain_forward_with_a_bias_matches_the_pallas_kernel_and_the_reference(n):
    q, k, v, _, bias = _inputs(2, n, seed=n)
    s = D**-0.5
    want_o, want_lse = _flash_attention_fwd(*_j(q, k, v, bias), s, block_q=128, block_k=128,
                                            interpret=True, return_lse=True)
    got_o, got_lse = port.flash_attention_fwd(*_t(q, k, v, bias), s, return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(jax_reference(*_j(q, k, v, bias), s)),
                               **TOL)


def _jax_vjp(q, k, v, bias, do, scale):
    _, vjp = jax.vjp(lambda a, b_, c, d: jax_reference(a, b_, c, d, scale), *_j(q, k, v, bias))
    return tuple(np.asarray(g) for g in vjp(jnp.asarray(do)))


@pytest.mark.parametrize("scale", [None, 1.0])
@pytest.mark.parametrize("n", [50, 197])
def test_bias_backward_matches_the_reference_vjp(n, scale):
    """One bias shared by the batch (C = 1): dq, dk, dv and dbias of the
    ``flash_attention`` Function (the plain K1, K2, K3 and the bias-gradient
    kernel's plain version) against ``jax.vjp``."""
    q, k, v, do, bias = _inputs(2, n, seed=3 * n)
    if scale == 1.0:
        q = q * np.float32(D**-0.5)  # the post-scaled q of the CLIP LoRA path
    s = D**-0.5 if scale is None else scale
    want = _jax_vjp(q, k, v, bias, do, s)
    tq, tk, tv, tb = (t.requires_grad_() for t in _t(q, k, v, bias))
    got = torch.autograd.grad(port.flash_attention(tq, tk, tv, tb, s), (tq, tk, tv, tb),
                              torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **TOL_VJP)
    assert port.attention_bias_grad.launches == 0  # the CPU launches nothing


def test_per_cell_biases_under_vmap_match_a_loop_over_the_cells():
    """A sweep round of 3 cells, each with its own bias (C = 3): under
    ``torch.func.vmap`` the rule folds the cells into the batch and the
    biases into the bias's cells; every gradient equals the JAX VJP of each
    cell alone.  Then the same round with q, k, v shared by the cells and
    only the biases batched (a model's first block, whose q, k and v are the
    frozen tower's): dbias alone, from delta computed from o."""
    cells, b, n = 3, 2, 33
    q, k, v, do, bias = _inputs(cells * b, n, seed=5, cells=cells)
    q, k, v, do = (x.reshape(cells, b, H, n, D) for x in (q, k, v, do))
    s = 0.2
    tq, tk, tv, tb = (t.requires_grad_() for t in _t(q, k, v, bias))
    out = vmap(lambda a, b_, c, d: port.flash_attention(a, b_, c, d, s))(tq, tk, tv, tb)
    got = torch.autograd.grad(out, (tq, tk, tv, tb), torch.from_numpy(do))
    for i in range(cells):
        want = _jax_vjp(q[i], k[i], v[i], bias[i], do[i], s)
        for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
            np.testing.assert_allclose(g[i].numpy(), w, err_msg=f"{name} cell {i}", **TOL_VJP)

    out = vmap(lambda d: port.flash_attention(*_t(q[0], k[0], v[0]), d, s))(tb)
    (got,) = torch.autograd.grad(out, (tb,), torch.from_numpy(do))
    for i in range(cells):
        want = _jax_vjp(q[0], k[0], v[0], bias[i], do[i], s)[3]
        np.testing.assert_allclose(got[i].numpy(), want, err_msg=f"cell {i}", **TOL_VJP)


def test_bias_gradient_wrapper_with_delta_or_o_and_in_the_bias_dtype():
    """``attention_bias_grad`` takes delta (as the dq kernel returns it) or o
    (and computes delta itself): the same result; a bf16 bias comes back
    from the Function in bf16, as the JAX VJP returns its cotangent in the
    bias's dtype."""
    q, k, v, do, bias = _inputs(4, 33, seed=7, cells=2)
    q, k, v, do, bias = _t(q, k, v, do, bias)
    o, lse = port.flash_attention_fwd(q, k, v, bias, 0.3, return_lse=True)
    _, delta = port.flash_attention_bwd_dq(q, k, v, do, lse, o, 0.3, bias)
    by_delta = port.attention_bias_grad(q, k, v, do, lse, 0.3, bias, delta=delta)
    by_o = port.attention_bias_grad(q, k, v, do, lse, 0.3, bias, o=o)
    assert by_delta.shape == bias.shape and by_delta.dtype == torch.float32
    torch.testing.assert_close(by_delta, by_o, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="delta or o"):
        port.attention_bias_grad(q, k, v, do, lse, 0.3, bias)
    with pytest.raises(ValueError, match="C dividing the batch"):
        port.attention_bias_grad(q, k, v, do, lse, 0.3, bias[:1].expand(3, -1, -1, -1), o=o)

    q, k, v, do, b16 = (t.to(torch.bfloat16) for t in (q, k, v, do, bias))
    b16.requires_grad_()
    out = port.flash_attention(q, k, v, b16, 0.3)
    (g,) = torch.autograd.grad(out, (b16,), do)
    o16, lse16 = port.flash_attention_fwd(q, k, v, b16, 0.3, return_lse=True)
    want = port._bias_grad_plain(q, k, v, do, lse16, 0.3, b16.float(), o=o16)
    assert g.dtype == torch.bfloat16 and torch.equal(g, want.to(torch.bfloat16))


@pytest.mark.parametrize("bad,match", [("bias_rank", r"\(C, H, N, N\)"),
                                       ("bias_dtype", "bias dtype"),
                                       ("delta_dtype", "float32 on the card"),
                                       ("o_shape", "o shape")])
def test_bias_gradient_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    """On the ``meta`` device, where a tensor reaches the kernel's checks as
    a CUDA tensor would: each bad operand is named before the device is."""
    n, dev = 8, "meta"
    q, k, v, do, o = (torch.zeros(2, 2, n, 64, device=dev) for _ in range(5))
    lse, delta = (torch.zeros(2, 2, 1, n, device=dev) for _ in range(2))
    bias = torch.zeros(2, n, n, device=dev)
    kw = {"delta": delta}
    if bad == "bias_rank":
        bias = torch.zeros(1, 1, 2, n, n, device=dev)
    elif bad == "bias_dtype":
        bias = bias.double()
    elif bad == "delta_dtype":
        kw = {"delta": delta.to(torch.bfloat16)}
    elif bad == "o_shape":
        kw = {"o": torch.zeros(2, 2, n, 32, device=dev)}
    with pytest.raises((ValueError, TypeError), match=match):
        port.attention_bias_grad(q, k, v, do, lse, 1.0, bias, **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        port.attention_bias_grad(q, k, v, do, lse, 1.0, torch.zeros(2, n, n, device=dev),
                                 delta=delta)


# ------------------------------------------------------------------ the hook


@pytest.mark.parametrize("fname", ["rpb_attention.npz", "refexec_rpb_attention.npz"])
def test_rpb_attention_matches_the_golden(fname):
    g = np.load(f"{GOLDEN}/{fname}")
    d = g["x"].shape[-1]
    m = port_layers.MultiHeadAttention(d, int(g["heads"]), spec=PEFTSpec(method="rpb",
                                                                         attn_bias="rpb"),
                                       grid_size=int(g["grid"]), n_prefix=0)
    state = {"in_proj.weight": g["w_qkv"], "in_proj.bias": g["b_qkv"],
             "relative_position_bias_table": g["table"], "out_proj.weight": g["w_out"],
             "out_proj.bias": g["b_out"]}
    m.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        got = m(torch.from_numpy(g["x"])).numpy()
    np.testing.assert_allclose(got, g["out"], rtol=1e-5, atol=1e-5)


def _pair(width, heads, grid, n_prefix, dtype):
    """The JAX RPB attention and the port's, the JAX one's variables with
    every leaf (the table too) drawn from a seed, loaded into both."""
    spec = dict(method="rpb", attn_bias="rpb")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jm = jax_layers.MultiHeadAttention(width, heads, spec=JaxSpec(**spec), grid_size=grid,
                                       n_prefix=n_prefix, use_flash=False, dtype=jdt)
    n = n_prefix + grid * grid
    x = np.random.RandomState(1).standard_normal((2, n, width)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.RandomState(2)
    flat = {path: (0.5 * rng.standard_normal(np.shape(leaf)) if path[-1] ==
                   "relative_position_bias_table"
                   else rng.standard_normal(np.shape(leaf)) / np.sqrt(np.shape(leaf)[0])
                   ).astype(np.float32)
            for path, leaf in traverse_util.flatten_dict(dict(variables)).items()}
    variables = traverse_util.unflatten_dict(flat)
    pm = port_layers.MultiHeadAttention(width, heads, spec=PEFTSpec(**spec), grid_size=grid,
                                        n_prefix=n_prefix, dtype=dtype)
    load_jax_variables(pm, variables)
    return jm, variables, pm, x


@pytest.mark.parametrize("n_prefix", [1, 4], ids=["cls", "cls+3 prompts"])
def test_rpb_attention_matches_the_jax_module_forward_and_table_gradient(n_prefix):
    """fp32: the forward and the table's gradient (through the gather, the
    zero prefix rows and columns, and the bias's VJP) of the JAX module."""
    jm, variables, pm, x = _pair(64, 4, 4, n_prefix, torch.float32)
    w = np.random.RandomState(3).standard_normal(x.shape).astype(np.float32)

    def loss(params):
        return jnp.sum(jm.apply({"params": params}, jnp.asarray(x)) * w)

    want_out = np.asarray(jm.apply(variables, jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(loss)(variables["params"])["relative_position_bias_table"])
    out = pm(torch.from_numpy(x))
    (grad,) = torch.autograd.grad(out, (pm.relative_position_bias_table,), torch.from_numpy(w))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    np.testing.assert_allclose(grad.numpy(), want_grad, **TOL_VJP)


def test_rpb_in_bf16_rounds_the_bias_and_its_cotangent_as_the_jax_module():
    """bf16 compute: the gathered table is rounded to bf16 before the fp32
    softmax, and the bias's cotangent comes back in bf16 before the gather's
    fp32 sum into the table, in both packages.  The forward and the table
    gradient against the JAX module within two bf16 steps of the largest
    value, 2^-6 of it (XLA and torch round the bf16 GEMMs at other points;
    measured 7.9e-3 and 6.5e-3 of it)."""
    jm, variables, pm, x = _pair(64, 4, 4, 1, torch.bfloat16)
    w = np.random.RandomState(3).standard_normal(x.shape).astype(np.float32)
    seen = {}
    real = port.multi_head_attention

    def spy(q, k, v, bias=None, **kw):
        seen["bias"] = bias
        bias.register_hook(lambda g: seen.setdefault("cotangent", g))
        return real(q, k, v, bias, **kw)

    port_layers.multi_head_attention = spy
    try:
        out = pm(torch.from_numpy(x))
        (grad,) = torch.autograd.grad(out.float(), (pm.relative_position_bias_table,),
                                      torch.from_numpy(w))
    finally:
        port_layers.multi_head_attention = real
    assert seen["bias"].dtype == torch.bfloat16 and seen["cotangent"].dtype == torch.bfloat16
    assert grad.dtype == torch.float32
    want_out = np.asarray(jm.apply(variables, jnp.asarray(x))).astype(np.float32)
    want_grad = np.asarray(jax.grad(lambda p: jnp.sum(
        jm.apply({"params": p}, jnp.asarray(x)).astype(jnp.float32) * w))(
        variables["params"])["relative_position_bias_table"])
    for got, want in ((out.detach().float().numpy(), want_out), (grad.numpy(), want_grad)):
        assert np.abs(got - want).max() <= 2.0**-6 * np.abs(want).max()


def test_rpb_checks_the_grid_as_the_jax_module():
    spec = PEFTSpec(method="rpb", attn_bias="rpb", rpb_ndim=7)
    with pytest.raises(ValueError, match="RPB_NDIM=7 does not match the 4x4 patch grid"):
        port_layers.MultiHeadAttention(64, 4, spec=spec, grid_size=4)
    with pytest.raises(ValueError, match="patch grid"):
        port_layers.MultiHeadAttention(64, 4, spec=PEFTSpec(method="rpb", attn_bias="rpb"))
    with pytest.raises(ValueError, match="unknown attn_bias"):
        port_layers.MultiHeadAttention(64, 4, spec=PEFTSpec(attn_bias="alibi"), grid_size=4)
    assert port_layers.MultiHeadAttention(
        64, 4, spec=PEFTSpec(method="rpb", attn_bias="rpb", rpb_ndim=4),
        grid_size=4).relative_position_bias_table.shape == (49, 4)


def test_the_index_is_the_jax_packages():
    for g in (1, 4, 7, 14):
        np.testing.assert_array_equal(port_layers._rpb_index(g), jax_layers._rpb_index(g))


def test_table_gather_backward_is_the_index_backward_and_takes_a_round():
    """The gather's backward (a fixed-order sum through the slots) against
    autograd's own backward of ``table[index]`` in float64, and under
    ``torch.func.vmap`` over 3 cells' tables."""
    g = 4
    index = torch.as_tensor(port_layers._rpb_index(g).reshape(-1))
    slots = torch.as_tensor(port_layers._gather_slots(index.numpy(), (2 * g - 1) ** 2))
    rng = np.random.RandomState(4)
    table = torch.from_numpy(rng.standard_normal((3, 49, 2))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((3, 256, 2)))
    out = vmap(lambda t: port_layers._TableGather.apply(t, index, slots))(table)
    (got,) = torch.autograd.grad(out, (table,), w)
    (want,) = torch.autograd.grad(table[:, index], (table,), w)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(out, table[:, index], atol=0, rtol=0)


def test_converter_round_trips_the_table():
    """The table is a raw flax leaf: it crosses as it is, no transpose."""
    jm, variables, pm, _ = _pair(64, 4, 4, 1, torch.float32)
    state = params_from_jax(variables)
    table = np.asarray(variables["params"]["relative_position_bias_table"])
    np.testing.assert_array_equal(state["relative_position_bias_table"].numpy(), table)
    back = params_to_jax(pm.state_dict())
    np.testing.assert_array_equal(back["params"]["relative_position_bias_table"], table)
    assert set(pm.state_dict()) == set(state)  # the index and slots are not weights
