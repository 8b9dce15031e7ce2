"""Int8 attention scores (``TPU.INT8_ATTN`` / ``INT8_ATTN_PV``) through the
port against the JAX package on the CPU:

* the int32 scores of ``int8_attention_scores`` EQUAL to the JAX
  ``dot_general(quantize_static(q), quantize_static(k),
  preferred_element_type=int32)``, fp32 and bf16 inputs (exact: fp32 sums of
  integers below 2^24);
* ``int8_attention``'s output and dq, dk, dv against ``jax.vjp`` of the JAX
  ``int8_attention``, with and without ``pv``: fp32 at ``F32``; bf16 at
  ``BF16_REL`` of each tensor's largest entry (the port's CPU backward is the
  flash kernels' plain versions, which round p and ds to bf16 where XLA's
  autodiff of the reference rounds other intermediates);
* ``softmax_fp32=False`` honoured by the backward on the CPU and refused on
  the card;
* the calibrated ``s_q``, ``s_k``, ``s_v`` (and the GEMMs' ``s_x``) against
  the JAX ``qstats`` sow at margin 1.5 (rtol 1e-6: fp32 absmaxes of the same
  activations summed in another order);
* a tiny ``INT8_ATTN`` ViT (and ``+ INT8_ATTN_PV``) on the JAX scales
  against the JAX model in train mode, logits at ``MODEL_REL`` of the
  largest; with a bias (RPB) the attention is the plain one, as in the JAX
  module;
* a round of 3 cells with per-cell scales against each cell alone, the op
  (outputs and gradients at ``F32``) and the static-recipe epoch
  (``RTOL_LEAF``)."""

import numpy as np
import pytest
import torch
from torch.func import vmap

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.models import ImageClassifier as JaxImageClassifier
from peft_vit_tpu.models import VisionTransformer as JaxViT
from peft_vit_tpu.ops import attention as jax_attn
from peft_vit_tpu.ops import int8 as jax_int8
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu_torch.engine import ce_per_example, init_cell_state, make_array_task
from peft_vit_tpu_torch.engine.train import calibrate, make_apply_fn, make_epoch_fn
from peft_vit_tpu_torch.models import ImageClassifier, load_jax_variables
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.ops import attention as attn
from peft_vit_tpu_torch.ops import int8 as i8
from peft_vit_tpu_torch.peft import PEFTSpec
from test_torch_port_cells import BATCH, CELLS, LRS, RTOL_LEAF, WDS, _data, _tiny
from test_torch_port_layers import randomize

F32 = dict(rtol=1e-5, atol=1e-5)
# bf16: one bf16 step (2^-8) of the tensor's largest entry, and a little more
# where p and ds are rounded at other points than XLA's autodiff rounds them
BF16_REL = 1e-2
# A tiny int8 model against the JAX one on the same scales: the q and k
# entering a quantize differ from JAX's by fp32 summation order (~1e-7), which
# may flip a code at a .5 boundary; a flipped code moves one score by s_q s_k
# |k code|, and the GEMMs' dynamic codes flip likewise.  Bound 2e-2 of the
# largest logit (4e-4 .. 1.5e-3 measured).
MODEL_REL = 2e-2
SHAPE = (2, 3, 17, 16)  # B, H, N, D


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    qkv = [(rng.standard_normal(SHAPE) * 0.5).astype(np.float32) for _ in range(3)]
    scales = [np.float32(np.abs(t).max() / 127.0) for t in qkv]
    if dtype != np.float32:  # round to bf16 once, both packages see those values
        qkv = [np.asarray(jnp.asarray(t, jnp.bfloat16).astype(jnp.float32)) for t in qkv]
    return qkv, scales


def _port(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int32_scores_equal_jax(dtype):
    (q, k, _), (s_q, s_k, _) = _qkv(0, dtype)
    jq, jk = (jnp.asarray(t, dtype) for t in (q, k))
    want = jax.lax.dot_general(jax_int8.quantize_static(jq, s_q),
                               jax_int8.quantize_static(jk, s_k),
                               (((3,), (3,)), ((0, 1), (0, 1))),
                               preferred_element_type=jnp.int32)
    tq, tk = _port((q, k), getattr(torch, dtype))
    got = attn.int8_attention_scores(tq, tk, torch.tensor(s_q), torch.tensor(s_k))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want, np.int64))
    # the scores are integers below 2^24: their fp32 sum is exact
    assert float(got.abs().max()) < 2**24 and torch.equal(got, got.round())


@pytest.mark.parametrize("pv", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_output_and_gradients_match_jax_vjp(dtype, pv):
    qkv, scales = _qkv(1, dtype)
    scale = 0.25
    g = np.random.RandomState(9).standard_normal(SHAPE).astype(np.float32)
    jd = getattr(jnp, dtype)
    out_j, vjp = jax.vjp(lambda a, b, c: jax_attn.int8_attention(
        a, b, c, *scales, scale, True, pv), *(jnp.asarray(t, jd) for t in qkv))
    grads_j = vjp(jnp.asarray(g, jd))
    td = getattr(torch, dtype)
    tq, tk, tv = (t.requires_grad_() for t in _port(qkv, td))
    out = attn.int8_attention(tq, tk, tv, *(torch.tensor(s) for s in scales), scale, True, pv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g).to(td))
    pairs = [(out, out_j)] + list(zip(grads, grads_j))
    for got, want in pairs:
        got = got.detach().to(torch.float32).numpy()
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **F32)
        else:
            assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def test_bf16_softmax_backward_on_the_cpu_and_refused_on_the_card(monkeypatch):
    qkv, scales = _qkv(2)
    g = np.random.RandomState(3).standard_normal(SHAPE).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_attn.int8_attention(a, b, c, *scales, 0.25, False),
                     *(jnp.asarray(t) for t in qkv))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in qkv)
    out = attn.int8_attention(tq, tk, tv, *(torch.tensor(s) for s in scales), 0.25, False)
    for got, want in zip(torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g)),
                         vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    cuda = torch.device("cuda")
    with pytest.raises(NotImplementedError, match="BF16_SOFTMAX"):
        attn.check_softmax_fp32(cuda.type, False)


def _jax_tiny(pv=False, attn_bias="none"):
    spec = dict(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
                lora_post_scale_q=True, attn_bias=attn_bias)
    shape = dict(image_size=32, patch_size=16, width=64, layers=2, heads=4)
    jax_model = JaxImageClassifier(
        backbone=JaxViT(**shape, style="clip", output_dim=32, spec=JaxSpec(**spec),
                        use_flash=False, int8_train=True, int8_attn=True, int8_attn_pv=pv),
        num_classes=5)
    port = ImageClassifier(VisionTransformer(**shape, output_dim=32, spec=PEFTSpec(**spec),
                                             int8_train=True, int8_attn=True, int8_attn_pv=pv,
                                             device="cpu"), num_classes=5, device="cpu")
    x = np.random.RandomState(4).standard_normal((3, 32, 32, 3)).astype(np.float32)
    init = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = randomize({"params": init["params"]}, 5)  # the init also sows qstats
    load_jax_variables(port, variables)
    return jax_model, port, variables, x


def _port_scales(qscale):
    return {k.replace("/", ".").replace("blocks_", "blocks."): torch.tensor(np.asarray(v))
            for k, v in traverse_util.flatten_dict(qscale, sep="/").items()}


def test_calibrated_scales_match_jax_qstats():
    jax_model, port, variables, x = _jax_tiny()
    _, st = jax_model.apply(variables, jnp.asarray(x), True, mutable=["qstats"])
    want = _port_scales(jax_int8.activation_scales_from_stats(st["qstats"], margin=1.5))
    got = calibrate(port, make_apply_fn(port), {}, torch.from_numpy(x))
    assert set(got) == set(want) and {k.rsplit(".", 1)[1] for k in got} == {
        "s_x", "s_q", "s_k", "s_v"}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("pv", [False, True])
def test_int8_attention_model_matches_jax(pv):
    jax_model, port, variables, x = _jax_tiny(pv)
    _, st = jax_model.apply(variables, jnp.asarray(x), True, mutable=["qstats"])
    qscale = jax_int8.activation_scales_from_stats(st["qstats"], margin=1.5)
    want = np.asarray(jax_model.apply({**variables, "qscale": qscale}, jnp.asarray(x), True))
    calls = []
    real = attn._Int8Attention.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn._Int8Attention, "apply", lambda *a: calls.append(a[-1]) or real(*a))
        got = make_apply_fn(port)(_port_scales(qscale), torch.from_numpy(x), True)
    assert calls == [pv] * 2  # both blocks took the int8 attention
    got = got.detach().numpy()
    assert np.abs(got - want).max() <= MODEL_REL * np.abs(want).max()


def test_with_a_bias_the_attention_stays_plain():
    """RPB's bias: the JAX module falls back to the plain attention (no
    ``int8_attention``) even with the scales present; so does the port."""
    jax_model, port, variables, x = _jax_tiny(attn_bias="rpb")
    _, st = jax_model.apply(variables, jnp.asarray(x), True, mutable=["qstats"])
    qscale = jax_int8.activation_scales_from_stats(st["qstats"], margin=1.5)
    assert "backbone/blocks_0/attn/s_q" in traverse_util.flatten_dict(qscale, sep="/")
    want = np.asarray(jax_model.apply({**variables, "qscale": qscale}, jnp.asarray(x), True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn._Int8Attention, "apply", lambda *a: pytest.fail("int8 attention ran"))
        got = make_apply_fn(port)(_port_scales(qscale), torch.from_numpy(x), True)
    assert np.abs(got.detach().numpy() - want).max() <= MODEL_REL * np.abs(want).max()


@pytest.mark.parametrize("pv", [False, True])
def test_round_of_cells_equals_each_cell(pv):
    """Per-cell scales under ``vmap``: the op folds the cells into the batch
    and the scales into per-row ones; outputs and dq, dk, dv as each cell's."""
    rng = np.random.RandomState(6)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((CELLS, *SHAPE)).astype(np.float32) * 0.5)
                  for _ in range(4))
    s = [torch.from_numpy((np.abs(t.numpy()).reshape(CELLS, -1).max(1) / 127.0)
                          .astype(np.float32)) * f for t, f in ((q, 1.0), (k, 0.9), (v, 1.1))]
    fn = lambda a, b, c, sa, sb, sc: attn.int8_attention(a, b, c, sa, sb, sc, 0.25, True, pv)
    leaves = lambda: [t.clone().requires_grad_() for t in (q, k, v)]
    xs = leaves()
    got = vmap(fn)(*xs, *s)
    got_g = torch.autograd.grad(got, xs, g)
    ys = leaves()
    want = torch.stack([fn(*(t[i] for t in ys), *(t[i] for t in s)) for i in range(CELLS)])
    want_g = torch.autograd.grad(want, ys, g)
    torch.testing.assert_close(got, want, **F32)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, **F32)


def test_static_recipe_round_with_int8_attention_equals_its_cells():
    """The static int8 recipe with int8 attention in a round of 3: each
    cell calibrates its own three attention scales per block, and trains as
    it does alone (``RTOL_LEAF``)."""
    model, draws, bn0 = _tiny(int8_train=True, int8_attn=True)
    frozen = {k: v for k, v in model.named_parameters() if not v.requires_grad}
    tree = i8.quantize_frozen_tree({k: v.float() for k, v in frozen.items()}, bwd_dx=True)
    apply_fn = make_apply_fn(model)
    x, y = _data(7, 16)
    task = make_array_task(x, y, x[:8], y[:8], BATCH, device="cpu")
    perm = np.random.RandomState(8).permutation(16)
    calls = []
    real = attn._Int8Attention.apply
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attn._Int8Attention, "apply",
                   lambda *a: calls.append(a[0].shape[0]) or real(*a))
        cells = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True,
                              calibrate_model=model, cells=True)
        state = init_cell_state({k: torch.stack([d[k] for d in draws]) for k in draws[0]},
                                {k: v.expand(CELLS, *v.shape) for k, v in bn0.items()})
        state, _ = cells(state, tree, task.x_train, task.y_train, task.valid_train, perm,
                         torch.tensor(LRS), torch.tensor(WDS))
    # 2 steps x 2 blocks, the round's cells folded into one call each (beside
    # the outer call under the vmap, which the batching rule serves)
    assert calls.count(CELLS * BATCH) == 2 * 2 and len(calls) == 2 * 2 * 2
    one = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True, calibrate_model=model)
    for i in range(CELLS):
        alone, _ = one(init_cell_state(draws[i], bn0), tree, task.x_train, task.y_train,
                       task.valid_train, perm, LRS[i], WDS[i])
        for part in ("trainable", "momentum", "bn"):
            for k, v in getattr(alone, part).items():
                diff = torch.linalg.vector_norm(getattr(state, part)[k][i] - v)
                assert diff <= RTOL_LEAF * torch.linalg.vector_norm(v), (part, k, i)
