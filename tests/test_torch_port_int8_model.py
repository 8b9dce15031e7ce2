"""The port's int8 frozen tower against the JAX package's on the CPU, on the
tiny flagship (width 64, 2 layers, 4 heads, 32 px, patch 16): the quantized
tree and the calibration (exact, or fp32-close where an activation is
involved), ``Int8Dense`` and its wiring, the int8 serving logits, one training
step under each recipe, a few epochs of the static recipe with per-epoch
recalibration, and the convergence gate.

Op-level checks are exact (``test_torch_port_int8_ops.py``).  Model-level
checks take a tolerance: the two frameworks' activations differ at 1e-6
upstream of a GEMM, which moves a value across a .5 rounding boundary now and
then, and one flipped code is a step of 1/127 of its row's range.  Each
tolerance is stated where it is used, with what was measured."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.engine import train as jax_train
from peft_vit_tpu.engine.serving import ServingSession as JaxServingSession
from peft_vit_tpu.models import ImageClassifier as JaxImageClassifier
from peft_vit_tpu.models import VisionTransformer as JaxVisionTransformer
from peft_vit_tpu.ops import int8 as jint8
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu.peft import masks as jax_masks
from peft_vit_tpu_torch.engine import ServingSession
from peft_vit_tpu_torch.engine import train as port_train
from peft_vit_tpu_torch.models import (
    Dense,
    ImageClassifier,
    Int8Dense,
    cast_frozen_,
    collect_activation_stats,
    flagship,
    layers as port_layers,
    load_jax_variables,
    params_from_jax,
    params_to_jax,
)
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.ops import int8 as pint8
from peft_vit_tpu_torch.peft import PEFTSpec, build_mask, split_params
from test_torch_port_model import TINY, _images, randomize
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

LORA = dict(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
            lora_post_scale_q=True)
N_GEMMS = 4 * TINY["layers"]


def _jax_model(use_bn=False, dtype=jnp.float32, **flags):
    vit = JaxVisionTransformer(
        image_size=TINY["image"], patch_size=TINY["patch"], width=TINY["width"],
        layers=TINY["layers"], heads=TINY["heads"], style="clip", output_dim=512,
        spec=JaxSpec(**LORA), use_flash=False, dtype=dtype, **flags)
    return JaxImageClassifier(backbone=vit, num_classes=TINY["num_classes"], use_bn=use_bn,
                              dtype=dtype)


def _variables(seed, use_bn=False):
    model = _jax_model(use_bn)
    return randomize(model.init(jax.random.PRNGKey(0), jnp.asarray(_images(1, 0))), seed)


def _port_model(variables, use_bn=False, dtype=torch.float32, **flags):
    return load_jax_variables(
        flagship(**TINY, dtype=dtype, use_bn=use_bn, device="cpu", **flags), variables)


def _port_name(path):
    """``backbone/blocks_0/attn/in_proj/w_i8`` -> ``backbone.blocks.0.attn.in_proj.w_i8``."""
    return re.sub(r"blocks_(\d+)", r"blocks.\1", path).replace("/", ".")


def _bridge(tree):
    """A JAX ``qkernel`` or ``qscale`` collection under the port's names and
    layouts: codes transposed, (1, N) scales flattened, scalars kept."""
    out = {}
    for path, leaf in traverse_util.flatten_dict(tree, sep="/").items():
        arr = np.asarray(leaf)
        if path.endswith("_i8"):
            arr = np.ascontiguousarray(arr.T)
        elif arr.ndim == 2:
            arr = arr.reshape(-1)
        out[_port_name(path)] = torch.from_numpy(np.array(arr))
    return out


def _jax_split(variables):
    params = variables["params"]
    mask = jax_masks.build_mask(params, "lora", num_layers=TINY["layers"])
    return jax_masks.split_params(params, mask)


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()
            if v is not None}


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


# ---------------------------------------------------------------- the quantized tree


@pytest.mark.parametrize("bwd_dx", [False, True])
@pytest.mark.parametrize("method", ["lora", "attention"])
def test_quantize_frozen_tree_equals_jax_on_a_bf16_model(method, bwd_dx):
    """Same paths under the mask, same codes and scales, from the stored fp32
    weights of a bf16 model; after ``cast_frozen_`` the function refuses."""
    variables = _variables(seed=1)
    mask = jax_masks.build_mask(variables["params"], method, num_layers=TINY["layers"])
    _, jfrozen = jax_masks.split_params(variables["params"], mask)
    want = _bridge(jint8.quantize_frozen_tree(jfrozen, bwd_dx=bwd_dx))

    model = _port_model(variables, dtype=torch.bfloat16, int8_train=True)
    _, frozen = split_params(model, build_mask(model, method, num_layers=TINY["layers"]))
    got = pint8.quantize_frozen_tree(frozen, bwd_dx=bwd_dx)
    per_gemm = 4 if bwd_dx else 2
    n_gemms = N_GEMMS if method == "lora" else N_GEMMS // 2  # attention trains in/out_proj
    assert set(got) == set(want) and len(got) == n_gemms * per_gemm
    for name, ref in want.items():
        assert got[name].dtype == ref.dtype and got[name].shape == ref.shape, name
        assert got[name].is_contiguous()
        np.testing.assert_array_equal(got[name].numpy(), ref.numpy(), err_msg=name)

    cast_frozen_(model)
    with pytest.raises(ValueError, match="before cast_frozen_"):
        pint8.quantize_frozen_tree(frozen, bwd_dx=bwd_dx)
    # what the refusal prevents: the bf16-rounded weights give other codes
    rounded = pint8.quantize_frozen_tree(frozen, bwd_dx=bwd_dx, param_dtype=torch.bfloat16)
    assert any(not torch.equal(rounded[k], got[k]) for k in got if k.endswith("w_i8"))


def test_quantize_frozen_tree_skips_other_leaves_and_honours_targets():
    model = _port_model(_variables(seed=2), int8_train=True)
    _, frozen = split_params(model, build_mask(model, "lora", num_layers=TINY["layers"]))
    got = pint8.quantize_frozen_tree(frozen, targets=("c_fc",))
    assert sorted(got) == sorted(
        f"backbone.blocks.{i}.mlp.c_fc.{leaf}" for i in range(TINY["layers"])
        for leaf in ("w_i8", "s_w"))
    assert got["backbone.blocks.0.mlp.c_fc.w_i8"].shape == (4 * TINY["width"], TINY["width"])


# ---------------------------------------------------------------- calibration


@pytest.mark.parametrize("use_bn", [False, True])
def test_calibration_statistics_and_scales_match_jax(use_bn):
    """The absmax of every Int8Dense's input in one train-mode forward against
    the JAX ``qstats``, and the scales at margins 1.0 and 1.5: fp32 activations
    of two frameworks, 1e-5.  The BN update of the calibration forward is
    discarded."""
    variables = _variables(seed=3, use_bn=use_bn)
    x = _images(6, seed=4)
    jmodel = _jax_model(use_bn, int8_train=True)
    mutable = ["qstats", "batch_stats"] if use_bn else ["qstats"]
    _, st = jmodel.apply(variables, jnp.asarray(x), True, mutable=mutable)
    want = {_port_name(k): float(np.max(np.asarray(v)))
            for k, v in traverse_util.flatten_dict(st["qstats"], sep="/").items()}

    model = _port_model(variables, use_bn=use_bn, int8_train=True).train()
    bn_before = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad(), collect_activation_stats(model) as stats:
        model(torch.from_numpy(x))
    assert set(stats) == set(want) and len(stats) == N_GEMMS
    for name, ref in want.items():
        np.testing.assert_allclose(stats[name].item(), ref, rtol=1e-5, err_msg=name)
    assert all(m._stats is None for m in model.modules() if isinstance(m, Int8Dense))
    with torch.no_grad():  # outside the context nothing is recorded
        model(torch.from_numpy(x))
    assert len(stats) == N_GEMMS

    load_jax_variables(model, variables)
    apply_fn = port_train.make_apply_fn(model)
    for margin in (1.0, 1.5):
        ref = _bridge(jint8.activation_scales_from_stats(st["qstats"], margin=margin))
        got = port_train.calibrate(model, apply_fn, {}, torch.from_numpy(x), margin)
        assert set(got) == set(ref) == {n[: -len("amax")] + "s_x" for n in want}
        for name in ref:
            np.testing.assert_allclose(got[name].item(), ref[name].item(), rtol=1e-5,
                                       err_msg=name)
    for k, v in model.named_buffers():  # the calibration forward's BN update is discarded
        assert torch.equal(v, bn_before[k]), k
    assert port_train.INT8_CALIB_MARGIN == 1.5


def test_eval_forward_with_int8_only_records_nothing():
    """``train_bwd`` gates the statistics, as in the JAX module."""
    model = _port_model(_variables(seed=5), int8=True).eval()
    with torch.no_grad(), collect_activation_stats(model) as stats:
        model(torch.from_numpy(_images(2, seed=6)))
    assert stats == {}


# ---------------------------------------------------------------- Int8Dense and the wiring


def test_int8_dense_has_the_parameters_of_dense_and_no_persistent_state():
    torch.manual_seed(0)
    a, b = Dense(32, 16), Int8Dense(32, 16)
    assert list(a.state_dict()) == list(b.state_dict()) == ["weight", "bias"]
    b.load_state_dict(a.state_dict(), strict=True)
    assert dict(b.named_buffers()) == {}
    x = torch.randn(4, 32)
    assert _cos(a(x).detach(), b(x).detach()) > 0.999  # the JAX module's own gate
    assert torch.equal(b(x, int8=False), a(x))
    b.w_i8, b.s_w = pint8.quantize_cols(b.weight.detach())
    assert list(b.state_dict()) == ["weight", "bias"] and len(dict(b.named_buffers())) == 2


@pytest.mark.parametrize("present,train_bwd,want", [
    ((), False, "int8_matmul"),
    ((), True, "int8_matmul_bf16_bwd"),
    (("w_i8",), True, "int8_prequant_matmul"),
    (("w_i8", "s_x"), True, "int8_static_matmul"),
    (("w_i8", "wt_i8"), True, "int8_prequant_matmul_i8bwd"),
    (("w_i8", "wt_i8", "s_x"), True, "int8_static_matmul_i8bwd"),
    (("w_i8", "wt_i8", "s_x"), False, "int8_matmul"),  # the tree is train_bwd's
    (("s_x",), True, "int8_matmul_bf16_bwd"),  # no tree: the scale alone does nothing
])
def test_int8_dense_branch_order(monkeypatch, present, train_bwd, want):
    """The branch order of the JAX ``Int8Dense.__call__``: ``wt_i8`` present
    -> the ``_i8bwd`` ops; ``s_x`` present -> the static ops; no tree -> the
    per-call quantize, differentiable only with ``train_bwd``."""
    dense = Int8Dense(32, 16, dtype=torch.bfloat16)
    w = dense.weight.detach()
    state = {"s_x": torch.tensor(0.05)}
    state["w_i8"], state["s_w"] = pint8.quantize_cols(w)
    state["wt_i8"], state["s_wt"] = pint8.quantize_cols(w.t())
    for name in present:
        setattr(dense, name, state[name])
        if name.endswith("_i8"):
            other = {"w_i8": "s_w", "wt_i8": "s_wt"}[name]
            setattr(dense, other, state[other])
    called = []
    for op in ("int8_matmul", "int8_matmul_bf16_bwd", "int8_prequant_matmul",
               "int8_prequant_matmul_i8bwd", "int8_static_matmul", "int8_static_matmul_i8bwd"):
        real = getattr(pint8, op)

        def spy(*args, _op=op, _real=real):
            called.append((_op, args[0].dtype, args[1].dtype))
            return _real(*args)

        monkeypatch.setattr(port_layers.int8_ops, op, spy)
    y = dense(torch.randn(3, 32), True, train_bwd)
    # x and the weight reach the op in the compute dtype; the bias is added after
    assert called == [(want, torch.bfloat16, torch.bfloat16)]
    assert y.dtype == torch.bfloat16 and y.shape == (3, 16)


def test_model_builds_int8_dense_only_for_the_targets_and_only_when_asked():
    dense = flagship(**TINY, dtype=torch.float32, device="cpu")
    assert not any(isinstance(m, Int8Dense) for m in dense.modules())
    for flags in (dict(int8=True), dict(int8_train=True)):
        model = flagship(**TINY, dtype=torch.float32, device="cpu", **flags)
        names = sorted(n for n, m in model.named_modules() if isinstance(m, Int8Dense))
        assert names == sorted(
            f"backbone.blocks.{i}.{m}" for i in range(TINY["layers"])
            for m in ("attn.in_proj", "attn.out_proj", "mlp.c_fc", "mlp.c_proj"))
        assert list(model.state_dict()) == list(dense.state_dict())  # strict loading holds
    model = flagship(**TINY, dtype=torch.float32, device="cpu", int8_train=True,
                     int8_targets=("c_fc", "c_proj"))
    assert sum(isinstance(m, Int8Dense) for m in model.modules()) == 2 * TINY["layers"]
    assert type(model.backbone.blocks[0].attn.in_proj) is Dense


@pytest.mark.parametrize("flag", ["int8_attn", "int8_attn_pv"])
def test_int8_attention_is_not_ported_and_raises(flag):
    """Int8 attention, once refused, is ported: the tower builds with the
    flag, its calibration gives every attention its three scales beside the
    GEMMs' ``s_x``, and a training forward on them runs and differentiates."""
    vit = VisionTransformer(image_size=32, patch_size=16, width=64, layers=1, heads=4,
                            spec=PEFTSpec(**LORA), int8_train=True, int8_attn=True,
                            **({flag: True} if flag != "int8_attn" else {}))
    model = ImageClassifier(vit, num_classes=3, device="cpu")
    apply_fn = port_train.make_apply_fn(model)
    x = torch.from_numpy(_images(2, 5))
    scales = port_train.calibrate(model, apply_fn, {}, x)
    assert {k for k in scales if not k.endswith(".s_x")} == {
        f"backbone.blocks.0.attn.s_{t}" for t in "qkv"}
    assert all(torch.isfinite(v) and v > 0 for v in scales.values())
    out = apply_fn(scales, x, True)
    out.sum().backward()
    assert torch.isfinite(out).all()
    assert model.backbone.blocks[0].attn.q_adapter2.weight.grad is not None


# ---------------------------------------------------------------- serving


def test_int8_serving_logits_match_jax():
    """``int8=True``, eval: weight and activation quantized per call.  fp32
    outside the GEMMs.  Measured 7.2e-7 on logits of up to 2.1 here, and at
    most 1.3e-6 over six other seeds: no code flipped.  Held at 1e-5."""
    variables = _variables(seed=7, use_bn=True)
    x = _images(8, seed=8)
    jmodel = _jax_model(True, int8=True)
    want = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, False))(variables, jnp.asarray(x)))
    model = _port_model(variables, use_bn=True, int8=True).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # and it is the int8 path: the dense model answers differently, but closely
    with torch.no_grad():
        dense = _port_model(variables, use_bn=True).eval()(torch.from_numpy(x)).numpy()
    assert 1e-4 < np.abs(got - dense).max() and _cos(got, dense) > 0.999


def test_int8_serving_session_matches_jax():
    variables = _variables(seed=9, use_bn=True)
    jax_sess = JaxServingSession(_jax_model(True, int8=True), variables, TINY["image"],
                                 buckets=(1, 8))
    port = flagship(**TINY, dtype=torch.float32, use_bn=True, int8=True, device="cpu")
    sess = ServingSession(port, params_from_jax(variables), TINY["image"], buckets=(1, 8),
                          device="cpu")
    for n in (1, 5, 9):
        x = _images(n, seed=20 + n)
        # a padded bucket quantizes the same rows: per-row scales (tolerance as above)
        np.testing.assert_allclose(sess.predict(x), jax_sess.predict(x), atol=1e-5, rtol=1e-5)


def test_training_forward_with_only_int8_is_the_dense_path_bit_for_bit():
    """``int8`` engages on eval forwards only: a training forward and its
    gradients are those of the dense model, exactly."""
    variables = _variables(seed=10)
    x, y = torch.from_numpy(_images(4, seed=11)), torch.tensor([0, 1, 2, 3])
    out = []
    for flags in ({}, dict(int8=True)):
        model = _port_model(variables, **flags).train()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        out.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    model.eval()  # the same module in eval mode takes the int8 path
    with torch.no_grad():
        assert not torch.equal(model(x), _port_model(variables).eval()(x))


@pytest.mark.parametrize("patch_gemm_jax", [False, True])
def test_patch_embed_gemm_matches_jax_and_the_convolution(patch_gemm_jax):
    """The patch embedding as one matrix product: the same parameters, the
    same logits as the JAX package's conv and GEMM forms (fp32, 1e-4 as the
    serving tests) and as the port's own convolution."""
    variables = _variables(seed=12)
    x = _images(3, seed=13)
    jmodel = _jax_model(patch_gemm=patch_gemm_jax)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), False))
    model = _port_model(variables, patch_gemm=True).eval()
    assert list(model.state_dict()) == list(_port_model(variables).state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        conv = _port_model(variables).eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, conv, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- one training step per recipe

RECIPES = {"prequant": (False, False), "prequant+dx": (True, False),
           "static": (False, True), "static+dx": (True, True)}


def _jax_step(variables, x, y, bwd_dx, static, margin=1.5):
    model = _jax_model(int8_train=True)
    trainable, frozen = _jax_split(variables)
    extra = {"qkernel": jint8.quantize_frozen_tree(frozen, bwd_dx=bwd_dx)}
    if static:
        _, st = model.apply(variables, jnp.asarray(x), True, mutable=["qstats"])
        extra["qscale"] = jint8.activation_scales_from_stats(st["qstats"], margin=margin)

    def loss_fn(tr):
        p = jax_masks.merge_params(tr, frozen)
        logits = model.apply({"params": p, **extra}, jnp.asarray(x), True)
        return jnp.mean(jax_train.ce_per_example(logits.astype(jnp.float32), jnp.asarray(y)))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
    return float(loss), _flat(grads), extra


def _port_step(variables, x, y, bwd_dx, extra):
    model = _port_model(variables, int8_train=True)
    trainable, frozen = split_params(model, build_mask(model, "lora", num_layers=TINY["layers"]))
    qtree = pint8.quantize_frozen_tree(frozen, bwd_dx=bwd_dx)
    cast_frozen_(model)
    ref_tree = _bridge(extra["qkernel"])
    assert set(qtree) == set(ref_tree)
    if "qscale" in extra:  # the same scales as the JAX step, bit for bit
        qtree.update(_bridge(extra["qscale"]))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in trainable.items()}
    logits = port_train.make_apply_fn(model)({**qtree, **leaves}, torch.from_numpy(x), True)
    loss = port_train.ce_per_example(logits.float(), torch.from_numpy(y)).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), _flat(params_to_jax(dict(zip(leaves, grads)))["params"])


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_one_training_step_matches_jax(recipe):
    """Loss and LoRA/head gradients of one train-mode step under each recipe,
    with the same quantized tree and the same static scales.  fp32 outside the
    GEMMs.  Measured: loss within 6.7e-8 relative; gradients within 8.5e-7 of
    each leaf's largest element at cosine 1 - 3e-13 (no code flipped in any of
    the four).  Held at 1e-5 (loss), 1e-4 of the largest element and cosine
    0.999999."""
    bwd_dx, static = RECIPES[recipe]
    variables = _variables(seed=14)
    x = _images(8, seed=15)
    y = np.random.RandomState(16).randint(0, TINY["num_classes"], 8)
    jloss, jgrads, extra = _jax_step(variables, x, y, bwd_dx, static)
    loss, grads = _port_step(variables, x, y, bwd_dx, extra)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert set(grads) == set(jgrads) and len(grads) == 4 * TINY["layers"] + 2
    for path, ref in jgrads.items():
        assert np.abs(ref).max() > 0, path
        assert np.abs(grads[path] - ref).max() <= 1e-4 * np.abs(ref).max(), path
        assert _cos(grads[path], ref) >= 0.999999, path


def test_the_recipes_differ_from_each_other_and_from_the_dense_step():
    """The flags reach the ops: each recipe's gradients are its own."""
    variables = _variables(seed=14)
    x = _images(8, seed=15)
    y = np.random.RandomState(16).randint(0, TINY["num_classes"], 8)
    name = "backbone/blocks_0/attn/q_adapter1/kernel"
    seen = []
    for recipe in sorted(RECIPES):
        bwd_dx, static = RECIPES[recipe]
        _, _, extra = _jax_step(variables, x, y, bwd_dx, static)
        seen.append(_port_step(variables, x, y, bwd_dx, extra)[1][name])
    model = _port_model(variables)
    logits = model.train()(torch.from_numpy(x))
    loss = port_train.ce_per_example(logits, torch.from_numpy(y)).mean()
    (dense,) = torch.autograd.grad(loss, [model.backbone.blocks[0].attn.q_adapter1.weight])
    seen.append(dense.numpy().T)
    for i in range(len(seen)):
        for j in range(i):
            assert not np.array_equal(seen[i], seen[j]), (i, j)
        assert _cos(seen[i], seen[-1]) > 0.98  # all near the dense gradient


# ---------------------------------------------------------------- the slice as a whole

BATCH, EPOCHS, LR, WD = 8, 3, 1e-4, 1e-3


def _epoch_task(seed):
    rng = np.random.RandomState(seed)
    x = _images(24, seed)
    y = rng.randint(0, TINY["num_classes"], 24)
    valid = np.ones(24, bool)
    return x, y, valid, [rng.permutation(24) for _ in range(EPOCHS)]


def test_static_recipe_epochs_with_recalibration_match_jax():
    """Three epochs of ``make_epoch_fn`` (channel BN, lr 1e-4) under static
    scales + int8 dx, the scales recalibrated on each epoch's first batch at
    margin 1.5, against the same loop written with the JAX package: calibrate
    on the parameters alone (BN update discarded), then train the epoch on the
    quantized tree and those scales.

    A static scale is an absmax: one code flipped in the calibration forward
    moves a later layer's scale by 1e-3, and every value of that layer near a
    rounding boundary then rounds the other way for the whole epoch.  Measured:
    the first epoch's loss within 2.2e-5 relative; the worst scale of a later
    epoch 2.3e-3 apart, that epoch's loss 4.2e-3, the updated leaves within
    2.7e-2 of each leaf's largest update and the BN statistics within 6.4e-3.
    Held at 1e-4, 1e-2 (scales), 2e-2 (losses), 0.1 and 2e-2.  Handing the
    JAX loop's scales to the port's epochs leaves the losses as far apart
    (4.0e-3): the flips of the static quantizer set this level, not the
    calibration."""
    variables = _variables(seed=17, use_bn=True)
    x, y, valid, perms = _epoch_task(18)

    jmodel = _jax_model(True, int8_train=True)
    trainable, frozen = _jax_split(variables)
    qk = jint8.quantize_frozen_tree(frozen, bwd_dx=True)
    jstate = jax_train.init_cell_state(jax.tree_util.tree_map(jnp.asarray, trainable),
                                       jax.tree_util.tree_map(jnp.asarray,
                                                              variables["batch_stats"]))
    jx, jy, jv = jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid)

    @jax.jit
    def calib(tr, bn, bx):
        p = jax_masks.merge_params(tr, frozen)
        _, st = jmodel.apply({"params": p, "batch_stats": bn}, bx, True,
                             mutable=["qstats", "batch_stats"])
        return jint8.activation_scales_from_stats(st["qstats"], margin=1.5)

    @jax.jit
    def epoch(state, qs, perm):
        apply_fn = lambda v, xx, train, **kw: jmodel.apply(
            {**v, "qkernel": qk, "qscale": qs}, xx, train, **kw)
        fn = jax_train.make_epoch_fn(apply_fn, jax_train.ce_per_example, BATCH, has_bn=True)
        return fn(state, frozen, jx, jy, jv, perm, LR, WD)

    jlosses, jscales = [], []
    for perm in perms:
        qs = calib(jstate.trainable, jstate.bn, jx[perm[:BATCH]])
        jscales.append(_bridge(qs))
        jstate, loss = epoch(jstate, qs, jnp.asarray(perm))
        jlosses.append(float(loss))

    model = _port_model(variables, use_bn=True, int8_train=True)
    ptrain, pfrozen = split_params(model, build_mask(model, "lora", num_layers=TINY["layers"]))
    qtree = pint8.quantize_frozen_tree(pfrozen, bwd_dx=True)
    cast_frozen_(model)
    apply_fn = port_train.make_apply_fn(model)
    epoch_fn = port_train.make_epoch_fn(apply_fn, port_train.ce_per_example, BATCH, has_bn=True,
                                        calibrate_model=model)
    state = port_train.init_cell_state(ptrain, dict(model.named_buffers()))
    tx, ty, tv = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(valid)
    losses = []
    for perm, ref in zip(perms, jscales):
        variables_now = {**state.trainable, **state.bn}
        scales = port_train.calibrate(model, apply_fn, variables_now, tx[perm[:BATCH]])
        for name in ref:  # what the epoch is about to calibrate itself
            np.testing.assert_allclose(scales[name].item(), ref[name].item(), rtol=1e-2)
        state, loss = epoch_fn(state, qtree, tx, ty, tv, perm, LR, WD)
        losses.append(float(loss))
    assert not any(k.endswith(".s_x") for k in qtree)  # the caller's dict is not written
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-4)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    # the scales moved between epochs: recalibration is not a no-op
    assert any(jscales[0][k].item() != jscales[-1][k].item() for k in jscales[0])
    start = _flat(trainable)
    want = _flat(jstate.trainable)
    got = _flat(params_to_jax(state.trainable)["params"])
    for path in want:
        du, dw = got[path] - start[path], want[path] - start[path]
        assert np.abs(du - dw).max() <= 0.1 * np.abs(dw).max(), path
    got_bn = _flat(params_to_jax(state.bn)["batch_stats"])
    for path, ref in _flat(jstate.bn).items():
        assert np.abs(got_bn[path] - ref).max() <= 2e-2 * np.abs(ref).max(), path
    assert state.step == EPOCHS * 3 == int(jstate.step)


def _blobs():
    """The separable task of the JAX package's convergence gate: class-coded
    brightness."""
    rng = np.random.RandomState(2)
    y = np.tile(np.arange(5), 4)
    x = rng.randn(20, TINY["image"], TINY["image"], 3).astype(np.float32) * 0.3
    x += np.linspace(-1, 1, 5)[y][:, None, None, None]
    return x, y


def _train_40_steps(variables, recipe):
    """40 full-batch SGD steps at lr 3e-3, wd 1e-4, as the JAX gate; static
    scales are recalibrated every 8 steps (an epoch of the gate's trainer)."""
    x, y = _blobs()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    int8 = recipe != "dense"
    model = _port_model(variables, int8_train=int8)
    trainable, frozen = split_params(model, build_mask(model, "lora", num_layers=TINY["layers"]))
    bwd_dx, static = RECIPES.get(recipe, (False, False))
    qtree = pint8.quantize_frozen_tree(frozen, bwd_dx=bwd_dx) if int8 else {}
    cast_frozen_(model)
    apply_fn = port_train.make_apply_fn(model)
    step = port_train.make_train_step(apply_fn, port_train.ce_per_example)
    state = port_train.init_cell_state(trainable)
    losses = []
    for i in range(40):
        if static and i % 8 == 0:
            qtree.update(port_train.calibrate(model, apply_fn, state.trainable, tx))
        state, loss = step(state, qtree, tx, ty, None, 3e-3, 1e-4)
        losses.append(float(loss))
    with torch.no_grad():
        logits = apply_fn({**qtree, **state.trainable}, tx, False)
    return np.asarray(losses), logits.argmax(-1).numpy(), y


@pytest.fixture(scope="module")
def dense_run():
    """The gate's weights and the dense run the three recipes are held to,
    trained once for the module (the same seed, steps and data)."""
    variables = _variables(seed=19)
    # the gate starts from a fresh LoRA delta (adapter2 = 0), as flax initialises it
    for i in range(TINY["layers"]):
        for t in ("q", "v"):
            variables["params"]["backbone"][f"blocks_{i}"]["attn"][f"{t}_adapter2"]["kernel"][:] = 0
    return (variables, *_train_40_steps(variables, "dense"))


@pytest.mark.parametrize("recipe", ["prequant", "prequant+dx", "static+dx"])
def test_int8_training_learns_and_tracks_the_dense_run(recipe, dense_run):
    """The port's analog of the JAX convergence gate, with its bounds: the
    int8 run's loss trajectory within rtol 0.25 / atol 0.02 of the dense
    run's, accuracy within one sample in 20, predictions agreeing on 85 %,
    and both runs halve their loss."""
    variables, losses_fp, pred_fp, y = dense_run
    losses_q, pred_q, _ = _train_40_steps(variables, recipe)
    assert np.isfinite(losses_q).all()
    np.testing.assert_allclose(losses_q, losses_fp, rtol=0.25, atol=0.02)
    acc_fp, acc_q = (pred_fp == y).mean(), (pred_q == y).mean()
    assert abs(acc_fp - acc_q) <= 0.05, (acc_fp, acc_q)
    assert (pred_fp == pred_q).mean() >= 0.85
    assert losses_q[-1] < losses_q[0] * 0.5 and losses_fp[-1] < losses_fp[0] * 0.5
    assert not np.array_equal(losses_q, losses_fp)  # it is another path
