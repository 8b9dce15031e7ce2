"""Intrinsic dimension through the port against the JAX package on the CPU:
the WHT forms at d = 16 ... 8,192; the executed reference's goldens
(``wht_out``, ``ff_*``, ``dense_*``, as ``test_refexec_engine.py::
TestIntrinsicRefexec`` reads them); ``fastfood_transform`` and
``materialize`` (Fastfood, dense, SAID) on a JAX projection carried across,
a rectangular Dense kernel and a conv kernel among its leaves (the layout);
the port's own draws; ``select_intrinsic_targets``; a tiny ViT's loss, dL/dv
and dL/dlambda through ``make_intrinsic_apply`` and five SGD steps; and the
``intrinsic`` method through ``finetune_main`` against the JAX driver (the
head trains alone there, as in JAX).  Tolerances are stated beside each
constant."""

import functools
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.engine import train as jax_train
from peft_vit_tpu.models import ImageClassifier as JaxImageClassifier
from peft_vit_tpu.models import VisionTransformer as JaxVisionTransformer
from peft_vit_tpu.peft import intrinsic as jax_intr
from peft_vit_tpu_torch.engine import train as port_train
from peft_vit_tpu_torch.models import load_jax_variables
from peft_vit_tpu_torch.models.classifier import ImageClassifier
from peft_vit_tpu_torch.models.convert import jax_path
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.ops import wht as port_wht
from peft_vit_tpu_torch.peft import intrinsic as port_intr
from test_torch_port_driver import _run_both
from test_torch_port_model import randomize
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

jax_wht = importlib.import_module("peft_vit_tpu.ops.wht")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
sys.path.insert(0, GOLDEN)
import generate_engine_from_reference as _genref  # noqa: E402

sys.path.pop(0)
G = np.load(os.path.join(GOLDEN, "refexec_engine.npz"))

# the WHT of d fp32 terms: the dense product sums them in another order than
# XLA's (the butterfly adds the same pairs in the same order: equal)
TOL_WHT_REL = 2e-6  # of max |H x|
TOL_GOLDEN = dict(rtol=1e-5, atol=1e-6)  # the JAX test's bounds on the same goldens
# theta through two fp32 WHTs and a division, each leaf's ray in both packages
TOL_RAY_REL = 1e-5  # of max |ray|
# the tiny ViT's loss and gradients: the same fp32 forward and backward,
# summed in other orders (dL/dv through two transforms per leaf)
TOL_MODEL = dict(rtol=1e-4, atol=1e-6)
D = 16  # the tiny ViT's intrinsic dimension
# width 16: c_fc's 16 x 64 kernel is 1,024 elements, so every WHT of the
# model is a product with a 4 MB H (at width 32 it would be 64 MB)
TINY = dict(width=16, layers=2, heads=2, image=16, patch=8, num_classes=4)


@pytest.mark.parametrize("d", [16, 64, 256, 1024, 4096, 8192])
def test_wht_forms_match_jax(d):
    x = np.random.RandomState(d).standard_normal((3, d)).astype(np.float32)
    # the dense H at 8,192 (256 MB) is on no path of either package: their
    # splits are at 4,096 (``wht.DENSE_MAX``)
    forms = ("wht_butterfly", "wht") if d > 4096 else ("wht_matmul", "wht_butterfly", "wht")
    for form in forms:
        fn = getattr(jax_wht, form)
        if form == "wht_butterfly" or d > 4096:  # compiled: op by op the stages take seconds
            fn = jax.jit(fn, static_argnums=1)
        for normalize in (True, False):
            want = np.asarray(fn(jnp.asarray(x), normalize))
            got = getattr(port_wht, form)(torch.from_numpy(x), normalize)
            assert got.dtype == torch.float32 and got.shape == want.shape
            err = np.abs(got.numpy() - want).max() / np.abs(want).max()
            assert err <= TOL_WHT_REL, (form, normalize, err)
    # the two forms are one transform; H is its own inverse up to d
    y = torch.from_numpy(x)
    if d <= 4096:
        np.testing.assert_allclose(port_wht.wht_matmul(y).numpy(),
                                   port_wht.wht_butterfly(y).numpy(),
                                   rtol=0, atol=TOL_WHT_REL * float(y.abs().sum(-1).max()))
    np.testing.assert_allclose(port_wht.wht(port_wht.wht(y)).numpy(), x, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="power of two"):
        port_wht.wht(torch.zeros(d + 1))


def test_dense_wht_runs_ieee_fp32_in_both_directions():
    """The dense product and its backward each turn TF32 off for their own
    product and put the process's setting back."""
    seen = []
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with port_wht._ieee_fp32():
            seen.append(torch.backends.cuda.matmul.allow_tf32)
        assert seen == [False] and torch.backends.cuda.matmul.allow_tf32
        x = torch.randn(2, 64, requires_grad=True)
        y = port_wht.wht_matmul(x)
        (g,) = torch.autograd.grad(y.sum(), x)
        np.testing.assert_allclose(g.numpy(), port_wht.wht_matmul(torch.ones(2, 64)).numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_refexec_goldens():
    v, x16 = _genref.intrinsic_inputs()
    np.testing.assert_allclose(port_wht.wht(x16, normalize=False).numpy(), G["wht_out"],
                               rtol=1e-5)
    leaf = port_intr._leaf(G["ff_b"], G["ff_pi"], G["ff_g"], float(G["ff_divisor"]), 11,
                           int(G["ff_ll"]), (11,))
    np.testing.assert_allclose(port_intr.fastfood_transform(v, leaf).numpy(), G["ff_ret"],
                               **TOL_GOLDEN)
    proj = port_intr.IntrinsicProjection(
        "dense", 6, {"w": torch.zeros(3, 4)},
        {"w": torch.from_numpy(G["dense_p"].reshape(-1, 6))})
    got = port_intr.materialize(proj, torch.from_numpy(G["dense_v"].reshape(-1)))["w"]
    np.testing.assert_allclose(got.numpy(), G["dense_ray"], **TOL_GOLDEN)


def _targets():
    """A rectangular Dense kernel, its bias and a conv kernel (HWIO), in the
    JAX layout."""
    rng = np.random.RandomState(0)
    return {"backbone": {
        "blocks_0": {"mlp": {"c_fc": {"kernel": rng.randn(8, 12).astype(np.float32),
                                      "bias": rng.randn(12).astype(np.float32)}}},
        "conv1": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32)}}}


PORT_NAMES = {"backbone/blocks_0/mlp/c_fc/kernel": "backbone.blocks.0.mlp.c_fc.weight",
              "backbone/blocks_0/mlp/c_fc/bias": "backbone.blocks.0.mlp.c_fc.bias",
              "backbone/conv1/kernel": "backbone.conv1.weight"}


def _to_jax_layout(name, t):
    a = t.detach().numpy()
    if name.endswith(".weight"):
        a = a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)
    return a


@pytest.mark.parametrize("kind,said", [("fastfood", False), ("fastfood", True), ("dense", False),
                                       ("dense", True)])
def test_materialize_matches_jax_on_a_carried_projection(kind, said):
    """theta of every leaf, in the port's layout, is the JAX theta mapped as
    ``params_from_jax`` maps the leaf: the rectangular kernel transposed,
    the conv kernel HWIO -> OIHW; v = 0 gives theta0 exactly, so does SAID's
    lambda = 0, and theta0 + ray is linear in v."""
    t = jax.tree_util.tree_map(jnp.asarray, _targets())
    jproj = jax_intr.build_projection(jax.random.PRNGKey(1), t, 6, kind=kind)
    proj = port_intr.projection_from_jax(jproj)
    assert list(proj.theta0) == [PORT_NAMES[k] for k in sorted(PORT_NAMES)]
    v = np.random.RandomState(2).randn(6).astype(np.float32)
    lam = {k: np.float32(0.5 + i) for i, k in enumerate(sorted(PORT_NAMES))}
    want = jax_intr.materialize(jproj, jnp.asarray(v),
                                {k: jnp.asarray(x) for k, x in lam.items()} if said else None)
    got = port_intr.materialize(proj, torch.from_numpy(v), {
        PORT_NAMES[k]: torch.tensor(x) for k, x in lam.items()} if said else None)
    for path, name in PORT_NAMES.items():
        ray_w = np.asarray(want[path]) - np.asarray(jproj.theta0[path])
        ray_g = _to_jax_layout(name, got[name] - proj.theta0[name])
        assert ray_g.shape == ray_w.shape, name
        assert np.abs(ray_g - ray_w).max() <= TOL_RAY_REL * np.abs(ray_w).max(), name
    zero = port_intr.materialize(proj, torch.zeros(6))
    off = port_intr.materialize(proj, torch.from_numpy(v), {k: torch.tensor(0.0)
                                                            for k in proj.theta0})
    for name, theta0 in proj.theta0.items():
        assert torch.equal(zero[name], theta0) and torch.equal(off[name], theta0)
    twice = port_intr.materialize(proj, 2 * torch.from_numpy(v))
    plain = port_intr.materialize(proj, torch.from_numpy(v))
    for name, theta0 in proj.theta0.items():
        np.testing.assert_allclose((twice[name] - theta0).numpy(),
                                   2 * (plain[name] - theta0).numpy(), rtol=1e-4, atol=1e-5)


def test_port_draws_follow_the_jax_recipe():
    """build_projection's own draws: leaves in the order of the JAX paths,
    LL = 2^ceil(log2 max(DD, d)), b in {+-1}, pi a permutation and its
    inverse, divisor = sqrt(LL sum g^2); the same generator state gives the
    same projection; the norm statistics of JAX's test hold."""
    targets = {"backbone.conv1.weight": torch.zeros(4, 2, 3, 3),
               "backbone.blocks.0.mlp.c_fc.weight": torch.zeros(12, 8),
               "backbone.blocks.0.mlp.c_fc.bias": torch.zeros(12)}
    a = port_intr.build_projection(torch.Generator().manual_seed(3), targets, 20)
    b = port_intr.build_projection(torch.Generator().manual_seed(3), targets, 20)
    assert list(a.theta0) == sorted(targets, key=lambda k: jax_path(k, targets[k].dim()))
    for name, leaf in a.leaves.items():
        assert leaf.shape == port_intr._jax_shape(name, targets[name].shape)
        assert leaf.dd == int(np.prod(leaf.shape)) and leaf.ll == max(32, 1 << (leaf.dd - 1)
                                                                      .bit_length())
        assert set(leaf.b.unique().tolist()) <= {-1.0, 1.0}
        assert torch.equal(leaf.pi.sort().values, torch.arange(leaf.ll))
        assert torch.equal(leaf.pi[leaf.inv], torch.arange(leaf.ll))
        np.testing.assert_allclose(float(leaf.divisor),
                                   np.sqrt(leaf.ll * float((leaf.g ** 2).sum())), rtol=1e-6)
        assert all(torch.equal(x, y) for x, y in zip(leaf, b.leaves[name])
                   if isinstance(x, torch.Tensor))
    dense = port_intr.build_projection(torch.Generator().manual_seed(3), targets, 20, "dense")
    assert dense.leaves["backbone.conv1.weight"].shape == (72, 20)
    big = port_intr.build_projection(torch.Generator().manual_seed(4),
                                     {"w": torch.zeros(256)}, 16)
    norms = [float(port_intr.fastfood_transform(torch.eye(16)[i], big.leaves["w"]).norm())
             for i in range(16)]
    assert 0.5 < np.mean(norms) < 2.0, norms
    with pytest.raises(ValueError, match="unknown projection kind"):
        port_intr.build_projection(torch.Generator(), targets, 4, "sparse")


@functools.lru_cache(maxsize=1)
def _models(seed=5):
    """The tiny ViT classifier (no PEFT hooks) in both packages on the same
    numpy weights."""
    t = TINY
    jax_model = JaxImageClassifier(
        backbone=JaxVisionTransformer(image_size=t["image"], patch_size=t["patch"],
                                      width=t["width"], layers=t["layers"], heads=t["heads"],
                                      style="clip", output_dim=16, use_flash=False),
        num_classes=t["num_classes"])
    x = np.random.RandomState(seed).standard_normal(
        (8, t["image"], t["image"], 3)).astype(np.float32)
    variables = randomize(jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1])), seed)
    port = ImageClassifier(
        VisionTransformer(image_size=t["image"], patch_size=t["patch"], width=t["width"],
                          layers=t["layers"], heads=t["heads"], output_dim=16, device="cpu"),
        num_classes=t["num_classes"], device="cpu")
    load_jax_variables(port, variables)
    for p in port.parameters():
        p.requires_grad_(False)
    y = np.arange(8) % t["num_classes"]
    return jax_model, variables, port, x, y


@pytest.mark.parametrize("layer_type,layer_num", [("mlp", -1), ("attention", 1), ("all", -1),
                                                  ("adapter", -1), ("mlp", 0)])
def test_select_intrinsic_targets_matches_jax(layer_type, layer_num):
    _, variables, port, _, _ = _models()
    want = jax_intr.select_intrinsic_targets(variables["params"], layer_type, layer_num)
    got = port_intr.select_intrinsic_targets(dict(port.named_parameters()), layer_type,
                                             layer_num)
    assert {jax_path(k, p.dim()): got[k] for k, p in port.named_parameters()} == want


def test_intrinsic_apply_matches_jax_and_trains():
    """Fastfood with SAID over every block's mlp (a rectangular c_fc and
    c_proj in each): the loss, dL/dv and dL/dlambda at a nonzero v and
    lambda against jax.value_and_grad through the JAX apply; then five SGD
    steps (momentum, nesterov, weight decay: the engines' ``sgd_update``)
    from v = 0, lambda = 1, every step's loss and the final v and lambda."""
    jax_model, variables, port, x, y = _models()
    params = variables["params"]
    sel = jax_intr.select_intrinsic_targets(params, "mlp")
    flat = traverse_util.flatten_dict(params, sep="/")
    targets = traverse_util.unflatten_dict({k: v for k, v in flat.items() if sel[k]}, sep="/")
    jproj = jax_intr.build_projection(jax.random.PRNGKey(7), targets, D)
    proj = port_intr.projection_from_jax(jproj)
    assert len(proj.theta0) == 8
    jax_apply, jax_trainable, _ = jax_intr.make_intrinsic_apply(
        lambda v, xx, t: jax_model.apply(v, xx, t), jproj, params, use_said=True)
    apply_fn, trainable = port_intr.make_intrinsic_apply(port_train.make_apply_fn(port), proj,
                                                         use_said=True)
    assert set(trainable) == {"v"} | {f"said.{k}" for k in proj.theta0}
    assert not trainable["v"].any() and all(trainable[f"said.{k}"] == 1 for k in proj.theta0)

    rng = np.random.RandomState(9)
    v = (0.3 * rng.standard_normal(D)).astype(np.float32)
    lam = {k: np.float32(rng.uniform(0.5, 1.5)) for k in sorted(jproj.theta0)}
    names = dict(zip(sorted(jproj.theta0), proj.theta0))

    def jax_loss(tr):
        logits = jax_apply({"params": tr}, jnp.asarray(x), True)
        return jnp.mean(jax_train.ce_per_example(logits.astype(jnp.float32), jnp.asarray(y)))

    jax_value_and_grad = jax.jit(jax.value_and_grad(jax_loss))  # op by op: ~17 s
    jt = {"v": jnp.asarray(v), "said": {k: jnp.asarray(s) for k, s in lam.items()}}
    want, want_g = jax_value_and_grad(jt)
    pt = {"v": torch.from_numpy(v).requires_grad_()}
    pt.update({f"said.{names[k]}": torch.tensor(s, requires_grad=True) for k, s in lam.items()})
    loss = port_train.ce_per_example(apply_fn(pt, torch.from_numpy(x), True).float(),
                                     torch.from_numpy(y)).mean()
    grads = dict(zip(pt, torch.autograd.grad(loss, list(pt.values()))))
    np.testing.assert_allclose(float(loss), float(want), **TOL_MODEL)
    np.testing.assert_allclose(grads["v"].numpy(), np.asarray(want_g["v"]), **TOL_MODEL)
    assert np.abs(np.asarray(want_g["v"])).max() > 1e-4
    for k in lam:
        np.testing.assert_allclose(float(grads[f"said.{names[k]}"]),
                                   float(want_g["said"][k]), **TOL_MODEL, err_msg=k)

    lr, wd = 0.5, 1e-4
    state = jax_train.init_cell_state(jax_trainable)
    step = port_train.make_train_step(apply_fn, port_train.ce_per_example)
    pstate = port_train.init_cell_state(trainable)
    for _ in range(5):
        jl, jg = jax_value_and_grad(state.trainable)
        state = jax_train.sgd_update(jg, state, jnp.float32(lr), jnp.float32(wd))
        pstate, pl = step(pstate, {}, torch.from_numpy(x), torch.from_numpy(y), None,
                          torch.tensor(lr), torch.tensor(wd))
        np.testing.assert_allclose(float(pl), float(jl), **TOL_MODEL)
    np.testing.assert_allclose(pstate.trainable["v"].numpy(), np.asarray(state.trainable["v"]),
                               **TOL_MODEL)
    for k in lam:
        np.testing.assert_allclose(float(pstate.trainable[f"said.{names[k]}"]),
                                   float(state.trainable["said"][k]), **TOL_MODEL)
    assert float(pl) < float(want)  # v trains


def test_finetune_main_intrinsic_matches_jax(monkeypatch, tmp_path):
    """``intrinsic`` through both drivers: the JAX driver trains the head
    alone (its mask selects no tower leaf, and ``INTRINSIC_*`` is read by no
    module), the head drawn fresh per cell; the port does the same.  The
    epoch losses within 1e-4 relative, the same score and record."""
    want, got = _run_both(monkeypatch, tmp_path, **{"PEFT.METHOD": "intrinsic",
                                                    "TRAIN.END_EPOCH": 3, "TRAIN.LR": 1e-3})
    assert len(got["losses"]) == len(want["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert got["record"]["method"] == want["record"]["method"] == "intrinsic"
    assert got["record"]["trainable_params"] == want["record"]["trainable_params"]
