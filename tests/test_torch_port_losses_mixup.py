"""The port's loss zoo and mixup/cutmix (``peft_vit_tpu_torch/engine/loss.py``,
``mixup.py``) against the JAX package's functions on the same inputs, and
against the executed reference's losses (``tests/golden/refexec_engine.npz``).

Tolerances: the losses within 1e-6 relative of JAX (fp32 reductions in
another order) and at the JAX tests' 1e-5 against the golden; mixup and
cutmix fed the JAX draws equal JAX's images and targets within 1e-6 (a
blend of two fp32 images).
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peft_vit_tpu.config import get_default_config as jax_config
from peft_vit_tpu.engine import loss as jax_loss
from peft_vit_tpu_torch.config import get_default_config as port_config
from peft_vit_tpu_torch.engine import loss as port_loss
from peft_vit_tpu_torch.engine import mixup as port_mixup

# the module, not the function of the same name the JAX engine package exports
jax_mixup = importlib.import_module("peft_vit_tpu.engine.mixup")

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
sys.path.insert(0, GOLDEN)
from generate_engine_from_reference import loss_inputs  # noqa: E402

sys.path.pop(0)
G = np.load(os.path.join(GOLDEN, "refexec_engine.npz"))


def _inputs(seed=0, b=8, c=5):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, c) * 2).astype(np.float32)
    labels = rng.randint(0, c, b)
    labels[3] = -1  # a negative label: a zero one-hot row on both sides
    soft = rng.dirichlet(np.ones(c), b).astype(np.float32)
    multihot = (rng.rand(b, c) > 0.6).astype(np.float32)
    return logits, labels, soft, multihot


LOSSES = [
    ("softmax_cross_entropy", lambda m, l, y, s, mh: m.softmax_cross_entropy(l, y)),
    ("softmax_cross_entropy smoothed", lambda m, l, y, s, mh: m.softmax_cross_entropy(l, y, 0.1)),
    ("softmax_cross_entropy soft", lambda m, l, y, s, mh: m.softmax_cross_entropy(l, s, 0.2)),
    ("soft_target_cross_entropy", lambda m, l, y, s, mh: m.soft_target_cross_entropy(l, s)),
    ("sigmoid_multilabel_loss", lambda m, l, y, s, mh: m.sigmoid_multilabel_loss(l, mh)),
    ("focal", lambda m, l, y, s, mh: m.focal_loss(l, mh, 0.7, 0.5, True)),
    ("focal no normalize", lambda m, l, y, s, mh: m.focal_loss(l, mh, 0.25, 2.0, False)),
    ("focal gamma 0 on labels", lambda m, l, y, s, mh: m.focal_loss(l, y, 1.0, 0.0, True)),
    ("multi_softmax_cross_entropy", lambda m, l, y, s, mh: m.multi_softmax_cross_entropy(l, mh)),
    ("multilabel_soft_margin_loss", lambda m, l, y, s, mh: m.multilabel_soft_margin_loss(l, mh)),
    ("clip_contrastive_loss", lambda m, l, y, s, mh: m.clip_contrastive_loss(l[:5], l[:5].T)),
]


@pytest.mark.parametrize("name,fn", LOSSES, ids=[n for n, _ in LOSSES])
def test_loss_matches_the_jax_loss(name, fn):
    logits, labels, soft, multihot = _inputs()
    want = float(fn(jax_loss, *(jnp.asarray(a) for a in (logits, labels, soft, multihot))))
    got = fn(port_loss, *(torch.from_numpy(np.asarray(a)) for a in (logits, labels, soft,
                                                                     multihot)))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-7)


CRITERIA = [
    ("softmax", 0.0), ("CE", 0.1), ("softmax_smooth", 0.1), ("labelSmoothCE", 0.2),
    ("soft_target", 0.0), ("softTargetCE", 0.0), ("sigmoid", 0.0), ("multilabel", 0.0),
    ("focal", 0.0), ("multi_softmax", 0.0), ("multiSoftmax", 0.0),
]


@pytest.mark.parametrize("name,smoothing", CRITERIA)
@pytest.mark.parametrize("train", [True, False])
def test_build_criterion_matches_the_jax_criterion(name, smoothing, train):
    logits, labels, soft, multihot = _inputs(1)
    target = {"soft_target": soft, "softTargetCE": soft, "sigmoid": multihot,
              "multilabel": multihot, "focal": multihot, "multi_softmax": multihot,
              "multiSoftmax": multihot}.get(name, labels)
    crit = []
    for factory in (jax_config, port_config):
        cfg = factory()
        cfg.LOSS.LOSS = name
        cfg.LOSS.LABEL_SMOOTHING = smoothing
        cfg.LOSS.FOCAL.NORMALIZE = False
        crit.append(cfg)
    want = float(jax_loss.build_criterion(crit[0], train)(jnp.asarray(logits),
                                                          jnp.asarray(target)))
    got = float(port_loss.build_criterion(crit[1], train)(torch.from_numpy(logits),
                                                          torch.from_numpy(np.asarray(target))))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_unknown_criterion_raises_as_in_jax():
    cfg = port_config()
    cfg.LOSS.LOSS = "hinge"
    with pytest.raises(ValueError, match="Unknown loss"):
        port_loss.build_criterion(cfg)


@pytest.mark.parametrize("key,fn", [
    ("loss_ls", lambda m, l, y, s, mh: m.softmax_cross_entropy(l, y, 0.1)),
    ("loss_soft", lambda m, l, y, s, mh: m.soft_target_cross_entropy(l, s)),
    ("loss_focal", lambda m, l, y, s, mh: m.focal_loss(l, mh, alpha=0.7, gamma=0.5,
                                                        normalize=True)),
    ("loss_focal_nonorm", lambda m, l, y, s, mh: m.focal_loss(l, mh, alpha=0.7, gamma=0.5,
                                                               normalize=False)),
    ("loss_msce", lambda m, l, y, s, mh: m.multi_softmax_cross_entropy(l, mh)),
    ("loss_mlsm", lambda m, l, y, s, mh: m.multilabel_soft_margin_loss(l, mh)),
    ("loss_clip", lambda m, l, y, s, mh: m.clip_contrastive_loss(l[:, :4], l[:, :4].T)),
])
def test_loss_matches_the_executed_reference(key, fn):
    assert float(fn(port_loss, *loss_inputs())) == pytest.approx(float(G[key]), rel=1e-5)


# -- mixup / cutmix -------------------------------------------------------------


def _jax_draws(rng, h, w, mixup_alpha=0.2, cutmix_alpha=1.0, switch_prob=0.5):
    """The draws ``peft_vit_tpu.engine.mixup.mixup_cutmix`` takes from ``rng``,
    split as it splits its key."""
    k_switch, k_op = jax.random.split(rng)
    k_lam, k_x, k_y = jax.random.split(k_op, 3)
    return {"use_cutmix": bool(jax.random.bernoulli(k_switch, switch_prob)),
            "lam_mix": float(jax.random.beta(k_op, mixup_alpha, mixup_alpha)),
            "lam_cut": float(jax.random.beta(k_lam, cutmix_alpha, cutmix_alpha)),
            "cy": int(jax.random.randint(k_y, (), 0, h)),
            "cx": int(jax.random.randint(k_x, (), 0, w))}


def _batch(seed=0, b=6, h=8, w=10, c=3, classes=4):
    rng = np.random.RandomState(seed)
    return rng.randn(b, h, w, c).astype(np.float32), rng.randint(0, classes, b), classes


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_mixup_cutmix_with_the_jax_draws_equals_jax(seed, smoothing):
    x, y, classes = _batch(seed)
    rng = jax.random.PRNGKey(seed)
    want_x, want_y = jax_mixup.mixup_cutmix(rng, jnp.asarray(x), jnp.asarray(y), classes,
                                            0.8, 1.0, 0.5, smoothing)
    draws = _jax_draws(rng, x.shape[1], x.shape[2], 0.8, 1.0, 0.5)
    tensors = {k: torch.tensor(v) for k, v in draws.items()}
    for d in (draws, tensors):  # Python numbers or 0-dim tensors (a replay's inputs)
        got_x, got_y = port_mixup.mixup_cutmix(torch.from_numpy(x), torch.from_numpy(y),
                                               classes, d, smoothing)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("lam,cy,cx", [(0.3, 0, 0), (0.7, 7, 9), (0.05, 4, 2), (0.999, 3, 3),
                                        (0.0, 4, 5)])
def test_cutmix_box_and_area_equal_jax(lam, cy, cx):
    """The box (side sqrt(1 - lam) truncated, clipped at the edges) and the
    targets' mix by its true area, at the JAX function's own arithmetic."""
    x, y, classes = _batch(1)
    k = jax.random.PRNGKey(0)
    orig_beta, orig_randint = jax.random.beta, jax.random.randint
    try:  # the JAX cutmix on these exact draws
        jax.random.beta = lambda *a, **kw: jnp.float32(lam)
        # the image is 8 x 10: the bound tells the row draw from the column's
        jax.random.randint = lambda key, shape, lo, hi: jnp.int32(cy if hi == x.shape[1] else cx)
        want = jax_mixup.cutmix(k, jnp.asarray(x), jnp.asarray(y), classes, 1.0, 0.1)
    finally:
        jax.random.beta, jax.random.randint = orig_beta, orig_randint
    got = port_mixup.cutmix(torch.from_numpy(x), torch.from_numpy(y), classes, lam, cy, cx, 0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_mixup_with_the_jax_lam_equals_jax():
    x, y, classes = _batch(2)
    rng = jax.random.PRNGKey(5)
    want = jax_mixup.mixup(rng, jnp.asarray(x), jnp.asarray(y), classes, 0.4, 0.1)
    lam = float(jax.random.beta(rng, 0.4, 0.4))
    got = port_mixup.mixup(torch.from_numpy(x), torch.from_numpy(y), classes, lam, 0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_the_draws_follow_the_explicit_generator():
    """The same generator state gives the same draws; the draws stay in
    range and the switch follows its probability."""
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = [port_mixup.draw_mixup_cutmix(g1, 0.8, 1.0, 0.5, 7, 9) for _ in range(200)]
    b = [port_mixup.draw_mixup_cutmix(g2, 0.8, 1.0, 0.5, 7, 9) for _ in range(200)]
    assert a == b
    assert all(0.0 <= d["lam_mix"] <= 1.0 and 0.0 <= d["lam_cut"] <= 1.0 for d in a)
    assert all(0 <= d["cy"] < 7 and 0 <= d["cx"] < 9 for d in a)
    share = np.mean([d["use_cutmix"] for d in a])
    assert 0.35 < share < 0.65
    assert not any(port_mixup.draw_mixup_cutmix(g1, 0.8, 1.0, 0.0, 7, 9)["use_cutmix"]
                   for _ in range(20))
