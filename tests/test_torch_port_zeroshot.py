"""Zero-shot, the head's init from text and the contrastive methods through
the port, against the JAX package on the CPU (the tiny config of
``test_torch_port_driver`` with a tiny text tower, ``TEXT``; the synthetic
task's classes registered with both packages' prompts):

* ``extract_text_features`` (one ``encode_text`` call per class, the
  templates' normalized mean) and ``clip_zeroshot_evaluator`` on the same
  text weights: fp32 at ``TOL``, the metric exactly;
* ``init_head_from_text``: the head's weight is the JAX kernel's transpose,
  with the logit scale folded in, the bias zero: exact;
* the losses: ``hybrid_contrastive_per_example`` (the driver's criterion),
  ``hybrid_contrastive_loss``, ``clip_contrastive_loss`` and
  ``contrastive_eval_logits`` against the JAX functions, values and
  gradients at ``TOL``;
* ``zeroshot_main`` of both packages on the same weights: the same score;
* ``finetune_main`` of both packages for ``finetune_contrast`` and
  ``linear_probe_contrast`` (a 2-lr sweep, 2 epochs a cell) and for LoRA
  with ``INIT_HEAD_WITH_TEXT_ENCODER`` and ``INIT_HEAD_WITH_LOGIT_SCALE``
  (``NO_TUNING``): the same rounds of cells, per-cell scores within 1e-4, the
  same choice and score, as ``test_torch_port_peft_driver`` holds the other
  methods."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import peft_vit_tpu.commands.zeroshot_eval as jax_zs
from peft_vit_tpu import config as jax_config
from peft_vit_tpu.data import prompts as jax_prompts
from peft_vit_tpu.engine import contrastive as jax_contrastive
from peft_vit_tpu.engine import loss as jax_loss
from peft_vit_tpu.engine import zeroshot as jax_zeroshot
from peft_vit_tpu.models import factory as jax_factory
from peft_vit_tpu.models.text import TextTransformer as JaxText
import peft_vit_tpu_torch.commands.zeroshot_eval as port_zs
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.data import prompts
from peft_vit_tpu_torch.engine import contrastive, loss, zeroshot
from peft_vit_tpu_torch.models import TextTransformer, load_jax_variables
from peft_vit_tpu_torch.models import factory as port_factory
from peft_vit_tpu_torch.models.text import TextEncoder
from peft_vit_tpu_torch.peft import spec as port_spec
from test_torch_port_driver import _run_both, jax_text_variables, tiny_cfg
from test_torch_port_layers import randomize

TOL = dict(rtol=1e-5, atol=1e-5)
TEXT = {"MODEL.SPEC.TEXT.WIDTH": 32, "MODEL.SPEC.TEXT.LAYERS": 1, "MODEL.SPEC.TEXT.HEADS": 2,
        "MODEL.SPEC.TEXT.CONTEXT_LENGTH": 16}
CLASSES = ["airplane", "bird", "cat", "dog"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _synthetic_prompts():
    """The synthetic task's classes in both packages' prompt registries, for
    this module's tests only."""
    saved = [dict(pkg._builtin_cache) for pkg in (prompts, jax_prompts)]
    for pkg in (prompts, jax_prompts):
        pkg.register_prompts("synthetic", CLASSES, ["a photo of a {}.", "art of the {}."])
    yield
    for pkg, cache in zip((prompts, jax_prompts), saved):
        pkg._builtin_cache.clear()
        pkg._builtin_cache.update(cache)


def _text_towers(seed=0):
    """A tiny text tower in both packages on the same weights (vocabulary
    49,408: the tokenizer's ids)."""
    kw = dict(vocab_size=49408, context_length=16, width=32, layers=1, heads=2, output_dim=24)
    jax_text = JaxText(**kw, use_flash=False)
    variables = randomize(jax_text.init(jax.random.PRNGKey(0), jnp.ones((1, 16), jnp.int32)),
                          seed)
    port = load_jax_variables(TextTransformer(**kw, device="cpu"), variables)
    jitted = jax.jit(lambda toks: jax_text.apply(variables, toks))
    jax_encode = lambda toks: jitted(toks)
    jax_encode.context_length = 16
    return jax_encode, TextEncoder(lambda: port, 16)


def test_text_features_and_evaluator_match_jax():
    jax_encode, port_encode = _text_towers(1)
    cfg_j, cfg_p = tiny_cfg(jax_config), tiny_cfg(port_config)
    want = np.asarray(jax_zeroshot.extract_text_features(jax_encode, cfg_j))
    got = zeroshot.extract_text_features(port_encode, cfg_p)
    assert got.shape == (4, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, rtol=1e-6)
    # named classes, no registry entry: the same features as the registry's
    np.testing.assert_allclose(zeroshot.extract_text_features(
        port_encode, cfg_p, dataset="cifar-10", classnames=CLASSES).numpy(),
        np.asarray(jax_zeroshot.extract_text_features(
            jax_encode, cfg_j, dataset="cifar-10", classnames=CLASSES)), **TOL)
    rng = np.random.RandomState(2)
    img = rng.standard_normal((10, 24)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    labels = rng.randint(0, 4, 10)
    want_score, want_logits = jax_zeroshot.clip_zeroshot_evaluator(img, want, labels)
    got_score, got_logits = zeroshot.clip_zeroshot_evaluator(img, got, labels)
    assert got_score == want_score
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="No class names"):
        zeroshot.extract_text_features(port_encode, cfg_p, dataset="no-such-dataset")


def test_image_features_cache(tmp_path):
    x = np.random.RandomState(3).standard_normal((5, 4)).astype(np.float32)
    path = str(tmp_path / "f.npz")
    got = zeroshot.extract_image_features(lambda b: torch.from_numpy(b) * 2.0, x, 2,
                                          cache_path=path)
    want = jax_zeroshot.extract_image_features(lambda b: b * 2.0, x, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(zeroshot.extract_image_features(None, x, cache_path=path), got)


def test_init_head_from_text_matches_jax():
    cfg = tiny_cfg(port_config)
    model, params, _ = port_factory.build_image_classifier(
        cfg, port_spec.spec_from_config(cfg), 4, device="cpu")
    feats = np.random.RandomState(4).standard_normal((4, 32)).astype(np.float32)
    jax_params = {"classifier": {"head": {"kernel": jnp.zeros((32, 4)), "bias": jnp.ones(4)}}}
    want = jax_factory.init_head_from_text(jax_params, feats, np.exp(2.659))
    port_factory.init_head_from_text(model, feats, float(np.exp(2.659)))
    head = model.classifier.head
    np.testing.assert_array_equal(head.weight.detach().numpy(),
                                  np.asarray(want["classifier"]["head"]["kernel"]).T)
    assert not head.bias.detach().any()
    with pytest.raises(ValueError, match="text features"):
        port_factory.init_head_from_text(model, feats[:, :8])


def test_contrastive_losses_match_jax():
    rng = np.random.RandomState(5)
    logits = rng.standard_normal((8, 5)).astype(np.float32) * 3
    target = rng.randint(0, 5, 8)
    img = rng.standard_normal((8, 12)).astype(np.float32)
    txt = rng.standard_normal((8, 12)).astype(np.float32)
    scale = np.float32(0.7)

    def jax_sum(a, b, c):
        return (jnp.sum(jax_contrastive.hybrid_contrastive_per_example(a, jnp.asarray(target)))
                + jax_loss.hybrid_contrastive_loss(b, c, jnp.asarray(target), scale)
                + jax_loss.clip_contrastive_loss(b @ c.T, c @ b.T))

    want, want_g = jax.value_and_grad(jax_sum, argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (logits, img, txt)))
    a, b, c = (torch.from_numpy(t).requires_grad_() for t in (logits, img, txt))
    t = torch.from_numpy(target)
    got = (contrastive.hybrid_contrastive_per_example(a, t).sum()
           + loss.hybrid_contrastive_loss(b, c, t, torch.tensor(scale))
           + loss.clip_contrastive_loss(b @ c.t(), c @ b.t()))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    for g, w in zip(torch.autograd.grad(got, (a, b, c)), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        contrastive.contrastive_eval_logits(torch.from_numpy(img), torch.from_numpy(txt)).numpy(),
        np.asarray(jax_contrastive.contrastive_eval_logits(jnp.asarray(img), jnp.asarray(txt))),
        rtol=1e-5, atol=1e-4)
    fn = contrastive.clip_contrastive_step_fn(lambda p, x: x, lambda p, x: x)
    np.testing.assert_allclose(float(fn(None, b, c, torch.tensor(scale))), float(
        jax_contrastive.clip_contrastive_step_fn(lambda p, x: x, lambda p, x: x)(
            None, jnp.asarray(img), jnp.asarray(txt), scale)), **TOL)
    # the global-batch gather needs a process group (test_torch_port_parallel.py
    # holds it on two processes against JAX)
    gathered = contrastive.clip_contrastive_step_fn(lambda p, x: x, lambda p, x: x, gather=True)
    with pytest.raises((RuntimeError, ValueError), match="process group"):
        gathered(None, b, c, torch.tensor(scale))
    with pytest.raises(ValueError, match="integer class targets"):
        contrastive.hybrid_contrastive_per_example(a, torch.ones(8, 5))


def test_zeroshot_main_matches_jax(monkeypatch):
    built = {}
    real = jax_zs.build_image_classifier

    def build(*a, **kw):
        built["out"] = real(*a, **kw)
        return built["out"]

    monkeypatch.setattr(jax_zs, "build_image_classifier", build)
    over = {**TEXT, "TEST.BATCH_SIZE_PER_GPU": 128}
    want = jax_zs.zeroshot_main(tiny_cfg(jax_config, **over))
    variables = jax.tree_util.tree_map(np.asarray, dict(built["out"][1]))
    text = jax_text_variables(built["out"][2], {"PEFT.METHOD": "finetune_contrast"})
    got = port_zs.zeroshot_main(tiny_cfg(port_config, **over), device="cpu",
                                variables=variables, text_variables=text)
    assert 0.0 <= got <= 100.0 and got == pytest.approx(want, abs=1e-4)


@pytest.mark.parametrize("method,over", [
    ("finetune_contrast", {"TRAIN.NO_TUNING": False}),
    ("linear_probe_contrast", {"TRAIN.NO_TUNING": False}),
    ("lora", {"TRAIN.INIT_HEAD_WITH_TEXT_ENCODER": True, "TRAIN.INIT_HEAD_WITH_LOGIT_SCALE": True,
              "TRAIN.LR": 1e-3}),
])
def test_contrastive_and_head_from_text_drivers_match_jax(monkeypatch, tmp_path, method, over):
    """Accuracy on 8 images: a step is 12.5 %; the per-cell scores at 1e-4,
    the choice and the score as the other methods' driver tests hold them."""
    over = {"TRAIN.END_EPOCH": 2, "TRAIN.SEARCH_WD_POINTS": 5, "TRAIN.SEARCH_WD_INIT_POINTS": 2,
            "MODEL.SPEC.VISION.LAYERS": 1, "PEFT.METHOD": method, **TEXT, **over}
    want, got = _run_both(monkeypatch, tmp_path, lr_grid=[1e-3, 3e-2], **over)
    assert [c[:2] for c in got["cells"]] == [c[:2] for c in want["cells"]]
    for g, w in zip(got["cells"], want["cells"]):
        np.testing.assert_allclose(g[2], w[2], atol=1e-4)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert (got["record"]["lr"], got["record"]["wd"]) == (want["record"]["lr"],
                                                          want["record"]["wd"])
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert got["record"]["trainable_params"] == want["record"]["trainable_params"]
