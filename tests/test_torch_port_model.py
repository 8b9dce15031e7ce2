"""The port's serving slice against the JAX package, on a tiny flagship
(width 64, 2 layers, 4 heads, image 32, patch 16, 10 classes): logits of
``ImageClassifier`` and ``ServingSession.predict`` from the same numpy
weights, fp32 on the CPU, atol = rtol = 1e-4 (fp32 through the whole
tower; XLA and torch sum in other orders).  Plus the port's guards: it imports
nothing of JAX or of ``peft_vit_tpu``, and its entry points need the
card unless the caller asks for the CPU."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.engine.serving import ServingSession as JaxServingSession
from peft_vit_tpu.models import ImageClassifier as JaxImageClassifier
from peft_vit_tpu.models import VisionTransformer as JaxVisionTransformer
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu_torch.engine import ServingSession
from peft_vit_tpu_torch.models import flagship, load_jax_variables, params_from_jax

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(width=64, layers=2, heads=4, image=32, patch=16, num_classes=10)


def randomize(variables, seed):
    """Every leaf of a flax variables tree redrawn from RandomState(seed)
    (LoRA adapter2 and the BN statistics non-zero)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in traverse_util.flatten_dict(dict(variables)).items():
        shape, name = np.shape(leaf), path[-1]
        if name == "bn_var":
            x = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "kernel" and "adapter" in path[-2]:
            x = 0.02 * rng.standard_normal(shape)
        elif name in ("kernel", "proj"):
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            x = 0.1 * rng.standard_normal(shape)
        out[path] = x.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def _jax_flagship(use_bn, dtype=jnp.float32, normalize_visual=False):
    spec = JaxSpec(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
                   lora_post_scale_q=True)
    vit = JaxVisionTransformer(
        image_size=TINY["image"], patch_size=TINY["patch"], width=TINY["width"],
        layers=TINY["layers"], heads=TINY["heads"], style="clip", output_dim=512,
        spec=spec, use_flash=False, dtype=dtype,
    )
    return JaxImageClassifier(backbone=vit, num_classes=TINY["num_classes"],
                              use_bn=use_bn, normalize_visual=normalize_visual, dtype=dtype)


def _images(n, seed):
    return np.random.RandomState(seed).standard_normal(
        (n, TINY["image"], TINY["image"], 3)).astype(np.float32)


def _jax_logits(model, variables, x):
    # one jitted program: eager flax dispatch compiles op by op and is slower
    return jax.jit(lambda v, xx: model.apply(v, xx, False))(variables, jnp.asarray(x))


def _both(use_bn, seed=0):
    model = _jax_flagship(use_bn)
    variables = randomize(model.init(jax.random.PRNGKey(0), jnp.asarray(_images(1, 0))), seed)
    port = flagship(**TINY, dtype=torch.float32, use_bn=use_bn, device="cpu")
    return model, variables, port


@pytest.mark.parametrize(
    "use_bn,normalize_visual", [(False, False), (True, False), (True, True)])
def test_logits_match_jax(use_bn, normalize_visual):
    model, variables, port = _both(use_bn, seed=1)
    if normalize_visual:
        model = _jax_flagship(use_bn, normalize_visual=True)
        port.classifier.normalize_input = True
    if use_bn:
        assert np.abs(variables["batch_stats"]["classifier"]["channel_bn"]["bn_mean"]).max() > 0
    x = _images(3, seed=2)
    want = np.asarray(_jax_logits(model, variables, x))
    load_jax_variables(port, variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (3, TINY["num_classes"])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("use_bn", [False, True])
def test_bf16_logits_track_jax(use_bn):
    """Both sides in bf16: every GEMM output and residual add rounds to bf16
    after summing in its own order, so the logits agree to a few bf16 steps
    (measured 1.1e-2 of max |logit|; bound 3e-2) and top-1 agrees."""
    model = _jax_flagship(use_bn, dtype=jnp.bfloat16)
    x = _images(8, seed=2)
    variables = randomize(model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1])), seed=1)
    want = np.asarray(_jax_logits(model, variables, x), np.float32)
    port = flagship(**TINY, dtype=torch.bfloat16, use_bn=use_bn, device="cpu")
    load_jax_variables(port, variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).float().numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))


def test_serving_session_matches_jax():
    model, variables, port = _both(use_bn=True, seed=3)
    jax_sess = JaxServingSession(model, variables, TINY["image"], buckets=(1, 8))
    sess = ServingSession(port, params_from_jax(variables), TINY["image"],
                          buckets=(1, 8), device="cpu")
    for n in (1, 5, 9):
        x = _images(n, seed=10 + n)
        got = sess.predict(x)
        assert got.dtype == np.float32 and got.shape == (n, TINY["num_classes"])
        np.testing.assert_allclose(got, jax_sess.predict(x), **TOL)


def test_feature_batchnorm_train_mode_matches_jax():
    """Torch-exact running statistics: normalize by the biased batch
    variance, blend the unbiased one at momentum 0.1."""
    from peft_vit_tpu.models.classifier import FeatureBatchNorm as JaxBN
    from peft_vit_tpu_torch.models import FeatureBatchNorm

    x = np.random.RandomState(4).standard_normal((6, 16)).astype(np.float32) * 3 + 1
    jbn = JaxBN()
    variables = {"batch_stats": {
        "bn_mean": np.full(16, 0.5, np.float32), "bn_var": np.full(16, 2.0, np.float32)}}
    want, updated = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                              mutable=["batch_stats"])
    bn = FeatureBatchNorm(16)
    load_jax_variables(bn, variables).train()
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for name in ("bn_mean", "bn_var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(updated["batch_stats"][name]), atol=1e-6, rtol=1e-6)


def test_strict_loading_rejects_missing_and_unexpected_keys():
    _, variables, port = _both(use_bn=True)
    state = params_from_jax(variables)
    with pytest.raises(RuntimeError):
        port.load_state_dict({k: v for k, v in state.items() if "bn_var" not in k}, strict=True)
    with pytest.raises(RuntimeError):
        load_jax_variables(flagship(**TINY, dtype=torch.float32, use_bn=False, device="cpu"),
                           variables)
    with pytest.raises(ValueError):
        params_from_jax({**variables, "qstats": {}})


def test_port_imports_nothing_of_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import peft_vit_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            peft_vit_tpu_torch.__path__, "peft_vit_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for want in ("ops.attention", "ops.int8", "ops.phm", "ops._build", "models.vit", "models.convert",
                     "models.factory", "engine.serving", "engine.train", "peft.spec",
                     "peft.masks", "config.node", "config.default", "data.registry",
                     "data.few_shot", "data.transforms", "data.pipeline", "engine.metrics",
                     "engine.sweep", "utils.logging", "utils.results", "commands.common",
                     "commands.run", "models.text", "models.clip", "models.classifier",
                     "data.tokenizer", "data.prompts", "engine.zeroshot", "engine.contrastive",
                     "engine.loss", "engine.cached", "engine.probes", "commands.zeroshot_eval",
                     "commands.linear_probe", "commands.eval_all", "engine.optim",
                     "engine.ema", "engine.mixup", "engine.checkpoint", "engine.trainer",
                     "utils.tb", "commands.train", "commands.swa_finetune",
                     "commands.bit_finetune", "data.native", "data.samplers",
                     "data.streaming", "data.elevater", "data.custom", "data.hub",
                     "data.augment", "commands.test_io", "ops.dropblock", "models.resnet",
                     "models.clip_resnet", "models.registry", "models.swin",
                     "models.ssl_swin", "models.vit_conv", "models.efficientnet",
                     "models.rexnet", "models.ttnet", "models.hrnet"):
            assert "peft_vit_tpu_torch." + want in names, want
        import bench_torch, chip_smoke
        bad = sorted(
            n for n in sys.modules
            if n.split(".")[0].startswith("jax")
            or n.split(".")[0] in ("flax", "optax", "orbax", "sklearn", "transformers")
            or n == "peft_vit_tpu" or n.startswith("peft_vit_tpu.")
        )
        assert not bad, bad
        print("imported", len(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship(**TINY, dtype=torch.float32)
    port = flagship(**TINY, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingSession(port, None, TINY["image"], buckets=(1,))
