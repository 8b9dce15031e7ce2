"""The probes through the port, against the JAX package on the CPU:

* the logistic probe: the batched L-BFGS against the JAX ``optax.lbfgs``
  fit on the same features, for every C of the coarse grid: the objective at
  the port's solution within ``OBJ_REL`` of JAX's for C <= 1e2, where both
  reach the minimizer, and never above JAX's by more than that at 1e4 and
  1e6 (where the fp32 optax run stops short of it and the float64 fit does
  not); the validation accuracies equal;
* ``linear_probe`` both ways: ``--classifier logistic`` (``logistic_main``:
  the sweep's chosen C and the test accuracy, the feature cache) and
  ``--classifier linear`` (the driver, with the cached prefix) of both
  packages on the same weights: the same choice and scores; the sklearn
  paths raise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import peft_vit_tpu.commands.linear_probe as jax_lp
import peft_vit_tpu.commands.run as jax_run
from peft_vit_tpu.engine import probes as jax_probes
import peft_vit_tpu_torch.commands.linear_probe as port_lp
from peft_vit_tpu_torch.engine import probes
from peft_vit_tpu_torch.models import params_from_jax
from test_torch_port_driver import _jax_key

# The logistic objective at the port's solution against JAX's (relative)
OBJ_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _features(seed, n, d=24, k=4):
    rng = np.random.RandomState(seed)
    centers = np.random.RandomState(99).standard_normal((k, d))
    y = np.arange(n) % k
    x = centers[y] * 0.6 + rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32), y


def test_logistic_fit_matches_jax():
    (x, y), (xv, yv) = _features(0, 40), _features(1, 20)
    cs = np.logspace(-6, 6, 7)
    w_j, b_j = jax.jit(jax.vmap(lambda c: jax_probes._lbfgs_logistic(
        jnp.asarray(x), jnp.asarray(y), c, 4, 200)))(jnp.asarray(cs, jnp.float32))
    x64, y64, c64 = torch.tensor(x, dtype=torch.float64), torch.tensor(y), torch.tensor(cs)
    w, b = probes._lbfgs_logistic(x64, y64, c64, 4, 200)
    f_port = probes.logistic_objective(x64, y64, w, b, c64)
    f_jax = probes.logistic_objective(x64, y64, torch.tensor(np.asarray(w_j), dtype=torch.float64),
                                      torch.tensor(np.asarray(b_j), dtype=torch.float64), c64)
    rel = ((f_port - f_jax) / f_jax).detach()
    # C <= 1e2: both fits reach the minimizer; at 1e4 and 1e6 the fp32 optax
    # run stops short of it (6.7e-5 above the port's at 1e6), so there the
    # port's objective only must not be above JAX's
    assert (rel[:5].abs() <= OBJ_REL).all(), rel
    assert (rel <= OBJ_REL).all(), rel
    _, acc_j = jax_probes.logistic_probe_vmapped(x, y, xv, yv, 4, list(cs))
    best, acc = probes.logistic_probe_vmapped(x, y, xv, yv, 4, list(cs), device="cpu")
    np.testing.assert_array_equal(acc, np.asarray(acc_j, np.float64))
    assert best == float(cs[int(np.argmax(acc))])


def _capture_jax_build(monkeypatch, module):
    built = {}
    real = module.build_image_classifier

    def build(*a, **kw):
        built["out"] = real(*a, **kw)
        return built["out"]

    monkeypatch.setattr(module, "build_image_classifier", build)
    return built


def test_linear_probe_both_ways_match_jax(monkeypatch, tmp_path):
    argv = ["--num-shots", "8", "OUTPUT_DIR", str(tmp_path), "NAME", "tiny",
            "DATASET.DATASET", "synthetic", "DATASET.NUM_CLASSES", "4",
            "TRAIN.IMAGE_SIZE", "[16, 16]", "TRAIN.BATCH_SIZE_PER_GPU", "8",
            "TRAIN.END_EPOCH", "2", "TRAIN.SCHEDULE", "[]", "TRAIN.NO_TUNING", "True",
            "TRAIN.LR", "0.01", "MODEL.NAME", "clip_tiny", "MODEL.SPEC.EMBED_DIM", "32",
            "MODEL.SPEC.VISION.PATCH_SIZE", "8", "MODEL.SPEC.VISION.WIDTH", "32",
            "MODEL.SPEC.VISION.LAYERS", "1", "MODEL.SPEC.VISION.HEADS", "2",
            "TRAIN.SEARCH_WD_LOG_LOWER", "-3", "TRAIN.SEARCH_WD_LOG_UPPER", "3"]
    # logistic: the same features, the same sweep (accuracies, chosen C)
    built = _capture_jax_build(monkeypatch, jax_lp)
    sweeps = {}
    for name, module, real in (("jax", jax_lp, jax_lp.logistic_probe_sweep),
                               ("port", port_lp, port_lp.logistic_probe_sweep)):
        monkeypatch.setattr(module, "logistic_probe_sweep", lambda *a, _n=name, _r=real, **kw:
                            sweeps.setdefault(_n, _r(*a, **kw)))
    want = jax_lp.main(["--classifier", "logistic", *argv])
    variables = jax.tree_util.tree_map(np.asarray, dict(built["out"][1]))
    real_logistic = port_lp.logistic_main
    monkeypatch.setattr(port_lp, "logistic_main", lambda cfg, out, device=None: real_logistic(
        cfg, out, device=device, variables=variables))
    got = port_lp.main(["--classifier", "logistic", *argv, "NAME", "tiny_port"], device="cpu")
    assert got == pytest.approx(want, abs=1e-9)
    assert sweeps["port"][1] == sweeps["jax"][1]  # the chosen C
    cache = list((tmp_path / "synthetic" / "tiny_port" / "feature_cache").glob("*.npz"))
    assert len(cache) == 3
    with pytest.raises(NotImplementedError, match="sklearn"):
        probes.logistic_probe_sweep(*[np.zeros((2, 3))] * 6, 2, use_sklearn=True, device="cpu")
    with pytest.raises(NotImplementedError, match="sklearn"):
        probes.multilabel_probe()
    # linear: the driver with the cached prefix, the same weights and draws
    built = _capture_jax_build(monkeypatch, jax_run)
    inits = {}
    real_engine = jax_run.SweepEngine

    class Spy(real_engine):
        def __init__(self, cfg, apply_fn, init_trainable, *a, **kw):
            super().__init__(cfg, apply_fn, init_trainable, *a, **kw)
            inits["init"] = init_trainable

    monkeypatch.setattr(jax_run, "SweepEngine", Spy)
    want = jax_lp.main(["--classifier", "linear", *argv])
    variables = jax.tree_util.tree_map(np.asarray, dict(built["out"][1]))
    def init_trainables(key):
        flat = traverse_util.flatten_dict(inits["init"](_jax_key(key)))
        return params_from_jax({"params": traverse_util.unflatten_dict(
            {k: np.asarray(v) for k, v in flat.items() if v is not None})})

    real_finetune = port_lp.finetune_main
    monkeypatch.setattr(port_lp, "finetune_main", lambda cfg, out, device=None: real_finetune(
        cfg, out, device=device, variables=variables, init_trainables=init_trainables))
    got = port_lp.main(["--classifier", "linear", *argv, "NAME", "tiny_port"], device="cpu")
    assert got == pytest.approx(want, abs=1e-4)


def test_eval_all_scores_each_run_and_zero_for_a_failed_one(tmp_path):
    """``eval_all`` through the port: one finite score per (dataset, shot,
    seed) from the driver, its summary read back from the logs; a run that
    raises (a CLIP ReXNet tower is not ported) scores 0, the reference's
    sweep-cell semantics, so a 0 is no proof that a run worked."""
    from peft_vit_tpu_torch.commands import eval_all

    opts = ["TRAIN.IMAGE_SIZE", "[16, 16]", "TRAIN.BATCH_SIZE_PER_GPU", "8",
            "TRAIN.END_EPOCH", "1", "TRAIN.SCHEDULE", "[]", "TRAIN.NO_TUNING", "True",
            "TRAIN.LR", "0.01", "MODEL.NAME", "clip_tiny", "MODEL.SPEC.EMBED_DIM", "32",
            "MODEL.SPEC.VISION.PATCH_SIZE", "8", "MODEL.SPEC.VISION.WIDTH", "32",
            "MODEL.SPEC.VISION.LAYERS", "1", "MODEL.SPEC.VISION.HEADS", "2",
            "DATASET.NUM_CLASSES", "4"]
    for name, refused in (("lora", []), ("refused", ["MODEL.SPEC.VISION.MODEL", "rexnet"])):
        out = tmp_path / name
        results = eval_all.main(["--datasets", "synthetic", "--shots", "4", "--seeds", "0",
                                 "--method", "lora", "--output", str(out), *opts, *refused],
                                device="cpu")
        assert list(results) == [("synthetic", 4, 0)]
        score = results["synthetic", 4, 0]
        assert (0.0 < score <= 100.0) if not refused else score == 0.0
