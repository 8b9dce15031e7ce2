"""CLIP pre-training through the port against the JAX package on the CPU, on
the tiny CLIP of the JAX package's tests/test_train_clip.py with the same
weights in both packages (``_port_dist.tiny_clip_cfg``): the one-process
step's loss and update; the gathered step (GATHER_TENSORS) on 2 gloo
processes against the JAX step on a 2-device mesh (``shard_map`` and the
differentiable ``all_gather``); ``train_clip_main``'s loss trajectory on the
synthetic pairs; the command's checkpoints and result line."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import peft_vit_tpu.commands.train_clip as jax_train_clip
import peft_vit_tpu_torch.commands.train_clip as port_train_clip
from peft_vit_tpu import config as jax_config
from peft_vit_tpu.data.tokenizer import tokenize as jax_tokenize
from peft_vit_tpu.engine import contrastive as jax_contrastive
from peft_vit_tpu.engine import optim as jax_optim
from peft_vit_tpu.models.clip import clip_from_config as jax_clip_from_config
from peft_vit_tpu.parallel import make_mesh as jax_make_mesh
from peft_vit_tpu.peft import spec_from_config as jax_spec_from_config
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.engine import contrastive
from peft_vit_tpu_torch.engine.optim import build_optimizer
from peft_vit_tpu_torch.models import load_jax_variables, params_to_jax
from peft_vit_tpu_torch.models.clip import clip_from_config
from peft_vit_tpu_torch.peft import spec_from_config

import _port_dist
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

# the same fp32 CLIP forward and backward in both frameworks, summed in other
# orders; SGD with momentum (Adam's g / sqrt(v) turns noise-level gradients
# into whole steps, so the updates are held under SGD and Adam by the losses)
TOL_STEP = dict(rtol=1e-4, atol=1e-6)
# the loss trajectory of train_clip_main under adamW at lr 5e-3: the
# parameters of both runs part by rounding, which Adam amplifies step by step
TOL_TRAJECTORY = dict(rtol=2e-3, atol=0)
SGD = {"TRAIN.OPTIMIZER": "sgd", "TRAIN.MOMENTUM": 0.9, "TRAIN.LR": 0.05, "TRAIN.WD": 1e-4}
BATCH = 8
STEPS = 2


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def setup():
    cfg = _port_dist.tiny_clip_cfg(jax_config, **SGD)
    model = jax_clip_from_config(cfg, jax_spec_from_config(cfg))
    rng = np.random.RandomState(0)
    images = rng.standard_normal((BATCH, 16, 16, 3)).astype(np.float32)
    tokens = jax_tokenize([f"a photo of a thing number {i}" for i in range(BATCH)], 16)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                 jnp.ones((1, 16), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return cfg, model, params, images, np.asarray(tokens, np.int64)


def _jax_steps(setup, mesh=None, gather=False):
    cfg, model, params, images, tokens = setup
    tx = jax_optim.build_optimizer(cfg, params, 4)
    step = jax_contrastive.make_clip_train_step(model, tx, mesh=mesh, gather=gather)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(p)
    losses = []
    for _ in range(STEPS):
        p, opt, loss = step(p, opt, jnp.asarray(images), jnp.asarray(tokens, jnp.int32))
        losses.append(float(loss))
    return losses, _flat(p)


def _check(got_losses, got_params, want_losses, want_params, start):
    np.testing.assert_allclose(got_losses, want_losses, **TOL_STEP)
    got = _flat(params_to_jax({k: torch.from_numpy(np.asarray(v))
                               for k, v in got_params.items()})["params"])
    assert set(got) == set(want_params)
    moved = 0
    for k, want in want_params.items():
        np.testing.assert_allclose(got[k], want, **TOL_STEP, err_msg=k)
        moved += not np.array_equal(want, start[k])
    assert moved == len(want_params)  # every leaf trained


def test_one_process_step_matches_jax(setup):
    """No group: the model's own logits and ``clip_contrastive_loss``; two
    SGD steps, each loss and every parameter after them."""
    cfg, _, params, images, tokens = setup
    want_losses, want_params = _jax_steps(setup)
    pcfg = _port_dist.tiny_clip_cfg(port_config, **SGD)
    model = clip_from_config(pcfg, spec_from_config(pcfg), device="cpu")
    load_jax_variables(model, {"params": params})
    p = {k: v.detach() for k, v in model.named_parameters()}
    tx = build_optimizer(pcfg, p, 4)
    step = contrastive.make_clip_train_step(model, tx)
    opt = contrastive.clip_opt_state(tx, p)
    losses = []
    for _ in range(STEPS):
        p, opt, loss = step(p, opt, torch.from_numpy(images), torch.from_numpy(tokens))
        losses.append(float(loss))
    assert int(opt["step"]) == STEPS
    _check(losses, {k: v.detach().numpy() for k, v in p.items()}, want_losses, want_params,
           _flat(params))


def test_captured_step_runs_the_eager_arithmetic(setup, monkeypatch):
    """The card's path on the CPU (``StepGraph`` stood in by
    ``test_torch_port_cells._Rerun``): the first call captures and copies the
    caller's state in, later calls hand back the graph's own buffers, and
    every step equals the eager step bit for bit (one torch thread)."""
    from peft_vit_tpu_torch.engine import train as train_engine
    from test_torch_port_cells import _Rerun

    _, _, params, images, tokens = setup
    cfg = _port_dist.tiny_clip_cfg(port_config, **SGD)
    runs = {}
    for captured in (False, True):
        if captured:
            monkeypatch.setattr(train_engine, "StepGraph", _Rerun)
            monkeypatch.setattr(train_engine, "runs_captured", lambda t: True)
        model = clip_from_config(cfg, spec_from_config(cfg), device="cpu")
        load_jax_variables(model, {"params": params})
        p = {k: v.detach() for k, v in model.named_parameters()}
        tx = build_optimizer(cfg, p, 4)
        step = contrastive.make_clip_train_step(model, tx)
        opt = contrastive.clip_opt_state(tx, p)
        losses = []
        for i in range(STEPS):
            out = step(p, opt, torch.from_numpy(images), torch.from_numpy(tokens))
            if captured and i:
                assert out[0] is p and out[1] is opt  # the graph's buffers, handed back
            p, opt, loss = out
            losses.append(loss)
        runs[captured] = (torch.stack(losses), p)
    assert torch.equal(runs[True][0], runs[False][0])
    for k, v in runs[False][1].items():
        assert torch.equal(runs[True][1][k], v), k


@pytest.fixture(scope="module")
def two_processes(setup, tmp_path_factory):
    _, _, params, images, tokens = setup
    return _port_dist.spawn(_port_dist.clip_steps, 2, tmp_path_factory.mktemp("clip"), SGD,
                            {"params": params}, images, tokens, STEPS)


@pytest.mark.parametrize("gather", [True, False])
def test_two_process_step_matches_jax(setup, two_processes, gather):
    """2 gloo processes, 4 rows each, against the JAX step on a 2-device
    mesh: with GATHER_TENSORS the ``shard_map`` over the differentiable
    all_gather, without it GSPMD's global batch; the port takes the gathered
    loss in both.  Both ranks hold the same parameters after each step."""
    _, _, params, _, _ = setup
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    want_losses, want_params = _jax_steps(setup, mesh=mesh, gather=gather)
    out = [rank[gather] for rank in two_processes]
    for rank in out:
        _check(rank["losses"], rank["params"], want_losses, want_params, _flat(params))
    for k, v in out[0]["params"].items():
        np.testing.assert_array_equal(out[1]["params"][k], v, err_msg=k)


def _record_steps(module, name, rec):
    real = module.make_clip_train_step

    def spy(*a, **kw):
        step = real(*a, **kw)

        def recorded(params, opt, images, tokens):
            if "params" not in rec:
                rec["params"] = jax.tree_util.tree_map(np.asarray, params)
            out = step(params, opt, images, tokens)
            rec.setdefault(name, []).append(float(out[2]))
            return out

        return recorded

    return spy


def test_train_clip_main_trajectory_matches_jax(monkeypatch):
    """``train_clip_main`` on the synthetic pairs (64 pairs, 8 a step, 1
    epoch of adamW at lr 5e-3, RandomState(0)'s order), the JAX command on
    one device: every step's loss, the port given the JAX init through its
    ``variables`` seam; the returned loss is the last one read."""
    rec = {}
    monkeypatch.setattr(jax, "device_count", lambda: 1)  # the one-process path, as the port's
    monkeypatch.setattr(jax_train_clip, "make_clip_train_step",
                        _record_steps(jax_train_clip, "jax", rec))
    monkeypatch.setattr(port_train_clip, "make_clip_train_step",
                        _record_steps(port_train_clip, "port", rec))
    over = {"TRAIN.END_EPOCH": 1}
    want = jax_train_clip.train_clip_main(_port_dist.tiny_clip_cfg(jax_config, **over))
    got = port_train_clip.train_clip_main(_port_dist.tiny_clip_cfg(port_config, **over),
                                          device="cpu", variables={"params": rec["params"]})
    assert len(rec["port"]) == len(rec["jax"]) == 8
    np.testing.assert_allclose(rec["port"], rec["jax"], **TOL_TRAJECTORY)
    assert got == rec["port"][-1] and np.isfinite(got)
    assert got == pytest.approx(want, rel=TOL_TRAJECTORY["rtol"])
    assert rec["port"][-1] < rec["port"][0]


def test_main_writes_checkpoints_and_the_result_line(tmp_path):
    """The command line through ``main``: one checkpoint an epoch under
    ``OUTPUT_DIR/clip_checkpoints`` (the main process's), the result line
    last in the rank-0 log."""
    argv = ["TRAIN.IMAGE_SIZE", "[16, 16]", "TRAIN.BATCH_SIZE_PER_GPU", "16",
            "TRAIN.END_EPOCH", "2", "MODEL.NAME", "clip_tiny", "MODEL.SPEC.EMBED_DIM", "32",
            "MODEL.SPEC.VISION.PATCH_SIZE", "8", "MODEL.SPEC.VISION.WIDTH", "32",
            "MODEL.SPEC.VISION.LAYERS", "1", "MODEL.SPEC.VISION.HEADS", "2",
            "MODEL.SPEC.TEXT.WIDTH", "32", "MODEL.SPEC.TEXT.LAYERS", "1",
            "MODEL.SPEC.TEXT.HEADS", "2", "MODEL.SPEC.TEXT.CONTEXT_LENGTH", "16",
            "DATASET.NUM_CLASSES", "2", "TRAIN.OPTIMIZER", "adamW",
            "OUTPUT_DIR", str(tmp_path)]
    loss = port_train_clip.main(argv, device="cpu")
    assert np.isfinite(loss)
    assert sorted(p.name for p in (tmp_path / "clip_checkpoints").iterdir()) == ["0.pt", "1.pt"]
    saved = torch.load(tmp_path / "clip_checkpoints" / "1.pt", weights_only=True)
    assert saved["epoch"] == 1 and "logit_scale" in saved["params"]
    (log,) = tmp_path.glob("*/train_clip/train_clip_*_rank0.txt")
    assert log.read_text().splitlines()[-1].endswith(f"=> TEST clip_loss: {loss:.3f}%")
