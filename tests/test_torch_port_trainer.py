"""The port's full-shot trainer (``peft_vit_tpu_torch/engine/trainer.py``)
against the JAX ``Trainer`` on the JAX trainer tests' fixtures (the timm
ViT at 16 px, patch 8, width 32, 2 layers; the synthetic 4-way data), and
its own guarantees: resume and mid-epoch resume equal to the uninterrupted
run bit for bit, the NaN guard, SIGTERM, chunked steps, the uint8 path, the
BN head, the int8 static recipe's recalibration, the captured path's Python
(``test_torch_port_cells._Rerun``).

Tolerances against JAX: per-epoch mean losses within 1e-5 relative, the
final leaves within 1e-5 relative + 1e-6 (a few dozen fp32 steps of the same
arithmetic in another summation order), eval top-1 equal, the rates within
1e-6 relative.
"""

import itertools
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from peft_vit_tpu.config import get_default_config as jax_config
from peft_vit_tpu.data import synthetic_dataset
from peft_vit_tpu.engine.trainer import Trainer as JaxTrainer
from peft_vit_tpu.engine.trainer import batch_iterator as jax_batches
from peft_vit_tpu.models import ImageClassifier as JaxClassifier
from peft_vit_tpu.models import VisionTransformer as JaxViT
from peft_vit_tpu.peft import build_mask as jax_mask
from peft_vit_tpu_torch.config import get_default_config as port_config
from peft_vit_tpu_torch.engine import trainer as port_trainer
from peft_vit_tpu_torch.engine.checkpoint import checkpoint_keys, latest_step, save_checkpoint
from peft_vit_tpu_torch.engine.trainer import PreemptedError, Trainer, _chunk_batches
from peft_vit_tpu_torch.engine.trainer import _skip_batches, batch_iterator
from peft_vit_tpu_torch.models import ImageClassifier, load_jax_variables
from peft_vit_tpu_torch.models.classifier import ClassifierHead
from peft_vit_tpu_torch.models.convert import params_to_jax
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.peft import build_mask
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)


def make_cfg(factory=port_config, **over):
    cfg = factory()
    cfg.DATASET.DATASET = "synthetic"
    cfg.DATASET.NUM_CLASSES = 4
    cfg.MODEL.NUM_CLASSES = 4
    cfg.TRAIN.IMAGE_SIZE = [16, 16]
    cfg.TRAIN.BATCH_SIZE_PER_GPU = 8
    cfg.TRAIN.END_EPOCH = 2
    cfg.TRAIN.LR = 0.01
    cfg.TRAIN.LR_SCHEDULER.METHOD = "warmupcosine"
    cfg.TRAIN.LR_SCHEDULER.WARMUP_EPOCH = 1
    cfg.PRINT_FREQ = 1
    for k, v in over.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    return cfg


_JAX = {}


def jax_params():
    """The JAX trainer tests' model and its init (PRNGKey(0))."""
    if not _JAX:
        model = JaxClassifier(backbone=JaxViT(image_size=16, patch_size=8, width=32, layers=2,
                                              heads=2, style="timm", use_flash=False),
                              num_classes=4)
        _JAX["model"] = model
        _JAX["params"] = jax.device_get(
            model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    return _JAX["model"], _JAX["params"]


def make_trainer(cfg, method="full", steps_per_epoch=8, seed=0):
    """The port's model with the JAX init loaded, and its Trainer."""
    _, params = jax_params()
    model = ImageClassifier(VisionTransformer(image_size=16, patch_size=8, width=32, layers=2,
                                              heads=2, style="timm", device="cpu"),
                            num_classes=4, device="cpu")
    load_jax_variables(model, {"params": params})
    return Trainer(cfg, model, build_mask(model, method, num_layers=2), steps_per_epoch, seed)


def _data(n_per_class=16, uint8=False):
    x, y = synthetic_dataset(4, n_per_class, 16)
    return (x if uint8 else x.astype(np.float32) / 255.0), y


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _port_flat(state, collection="params"):
    return _flat(params_to_jax(state)[collection])


CASES = {
    "full_sgd_ema_swa": ({"TRAIN.EMA_DECAY": 0.9, "SWA.ENABLED": True, "SWA.BEGIN_EPOCH": 1,
                          "TRAIN.CLIP_GRAD_NORM": 1.0, "TRAIN.MOMENTUM": 0.9,
                          "TRAIN.NESTEROV": True, "TRAIN.WD": 1e-4}, "full"),
    # not bitfit: the key bias's gradient is zero up to rounding (softmax
    # ignores a per-row constant), and Adam turns that noise into whole steps
    "layernorm_adamw_two_lr": ({"TRAIN.OPTIMIZER": "adamw", "TRAIN.WD": 0.05,
                                "TRAIN.TWO_LR": True, "TRAIN.LR": 1e-3,
                                "TRAIN.LR_SCHEDULER.METHOD": "cosine",
                                "LOSS.LOSS": "softmax_smooth", "LOSS.LABEL_SMOOTHING": 0.1},
                               "layernorm"),
    "full_sgd_uint8": ({"TRAIN.MOMENTUM": 0.0, "AUG.RANDOM_FLIP": False,
                        "TRAIN.LR_SCHEDULER.METHOD": "multistep", "TRAIN.SCHEDULE": [1]},
                       "full"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trainer_matches_the_jax_trainer(case):
    """Two epochs: the per-epoch mean losses, the eval top-1 (raw and EMA),
    the rate at each epoch's end, the final leaves and, with SWA, the
    average and its count."""
    over, method = CASES[case]
    uint8 = "uint8" in case
    x, y = _data(uint8=uint8)
    jmodel, params = jax_params()
    jt = JaxTrainer(make_cfg(jax_config, **over), jmodel, params,
                    jax_mask(params, method, num_layers=2), steps_per_epoch=8)
    pt = make_trainer(make_cfg(**over), method)
    for e in range(2):
        want = jt.train_one_epoch(jax_batches(x, y, 8, seed=e), epoch=e)["loss"]
        got = pt.train_one_epoch(batch_iterator(x, y, 8, seed=e), epoch=e)["loss"]
        assert got == pytest.approx(want, rel=1e-5)
        assert float(pt.schedule(pt.state.step)) == pytest.approx(
            float(jt.schedule(jt.state.step)), rel=1e-6)
    evals = [{"use_ema": False}] + ([{"use_ema": True}] if pt.state.ema else []) + (
        [{"use_swa": True}] if pt.state.swa else [])
    for kw in evals:
        assert pt.evaluate(batch_iterator(x, y, 8, shuffle=False, drop_last=False), **kw) == \
            jt.evaluate(jax_batches(x, y, 8, shuffle=False, drop_last=False), **kw)
    want = _flat(jt.state.trainable)
    for k, v in _port_flat(pt.state.trainable).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    if pt.state.swa is not None:
        assert int(pt.state.swa.count) == int(jt.state.swa.count) == 8
        want = _flat(jt.state.swa.average)
        for k, v in _port_flat(pt.state.swa.average).items():
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_mixup_owns_label_smoothing_as_in_jax():
    from peft_vit_tpu_torch.engine.loss import soft_target_cross_entropy

    mixed = make_trainer(make_cfg(**{"AUG.MIXUP": 0.2, "LOSS.LOSS": "softmax",
                                     "LOSS.LABEL_SMOOTHING": 0.1}))
    assert mixed.criterion is soft_target_cross_entropy
    assert mixed.mixup_alpha == 0.2 and mixed.cutmix_alpha == 1.0
    only_cut = make_trainer(make_cfg(**{"AUG.MIXCUT": 0.5}))
    # the JAX quirk: mixup's alpha is AUG.MIXUP or 0.2 when only MIXCUT is set
    assert only_cut.use_mixup and only_cut.mixup_alpha == 0.2 and only_cut.cutmix_alpha == 0.5
    plain = make_trainer(make_cfg(**{"LOSS.LOSS": "softmax", "LOSS.LABEL_SMOOTHING": 0.1}))
    assert plain.criterion is not soft_target_cross_entropy


def test_mixup_draws_follow_the_generator():
    """Two trainers of one seed draw alike and land alike; another seed
    draws otherwise."""
    cfg = make_cfg(**{"AUG.MIXUP": 0.8, "AUG.MIXCUT": 1.0})
    x, y = _data()
    a, b, c = make_trainer(cfg), make_trainer(cfg), make_trainer(cfg, seed=1)
    for e in range(2):
        losses = [t.train_one_epoch(batch_iterator(x, y, 8, seed=e), e)["loss"]
                  for t in (a, b, c)]
        assert np.isfinite(losses).all() and losses[0] == losses[1] != losses[2]
    _equal(a, b)


@pytest.mark.parametrize("k", [2, 4])
def test_chunked_steps_equal_single_steps(k):
    """TPU.STEPS_PER_DISPATCH = K: K steps of the one-step function a chunk,
    bit for bit the single steps (mixup's draws included), the step counter
    at the batch count."""
    over = {"AUG.MIXUP": 0.8, "AUG.MIXCUT": 1.0, "TRAIN.EMA_DECAY": 0.9}
    x, y = _data()
    single = make_trainer(make_cfg(**over))
    chunked = make_trainer(make_cfg(**over, **{"TPU.STEPS_PER_DISPATCH": k}))
    single.train_one_epoch(batch_iterator(x, y, 8, seed=0), 0)
    chunked.train_one_epoch(batch_iterator(x, y, 8, seed=0), 0)
    assert int(chunked.state.step) == 8
    for a, b in zip(single.state.trainable.values(), chunked.state.trainable.values()):
        assert torch.equal(a, b)


def test_chunk_and_skip_batches_as_in_jax():
    bs = [(np.zeros((8, 4)), np.zeros((8,))) for _ in range(7)] + [
        (np.zeros((5, 4)), np.zeros((5,)))]
    out = list(_chunk_batches(iter(bs), 3))
    assert [o[0].shape for o in out] == [(3, 8, 4), (3, 8, 4), (8, 4), (5, 4)]
    assert [len(o) for o in out] == [3, 3, 2, 2]
    raw = [(np.zeros((8, 1)), np.zeros(8))] * 6
    assert len(list(_skip_batches(iter(raw), 4))) == 2
    chunks = [(np.zeros((2, 8, 1)), np.zeros((2, 8)), True)] * 3
    assert len(list(_skip_batches(iter(chunks), 4))) == 1
    assert list(_skip_batches(iter(raw), 99)) == []


def test_nan_guard_raises_and_dumps(tmp_path):
    cfg = make_cfg(**{"TRAIN.LR": 1e12, "OUTPUT_DIR": str(tmp_path), "PRINT_FREQ": 8,
                      "TPU.STEPS_PER_DISPATCH": 4})
    x, y = _data()
    x = x * 1e6
    trainer = make_trainer(cfg)
    with pytest.raises(FloatingPointError):
        for e in range(5):
            trainer.train_one_epoch(batch_iterator(x, y, 8, seed=e), epoch=e)
    dumps = list(tmp_path.glob("nan_dump_*.npz"))
    assert dumps
    blob = np.load(dumps[0])
    assert blob["x"].shape[-3:] == (16, 16, 3) and blob["y"].shape[-1] == 8


def _leaves(t):
    return list(t.state.trainable.values())


def _equal(a, b):
    for u, v in zip(_leaves(a), _leaves(b)):
        assert torch.equal(u, v)


@pytest.mark.parametrize("k_disp", [1, 2])
def test_midepoch_resume_equals_uninterrupted(k_disp, tmp_path):
    """A run stopped after 4 of 8 batches (its checkpoint at 4) and a fresh
    Trainer resumed there equal the uninterrupted run bit for bit (the
    generator's mixup draws, the momentum and the EMA ride the checkpoint)."""
    over = {"TRAIN.CHECKPOINT_EVERY_STEPS": 4, "TPU.STEPS_PER_DISPATCH": k_disp,
            "AUG.MIXUP": 0.8, "AUG.MIXCUT": 1.0, "TRAIN.EMA_DECAY": 0.9,
            "TRAIN.MOMENTUM": 0.9, "TRAIN.END_EPOCH": 1, "TRAIN.LR_SCHEDULER.METHOD": "constant"}
    x, y = _data()
    d = str(tmp_path / "ckpt")
    ref = make_trainer(make_cfg(**over), "bitfit")
    ref.train_one_epoch(batch_iterator(x, y, 8, seed=0), epoch=0)
    pre = make_trainer(make_cfg(**over), "bitfit")
    pre.train_one_epoch(itertools.islice(batch_iterator(x, y, 8, seed=0), 4), epoch=0,
                        checkpoint_dir=d)
    res = make_trainer(make_cfg(**over), "bitfit")
    assert res.maybe_resume(d) == 0 and res.resume_batch_in_epoch == 4
    res.train_one_epoch(_skip_batches(batch_iterator(x, y, 8, seed=0), 4), epoch=0,
                        start_batch=4)
    _equal(ref, res)
    for a, b in zip(ref.state.ema.shadow.values(), res.state.ema.shadow.values()):
        assert torch.equal(a, b)


def test_fit_resumes_midepoch_end_to_end(tmp_path):
    cfg = make_cfg(**{"TRAIN.CHECKPOINT_EVERY_STEPS": 2, "AUG.MIXUP": 0.8,
                      "TRAIN.AUTO_RESUME": True})
    x, y = _data()
    d = str(tmp_path / "ckpt")

    def full_epoch(e, skip=None):
        it = batch_iterator(x, y, 8, seed=e)
        return it if skip is None else _skip_batches(it, skip)

    def eval_batches():
        return batch_iterator(x, y, 8, shuffle=False, drop_last=False)

    ref = make_trainer(cfg)
    ref.fit(full_epoch, eval_batches)

    class Crash(Exception):
        pass

    def crashing(e):
        for j, b in enumerate(batch_iterator(x, y, 8, seed=e)):
            if j == 5:
                raise Crash()
            yield b

    with pytest.raises(Crash):
        make_trainer(cfg).fit(crashing, eval_batches, checkpoint_dir=d)
    assert latest_step(d) == 4
    res = make_trainer(cfg)
    res.fit(full_epoch, eval_batches, checkpoint_dir=d)
    _equal(ref, res)
    assert sorted(int(f[:-3]) for f in os.listdir(d) if f.endswith(".pt")) == [12, 14, 16]


def test_resume_checkpoint_without_new_keys(tmp_path):
    cfg = make_cfg(**{"TRAIN.AUTO_RESUME": True})
    x, y = _data()
    tr = make_trainer(cfg, "bitfit")
    tr.train_one_epoch(batch_iterator(x, y, 8, seed=0), epoch=0)
    d = str(tmp_path / "old")
    state = tr._ckpt_state(epoch=0)
    del state["rng"], state["batch_in_epoch"]  # the layout from before those keys
    save_checkpoint(d, 0, state)
    assert "rng" not in checkpoint_keys(d)
    tr2 = make_trainer(cfg, "bitfit")
    assert tr2.maybe_resume(d) == 0 and tr2.resume_batch_in_epoch == 0
    _equal(tr, tr2)


def test_sigterm_checkpoints_and_resume_matches(tmp_path):
    cfg = make_cfg(**{"TRAIN.CHECKPOINT_EVERY_STEPS": 100, "TRAIN.AUTO_RESUME": True,
                      "AUG.MIXUP": 0.8, "TRAIN.END_EPOCH": 1})
    x, y = _data()
    d = str(tmp_path / "ckpt")
    ref = make_trainer(cfg)
    ref.fit(lambda e: batch_iterator(x, y, 8, seed=e),
            lambda: batch_iterator(x, y, 8, shuffle=False, drop_last=False))

    def preempting(e, skip=None):
        it = batch_iterator(x, y, 8, seed=e)
        if skip:
            yield from _skip_batches(it, skip)
            return
        for j, b in enumerate(it):
            if j == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    prior = signal.getsignal(signal.SIGTERM)
    with pytest.raises(PreemptedError, match="checkpointed"):
        make_trainer(cfg).fit(preempting, lambda: iter(()), checkpoint_dir=d)
    assert signal.getsignal(signal.SIGTERM) is prior
    res = make_trainer(cfg)
    res.fit(preempting, lambda: batch_iterator(x, y, 8, shuffle=False, drop_last=False),
            checkpoint_dir=d)
    _equal(ref, res)


def test_main_exits_75_on_preemption(monkeypatch, tmp_path):
    from peft_vit_tpu_torch.commands import train as train_cmd

    def preempted(cfg, **kw):
        raise PreemptedError("boom")

    monkeypatch.setattr(train_cmd, "train_main", preempted)
    with pytest.raises(SystemExit) as e:
        train_cmd.main(["OUTPUT_DIR", str(tmp_path)], device="cpu")
    assert e.value.code == 75


def test_uint8_path_flips_normalizes_and_learns():
    cfg = make_cfg(**{"TRAIN.END_EPOCH": 6, "TRAIN.LR": 0.05})
    xu, y = _data(uint8=True)
    trainer = make_trainer(cfg)
    mean = np.asarray(cfg.INPUT.MEAN, np.float32) * 255.0
    std = np.asarray(cfg.INPUT.STD, np.float32) * 255.0
    xf = (xu.astype(np.float32) - mean) / std
    lu = trainer.eval_logits(trainer.state.trainable, xu[:8])
    lf = trainer.eval_logits(trainer.state.trainable, xf[:8])
    np.testing.assert_allclose(lu.numpy(), lf.numpy(), atol=1e-5)
    flip = torch.tensor([True, False] * 4)
    got = trainer._normalize(torch.from_numpy(xu[:8]), flip).numpy()
    want = np.where(flip.numpy()[:, None, None, None], xf[:8, :, ::-1], xf[:8])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    s0 = trainer.train_one_epoch(batch_iterator(xu, y, 8, seed=0), epoch=0)
    for e in range(1, 6):
        stats = trainer.train_one_epoch(batch_iterator(xu, y, 8, seed=e), epoch=e)
    assert stats["loss"] < s0["loss"]
    assert trainer.evaluate(batch_iterator(xu, y, 8, shuffle=False, drop_last=False)) > 30.0


def _bn_head(factory):
    """The JAX test's BN-bearing model: a ClassifierHead with channel BN over
    8-dim features, its init from the JAX module."""
    from peft_vit_tpu.models.classifier import ClassifierHead as JaxHead

    jmodel = JaxHead(3, use_bn=True)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8))))
    model = ClassifierHead(8, 3, use_bn=True, device="cpu")
    load_jax_variables(model, variables)
    return jmodel, variables, model


def test_bn_head_trains_resumes_and_update_bn_as_in_jax(tmp_path):
    cfg, jcfg = make_cfg(**{"TRAIN.AUTO_RESUME": True}), make_cfg(jax_config)
    jmodel, variables, model = _bn_head(jax_config)
    rng = np.random.RandomState(0)
    x = rng.randn(32, 8).astype(np.float32)
    y = rng.randint(0, 3, 32)
    jt = JaxTrainer(jcfg, jmodel, variables["params"],
                    jax_mask(variables["params"], "full", num_layers=0), 4,
                    batch_stats=variables["batch_stats"])
    a = Trainer(cfg, model, build_mask(model, "full", num_layers=0), 4)
    for e in (0, 1):
        jt.train_one_epoch(jax_batches(x, y, 8, seed=e), epoch=e)
        a.train_one_epoch(batch_iterator(x, y, 8, seed=e), epoch=e)
    want = _flat(jt.state.batch_stats)
    for k, v in _port_flat(a.state.batch_stats, "batch_stats").items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # the statistics round-trip a checkpoint: a resumed run continues exactly
    b = Trainer(cfg, model, build_mask(model, "full", num_layers=0), 4)
    b.train_one_epoch(batch_iterator(x, y, 8, seed=0), epoch=0)
    d = str(tmp_path / "ckpt")
    b.save(d, epoch=0)
    c = Trainer(cfg, model, build_mask(model, "full", num_layers=0), 4)
    assert c.maybe_resume(d) == 0
    c.train_one_epoch(batch_iterator(x, y, 8, seed=1), epoch=1)
    for k in a.state.batch_stats:
        assert torch.equal(a.state.batch_stats[k], c.state.batch_stats[k])
    # update_bn: the equal-weight average of the batch statistics (the
    # unbiased variance, as torch's BN blends it)
    xb = 3.0 + 2.0 * np.random.RandomState(1).randn(24, 8).astype(np.float32)
    batches = list(batch_iterator(xb, y[:24], 8, shuffle=False))
    stats = a.update_bn(iter(batches))
    means = np.stack([bx.mean(0) for bx, _ in batches]).mean(0)
    variances = np.stack([bx.var(0, ddof=1) for bx, _ in batches]).mean(0)
    mean = next(v for k, v in stats.items() if k.endswith("bn_mean"))
    var = next(v for k, v in stats.items() if k.endswith("bn_var"))
    np.testing.assert_allclose(mean.numpy(), means, rtol=1e-4)
    np.testing.assert_allclose(var.numpy(), variances, rtol=1e-4)
    jstats = _flat(jt.update_bn(iter(batches)))
    for k, v in _port_flat(stats, "batch_stats").items():
        np.testing.assert_allclose(v, jstats[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_swa_fit_refreshes_bn_and_writes_tensorboard(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    cfg = make_cfg(**{"SWA.ENABLED": True, "SWA.BEGIN_EPOCH": 0, "TRAIN.END_EPOCH": 2,
                      "TRAIN.LR_SCHEDULER.METHOD": "swalr", "TRAIN.EMA_DECAY": 0.5})
    _, _, model = _bn_head(jax_config)
    trainer = Trainer(cfg, model, build_mask(model, "full", num_layers=0), 4)
    rng = np.random.RandomState(2)
    x = rng.randn(32, 8).astype(np.float32)
    y = rng.randint(0, 3, 32)
    before = {k: v.clone() for k, v in trainer.state.batch_stats.items()}
    tb_dir = str(tmp_path / "tb_log")
    best = trainer.fit(lambda e: batch_iterator(x, y, 8, seed=e),
                       lambda: batch_iterator(x, y, 8, shuffle=False), tb_log_dir=tb_dir)
    assert np.isfinite(best) and int(trainer.state.swa.count) == 8
    assert any(not torch.allclose(before[k], v) for k, v in trainer.state.batch_stats.items())
    acc = EventAccumulator(tb_dir)
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"train_loss", "valid_top1", "valid_top1_ema", "valid_top1_swa", "lr"} <= tags
    assert len(acc.Scalars("train_loss")) == 2


def test_int8_static_recipe_recalibrates_every_epoch():
    """TPU.INT8_FWD_TRAIN + INT8_STATIC_ACT: the frozen tree quantized once
    (before the cast), the static scales calibrated on each epoch's first
    batch, one scale a frozen GEMM, and they move as the trained leaves do."""
    cfg = make_cfg(**{"TPU.INT8_FWD_TRAIN": True, "TPU.INT8_STATIC_ACT": True,
                      "TPU.INT8_BWD_DX": True, "TRAIN.LR": 0.05, "TRAIN.END_EPOCH": 3})
    _, params = jax_params()
    model = ImageClassifier(VisionTransformer(image_size=16, patch_size=8, width=32, layers=2,
                                              heads=2, style="timm", int8_train=True,
                                              device="cpu"), num_classes=4, device="cpu")
    load_jax_variables(model, {"params": params})
    trainer = Trainer(cfg, model, build_mask(model, "bitfit", num_layers=2), 8)
    assert len([k for k in trainer.qtree if k.endswith(".w_i8")]) == 8
    assert len([k for k in trainer.qtree if k.endswith(".wt_i8")]) == 8
    x, y = _data()
    scales = []
    for e in range(3):
        stats = trainer.train_one_epoch(batch_iterator(x, y, 8, seed=e), e)
        assert np.isfinite(stats["loss"])
        scales.append({k: v.clone() for k, v in trainer._qscale.items()})
    assert len(scales[0]) == 8 and all(k.endswith(".s_x") for k in scales[0])
    assert any(not torch.equal(scales[0][k], scales[2][k]) for k in scales[0])
    assert trainer.evaluate(batch_iterator(x, y, 8, shuffle=False)) >= 0.0


def test_refusals_name_their_roadmap_items():
    from peft_vit_tpu_torch.parallel.mesh import Mesh

    # TPU.ZERO1 and a mesh of several processes build (the multi-process
    # Trainer: tests/test_torch_port_trainer_dist.py); ZERO1 without a mesh
    # is inert, as in the JAX trainer
    assert not make_trainer(make_cfg(**{"TPU.ZERO1": True})).zero1
    tr = make_trainer(make_cfg(**{"TPU.MESH.PIPE": 2}))
    port_trainer.check_mesh(make_cfg(), tr.model, Mesh(2, rank=1), False)
    # TPU.MESH.PIPE without a group is inert, as the JAX trainer without a
    # mesh (GPipe over a group: tests/test_torch_port_pipeline.py); a model
    # degree runs only with sequence parallelism (test_torch_port_seqpar.py),
    # and without it still raises: no JAX trainer runs one
    assert tr.mesh is None and tr.pipe == 1
    port_trainer.check_mesh(make_cfg(**{"TPU.SEQUENCE_PARALLEL": True}), tr.model,
                            Mesh(1, model=2), False)
    with pytest.raises(NotImplementedError,
                       match=r"model degree of 2 in the Trainer without TPU\.SEQUENCE_PARALLEL"):
        port_trainer.check_mesh(make_cfg(), tr.model, Mesh(1, model=2), False)
    # DropBlock stays refused on a ViT and builds on a ResNet (the JAX guard)
    with pytest.raises(ValueError, match="requires a ResNet"):
        make_trainer(make_cfg(**{"AUG.DROPBLOCK_KEEP_PROB": 0.9}))
    rn = _rn_trainer(make_cfg(**DROPBLOCK))
    assert rn.use_dropblock and rn.drop_generator is not None
    # AUG.TIMM_AUG is no longer refused: the device-side augmentation runs
    # inside the step on the raw batch (tests/test_torch_port_augment.py
    # holds it against JAX)
    timm = make_trainer(make_cfg(**{"AUG.TIMM_AUG.USE_TRANSFORM": True,
                                    "AUG.TIMM_AUG.RE_PROB": 0.25}))
    assert (timm.transform.num_ops, timm.transform.magnitude) == (2, 9.0)
    x, y = _data(n_per_class=2, uint8=True)
    loss, _ = timm.train_step(x, y, 0)
    assert np.isfinite(float(loss)) and timm.noise_generator is not None


def test_captured_path_equals_eager(monkeypatch):
    """The captured path's Python on the CPU (the StepGraph stand-in of
    ``test_torch_port_cells``): the state lives in the graph's buffers, a
    replay copies in the batch and its draws, a second shape (the ragged
    last batch) has its own graph, a resume copies the state back in; the
    run equals the eager one bit for bit."""
    from test_torch_port_cells import _Rerun

    over = {"AUG.MIXUP": 0.8, "AUG.MIXCUT": 1.0, "TRAIN.EMA_DECAY": 0.9,
            "SWA.ENABLED": True, "SWA.BEGIN_EPOCH": 1}
    x, y = _data(n_per_class=15)  # 60 images: 7 batches of 8 and one of 4
    eager = make_trainer(make_cfg(**over))
    for e in range(2):
        eager.train_one_epoch(batch_iterator(x, y, 8, seed=e, drop_last=False), e)
    monkeypatch.setattr(port_trainer._train, "StepGraph", _Rerun)
    monkeypatch.setattr(port_trainer._train, "runs_captured", lambda t: True)
    captured = make_trainer(make_cfg(**over))
    for e in range(2):
        captured.train_one_epoch(batch_iterator(x, y, 8, seed=e, drop_last=False), e)
    trains = [g for key, g in captured.graphs.items() if key[0] == "train"]
    assert len(trains) == 2 and sum(g.replays for g in trains) == 16
    _equal(eager, captured)
    for part in ("ema",):
        for a, b in zip(eager.state.ema.shadow.values(), captured.state.ema.shadow.values()):
            assert torch.equal(a, b)
    assert int(captured.state.swa.count) == int(eager.state.swa.count) == 8
    kw = dict(shuffle=False, drop_last=False)
    assert captured.evaluate(batch_iterator(x, y, 8, **kw), use_ema=True) == \
        eager.evaluate(batch_iterator(x, y, 8, **kw), use_ema=True)
    assert captured.evaluate(batch_iterator(x, y, 8, **kw)) == \
        eager.evaluate(batch_iterator(x, y, 8, **kw))


# -- the ResNet family: the executed reference's epoch, DropBlock, update_bn ----------

RN_IMAGE = 64
# DropBlock on stages 3 and 4 at block 3: stage 3's 4 x 4 maps take the
# min-pool branch, stage 4's 2 x 2 the whole-map one
DROPBLOCK = {"AUG.DROPBLOCK_KEEP_PROB": 0.8, "AUG.DROPBLOCK_LAYERS": [3, 4],
             "AUG.DROPBLOCK_BLOCK_SIZE": 3, "TRAIN.IMAGE_SIZE": [RN_IMAGE, RN_IMAGE],
             "TRAIN.WD": 1e-4, "TRAIN.MOMENTUM": 0.9, "TRAIN.LR": 1e-5}
RN_KW = dict(layers=(1, 1, 1, 1), width=8, dropblock_stages=(3, 4), dropblock_keep_prob=0.8,
             dropblock_block_size=3)
_RN = {}


def _rn_jax():
    """The tiny DropBlock ResNet's JAX classifier and its variables (the
    flax init, PRNGKey(0))."""
    from peft_vit_tpu.models.resnet import ResNet as JaxResNet

    if not _RN:
        model = JaxClassifier(backbone=JaxResNet(**RN_KW), num_classes=4)
        _RN["model"] = model
        _RN["variables"] = jax.device_get(dict(jax.jit(model.init)(
            jax.random.PRNGKey(0), jnp.zeros((1, RN_IMAGE, RN_IMAGE, 3)))))
    return _RN["model"], _RN["variables"]


def _rn_trainer(cfg, seed=0):
    from peft_vit_tpu_torch.models.resnet import ResNet

    _, variables = _rn_jax()
    model = ImageClassifier(ResNet(**RN_KW, device="cpu"), num_classes=4, device="cpu")
    load_jax_variables(model, variables)
    return Trainer(cfg, model, build_mask(model, "full", num_layers=0), 4, seed)


def _rn_data():
    x, y = synthetic_dataset(4, 8, RN_IMAGE)
    return x.astype(np.float32) / 255.0, y


def _noise(kp, shape):
    """The DropBlock noise both packages are fed: uniform [0, 1) from a
    RandomState keyed by the keep probability's fp32 bits and the NHWC
    shape (sites of one shape in one step share a draw, in both)."""
    import zlib

    key = zlib.crc32(np.float32(kp).tobytes() + np.asarray(shape, np.int64).tobytes())
    return np.random.RandomState(key).random_sample(tuple(shape)).astype(np.float32)


@pytest.fixture
def shared_dropblock_noise(monkeypatch):
    """DropBlock's uniform draw from ``_noise`` in both packages: the port's
    ``drop_block`` given it as ``noise`` (NCHW), the JAX op's
    ``jax.random.uniform`` answered by a ``pure_callback`` of it (NHWC), so
    that the JAX op's own mask arithmetic runs on it."""
    import peft_vit_tpu.models.resnet as jax_resnet_module
    import peft_vit_tpu.ops.dropblock as jax_dropblock
    import peft_vit_tpu_torch.models.resnet as port_resnet_module
    from peft_vit_tpu_torch.ops.dropblock import drop_block as port_drop_block

    real_jax_db = jax_dropblock.drop_block
    current = {}

    class _Random:
        @staticmethod
        def uniform(rng, shape, dtype):
            return jax.pure_callback(lambda kp: _noise(float(kp), shape),
                                     jax.ShapeDtypeStruct(tuple(shape), jnp.float32),
                                     current["kp"])

    class _Jax:
        random = _Random

        def __getattr__(self, name):
            return getattr(jax, name)

    def jax_db(x, rng, *, block_size, keep_prob):
        current["kp"] = jnp.asarray(keep_prob, jnp.float32)
        return real_jax_db(x, rng, block_size=block_size, keep_prob=keep_prob)

    def port_db(x, *, block_size, keep_prob, generator=None, noise=None):
        n, c, h, w = x.shape
        u = _noise(float(keep_prob), (n, h, w, c)).transpose(0, 3, 1, 2)
        return port_drop_block(x, block_size=block_size, keep_prob=keep_prob,
                               noise=torch.from_numpy(np.ascontiguousarray(u)))

    monkeypatch.setattr(jax_dropblock, "jax", _Jax())
    monkeypatch.setattr(jax_resnet_module, "drop_block", jax_db)
    monkeypatch.setattr(port_resnet_module, "drop_block", port_db)


def test_dropblock_epochs_and_update_bn_match_the_jax_trainer(shared_dropblock_noise):
    """A tiny v1 ResNet with DropBlock on stages 3 and 4 (both branches), its
    BatchNorm live, the full fine-tune: two epochs against the JAX Trainer
    fed the same draws (the anneal's position step / total steps), then
    ``update_bn`` (DropBlock live, at the target keep probability).  At lr
    1e-5: train-mode BN at batch 8 makes the run chaotic, and the two
    packages' variances round otherwise (flax's one pass, the port's two), so
    at 1e-4 two runs part by 3e-4 within two epochs.  Per-epoch losses within
    1e-4 relative, the final leaves within 1e-4 relative + 1e-5, every BN
    statistic within 1e-4 of its tensor's largest value (``update_bn``
    divides the batch statistic by 1 - momentum = 0.1, which scales the
    rounding by 10), eval top-1 equal."""
    over = dict(DROPBLOCK)
    x, y = _rn_data()
    jmodel, variables = _rn_jax()
    jt = JaxTrainer(make_cfg(jax_config, **over), jmodel, variables["params"],
                    jax_mask(variables["params"], "full", num_layers=0), steps_per_epoch=4,
                    batch_stats=variables["batch_stats"])
    pt = _rn_trainer(make_cfg(**over))
    for e in range(2):
        want = jt.train_one_epoch(jax_batches(x, y, 8, seed=e), epoch=e)["loss"]
        got = pt.train_one_epoch(batch_iterator(x, y, 8, seed=e), epoch=e)["loss"]
        assert got == pytest.approx(want, rel=1e-4)
    want = _flat(jt.state.trainable)
    for k, v in _port_flat(pt.state.trainable).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    want = _flat(jt.state.batch_stats)
    for k, v in _port_flat(pt.state.batch_stats, "batch_stats").items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)
    kw = dict(shuffle=False, drop_last=False)
    assert pt.evaluate(batch_iterator(x, y, 8, **kw)) == jt.evaluate(jax_batches(x, y, 8, **kw))
    batches = list(batch_iterator(x, y, 8, shuffle=False))
    got = _port_flat(pt.update_bn(iter(batches)), "batch_stats")
    want = _flat(jt.update_bn(iter(batches)))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_refexec_resnet_epoch():
    """The ResNet leg of the executed reference's epoch loop
    (``refexec_trainer_epoch_resnet.npz``): cls_resnet bottlenecks with live
    BatchNorm, hard CE, WD 1e-4 with ``WITHOUT_WD_LIST = ['bn']``, the clip
    and MultiStep[2] at 0.1, through the port's Trainer: the per-epoch mean
    losses and the running-statistics val top-1 at the JAX test's bounds
    (rtol 2e-3, atol 2e-4; top-1 exact)."""
    from peft_vit_tpu_torch.models.resnet import ResNet
    from test_torch_port_resnet import _reference_to_port

    g = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                             "refexec_trainer_epoch_resnet.npz"))
    sd = {k[len("sd."):]: np.asarray(v) for k, v in g.items() if k.startswith("sd.")}
    classes = sd["fc.weight"].shape[0]
    model = ImageClassifier(ResNet(layers=(1, 1), width=16, se_ratio=1.0 / 16.0,
                                   se_stages=(False, True), avg_down=True, device="cpu"),
                            num_classes=classes, device="cpu")
    state = {"backbone." + k: v for k, v in _reference_to_port(sd).items()}
    state["classifier.head.weight"] = torch.from_numpy(sd["fc.weight"])
    state["classifier.head.bias"] = torch.from_numpy(sd["fc.bias"])
    model.load_state_dict(state, strict=True)
    epochs, batch = int(g["epochs"]), int(g["batch"])
    cfg = make_cfg(**{"DATASET.NUM_CLASSES": classes, "MODEL.NUM_CLASSES": classes,
                      "TRAIN.BATCH_SIZE_PER_GPU": batch, "TRAIN.END_EPOCH": epochs,
                      "TRAIN.LR": float(g["lr"]), "TRAIN.WD": float(g["wd"]),
                      "TRAIN.OPTIMIZER": "sgd", "TRAIN.MOMENTUM": 0.9, "TRAIN.NESTEROV": True,
                      "TRAIN.CLIP_GRAD_NORM": float(g["clip_norm"]),
                      "TRAIN.LR_SCHEDULER.METHOD": "multistep",
                      "TRAIN.SCHEDULE": [int(m) for m in g["milestones"]],
                      "TRAIN.WITHOUT_WD_LIST": ["bn"], "AUG.RANDOM_FLIP": False,
                      "LOSS.LOSS": "softmax", "TPU.PREFETCH_DEPTH": 0})
    per = len(g["y_train"]) // batch
    trainer = Trainer(cfg, model, build_mask(model, "full", num_layers=0), per)

    def batches(xs, ys):
        for i in range(0, len(ys), batch):
            yield np.ascontiguousarray(xs[i:i + batch].transpose(0, 2, 3, 1)), ys[i:i + batch]

    losses, top1 = [], []
    for e in range(epochs):
        losses.append(trainer.train_one_epoch(batches(g["x_train"], g["y_train"]), e)["loss"])
        top1.append(trainer.evaluate(batches(g["x_val"], g["y_val"])))
    np.testing.assert_allclose(losses, g["epoch_losses"], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(top1, g["val_top1"], atol=1e-6)


def test_dropblock_resume_and_captured_path_equal_uninterrupted(monkeypatch, tmp_path):
    """DropBlock's draws from the trainer's generator (no noise pinned): a
    run stopped after 2 of 4 batches and resumed from its checkpoint (the
    drop generator's state in it) equals the uninterrupted run bit for bit,
    trainable leaves and BN statistics; so does the captured path's Python
    (the StepGraph stand-in, the generator registered with the graph)."""
    from test_torch_port_cells import _Rerun

    over = {**DROPBLOCK, "TRAIN.CHECKPOINT_EVERY_STEPS": 2, "TRAIN.END_EPOCH": 1,
            "TRAIN.LR_SCHEDULER.METHOD": "constant"}
    x, y = _rn_data()
    d = str(tmp_path / "ckpt")
    ref = _rn_trainer(make_cfg(**over))
    ref.train_one_epoch(batch_iterator(x, y, 8, seed=0), epoch=0)
    pre = _rn_trainer(make_cfg(**over))
    pre.train_one_epoch(itertools.islice(batch_iterator(x, y, 8, seed=0), 2), epoch=0,
                        checkpoint_dir=d)
    res = _rn_trainer(make_cfg(**over))
    assert res.maybe_resume(d) == 0 and res.resume_batch_in_epoch == 2
    res.train_one_epoch(_skip_batches(batch_iterator(x, y, 8, seed=0), 2), epoch=0,
                        start_batch=2)
    _equal(ref, res)
    for k, v in ref.state.batch_stats.items():
        assert torch.equal(v, res.state.batch_stats[k]), k
    assert torch.equal(ref.drop_generator.get_state(), res.drop_generator.get_state())
    monkeypatch.setattr(port_trainer._train, "StepGraph", _Rerun)
    monkeypatch.setattr(port_trainer._train, "runs_captured", lambda t: True)
    cap = _rn_trainer(make_cfg(**over))
    cap.train_one_epoch(batch_iterator(x, y, 8, seed=0), epoch=0)
    assert sum(g.replays for key, g in cap.graphs.items() if key[0] == "train") == 4
    _equal(ref, cap)
    for k, v in ref.state.batch_stats.items():
        assert torch.equal(v, cap.state.batch_stats[k]), k
