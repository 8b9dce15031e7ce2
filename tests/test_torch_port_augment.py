"""The device-side timm augmentation (``peft_vit_tpu_torch/data/augment.py``)
and the tensor flip and crop of ``data/transforms.py`` against the JAX
package's on the CPU, each fed the JAX package's own draws, replayed here
from the same keys: the 16 RandAugment ops at the same magnitudes,
``rand_augment``, ``random_erasing`` (pixel and const), the whole train
transform, ``make_train_transform``'s parse; then a Trainer epoch with
``AUG.TIMM_AUG`` against the JAX Trainer's, and the port's own guarantees
with the augmentation on: mid-epoch resume and the captured path equal to
the uninterrupted eager run bit for bit.

Tolerances, from what these tests measure: an op within 1e-4 of JAX's on
the [0, 255] scale (posterize's ``exp2``, color's mean of three, contrast's
image mean and sharpness's 3x3 sum round differently in the last bit, up to
4.6e-5; the other eleven ops are equal), the erasing exactly.  The chained
``rand_augment`` and the whole transform are held, within 1e-4 on the
[0, 255] scale, to the JAX package's own ops replayed image by image and
slot by slot, uncompiled, on the draws the JAX function makes: XLA's fused
arithmetic differs from its own op-by-op run by up to 4.6e-4 (a rotation
here), and where such a last-bit difference meets an op's threshold
(solarize_add's 128, posterize's floor, equalize's bins) a pixel jumps, in
JAX's compiled run against its own op-by-op run as against the port.  That
the replayed draws are the JAX function's own shows in the Trainer epoch,
whose JAX step runs the compiled transform on them, matching.  The
Trainer's epoch losses within 1e-5 relative and its leaves within 1e-5
relative + 1e-6, the full-shot trainer tests' bound.
"""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peft_vit_tpu.data import augment as jax_aug
from peft_vit_tpu.data import transforms as jax_transforms
from peft_vit_tpu_torch.data import augment as aug
from peft_vit_tpu_torch.data import transforms
from peft_vit_tpu_torch.engine import trainer as port_trainer
from test_torch_port_trainer import (_data, _equal, _port_flat, _flat, jax_params, make_cfg,
                                     make_trainer)
from test_torch_port_trainer import JaxTrainer, jax_mask
from test_torch_port_trainer import jax_config, batch_iterator, jax_batches  # noqa: F401
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

B, H, W = 6, 20, 28


def _x(seed=0, b=B, h=H, w=W):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (b, h, w, 3)).astype(np.float32)
    x[1] = np.clip(x[1] * 0.3 + 40, 0, 255).round()  # a low-contrast image
    return x


@pytest.mark.parametrize("k", range(16), ids=aug.OPS)
def test_each_op_matches_jax(k):
    """Each op through ``apply_op`` (every image drew it) at the same signed
    magnitudes, against the JAX op under ``vmap``."""
    x = _x(k)
    m = np.array([-7.3, 4.1, 9.6, 0.0, 10.0, -2.5], np.float32)
    if not jax_aug._SIGNED[k]:
        m = np.abs(m)
    want = np.asarray(jax.vmap(jax_aug._OPS[k])(jnp.asarray(x), jnp.asarray(m)))
    got = aug.apply_op(torch.tensor(x), torch.full((B,), k), torch.tensor(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert aug.SIGNED == jax_aug._SIGNED and len(aug.OPS) == len(jax_aug._OPS)


# -- the JAX draws, replayed from the same keys --------------------------------

@jax.jit
def _one_op_draw(key):
    k_op, k_mag, k_sign = jax.random.split(key, 3)
    return (jax.random.randint(k_op, (), 0, 16), jax.random.normal(k_mag),
            jax.random.uniform(k_sign))


def jax_rand_augment_draws(rng, b, num_ops, magnitude, mag_std):
    """(ops, signed magnitudes) (b, num_ops) as ``jax_aug.rand_augment``
    draws them from ``rng``."""
    keys = jax.random.split(rng, b)
    ops, mags = np.zeros((b, num_ops), np.int64), np.zeros((b, num_ops), np.float32)
    signed = jnp.asarray(jax_aug._SIGNED, jnp.float32)
    for i in range(b):
        for s, key in enumerate(jax.random.split(keys[i], num_ops)):
            op, z, u = _one_op_draw(key)
            m = jnp.clip(magnitude + mag_std * z, 0.0, 10.0)
            sign = jnp.where((u < 0.5) & (signed[op] > 0), -1.0, 1.0)
            ops[i, s], mags[i, s] = int(op), float(m * sign)
    return torch.tensor(ops), torch.tensor(mags)


def jax_erasing_draws(rng, shape, area_range=(0.02, 1.0 / 3.0)):
    """The erase's draws of ``jax_aug.random_erasing`` from ``rng``: p, area,
    log-ratio, corner and the (b, h, w, c) noise."""
    out = {k: [] for k in ("p", "area", "log_ratio", "uy", "ux", "noise")}
    for key in jax.random.split(rng, shape[0]):
        k_p, k_a, k_r, k_y, k_x, k_n = jax.random.split(key, 6)
        out["p"].append(jax.random.uniform(k_p))
        out["area"].append(jax.random.uniform(k_a, minval=area_range[0], maxval=area_range[1]))
        out["log_ratio"].append(jax.random.uniform(k_r, minval=jnp.log(0.3),
                                                   maxval=jnp.log(1 / 0.3)))
        out["uy"].append(jax.random.uniform(k_y))
        out["ux"].append(jax.random.uniform(k_x))
        out["noise"].append(jax.random.normal(k_n, shape[1:]))
    return {k: torch.tensor(np.asarray(jnp.stack(v))) for k, v in out.items()}


def jax_transform_draws(rng, shape, t):
    """The port ``TrainTransform`` draws and noise that replay the JAX
    ``make_train_transform`` transform at ``rng``."""
    k_f, k_a, k_e = jax.random.split(rng, 3)
    draws = {"flip": torch.tensor(np.asarray(
        jax.random.uniform(k_f, (shape[0], 1, 1, 1)) < t.hflip).reshape(-1))}
    if t.rand_augment:
        draws["ops"], draws["mags"] = jax_rand_augment_draws(k_a, shape[0], t.num_ops,
                                                             t.magnitude, t.mag_std)
        draws["mats"] = aug.slot_matrices(draws["ops"], draws["mags"], shape[1], shape[2])
    noise = None
    if t.re_prob > 0:
        e = jax_erasing_draws(k_e, shape)
        noise = e.pop("noise")
        draws.update({f"erase_{k}": v for k, v in e.items()})
    return draws, noise


def jax_ops_replayed(x, ops, mags):
    """The JAX package's ops applied image by image, slot by slot, each call
    uncompiled (XLA's primitives one at a time, as the port runs them)."""
    out = []
    for i in range(x.shape[0]):
        xi = jnp.asarray(x[i], jnp.float32)
        for s in range(ops.shape[1]):
            xi = jax_aug._OPS[int(ops[i, s])](xi, jnp.float32(mags[i, s]))
        out.append(np.asarray(xi))
    return np.stack(out)


def test_rand_augment_fed_jax_draws():
    x, rng = _x(1, b=4), jax.random.PRNGKey(3)
    ops, mags = jax_rand_augment_draws(rng, 4, 2, 9.0, 0.5)
    want = jax_ops_replayed(x, ops, mags)
    got = aug.rand_augment(torch.tensor(x), ops, mags).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the matrices computed with the draws (as TrainTransform.draw does) or in place: equal
    mats = aug.slot_matrices(ops, mags, H, W)
    np.testing.assert_array_equal(aug.rand_augment(torch.tensor(x), ops, mags, mats).numpy(), got)


@pytest.mark.parametrize("mode", ["pixel", "const"])
def test_random_erasing_fed_jax_draws(mode):
    x, rng = _x(2), jax.random.PRNGKey(4)
    want = np.asarray(jax_aug.random_erasing(rng, jnp.asarray(x), prob=0.7, mode=mode))
    d = jax_erasing_draws(rng, x.shape)
    got = aug.random_erasing(torch.tensor(x), d["p"], d["area"], d["log_ratio"], d["uy"],
                             d["ux"], prob=0.7,
                             noise=d["noise"] if mode == "pixel" else None).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != x).any(axis=(1, 2, 3)).sum() == (d["p"].numpy() < 0.7).sum()


@pytest.mark.parametrize("aa,re_prob,hflip", [("rand-m9-mstd0.5-inc1", 0.25, 0.5),
                                              ("rand-n1-m7", 1.0, 1.0), ("", 0.5, 0.0)])
def test_train_transform_fed_jax_draws_and_its_parse(aa, re_prob, hflip):
    """hflip -> RandAugment -> erasing -> normalise; and the AUTO_AUGMENT
    string parsed into the JAX transform's (num_ops, magnitude, mstd)."""
    from peft_vit_tpu.config import get_default_config as jax_config
    from peft_vit_tpu_torch.config import get_default_config as port_config

    cfgs = []
    for factory in (jax_config, port_config):
        cfg = factory()
        t = cfg.AUG.TIMM_AUG
        t.USE_TRANSFORM, t.AUTO_AUGMENT, t.RE_PROB, t.HFLIP = True, aa, re_prob, hflip
        cfgs.append(cfg)
    jt, pt = jax_aug.make_train_transform(cfgs[0]), aug.make_train_transform(cfgs[1])
    closure = {c.cell_contents for c in jt.__closure__
               if isinstance(c.cell_contents, (int, float))}
    for value in (pt.num_ops, pt.magnitude, pt.mag_std, pt.re_prob, pt.hflip):
        assert value in closure
    x, rng = _x(5, b=4).astype(np.uint8), jax.random.PRNGKey(9)
    draws, noise = jax_transform_draws(rng, x.shape, pt)
    # the JAX transform's steps on its own draws: the flip, the ops replayed,
    # its random_erasing on its own key, the normalisation
    want = np.where(draws["flip"].numpy()[:, None, None, None], x[:, :, ::-1], x)
    if aa:
        want = jax_ops_replayed(want, draws["ops"], draws["mags"])
    if re_prob > 0:
        want = jax_aug.random_erasing(jax.random.split(rng, 3)[2], jnp.asarray(want, jnp.float32),
                                      re_prob, mode="pixel")
    mean = jnp.asarray(cfgs[0].INPUT.MEAN, jnp.float32) * 255.0
    std = jnp.asarray(cfgs[0].INPUT.STD, jnp.float32) * 255.0
    want = np.asarray((jnp.asarray(want, jnp.float32) - mean) / std)
    got = pt(torch.tensor(x), draws, noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 / (255 * 0.224))
    assert aug.parse_auto_augment("rand-m9-mstd0.5-inc1") == (2, 9.0, 0.5)
    assert aug.parse_auto_augment("rand-n4-m12.5-mstd1") == (4, 12.5, 1.0)
    cfgs[1].AUG.TIMM_AUG.USE_TRANSFORM = False
    assert aug.make_train_transform(cfgs[1]) is None and jax_aug.make_train_transform(
        cfgs[0]) is not None


def test_flip_and_crop_resize_fed_jax_draws():
    x, rng = _x(6, b=3), jax.random.PRNGKey(2)
    flips = jax.random.bernoulli(rng, 0.5, (3, 1, 1, 1))
    np.testing.assert_array_equal(
        transforms.random_flip(torch.tensor(x), torch.tensor(np.asarray(flips)).view(-1)).numpy(),
        np.asarray(jax_transforms.random_flip(rng, jnp.asarray(x))))
    want = np.asarray(jax_transforms.random_crop_resize(rng, jnp.asarray(x)))
    k_area, k_ratio, k_x, k_y = jax.random.split(rng, 4)
    draws = [np.asarray(v) for v in (
        jax.random.uniform(k_area, (3,), minval=0.08, maxval=1.0),
        jax.random.uniform(k_ratio, (3,), minval=jnp.log(0.75), maxval=jnp.log(4.0 / 3.0)),
        jax.random.uniform(k_y, (3,)), jax.random.uniform(k_x, (3,)))]
    got = transforms.random_crop_resize(torch.tensor(x), *map(torch.tensor, draws)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    flip = transforms.draw_flip(torch.Generator().manual_seed(0), 3)
    assert flip.shape == (3,) and flip.dtype == torch.bool
    d = transforms.draw_crop_resize(torch.Generator().manual_seed(0), 3)
    assert ((d["area"] >= 0.08) & (d["area"] < 1.0)).all() and set(d) == {
        "area", "log_ratio", "uy", "ux"}


# -- the trainer -----------------------------------------------------------------

TIMM = {"AUG.TIMM_AUG.USE_TRANSFORM": True, "AUG.TIMM_AUG.RE_PROB": 0.5,
        "TRAIN.MOMENTUM": 0.9, "TRAIN.LR_SCHEDULER.METHOD": "constant"}


def test_trainer_epoch_with_timm_aug_matches_the_jax_trainer(monkeypatch):
    """Two epochs of 4 steps on raw uint8 batches, the port's draws replaced
    by those the JAX Trainer's steps make (its key chain from PRNGKey(0)):
    the epoch losses, eval top-1 and the final leaves."""
    x, y = _data(n_per_class=8, uint8=True)
    jmodel, params = jax_params()
    jt = JaxTrainer(make_cfg(jax_config, **TIMM), jmodel, params,
                    jax_mask(params, "full", num_layers=2), steps_per_epoch=4)
    pt = make_trainer(make_cfg(**TIMM), steps_per_epoch=4)
    chain, queue = jax.random.PRNGKey(0), []
    for _ in range(8):
        chain, step_rng = jax.random.split(chain)
        queue.append(jax_transform_draws(jax.random.split(step_rng)[1], (8, 16, 16, 3),
                                         pt.transform))
    pending = iter(queue)
    noise = {}

    def draw(self, generator, shape):
        draws, noise["next"] = next(pending)
        return draws

    monkeypatch.setattr(aug.TrainTransform, "draw", draw)
    monkeypatch.setattr(aug.TrainTransform, "noise", lambda self, shape, g: noise["next"])
    for e in range(2):
        want = jt.train_one_epoch(jax_batches(x, y, 8, seed=e), epoch=e)["loss"]
        got = pt.train_one_epoch(batch_iterator(x, y, 8, seed=e), epoch=e)["loss"]
        assert got == pytest.approx(want, rel=1e-5)
    assert pt.evaluate(batch_iterator(x, y, 8, shuffle=False, drop_last=False)) == \
        jt.evaluate(jax_batches(x, y, 8, shuffle=False, drop_last=False))
    want = _flat(jt.state.trainable)
    for k, v in _port_flat(pt.state.trainable).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_midepoch_resume_with_timm_aug_equals_uninterrupted(tmp_path):
    """Stopped after 3 of 6 batches, a fresh Trainer resumed from the
    checkpoint equals the uninterrupted run bit for bit: the host draws ride
    the generator's state, the erase's noise the noise generator's."""
    over = {**TIMM, "TRAIN.CHECKPOINT_EVERY_STEPS": 3, "TRAIN.EMA_DECAY": 0.9,
            "TRAIN.END_EPOCH": 1}
    x, y = _data(n_per_class=12, uint8=True)
    d = str(tmp_path / "ckpt")
    ref = make_trainer(make_cfg(**over))
    ref.train_one_epoch(batch_iterator(x, y, 8, seed=0), epoch=0)
    pre = make_trainer(make_cfg(**over))
    pre.train_one_epoch(itertools.islice(batch_iterator(x, y, 8, seed=0), 3), epoch=0,
                        checkpoint_dir=d)
    res = make_trainer(make_cfg(**over))
    assert res.maybe_resume(d) == 0 and res.resume_batch_in_epoch == 3
    assert torch.equal(res.noise_generator.get_state(), pre.noise_generator.get_state())
    res.train_one_epoch(port_trainer._skip_batches(batch_iterator(x, y, 8, seed=0), 3),
                        epoch=0, start_batch=3)
    _equal(ref, res)
    for a, b in zip(ref.state.ema.shadow.values(), res.state.ema.shadow.values()):
        assert torch.equal(a, b)
    assert torch.equal(ref.generator.get_state(), res.generator.get_state())
    assert torch.equal(ref.noise_generator.get_state(), res.noise_generator.get_state())
    assert os.path.isdir(d)


def test_captured_path_with_timm_aug_equals_eager(monkeypatch):
    """The captured path's Python (``test_torch_port_cells._Rerun``): the
    augmentation's draws enter each replay, the noise generator is handed to
    the graph and put back after the capture; the run equals the eager one
    bit for bit, chunks of K = 2 included."""
    from test_torch_port_cells import _Rerun

    over = {**TIMM, "TPU.STEPS_PER_DISPATCH": 2}
    x, y = _data(n_per_class=10, uint8=True)  # 40 images: 5 batches of 8
    eager = make_trainer(make_cfg(**over))
    eager.train_one_epoch(batch_iterator(x, y, 8, seed=0), 0)
    monkeypatch.setattr(port_trainer._train, "StepGraph", _Rerun)
    monkeypatch.setattr(port_trainer._train, "runs_captured", lambda t: True)
    captured = make_trainer(make_cfg(**over))
    captured.train_one_epoch(batch_iterator(x, y, 8, seed=0), 0)
    trains = [g for key, g in captured.graphs.items() if key[0] == "train"]
    assert len(trains) == 1 and trains[0].replays == 5
    _equal(eager, captured)
    assert torch.equal(eager.noise_generator.get_state(), captured.noise_generator.get_state())
