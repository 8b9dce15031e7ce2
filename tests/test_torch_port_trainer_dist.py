"""The port's full-shot Trainer over 2 processes (2 spawned gloo processes,
``_port_dist.trainer_runs``) against the JAX ``Trainer`` on a 2-device mesh
(2 of conftest's 8 virtual CPU devices), and against the port's own
one-process run of the global batch.

With the random draws off, the timm ViT's full fine-tune (adamW with the
gradient-norm clip), replicated and under ZeRO-1, matches the JAX trainer:
every epoch's loss, the trainable leaves and the adam moments within
``TOL_STEP`` (two fp32 runs of the same steps, the gradients summed in
another order), the eval top-1 over the ranks' stripes equal.  One slice is
left out of the leaves: the key rows of ``in_proj``'s bias, whose gradient
is zero but for rounding (softmax ignores a per-row constant), which adam
divides by its own size into steps of the learning rate (the one-process
trainer test leaves adamw off ``full`` for the same reason).  The tiny
ResNet with train-mode BN matches the JAX trainer within the one-process
ResNet test's bounds (``TOL_RN``: flax takes the variance in one pass, the
port in two, and train-mode BN at batch 8 amplifies the difference).  The
int8 static scales of the first batch (the global batch's absmax) match
within ``TOL_SCALE``.  With every draw on (the timm augmentation with its
pixel erase, mixup / cutmix, DropBlock), two ranks compute the port's
one-process run of the global batch within ``TOL_STEP``, a gradient-sized
tensor (the momentum) within ``TOL_STEP`` of its largest value.  A preemption flagged on rank 1 stops both ranks at the same
checkpoint, and the resumed run equals the uninterrupted one bit for bit,
under ZeRO-1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import _port_dist
from peft_vit_tpu import config as jax_config
from peft_vit_tpu.data import synthetic_dataset
from peft_vit_tpu.engine.trainer import Trainer as JaxTrainer
from peft_vit_tpu.engine.trainer import batch_iterator as jax_batches
from peft_vit_tpu.models import ImageClassifier as JaxClassifier
from peft_vit_tpu.models import VisionTransformer as JaxViT
from peft_vit_tpu.parallel import make_mesh as jax_make_mesh
from peft_vit_tpu.peft import build_mask as jax_mask
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.models.convert import params_to_jax
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)
from test_torch_port_trainer import jax_params

WORLD = 2
TOL_STEP = dict(rtol=1e-5, atol=1e-6)  # two fp32 runs of the same steps (test_torch_port_parallel)
TOL_SCALE = dict(rtol=1e-6)  # an absmax of the same activations, another GEMM order
# test_torch_port_trainer.py's ResNet against JAX: the losses and leaves, and
# each BN statistic within 1e-4 of its tensor's largest value
TOL_RN_LOSS, TOL_RN_LEAF, TOL_RN_STAT = 1e-4, dict(rtol=1e-4, atol=1e-5), 1e-4
RN_IMAGES = 8  # a class: 32 images, 4 steps of the global batch


@pytest.fixture(scope="module")
def data():
    x, y = synthetic_dataset(4, 16, 16)
    rn_x, rn_y = synthetic_dataset(4, RN_IMAGES, 64)
    return x.astype(np.float32) / 255.0, y, x, rn_x.astype(np.float32) / 255.0, rn_y


@pytest.fixture(scope="module")
def rn_jax():
    from peft_vit_tpu.models.resnet import ResNet as JaxResNet

    model = JaxClassifier(backbone=JaxResNet(**_port_dist.RN_BN), num_classes=4)
    variables = jax.device_get(dict(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 64, 64, 3)))))
    return model, variables


@pytest.fixture(scope="module")
def spawned(data, rn_jax, tmp_path_factory):
    _, params = jax_params()
    x, y, xu8, rn_x, rn_y = data
    tmp = tmp_path_factory.mktemp("trainer_dist")
    return _port_dist.spawn(_port_dist.trainer_runs, WORLD, tmp, params, rn_jax[1], x, y, xu8,
                            rn_x, rn_y, str(tmp))


def _mesh():
    return jax_make_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])


def _jax_run(cfg, model, params, method, x, y, epochs, batch_stats=None):
    jt = JaxTrainer(cfg, model, params, jax_mask(params, method, num_layers=2),
                    steps_per_epoch=_port_dist.TRAINER_STEPS, mesh=_mesh(),
                    batch_stats=batch_stats)
    losses = [jt.train_one_epoch(jax_batches(x, y, _port_dist.TRAINER_BATCH, seed=e),
                                 epoch=e)["loss"] for e in range(epochs)]
    top1 = jt.evaluate(jax_batches(x, y, _port_dist.TRAINER_BATCH, shuffle=False,
                                   drop_last=False))
    return jt, losses, top1


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _port_flat(arrays, collection="params"):
    return _flat(params_to_jax({k: torch.from_numpy(v) for k, v in arrays.items()})[collection])


def _close(got: dict, want: dict, scaled: float = 0.0, **tol):
    """Every tensor within ``tol``; ``scaled`` > 0 adds ``scaled`` times the
    tensor's largest magnitude to the absolute bound."""
    assert set(got) == set(want)
    for k, v in want.items():
        kw = dict(tol)
        if scaled:
            kw["atol"] = kw.get("atol", 0.0) + scaled * float(np.abs(v).max())
        np.testing.assert_allclose(got[k], v, **kw, err_msg=k)


def _without_key_bias(leaves: dict) -> dict:
    """The leaves with the key rows of each ``in_proj`` bias left out (see
    the module docstring)."""
    out = dict(leaves)
    for k, v in leaves.items():
        if k.endswith("attn/in_proj/bias"):
            third = v.shape[0] // 3
            out[k] = np.concatenate([v[:third], v[2 * third:]])
    return out


def _adam(opt_state):
    """The JAX chain's adam state (count, mu, nu)."""
    return next(n for n in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda n: hasattr(n, "mu") and hasattr(n, "nu"))
        if hasattr(n, "mu"))


@pytest.fixture(scope="module")
def jax_vit(data):
    x, y = data[:2]
    model, params = jax_params()
    out = {}
    for zero1 in (False, True):
        cfg = _port_dist.trainer_cfg(jax_config, **_port_dist.VIT_FULL, **{"TPU.ZERO1": zero1})
        out[zero1] = _jax_run(cfg, model, params, "full", x, y, epochs=2)
    return out


@pytest.mark.parametrize("zero1", [False, True])
def test_full_finetune_over_two_processes_matches_jax(spawned, jax_vit, zero1):
    """Two epochs of the timm ViT's full fine-tune (adamW, CLIP_GRAD_NORM) on
    2 ranks against the JAX trainer on a 2-device mesh: each epoch's loss
    (the group's mean), every leaf, the adam moments and count (under ZeRO-1
    gathered from the ranks' slices, of which each rank holds half where the
    leaf splits), and the eval top-1 over the ranks' stripes."""
    jt, losses, top1 = jax_vit[zero1]
    adam = _adam(jt.state.opt_state)
    want_leaves = _flat(jt.state.trainable)
    for out in spawned:
        run = out[("vit", zero1)]
        np.testing.assert_allclose(run["losses"], losses, **TOL_STEP)
        _close(_without_key_bias(_port_flat(run["trainable"])), _without_key_bias(want_leaves),
               **TOL_STEP)
        for slot in ("mu", "nu"):
            got = {k.split(".", 1)[1]: v for k, v in run["opt"].items()
                   if k.startswith(slot + ".")}
            _close(_port_flat(got), _flat(getattr(adam, slot)), **TOL_STEP)
        assert int(run["opt"]["count"]) == int(adam.count) == 2 * _port_dist.TRAINER_STEPS
        assert run["top1"] == top1
        halves = [k for k, s in run["opt_shapes"].items() if s != run["opt"][k].shape]
        assert bool(halves) == zero1
        for k in halves:
            assert 2 * np.prod(run["opt_shapes"][k]) == run["opt"][k].size, k


def test_resnet_bn_over_two_processes_matches_jax(spawned, rn_jax, data):
    """An epoch of the tiny ResNet with train-mode BN: the moments are the
    global batch's on every rank, so the BN statistics, the leaves and the
    loss match the JAX trainer's over the mesh (``TOL_RN``)."""
    model, variables = rn_jax
    rn_x, rn_y = data[3:]
    cfg = _port_dist.trainer_cfg(jax_config, **_port_dist.RN_SGD)
    jt, losses, top1 = _jax_run(cfg, model, variables["params"], "full", rn_x, rn_y, epochs=1,
                                batch_stats=variables["batch_stats"])
    for out in spawned:
        run = out["rn"]
        np.testing.assert_allclose(run["losses"], losses, rtol=TOL_RN_LOSS)
        _close(_port_flat(run["bn"], "batch_stats"), _flat(jt.state.batch_stats),
               scaled=TOL_RN_STAT, rtol=0)
        _close(_port_flat(run["trainable"]), _flat(jt.state.trainable), **TOL_RN_LEAF)
        assert run["top1"] == top1


def test_static_int8_scales_are_the_global_batchs(spawned, data):
    """TPU.INT8_STATIC_ACT: every rank's scales of the first batch are the JAX
    trainer's, calibrated on the global first batch (the ranks' absmax
    max-reduced)."""
    x, y = data[:2]
    _, params = jax_params()
    model = JaxClassifier(backbone=JaxViT(image_size=16, patch_size=8, width=32, layers=2,
                                          heads=2, style="timm", int8_train=True,
                                          use_flash=False), num_classes=4)
    cfg = _port_dist.trainer_cfg(jax_config, **_port_dist.INT8_STATIC)
    jt = JaxTrainer(cfg, model, params, jax_mask(params, "bitfit", num_layers=2),
                    _port_dist.TRAINER_STEPS, mesh=_mesh())
    bx, _ = next(jax_batches(x, y, _port_dist.TRAINER_BATCH, seed=0))
    jt._qk_vars(bx)
    want = {k.replace("/", ".").replace("blocks_", "blocks."): np.asarray(v)
            for k, v in traverse_util.flatten_dict(jt._qscale, sep="/").items()}
    assert len(want) == 8
    for out in spawned:
        _close(out["scales"], want, **TOL_SCALE)
    np.testing.assert_array_equal(spawned[0]["scales"]["backbone.blocks.0.attn.in_proj.s_x"],
                                  spawned[1]["scales"]["backbone.blocks.0.attn.in_proj.s_x"])


@pytest.mark.parametrize("case", ["vit", "resnet"])
def test_draws_over_two_processes_equal_the_one_process_run(spawned, data, case):
    """Every draw on: the ranks draw the global batch's flips, RandAugment
    ops and erase boxes from one generator state, its erase noise and
    DropBlock masks from one device generator, mixup's switch, lam and box
    once, and mixup pairs rows across the ranks; so an epoch on 2 ranks
    under ZeRO-1 equals the port's one-process epoch of the global batch."""
    x, y, xu8, rn_x, rn_y = data
    if case == "vit":
        _, params = jax_params()
        cfg = _port_dist.trainer_cfg(port_config, **_port_dist.DRAWS,
                                     **{"TRAIN.BATCH_SIZE_PER_GPU": _port_dist.TRAINER_BATCH})
        tr, key, images, labels = _port_dist.vit_trainer(cfg, params), "draws", xu8, y
    else:
        cfg = _port_dist.trainer_cfg(port_config, **_port_dist.RN_DRAWS,
                                     **{"TRAIN.BATCH_SIZE_PER_GPU": _port_dist.TRAINER_BATCH})
        tr = _port_dist.rn_trainer(cfg, None, _port_dist.RN_DROPBLOCK)
        key, images, labels = "rn_draws", rn_x, rn_y
    assert tr.mesh is None
    want = _port_dist.run_trainer(tr, images, labels, 0, 1, epochs=1)
    for out in spawned:
        run = out[key]
        np.testing.assert_allclose(run["losses"], want["losses"], **TOL_STEP)
        _close(run["trainable"], want["trainable"], **TOL_STEP)
        _close(run["opt"], want["opt"], scaled=TOL_STEP["rtol"], **TOL_STEP)
        _close(run["bn"], want["bn"], **TOL_STEP)


def test_preemption_on_one_rank_stops_both_and_resumes_exactly(spawned):
    """Rank 1 alone is flagged after 3 steps: the ranks agree at the
    checkpoint crossing, both save at batch 3 and stop; the resumed run
    finishes equal to the uninterrupted one bit for bit (each rank's leaves
    and its ZeRO-1 slices of the optimizer state)."""
    for out in spawned:
        assert out["whole"]["stopped"] is None and out["resumed"]["stopped"] is None
        assert "epoch 0 batch 3" in out["preempted"]["stopped"]
        assert out["preempted"]["step"] == _port_dist.PREEMPT_AT
        assert out["resumed"]["step"] == out["whole"]["step"] == 2 * _port_dist.TRAINER_STEPS
        for part in ("trainable", "opt"):
            assert set(out["resumed"][part]) == set(out["whole"][part])
            for k, v in out["whole"][part].items():
                np.testing.assert_array_equal(out["resumed"][part][k], v, err_msg=k)


def test_train_main_over_two_processes_equals_one_process(spawned, tmp_path):
    """``commands.train.train_main`` in the group: the global batch is
    ``BATCH_SIZE_PER_GPU`` x 2, each rank trains its rows and scores its
    stripe of the test set, rank 0 writes the checkpoint; the best top-1 and
    the last checkpoint's leaves are the one-process command's at the global
    batch."""
    _, params = jax_params()
    want = _port_dist.train_main_run(params, str(tmp_path), _port_dist.TRAINER_BATCH)
    for out in spawned:
        got = out["train_main"]
        assert got["best"] == want["best"] and got["step"] == want["step"] > 0
        _close(got["trainable"], want["trainable"], **TOL_STEP)
