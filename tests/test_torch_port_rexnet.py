"""The port's ReXNet (``peft_vit_tpu_torch/models/rexnet.py``) against the
JAX module (``peft_vit_tpu/models/rexnet.py``), against the executed
reference's tower (``tests/golden/refexec_rexnet.npz``), and through the
port's entry points: ``finetune_main`` (bitfit) against the JAX driver, a
round of 3 bitfit cells against its cells, the full-shot Trainer's epoch
against the JAX Trainer.

ReLU6 is held to ``jnp.clip``'s gradient at the ties (0.5 at exactly 0 and
6), which the zero-kernel partial-residual check lands on.

Tolerances: the golden at the JAX test's own rtol 1e-4, atol 1e-5; the
module at ``_port_zoo.TOL`` (1e-4 of the largest reference value) for the
forward, the BN statistics (the SE's BN over a 1x1 map included) and every
gradient; the ties exactly; ``finetune_main``'s epoch losses within 1e-4
relative and its score within 1e-4; the round and the trainer as
``_port_zoo`` states.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_zoo import (hold_against_jax, jax_reference, jax_traced_init,  # noqa: F401 (a fixture)
                       round_against_cells, trainer_against_jax)
from peft_vit_tpu.models import rexnet as jax_rexnet
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.models import factory as port_factory
from peft_vit_tpu_torch.models import rexnet as port_rexnet
from peft_vit_tpu_torch.models.convert import tower_state_dict
from peft_vit_tpu_torch.peft import spec_from_config
from test_torch_port_driver import _run_both, tiny_cfg
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# six blocks, one a stage: the t=1 block, SE from stage 3, the partial
# residual of the stride-1 stage 5
TINY = dict(width_mult=0.5, depth_mult=0.1)
TINY_CFG = {"MODEL.NAME": "rexnet", "MODEL.SPEC.VISION.WIDTH_MULT": 0.5,
            "MODEL.SPEC.VISION.DEPTH_MULT": 0.1}


def test_channel_schedule_matches_jax():
    for wm in (0.5, 0.75, 1.0, 1.3, 2.0):
        for dm in (0.1, 0.5, 1.0):
            assert port_rexnet._rexnet_channels(wm, dm) == jax_rexnet._rexnet_channels(wm, dm)
            assert port_rexnet.rexnet_stem_channels(wm) == jax_rexnet.rexnet_stem_channels(wm)


def test_relu6_splits_the_ties_as_jnp_clip():
    x = np.array([-1.0, 0.0, 0.5, 6.0, 7.0, 0.0], np.float32)
    want = np.asarray(jax.grad(lambda v: (jnp.clip(v, 0.0, 6.0) * jnp.arange(1, 7)).sum())(x))
    xt = torch.from_numpy(x).requires_grad_()
    (port_rexnet.relu6(xt) * torch.arange(1, 7)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    # half of each tie's weight (2, 4, 6 at 0, 6, 0), where torch.clamp passes all of it
    np.testing.assert_array_equal(want, [0.0, 1.0, 3.0, 2.0, 0.0, 3.0])


def test_partial_residual_with_zero_kernels():
    """A stride-1 block with every kernel zero: the output is the partial
    residual exactly (the input on the first in_ch channels, zeros after),
    and every gradient is JAX's, ReLU6's ties at 0 included."""
    from flax import traverse_util

    jm = jax_rexnet.LinearBottleneck(in_ch=8, out_ch=16, stride=1, use_se=False)
    x = np.full((1, 4, 4, 8), 3.0, np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    # flax's fresh BN (scale 1, bias 0, mean 0, var 1), every kernel zero
    fill = {"kernel": 0.0, "scale": 1.0, "bias": 0.0, "mean": 0.0, "var": 1.0}
    v = {col: traverse_util.unflatten_dict(
        {k: np.full(a.shape, fill[k.rsplit("/", 1)[-1]], np.float32)
         for k, a in traverse_util.flatten_dict(shapes[col], sep="/").items()}, sep="/")
        for col in shapes}
    cot = np.random.RandomState(0).standard_normal((1, 4, 4, 16)).astype(np.float32)

    @jax.jit
    def run(p, xx, c):
        out, vjp = jax.vjp(lambda p_, x_: jm.apply({"params": p_,
                                                     "batch_stats": v["batch_stats"]}, x_), p, xx)
        return out, vjp(c)

    out, (g_p, g_x) = run(v["params"], jnp.asarray(x), jnp.asarray(cot))
    pm = port_rexnet.LinearBottleneck(8, 16, 1, use_se=False, device="cpu").eval()
    from peft_vit_tpu_torch.models.convert import params_from_jax

    pm.load_state_dict(params_from_jax(v), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = pm(xt)
    (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_array_equal(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out))
    assert (got[:, :8] == 3.0).all() and (got[:, 8:] == 0.0).all()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_x), rtol=1e-6)
    grads = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, g_p)})
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def _golden_tree(sd, wm, dm):
    """The executed reference's ReXNetV1 state dict (``features.<i>`` in the
    reference's Sequential order) in the JAX module's names, as
    ``test_refexec_models.TestRexnetRefexec`` maps it."""
    params, stats = {}, {}

    def conv(path, key):
        params[path + "/kernel"] = sd[key + ".weight"].transpose(2, 3, 1, 0)
        if key + ".bias" in sd:
            params[path + "/bias"] = sd[key + ".bias"]

    def bn(path, key):
        params[path + "/scale"], params[path + "/bias"] = sd[key + ".weight"], sd[key + ".bias"]
        stats[path + "/mean"] = sd[key + ".running_mean"]
        stats[path + "/var"] = sd[key + ".running_var"]

    conv("stem", "features.0")
    bn("stem_bn", "features.1")
    cfg = jax_rexnet._rexnet_channels(wm, dm)
    for i, (_, _, _, t, se) in enumerate(cfg):
        base, o, j = f"features.{3 + i}.out", f"block{i}", 0
        if t != 1:
            conv(f"{o}/expand", f"{base}.{j}")
            bn(f"{o}/bn_expand", f"{base}.{j + 1}")
            j += 3  # conv, bn, swish
        conv(f"{o}/dw", f"{base}.{j}")
        bn(f"{o}/bn_dw", f"{base}.{j + 1}")
        j += 2
        if se:
            conv(f"{o}/se/fc1", f"{base}.{j}.fc.0")
            bn(f"{o}/se/bn", f"{base}.{j}.fc.1")
            conv(f"{o}/se/fc2", f"{base}.{j}.fc.3")
            j += 1
        j += 1  # ReLU6
        conv(f"{o}/project", f"{base}.{j}")
        bn(f"{o}/bn_project", f"{base}.{j + 1}")
    conv("head_conv", f"features.{3 + len(cfg)}")
    bn("head_bn", f"features.{4 + len(cfg)}")
    return params, stats


def test_golden_refexec_rexnet():
    """cls_rexnet.py executed: the channel schedule, the partial residual,
    the BN-carrying SE; the logits through the reference's 1x1-conv head."""
    g = np.load(os.path.join(GOLDEN, "refexec_rexnet.npz"))
    sd = {k[len("sd__"):].replace("__", "."): np.asarray(v) for k, v in g.items()
          if k.startswith("sd__")}
    wm, dm = float(g["wm"]), float(g["dm"])
    model = port_rexnet.ReXNet(width_mult=wm, depth_mult=dm, device="cpu").eval()
    model.load_state_dict(tower_state_dict(*_golden_tree(sd, wm, dm)), strict=True)
    with torch.no_grad():
        feats = model(torch.from_numpy(np.ascontiguousarray(g["x"].transpose(0, 2, 3, 1))))
    w = sd["output.1.weight"]
    logits = feats.numpy() @ w.reshape(w.shape[0], -1).T + sd["output.1.bias"]
    np.testing.assert_allclose(logits, g["logits"], rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_pair():
    x = np.random.RandomState(1).standard_normal((4, 32, 32, 3)).astype(np.float32)
    return (x, *jax_reference(jax_rexnet.ReXNet(**TINY), x))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_rexnet_matches_jax(tiny_pair, train):
    """The forward, in train mode the new BN statistics, and the gradient of
    every parameter and of the input."""
    x, variables, cot, want = tiny_pair
    hold_against_jax(port_rexnet.ReXNet(**TINY, device="cpu"), variables, x, cot, want, train,
                     "rexnet")


def test_finetune_main_bitfit_matches_jax(jax_traced_init, monkeypatch, tmp_path):
    """The few-shot driver's bitfit (the BN biases and the head train, the
    tower's BN in train mode, its statistics per cell) on the cut ReXNet:
    NO_TUNING, 2 epochs at lr 1e-4."""
    over = {**TINY_CFG, "PEFT.METHOD": "bitfit", "TRAIN.END_EPOCH": 2, "TRAIN.LR": 1e-4}
    want, got = _run_both(monkeypatch, tmp_path, **over)
    assert len(got["losses"]) == len(want["losses"]) == 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert got["record"]["trainable_params"] == want["record"]["trainable_params"]


def test_bitfit_round_trains_as_its_cells_one_by_one():
    cfg = tiny_cfg(port_config, **TINY_CFG)
    model, _, _ = port_factory.build_image_classifier(cfg, spec_from_config(cfg), 5, use_bn=True,
                                                      device="cpu")
    round_against_cells(model, "bitfit", image=16)


def test_trainer_epoch_matches_jax():
    """The full-shot Trainer's epoch on the cut ReXNet against the JAX Trainer."""
    trainer_against_jax(TINY_CFG, image=16)


def test_fullshot_commands_train_the_cut_rexnet(monkeypatch, tmp_path):
    """``train``, ``swa_finetune`` (the SWA average's BN statistics
    refreshed by ``update_bn`` on the CNN) and ``bit_finetune`` (the
    HyperRule, its 500 steps cut to 16) on the cut ReXNet, 16 px: each runs
    to its end on the CPU with a finite top-1."""
    from peft_vit_tpu_torch.commands import bit_finetune, swa_finetune, train
    from peft_vit_tpu_torch.config import get_default_config

    tiny = ["DATASET.DATASET", "synthetic", "DATASET.NUM_CLASSES", "2", "MODEL.NUM_CLASSES", "2",
            "TRAIN.IMAGE_SIZE", "[16, 16]", "TRAIN.BATCH_SIZE_PER_GPU", "16",
            "TEST.BATCH_SIZE_PER_GPU", "40", "TRAIN.END_EPOCH", "2", "TRAIN.LR", "0.01"]
    for key, value in TINY_CFG.items():
        tiny += [key, str(value)]
    score = train.main([*tiny, "OUTPUT_DIR", str(tmp_path / "train")], device="cpu")
    assert 0.0 <= score <= 100.0
    swa = swa_finetune.main([*tiny, "SWA.BEGIN_EPOCH", "1", "SWA.ANNEAL_EPOCHS", "1",
                             "OUTPUT_DIR", str(tmp_path / "swa")], device="cpu")
    assert 0.0 <= swa <= 100.0
    monkeypatch.setattr(bit_finetune, "bit_hyperrule", lambda n: (16, (8, 12, 14)))
    cfg = get_default_config()
    cfg.merge_from_list([*tiny, "OUTPUT_DIR", str(tmp_path / "bit")])
    assert 0.0 <= bit_finetune.bit_main(cfg, device="cpu") <= 100.0
