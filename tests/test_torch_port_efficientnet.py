"""The port's EfficientNet (``peft_vit_tpu_torch/models/efficientnet.py``)
against the JAX module (``peft_vit_tpu/models/efficientnet.py``), against
the timm-layout golden (``tests/golden/effnet_tower.npz``) through the
port's loader, and through the port's entry points: the factory's B0 and
its timm checkpoint graft, ``finetune_main`` (linear, the ELEVATER probe's
use of it) against the JAX driver, a round of 3 full fine-tune cells
against its cells, the full-shot Trainer's epoch against the JAX Trainer,
and ``eval_all``'s loop.

Tolerances: the golden at the JAX test's own rtol 1e-4, atol 1e-5; the
module at ``_port_zoo.TOL`` (1e-4 of the largest reference value) for the
forward, the BN statistics and every gradient; ``finetune_main``'s epoch
losses within 1e-4 relative and its score within 1e-4 (fp32, the same
arithmetic in other orders); the round and the trainer as
``_port_zoo`` states.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
from _port_zoo import (hold_against_jax, jax_reference, jax_traced_init,  # noqa: F401 (a fixture)
                       round_against_cells, trainer_against_jax)
from peft_vit_tpu.models import efficientnet as jax_eff
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.models import convert as port_convert
from peft_vit_tpu_torch.models import efficientnet as port_eff
from peft_vit_tpu_torch.models import factory as port_factory
from peft_vit_tpu_torch.models.convert import params_to_jax
from peft_vit_tpu_torch.peft import spec_from_config
from test_torch_port_driver import _run_both, tiny_cfg
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# two stages, both block kinds, a 5x5 depthwise at stride 2, the residual
TINY = dict(blocks=((1, 8, 1, 3, 1), (6, 16, 2, 5, 2)), stem_ch=8, head_ch=24)
# the factory's B0 cut by its own multipliers: 7 blocks of 8-48 channels
TINY_CFG = {"MODEL.NAME": "efficientnet_b0", "MODEL.SPEC.VISION.WIDTH_MULT": 0.25,
            "MODEL.SPEC.VISION.DEPTH_MULT": 0.1, "MODEL.SPEC.VISION.HEAD_CH": 32}


def test_round_channels_matches_jax():
    for ch in (8, 16, 24, 32, 40, 112, 320, 1280):
        for mult in (0.25, 0.5, 1.0, 1.1, 1.2, 2.0):
            assert port_eff.round_channels(ch, mult) == jax_eff.round_channels(ch, mult)


def test_golden_through_the_port_loader():
    """The timm-layout tower of ``effnet_tower.npz`` (both block kinds, SE,
    BN eps 1e-3) through ``timm_effnet_state_dict_to_tree``: every leaf
    taken, the golden's features."""
    g = np.load(os.path.join(GOLDEN, "effnet_tower.npz"))
    sd = {k.replace("__", "."): g[k] for k in g.files if k not in ("x", "out", "image")}
    model = port_eff.EfficientNet(blocks=((1, 8, 1, 3, 1), (6, 16, 2, 3, 2)), stem_ch=8,
                                  head_ch=24, device="cpu")
    model.load_state_dict(port_convert.tower_state_dict(
        *port_convert.timm_effnet_state_dict_to_tree(sd)), strict=True)
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(np.ascontiguousarray(g["x"].transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_pair():
    x = np.random.RandomState(1).standard_normal((4, 24, 24, 3)).astype(np.float32)
    return (x, *jax_reference(jax_eff.EfficientNet(**TINY), x))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_efficientnet_matches_jax(tiny_pair, train):
    """The forward, in train mode the new BN statistics (eps 1e-3), and the
    gradient of every parameter and of the input."""
    x, variables, cot, want = tiny_pair
    hold_against_jax(port_eff.EfficientNet(**TINY, device="cpu"), variables, x, cot, want,
                     train, "efficientnet")


def test_b0_has_the_jax_leaves():
    """B0 at its defaults: the JAX module's parameter tree (names and
    shapes; 16 blocks in 7 stages) and ~4.0 M parameters (timm's without
    its classifier)."""
    shapes = jax.eval_shape(jax_eff.EfficientNet().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    model = port_eff.EfficientNet(device="cpu")
    got = params_to_jax(model.state_dict())
    for col in ("params", "batch_stats"):
        want = {k: v.shape for k, v in traverse_util.flatten_dict(shapes[col], sep="/").items()}
        flat = {k: v.shape for k, v in traverse_util.flatten_dict(got[col], sep="/").items()}
        assert flat == want, col
    assert 3.8e6 < sum(p.numel() for p in model.parameters()) < 4.2e6


def _timm_names(variables) -> dict:
    """A flax EfficientNet tree in timm's state-dict names (the inverse of
    ``timm_effnet_state_dict_to_tree``), with a classifier beside it."""
    sd = {}
    for col, leaf_map in (("params", {"kernel": "weight", "scale": "weight", "bias": "bias"}),
                          ("batch_stats", {"mean": "running_mean", "var": "running_var"})):
        for k, v in traverse_util.flatten_dict(variables[col], sep="/").items():
            *mods, leaf = k.split("/")
            mods = [m.replace("blocks_", "blocks.").replace("_", ".") if m.startswith("blocks_")
                    else m for m in mods]
            v = np.asarray(v)
            sd[".".join(mods + [leaf_map[leaf]])] = v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
    sd["classifier.weight"] = np.zeros((1000, 1280), np.float32)
    sd["classifier.bias"] = np.zeros(1000, np.float32)
    return sd


def test_factory_builds_b0_and_grafts_a_timm_checkpoint(tmp_path, caplog):
    """``efficientnet_b0`` through the port's builder with ``MODEL.PRETRAINED``
    a timm state dict (the JAX builder's graft, ``factory.py:640-655``):
    every tower leaf and statistic from the checkpoint, the head fresh (its
    two leaves the only fresh ones logged), the classifier ignored."""
    shapes = jax.eval_shape(jax_eff.EfficientNet().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3)))
    from test_torch_port_resnet import _randomize

    sd = _timm_names(_randomize(dict(shapes), 5))
    path = str(tmp_path / "effnet.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    cfg = tiny_cfg(port_config, **{"MODEL.NAME": "efficientnet_b0", "MODEL.PRETRAINED": path,
                                   "TRAIN.IMAGE_SIZE": [32, 32]})
    with caplog.at_level("INFO"):
        model, params, encode_text = port_factory.build_image_classifier(
            cfg, spec_from_config(cfg), 5, device="cpu")
    assert encode_text is None and isinstance(model.backbone, port_eff.EfficientNet)
    assert "grafted timm EfficientNet weights (2 fresh leaves)" in caplog.text
    want = port_convert.tower_state_dict(*port_convert.timm_effnet_state_dict_to_tree(sd))
    state = model.backbone.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k
    with torch.no_grad():
        assert model(torch.zeros(2, 32, 32, 3)).shape == (2, 5)


def test_finetune_main_linear_matches_jax(jax_traced_init, monkeypatch, tmp_path):
    """The few-shot driver's linear probe on a cut B0 (the tower frozen, its
    BN in train mode in every step as in the JAX step, the statistics per
    cell): NO_TUNING, 2 epochs at lr 1e-4."""
    over = {**TINY_CFG, "PEFT.METHOD": "linear", "TRAIN.END_EPOCH": 2, "TRAIN.LR": 1e-4}
    want, got = _run_both(monkeypatch, tmp_path, **over)
    assert len(got["losses"]) == len(want["losses"]) == 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert got["record"]["trainable_params"] == want["record"]["trainable_params"]


def test_full_round_trains_as_its_cells_one_by_one():
    """A round of 3 full fine-tune cells on the cut B0: every depthwise and
    SE conv per cell (a grouped conv of cells x channels groups)."""
    cfg = tiny_cfg(port_config, **TINY_CFG)
    model, _, _ = port_factory.build_image_classifier(cfg, spec_from_config(cfg), 5, use_bn=True,
                                                      device="cpu")
    round_against_cells(model, "full", image=16)


def test_trainer_epoch_matches_jax():
    """The full-shot Trainer's epoch on the cut B0 against the JAX Trainer."""
    trainer_against_jax(TINY_CFG, image=16)


def test_eval_all_runs_linear_on_b0(tmp_path, monkeypatch):
    """``eval_all`` (the ELEVATER loop: dataset x shots x seed through
    ``finetune_main``) with ``efficientnet_b0.yaml`` cut by its multipliers
    and the linear method: the run finishes (a run that raises would score 0
    silently) and its score is the loop's."""
    import peft_vit_tpu_torch.commands.eval_all as eval_all

    runs = []
    real = eval_all.finetune_main

    def finetune_main(cfg, out, device=None):
        runs.append(real(cfg, out, device=device))
        return runs[-1]

    monkeypatch.setattr(eval_all, "finetune_main", finetune_main)
    opts = ["TRAIN.IMAGE_SIZE", "[16, 16]", "DATASET.NUM_CLASSES", "4", "TRAIN.END_EPOCH", "1",
            "TRAIN.NO_TUNING", "True", "TRAIN.BATCH_SIZE_PER_GPU", "8"]
    for key, value in TINY_CFG.items():
        if key != "MODEL.NAME":
            opts += [key, str(value)]
    yaml_file = os.path.join(os.path.dirname(GOLDEN), os.pardir, "peft_vit_tpu", "resources",
                             "model", "efficientnet_b0.yaml")
    results = eval_all.main(["--model", yaml_file,
                             "--datasets", "synthetic", "--method", "linear", "--shots", "2",
                             "--seeds", "0", "--output", str(tmp_path), *opts], device="cpu")
    assert len(runs) == len(results) == 1 and list(results.values()) == runs
    assert all(np.isfinite(s) for s in runs)
