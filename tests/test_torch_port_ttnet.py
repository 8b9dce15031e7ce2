"""The port's TTNet v2 / v3 (``peft_vit_tpu_torch/models/ttnet.py``) against
the JAX module (``peft_vit_tpu/models/ttnet.py``), against the executed
reference's towers (``tests/golden/refexec_ttnet_v2.npz`` / ``_v3.npz``)
through the port's loader, and through the port's entry points: the
factory's v2 and v3, ``finetune_main`` (full) against the JAX driver, a
round of 3 full fine-tune cells against its cells, the full-shot Trainer's
epoch and ``update_bn`` against the JAX Trainer.

The port computes NCHW: ``channel_shuffle`` is held to the JAX module's
NHWC permutation of the channel index.

Tolerances: the goldens at the JAX tests' own rtol 1e-4, atol 1e-4; the
shuffle exactly; the module at ``_port_zoo.TOL`` (1e-4 of the largest
reference value) for the logits, the BN statistics and every gradient;
``finetune_main``'s epoch losses within 1e-4 relative and its score within
1e-4; the round and the trainer as ``_port_zoo`` states.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_zoo import (hold_against_jax, jax_reference, jax_traced_init,  # noqa: F401 (a fixture)
                       round_against_cells, trainer_against_jax)
from peft_vit_tpu.models import ttnet as jax_ttnet
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.models import factory as port_factory
from peft_vit_tpu_torch.models import ttnet as port_ttnet
from peft_vit_tpu_torch.models.convert import tower_state_dict, ttnet_state_dict_to_tree
from peft_vit_tpu_torch.peft import spec_from_config
from test_torch_port_driver import _run_both, tiny_cfg
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# the three block types, k = 3 and 5, the final 1x1 conv and the fc head
TINY = dict(num_classes=5, stem_kickoff=8, stem_start=16, stem_expand=2, stem_kernel=3,
            stage_channels=(24, 48), stage_repeats=(2, 2), stage_kernels=(3, 5),
            channel_final=64)
TINY_CFG = {"MODEL.NAME": "cls_ttnet_v3", "MODEL.EXTRA": {
    "STEM": {"NUM_CHANNEL_KICKOFF": 8, "NUM_CHANNEL_STEM_START": 16, "EXPAND_STEM_START": 2,
             "KERNEL_SIZE": 3},
    "STAGES": {"NUM_CHANNEL_OUTPUT": [24, 48], "NUM_BLOCK_REPEATS": [2, 2],
               "KERNEL_SIZE": [3, 5]},
    "NUM_CHANNEL_FINAL": 64}}


def test_channel_shuffle_matches_jax():
    x = np.arange(2 * 3 * 3 * 32, dtype=np.float32).reshape(2, 3, 3, 32)
    for fn in ("channel_shuffle", "channel_unshuffle"):
        want = np.asarray(getattr(jax_ttnet, fn)(jnp.asarray(x), 2, 4))
        got = getattr(port_ttnet, fn)(torch.from_numpy(x).permute(0, 3, 1, 2), 2, 4)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert torch.equal(port_ttnet.channel_unshuffle(port_ttnet.channel_shuffle(xt, 2), 2), xt)


@pytest.mark.parametrize("version", ["v2", "v3"])
def test_golden_through_the_port_loader(version):
    """cls_ttnet_v2.py's MobileShuffleV2Net (k = 5, the hardcoded 1000-way
    fc) and cls_ttnet_v3.py's TTNetV3 executed; every leaf taken by
    ``ttnet_state_dict_to_tree``."""
    g = np.load(os.path.join(GOLDEN, f"refexec_ttnet_{version}.npz"))
    sd = {k[len("sd__"):].replace("__", "."): g[k] for k in g.files if k.startswith("sd__")}
    if version == "v2":
        model = port_ttnet.TTNetV2(num_classes=1000, device="cpu")
    else:
        model = port_ttnet.TTNetV3(num_classes=7, stem_kickoff=8, stem_start=16, stem_expand=2,
                                   stem_kernel=3, stage_channels=(32, 64), stage_repeats=(2, 3),
                                   stage_kernels=(3, 5), channel_final=128, device="cpu")
    model.load_state_dict(tower_state_dict(*ttnet_state_dict_to_tree(sd)), strict=True)
    with torch.no_grad():
        y = model.eval()(torch.from_numpy(np.ascontiguousarray(g["x"].transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(y.numpy(), g["y"], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny_pair():
    x = np.random.RandomState(1).standard_normal((4, 16, 16, 3)).astype(np.float32)
    return (x, *jax_reference(jax_ttnet.TTNetV3(**TINY), x))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ttnet_matches_jax(tiny_pair, train):
    """The logits, in train mode the new BN statistics, and the gradient of
    every parameter and of the input."""
    x, variables, cot, want = tiny_pair
    hold_against_jax(port_ttnet.TTNetV3(**TINY, device="cpu"), variables, x, cot, want, train,
                     "ttnet")


@pytest.mark.parametrize("name", ["cls_ttnet_v2", "cls_ttnet_v3"])
def test_factory_builds_both_versions_as_features(name):
    """v2 at its fixed topology (1024 features), v3 from ``MODEL.EXTRA``;
    both without their fc, under the classifier head."""
    over = TINY_CFG if name.endswith("v3") else {"MODEL.NAME": name}
    cfg = tiny_cfg(port_config, **over)
    model, params, encode_text = port_factory.build_image_classifier(
        cfg, spec_from_config(cfg), 5, device="cpu")
    assert encode_text is None and not hasattr(model.backbone, "fc")
    assert model.backbone.num_features == (64 if name.endswith("v3") else 1024)
    with torch.no_grad():
        assert model.eval()(torch.zeros(2, 16, 16, 3)).shape == (2, 5)


def test_finetune_main_full_matches_jax(jax_traced_init, monkeypatch, tmp_path):
    """The few-shot driver's full fine-tune (every tower leaf trains, its BN
    in train mode, the statistics per cell) on the tiny v3: NO_TUNING, 2
    epochs at lr 1e-4."""
    over = {**TINY_CFG, "PEFT.METHOD": "full", "TRAIN.END_EPOCH": 2, "TRAIN.LR": 1e-4}
    want, got = _run_both(monkeypatch, tmp_path, **over)
    assert len(got["losses"]) == len(want["losses"]) == 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert got["record"]["trainable_params"] == want["record"]["trainable_params"]


def test_full_round_trains_as_its_cells_one_by_one():
    """A round of 3 full fine-tune cells on the tiny v3: each depthwise conv
    per cell a grouped conv of cells x channels groups."""
    cfg = tiny_cfg(port_config, **TINY_CFG)
    model, _, _ = port_factory.build_image_classifier(cfg, spec_from_config(cfg), 5, use_bn=True,
                                                      device="cpu")
    round_against_cells(model, "full", image=16)


def test_trainer_epoch_and_update_bn_match_jax():
    """The full-shot Trainer's epoch on the tiny v3 against the JAX Trainer,
    then ``update_bn``."""
    trainer_against_jax(TINY_CFG, image=16, update_bn=True)
