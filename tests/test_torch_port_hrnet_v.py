"""The port's cls_hrnet_v2 / v2_share / v3 / v4
(``peft_vit_tpu_torch/models/hrnet.py::HRNetV``) against the JAX module
(``peft_vit_tpu/models/hrnet.py``), against the executed reference's towers
(``tests/golden/refexec_hrnet_{v2,v2_share,v3,v4,v4_wose}.npz``) through
the port's loader, and through the few-shot driver: ``finetune_main``
(bitfit: the BN biases and the inverted residuals' conv biases) against the
JAX driver and a round of 3 full fine-tune cells against its cells.
cls_hrnet and the factory are in ``test_torch_port_hrnet.py``.

Tolerances: the goldens at the JAX tests' own rtol 2e-4, atol 1e-4; the
module at ``_port_zoo.TOL`` (1e-4 of the largest reference value) for the
forward, the BN statistics and every gradient (v2_share's shared stacks'
the sum over the resolutions that run them); ``finetune_main``'s epoch
losses within 1e-4 relative and its score within 1e-4; the round as
``_port_zoo`` states.
"""

import os

import numpy as np
import pytest

from _port_zoo import (hold_against_jax, jax_reference, jax_traced_init,  # noqa: F401 (a fixture)
                       round_against_cells)
from peft_vit_tpu.models import hrnet as jax_hrnet
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.models import convert as port_convert
from peft_vit_tpu_torch.models import factory as port_factory
from peft_vit_tpu_torch.models import hrnet as port_hrnet
from peft_vit_tpu_torch.peft import spec_from_config
from test_torch_port_driver import _run_both, tiny_cfg
from test_torch_port_hrnet import GOLDEN, V4_CFG, V2_SHARE_TINY, _logits, _sd
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

_V_GOLDEN = dict(num_modules=(1, 1, 1), num_branches=(2, 3, 4),
                 num_blocks=((2, 2), (2, 2, 2), (2, 2, 2, 2)), with_se=True)
_INVERTED = dict(num_channels=((8, 16), (8, 16, 32), (8, 16, 32, 64)), block=("INVERTED",) * 3,
                 head_block=("INVERTED",) * 4, head_channels=(16, 32, 64, 128), head_proj=256)
GOLDENS = {
    "refexec_hrnet_v2.npz": ("v2", dict(
        num_channels=((8, 16), (9, 18, 36), (10, 20, 40, 80)), block=("BASIC",) * 3,
        head_block=("BOTTLENECK",) * 4, head_channels=(8, 16, 32, 64), head_proj=128)),
    "refexec_hrnet_v2_share.npz": ("v2_share", dict(
        num_channels=((8, 16), (8, 16, 32), (8, 16, 32, 64)), block=("BASIC",) * 3,
        head_block=("BOTTLENECK",) * 4, head_channels=(8, 16, 32, 64), head_proj=128)),
    "refexec_hrnet_v3.npz": ("v3", _INVERTED),
    "refexec_hrnet_v4.npz": ("v4", dict(_INVERTED, stem_spec="conv32s2maxpools2inv32e6x1")),
    "refexec_hrnet_v4_wose.npz": ("v4", dict(_INVERTED,
                                             stem_spec="conv32s2maxpools2inv32e2wosex1")),
}


@pytest.mark.parametrize("fname", sorted(GOLDENS))
def test_golden_through_the_port_loader(fname):
    """cls_hrnet_v2 / v2_share / v3 / v4 (two stems) executed whole; every
    leaf and statistic taken by ``hrnet_v_state_dict_to_tree``."""
    version, kw = GOLDENS[fname]
    spec = dict(_V_GOLDEN, **kw)
    g = np.load(os.path.join(GOLDEN, fname))
    sd = _sd(g)
    flat, stats = port_convert.hrnet_v_state_dict_to_tree(
        sd, version, stem_spec=spec.get("stem_spec", ""), num_modules=spec["num_modules"],
        num_branches=spec["num_branches"], num_blocks=spec["num_blocks"],
        num_channels=spec["num_channels"], block=spec["block"], head_block=spec["head_block"],
        head_proj=spec["head_proj"])
    model = port_hrnet.HRNetV(version=version, **spec, device="cpu")
    model.load_state_dict(port_convert.tower_state_dict(flat, stats), strict=True)
    np.testing.assert_allclose(_logits(model, g, sd), g["logits"], rtol=2e-4, atol=1e-4)


@pytest.fixture(scope="module")
def v2_share_pair():
    x = np.random.RandomState(2).standard_normal((4, 16, 16, 3)).astype(np.float32)
    return (x, *jax_reference(jax_hrnet.HRNetV(**V2_SHARE_TINY), x))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_v2_share_matches_jax(v2_share_pair, train):
    """v2_share with grouped basic blocks: the same, each shared stack one
    module (one parameter) whose gradient sums its resolutions' runs, and
    whose BN statistics are blended once a run, as flax blends them."""
    x, variables, cot, want = v2_share_pair
    hold_against_jax(port_hrnet.HRNetV(**V2_SHARE_TINY, device="cpu"), variables, x, cot, want,
                     train, "hrnet v2_share")


def test_finetune_main_bitfit_matches_jax(jax_traced_init, monkeypatch, tmp_path):
    """The few-shot driver's bitfit on the tiny v4 (the BN biases and the
    inverted residuals' conv biases train, the tower's BN in train mode, the
    statistics per cell): NO_TUNING, 2 epochs at lr 1e-4."""
    over = {**V4_CFG, "PEFT.METHOD": "bitfit", "TRAIN.END_EPOCH": 2, "TRAIN.LR": 1e-4}
    want, got = _run_both(monkeypatch, tmp_path, **over)
    assert len(got["losses"]) == len(want["losses"]) == 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert got["record"]["trainable_params"] == want["record"]["trainable_params"]


def test_full_round_trains_as_its_cells_one_by_one():
    """A round of 3 full fine-tune cells on the tiny v4 (the max-pool stem,
    the depthwise convs per cell, the chained fuse)."""
    cfg = tiny_cfg(port_config, **V4_CFG)
    model, _, _ = port_factory.build_image_classifier(cfg, spec_from_config(cfg), 5, use_bn=True,
                                                      device="cpu")
    round_against_cells(model, "full", image=16)
