"""The port's cls_hrnet (``peft_vit_tpu_torch/models/hrnet.py::HRNet``)
against the JAX module (``peft_vit_tpu/models/hrnet.py``), against the
executed reference's tower (``tests/golden/refexec_hrnet.npz``) through the
port's loader, the factory's five HRNet names against the JAX builder's
trees, and the full-shot Trainer's epoch against the JAX Trainer (on the
tiny v4).  The v2-v4 family's goldens, module and drivers are in
``test_torch_port_hrnet_v.py``.

Tolerances: the golden at the JAX test's own rtol 2e-4, atol 1e-4; the
upsample exactly.  The module is held in float64, at ``_port_zoo.TOL_F64``
(1e-8 of the largest reference value) for the forward, the BN statistics
and every gradient: at random weights its train-mode gradients are
ill-conditioned in fp32, where either package's input gradient stands
1.3-1.9e-2 from float64's (and some BN biases' 0.7-14e-2), the two as far
from each other.  The trainer runs the tiny v4, as ``_port_zoo`` states.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _port_zoo import TOL_F64, hold_against_jax, jax_reference, trainer_against_jax
from peft_vit_tpu.models import hrnet as jax_hrnet
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.models import convert as port_convert
from peft_vit_tpu_torch.models import factory as port_factory
from peft_vit_tpu_torch.models import hrnet as port_hrnet
from peft_vit_tpu_torch.peft import spec_from_config
from test_torch_port_driver import tiny_cfg
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# cls_hrnet at width 4 with 2 branches (the golden holds the fuse's chained
# down paths of 3 and 4), at 32 px
V1_TINY = dict(width=4, stage_modules=(1,))
# v2_share with groups on the shared basic blocks: one stack a resolution,
# run on the channel split of every lower branch
V2_SHARE_TINY = dict(version="v2_share", num_modules=(1,), num_branches=(2,),
                     num_blocks=((1, 1),), num_channels=((8, 16),), block=("BASIC",),
                     groups=((1, 2),), head_block=("BOTTLENECK",) * 2, head_channels=(4, 8),
                     head_proj=32, with_se=True)
# v4 with one stage of two branches: the max-pool stem, inverted residuals
# (depthwise, SE, biased convs), the chained fuse, the INVERTED head
V4_EXTRA = {"WITH_SE": True, "STEM_SPEC": "conv32s2maxpools2inv32e6x1",
            "STAGES_SPEC": {"NUM_MODULES": [1], "NUM_BRANCHES": [2], "NUM_BLOCKS": [[1, 1]],
                            "NUM_CHANNELS": [[8, 16]], "BLOCK": ["INVERTED"]},
            "HEAD_SPEC": {"BLOCK": ["INVERTED"] * 2, "NUM_CHANNELS": [16, 32],
                          "NUM_CHANNELS_PROJ": 64}}
V4_CFG = {"MODEL.NAME": "cls_hrnet_v4", "MODEL.EXTRA": V4_EXTRA}
V1_CFG = {"MODEL.NAME": "cls_hrnet", "MODEL.SPEC.VISION.HRNET_WIDTH": 4,
          "MODEL.SPEC.VISION.STAGE_MODULES": [1]}


def test_upsample_nearest_matches_jax():
    x = np.random.RandomState(0).standard_normal((2, 3, 5, 4)).astype(np.float32)
    for f in (2, 4):
        want = np.asarray(jax_hrnet._upsample_nearest(jnp.asarray(x), f))
        got = port_hrnet._upsample_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), f)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def _sd(g):
    return {k[len("sd__"):].replace("__", "."): np.asarray(v) for k, v in g.items()
            if k.startswith("sd__")}


def _logits(model, g, sd):
    with torch.no_grad():
        feats = model.eval()(torch.from_numpy(np.ascontiguousarray(g["x"].transpose(0, 2, 3, 1))))
    return feats.numpy() @ sd["classifier.weight"].T + sd["classifier.bias"]


def test_golden_through_the_port_loader():
    """cls_hrnet.py executed at W8, 3 stages: the stem, layer1, the
    transitions, the branches, every fuse path and the biased head convs;
    every leaf and statistic taken by ``hrnet_state_dict_to_tree``."""
    g = np.load(os.path.join(GOLDEN, "refexec_hrnet.npz"))
    sd = _sd(g)
    model = port_hrnet.HRNet(width=int(g["w"]), stage_modules=(1, 1, 1), device="cpu")
    model.load_state_dict(port_convert.tower_state_dict(
        *port_convert.hrnet_state_dict_to_tree(sd)), strict=True)
    np.testing.assert_allclose(_logits(model, g, sd), g["logits"], rtol=2e-4, atol=1e-4)


@pytest.fixture(scope="module")
def v1_pair():
    x = np.random.RandomState(1).standard_normal((4, 32, 32, 3))
    return (x, *jax_reference(jax_hrnet.HRNet(**V1_TINY, dtype=jnp.float64), x, float64=True))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_hrnet_matches_jax(v1_pair, train):
    """cls_hrnet in float64: the forward, in train mode the new BN
    statistics, and the gradient of every parameter and of the input."""
    x, variables, cot, want = v1_pair
    hold_against_jax(port_hrnet.HRNet(**V1_TINY, device="cpu"), variables, x, cot, want, train,
                     "hrnet", TOL_F64)


@pytest.mark.parametrize("name", ["cls_hrnet", "cls_hrnet_v2", "cls_hrnet_v2_share",
                                  "cls_hrnet_v3", "cls_hrnet_v4"])
def test_factory_builds_every_version(name):
    """cls_hrnet from ``MODEL.SPEC.VISION``; v2 / v2_share from
    ``MODEL.SPEC`` (``STAGES``, ``HEAD``, ``WITH_SE``), v3 / v4 from
    ``MODEL.EXTRA``, as the JAX builder reads them: the JAX builder's
    leaves, a forward."""
    from peft_vit_tpu import config as jax_config
    from peft_vit_tpu.models.factory import _build_hrnet_backbone
    from peft_vit_tpu_torch.models.convert import params_to_jax

    if name == "cls_hrnet":
        over = V1_CFG
    elif name in ("cls_hrnet_v3", "cls_hrnet_v4"):
        over = {"MODEL.NAME": name, "MODEL.EXTRA": dict(
            V4_EXTRA, STEM_SPEC="conv32s2maxpools2inv32e6x1" if name.endswith("v4") else "")}
    else:
        over = {"MODEL.NAME": name, "MODEL.SPEC.WITH_SE": True,
                "MODEL.SPEC.STAGES": {k.upper(): list(v) for k, v in (
                    ("num_modules", V2_SHARE_TINY["num_modules"]),
                    ("num_branches", V2_SHARE_TINY["num_branches"]),
                    ("num_blocks", [list(b) for b in V2_SHARE_TINY["num_blocks"]]),
                    ("num_channels", [list(c) for c in V2_SHARE_TINY["num_channels"]]),
                    ("block", V2_SHARE_TINY["block"]))},
                "MODEL.SPEC.HEAD": {"BLOCK": list(V2_SHARE_TINY["head_block"]),
                                    "NUM_CHANNELS": list(V2_SHARE_TINY["head_channels"]),
                                    "NUM_CHANNELS_PROJ": V2_SHARE_TINY["head_proj"]}}
    cfg = tiny_cfg(port_config, **over)
    model, _, encode_text = port_factory.build_image_classifier(cfg, spec_from_config(cfg), 5,
                                                                device="cpu")
    assert encode_text is None
    jm = _build_hrnet_backbone(tiny_cfg(jax_config, **over), jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    got = params_to_jax(model.backbone.state_dict())
    for col in ("params", "batch_stats"):
        want = {k: v.shape for k, v in traverse_util.flatten_dict(shapes[col], sep="/").items()}
        assert {k: v.shape for k, v in traverse_util.flatten_dict(
            got[col], sep="/").items()} == want, col
    with torch.no_grad():
        assert model.eval()(torch.zeros(2, 16, 16, 3)).shape == (2, 5)


def test_trainer_epoch_matches_jax():
    """The full-shot Trainer's epoch on the tiny v4 against the JAX Trainer."""
    trainer_against_jax(V4_CFG, image=16)
