"""The few-shot driver on CLIP's ModifiedResNet tower through both packages:
``finetune_main`` (linear, bitfit, full) with the tower's BatchNorm in train
mode in every step and its statistics carried per cell, as the JAX step
does, and bitfit's sweep of rounds.  Each package's driver is fed the same
weights and initial trainables (``test_torch_port_driver._run_both``).  The
tower itself, its loaders, the factory, zero-shot and the logistic probe are
in ``test_torch_port_clip_resnet.py``.

Tolerances: the epoch losses within 1e-4 relative (fp32, the same
arithmetic summed in other orders), the sweep's scores within 1e-3, the
same choice and score.
"""

import numpy as np
import pytest

from test_torch_port_clip_resnet import RN_TINY, jax_build_once  # noqa: F401 (a fixture)
from test_torch_port_driver import _run_both
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("method", ["linear", "bitfit", "full"])
def test_finetune_main_on_the_rn_tower_matches_jax(jax_build_once, monkeypatch, tmp_path,
                                                   method):
    """The few-shot driver on rn_tiny_cfg: the tower's BN in train mode in
    every step (as the JAX step), its statistics per cell; NO_TUNING, 2
    epochs at lr 1e-4: epoch losses within 1e-4 relative, the same score."""
    over = {**RN_TINY, "PEFT.METHOD": method, "TRAIN.END_EPOCH": 2, "TRAIN.LR": 1e-4}
    want, got = _run_both(monkeypatch, tmp_path, **over)
    assert len(got["losses"]) == len(want["losses"]) == 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert got["record"]["trainable_params"] == want["record"]["trainable_params"]


def test_finetune_main_rn_sweep_matches_jax(jax_build_once, monkeypatch, tmp_path):
    """bitfit's sweep on the RN tower (rounds of cells, each with its own BN
    statistics): the same rounds, scores and choice."""
    over = {**RN_TINY, "PEFT.METHOD": "bitfit", "TRAIN.END_EPOCH": 2, "TRAIN.NO_TUNING": False,
            "TRAIN.SEARCH_WD_LOG_UPPER": -2}
    want, got = _run_both(monkeypatch, tmp_path, lr_grid=(1e-3, 3e-2), **over)
    assert len(got["cells"]) == len(want["cells"]) > 0
    for (gl, gw, gs), (wl, ww, ws) in zip(got["cells"], want["cells"]):
        np.testing.assert_allclose(gl, wl)
        np.testing.assert_allclose(gw, ww)
        np.testing.assert_allclose(gs, ws, atol=1e-3)
    assert (got["record"]["lr"], got["record"]["wd"]) == (want["record"]["lr"],
                                                           want["record"]["wd"])
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)


def test_fewshot_step_refuses_dropblock_in_both(tmp_path):
    """A DropBlock ResNet under the few-shot driver: the JAX step applies
    the model without a ``dropblock`` PRNG stream and flax refuses the
    train-mode forward; the port's step passes no generator and the
    ResNet refuses it the same way, on the first step."""
    from flax.errors import InvalidRngError

    import peft_vit_tpu.commands.run as jax_run
    import peft_vit_tpu_torch.commands.run as port_run
    from peft_vit_tpu import config as jax_config
    from peft_vit_tpu_torch import config as port_config
    from test_torch_port_clip_resnet import _jit_init
    from test_torch_port_driver import tiny_cfg

    over = {"MODEL.NAME": "resnet50", "MODEL.SPEC.VISION.MODEL": "resnet",
            "MODEL.SPEC.VISION.LAYERS_PER_STAGE": [1, 1, 1, 1],
            "MODEL.SPEC.VISION.STEM_WIDTH": 8, "TRAIN.IMAGE_SIZE": [32, 32],
            "AUG.DROPBLOCK_KEEP_PROB": 0.9, "PEFT.METHOD": "linear", "TRAIN.END_EPOCH": 1}
    with pytest.raises(InvalidRngError, match="dropblock"), _jit_init():
        jax_run.finetune_main(tiny_cfg(jax_config, **over), str(tmp_path))
    with pytest.raises(ValueError, match="through DropBlock needs its generator"):
        port_run.finetune_main(tiny_cfg(port_config, **over), str(tmp_path), device="cpu")
