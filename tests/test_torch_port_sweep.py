"""The port's ``SweepEngine.sweep`` against the JAX engine on the CPU,
through both packages' ``finetune_main`` on the tiny config of
``test_torch_port_driver`` with the JAX weights and initial trainables
handed to the port: the same rounds of (lr, wd) cells, the same scores, the
same choice, under the default refinement, ``SWEEP.REF_COMPAT`` and
``TRAIN.VMAP_SWEEP=False``."""

import numpy as np
import pytest

from test_torch_port_driver import _run_both


@pytest.mark.parametrize("ref_compat,vmap", [(False, True), (True, True), (False, False)])
def test_sweep_visits_and_chooses_as_jax(monkeypatch, tmp_path, ref_compat, vmap):
    """One block, a 2-lr grid over a 5-point wd grid (2 coarse points), 2
    epochs a cell: the same rounds of (lr, wd) cells in the same order, the
    same per-cell val scores (accuracy on 8 images: a step is 12.5 %, fp32
    logits differ by ~1e-6), the same choice, then the same final score."""
    over = {"TRAIN.NO_TUNING": False, "TRAIN.END_EPOCH": 2, "TRAIN.SEARCH_WD_POINTS": 5,
            "TRAIN.SEARCH_WD_INIT_POINTS": 2, "SWEEP.REF_COMPAT": ref_compat,
            "TRAIN.VMAP_SWEEP": vmap, "MODEL.SPEC.VISION.LAYERS": 1}
    want, got = _run_both(monkeypatch, tmp_path, lr_grid=[1e-3, 3e-2], **over)
    assert [c[:2] for c in got["cells"]] == [c[:2] for c in want["cells"]]
    for g, w in zip(got["cells"], want["cells"]):
        np.testing.assert_allclose(g[2], w[2], atol=1e-4)
    assert (got["record"]["lr"], got["record"]["wd"]) == (want["record"]["lr"],
                                                          want["record"]["wd"])
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    if vmap and not ref_compat:
        assert len(want["cells"][0][0]) == 2  # the coarse round trains together
