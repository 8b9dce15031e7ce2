"""The port's few-shot driver against the JAX package's for the PEFT methods
the port added beside LoRA: ``finetune_main`` of both packages on the tiny
config of ``test_torch_port_driver`` (clip_tiny, width 32, 2 heads, 16 px,
synthetic 4-way 8-shot, batch 8) at one block (the probe's is a second) with the JAX weights and each cell's JAX
initial trainables handed to the port, a 2-lr grid over a 5-point wd grid
(2 coarse points), 2 epochs a cell: the same rounds of (lr, wd) cells, the
same per-cell val scores, the same choice and the same test score, as
``test_torch_port_sweep`` holds LoRA.  KAdaptation at phm_dim 4 (the
default, the reference's 768, does not divide width 32); the transformer
probe with ``TRAIN.CACHE_FROZEN_PREFIX`` False, which the port requires.
Every other method is held by the hook and round tests."""

import numpy as np
import pytest
import torch

from test_torch_port_driver import _run_both

METHODS = {
    "kadaptation": {"PEFT.PHM_DIM": 4},
    "adapter": {},
    "compacter": {},
    "vpt": {},
    "transformer_probe": {"TRAIN.CACHE_FROZEN_PREFIX": False},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny tensors: as fast alone, and it
    does not contend with the other test processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_driver_sweeps_and_chooses_as_jax(monkeypatch, tmp_path, method):
    """Accuracy on 8 images: a step is 12.5 %, fp32 logits differ by ~1e-6,
    so the per-cell scores are held at 1e-4, the choice and the score
    exactly as the LoRA sweep test holds them."""
    over = {"TRAIN.NO_TUNING": False, "TRAIN.END_EPOCH": 2, "TRAIN.SEARCH_WD_POINTS": 5,
            "TRAIN.SEARCH_WD_INIT_POINTS": 2, "MODEL.SPEC.VISION.LAYERS": 1,
            "PEFT.METHOD": method, **METHODS[method]}
    want, got = _run_both(monkeypatch, tmp_path, lr_grid=[1e-3, 3e-2], **over)
    assert [c[:2] for c in got["cells"]] == [c[:2] for c in want["cells"]]
    for g, w in zip(got["cells"], want["cells"]):
        np.testing.assert_allclose(g[2], w[2], atol=1e-4)
    assert (got["record"]["lr"], got["record"]["wd"]) == (want["record"]["lr"],
                                                          want["record"]["wd"])
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert got["record"]["trainable_params"] == want["record"]["trainable_params"]


@pytest.mark.parametrize("method", ["adapterdrop", "lora_fix_one", "lora_moe", "lora_adapter",
                                    "lora_compacter", "lora_drop_adapter", "lepe"])
def test_finetune_main_runs_the_other_methods_on_the_cpu(tmp_path, method):
    """The methods the JAX comparison above leaves out, through the port's
    driver alone (``NO_TUNING``, 2 epochs): a finite score written to
    results.jsonl with the method's trainable count.  AdapterDrop trains
    only its last block's adapter, so it needs ``CACHE_FROZEN_PREFIX``
    False."""
    import json

    import peft_vit_tpu_torch.commands.run as port_run
    from peft_vit_tpu_torch import config as port_config
    from test_torch_port_driver import tiny_cfg

    cfg = tiny_cfg(port_config, **{"PEFT.METHOD": method, "TRAIN.END_EPOCH": 2,
                                   "TRAIN.LR": 1e-3, "TRAIN.CACHE_FROZEN_PREFIX": False})
    score = port_run.finetune_main(cfg, str(tmp_path), device="cpu")
    record = json.loads((tmp_path / "results.jsonl").read_text().splitlines()[-1])
    assert 0.0 <= score <= 100.0 and record["score"] == score and record["method"] == method
    assert record["trainable_params"] > 0
