"""The port's small commands against the JAX package's, on the CPU:
``commands.read_results`` (the same table for the same logs),
``utils.submission`` (the same serialisation) and ``commands.debug_run``
(the same score as ``commands.run`` under anomaly detection, a raise at an
injected NaN, ``--check-leaks`` refused)."""

import json

import numpy as np
import pytest
import torch

from peft_vit_tpu.commands import read_results as jax_read_results
from peft_vit_tpu.utils import submission as jax_submission
from peft_vit_tpu_torch.commands import debug_run, read_results, run
from peft_vit_tpu_torch.utils import submission
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)


def _write_logs(root):
    """Two datasets' run logs as the driver writes them: a trainable-params
    line and the final accuracy as the last token; one log truncated."""
    accs = {("cifar-10", 5, 0): 81.25, ("cifar-10", 5, 1): 79.5, ("cifar-10", 10, 0): 90.0,
            ("dtd", 5, 0): 42.0}
    for (ds, shots, seed), acc in accs.items():
        d = root / ds
        d.mkdir(exist_ok=True)
        (d / f"finetuning_{shots}_seed{seed}.txt").write_text(
            f"=> config\ntrainable params: 0.0513M\n=> TEST accuracy: {acc}%\n")
    (root / "dtd" / "finetuning_10_seed0.txt").write_text("trainable params: 0.0513M\n=> trai")


def test_read_results_prints_the_jax_table(tmp_path, capsys):
    _write_logs(tmp_path)
    argv = ["--output", str(tmp_path), "--datasets", "cifar-10", "dtd", "--shots", "5", "10",
            "--seeds", "0", "1"]
    want = jax_read_results.main(argv)
    want_out = capsys.readouterr().out
    got = read_results.main(argv)
    assert capsys.readouterr().out == want_out
    assert json.dumps(got) == json.dumps(want)  # nan included, as the JAX table has it
    assert "AVERAGE" in want_out and "params: 0.0513M" in want_out


def _submissions():
    kw = dict(dataset_name="cifar-10", model_name="vitb32_CLIP",
              task="classification_multiclass", predictions=[[0.1, 0.9], [0.8, 0.2]],
              num_shots=5)
    return submission.PredictionSubmission(**kw), jax_submission.PredictionSubmission(**kw)


def test_submission_serialises_as_jax(tmp_path):
    port, jax_sub = _submissions()
    p, q = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    assert submission.submit_predictions(port, p) == p
    jax_submission.submit_predictions(jax_sub, q)
    assert open(p).read() == open(q).read()
    back = submission.PredictionSubmission.load(q)
    assert back == port


@pytest.mark.parametrize("bad", [{"task": "segmentation"}, {"predictions": [[float("nan")]]},
                                 {"predictions": []}, {"dataset_name": ""}])
def test_submission_rejects_what_jax_rejects(bad):
    kw = dict(dataset_name="x", model_name="m", task="classification_multiclass",
              predictions=[[0.0]])
    kw.update(bad)
    with pytest.raises(ValueError):
        jax_submission.PredictionSubmission(**kw).validate()
    with pytest.raises(ValueError):
        submission.PredictionSubmission(**kw).validate()


_TINY = ["--method", "lora", "--lr", "0.02",
         "DATASET.DATASET", "synthetic", "DATASET.NUM_CLASSES", "4",
         "DATASET.NUM_SAMPLES_PER_CLASS", "8", "TRAIN.IMAGE_SIZE", "[16,16]",
         "TRAIN.BATCH_SIZE_PER_GPU", "8", "TRAIN.SCHEDULE", "[]", "MODEL.NAME", "clip_tiny",
         "MODEL.SPEC.EMBED_DIM", "32", "MODEL.SPEC.VISION.PATCH_SIZE", "8",
         "MODEL.SPEC.VISION.WIDTH", "32", "MODEL.SPEC.VISION.LAYERS", "1",
         "MODEL.SPEC.VISION.HEADS", "2", "MODEL.SPEC.TEXT.WIDTH", "32",
         "MODEL.SPEC.TEXT.LAYERS", "1", "MODEL.SPEC.TEXT.HEADS", "2"]


def test_debug_run_scores_as_the_driver(tmp_path, monkeypatch):
    """The JAX test's tiny drive: debug_run (anomaly detection, one epoch,
    the sweep off) scores as ``commands.run`` with the same settings, and
    leaves anomaly detection off."""
    monkeypatch.chdir(tmp_path)
    out = ["OUTPUT_DIR", str(tmp_path)]
    score = debug_run.main(_TINY + out, device="cpu")
    want = run.main(_TINY + ["--no-tuning", "true", "TRAIN.END_EPOCH", "1"] + out, device="cpu")
    assert 0.0 <= score <= 100.0 and score == want
    assert not torch.is_anomaly_enabled()


def test_debug_run_raises_at_an_injected_nan(tmp_path, monkeypatch):
    """A NaN in the training images: the backward's anomaly check raises,
    naming the operation (the JAX debug_nans raise)."""
    real = run.construct_splits

    def with_nan(cfg):
        splits = real(cfg)
        splits.x_train[0, 0, 0, 0] = np.nan
        return splits

    monkeypatch.setattr(run, "construct_splits", with_nan)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="nan"):
        debug_run.main(_TINY + ["OUTPUT_DIR", str(tmp_path)], device="cpu")
    assert not torch.is_anomaly_enabled()


def test_debug_run_refuses_check_leaks(capsys):
    with pytest.raises(SystemExit):
        debug_run.main(["--check-leaks", *_TINY], device="cpu")
    assert "no PyTorch counterpart" in capsys.readouterr().err
