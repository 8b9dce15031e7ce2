"""The full-shot slice end to end through the port on the CPU: the executed
reference's epoch loop (``tests/golden/refexec_trainer_epoch_vit.npz``, the
timm ViT leg of ``tests/test_refexec_trainer_epoch.py``) and the commands
``train``, ``swa_finetune`` and ``bit_finetune`` against the JAX commands on
the synthetic task, the JAX builder's weights handed to the port.

Tolerances: the golden at the JAX test's own (epoch losses rtol 2e-3, atol
2e-4; val and EMA top-1 1e-6; the rates 1e-6 relative); the commands' epoch
losses within 1e-5 relative of the JAX commands' and the same best top-1.
The golden's ResNet leg waits for the backbone zoo (ROADMAP §1).
"""

import os

import numpy as np
import pytest

from peft_vit_tpu.commands import bit_finetune as jax_bit
from peft_vit_tpu.commands import swa_finetune as jax_swa
from peft_vit_tpu.commands import train as jax_train
from peft_vit_tpu.config import get_default_config as jax_config
from peft_vit_tpu.engine import trainer as jax_trainer
from peft_vit_tpu.models import factory as jax_factory
from peft_vit_tpu.peft import spec_from_config as jax_spec
from peft_vit_tpu_torch.commands import bit_finetune as port_bit
from peft_vit_tpu_torch.commands import swa_finetune as port_swa
from peft_vit_tpu_torch.commands import train as port_train
from peft_vit_tpu_torch.config import get_default_config
from peft_vit_tpu_torch.engine import trainer as port_trainer
from peft_vit_tpu_torch.engine.trainer import Trainer
from peft_vit_tpu_torch.models import ImageClassifier, load_jax_variables
from peft_vit_tpu_torch.models.convert import timm_vit_state_dict, timm_vit_state_dict_to_tree
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.peft import build_mask

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _set(cfg, over):
    for key, value in over.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


def test_trainer_reproduces_the_executed_reference_epoch_loop():
    """cls_vit + the recorded mixup soft targets + label smoothing + the
    global-norm clip 1.0 + EMA(0.9) + MultiStep[2] at 0.1: the per-epoch
    mean losses, the raw and EMA val top-1 and the per-epoch rates of the
    reference's own train_one_epoch and test."""
    g = np.load(os.path.join(GOLDEN, "refexec_trainer_epoch_vit.npz"))
    sd = {k[len("sd."):]: np.asarray(v) for k, v in g.items() if k.startswith("sd.")}
    width = sd["cls_token"].shape[-1]
    layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    patch = sd["patch_embed.proj.weight"].shape[-1]
    image = patch * int(np.sqrt(sd["pos_embed"].shape[1] - 1))
    classes = sd["head.weight"].shape[0]
    model = ImageClassifier(VisionTransformer(image_size=image, patch_size=patch, width=width,
                                              layers=layers, heads=int(g["heads"]),
                                              style="timm", device="cpu"),
                            num_classes=classes, device="cpu")
    state = timm_vit_state_dict(timm_vit_state_dict_to_tree(sd))
    import torch

    state["classifier.head.weight"] = torch.from_numpy(sd["head.weight"])
    state["classifier.head.bias"] = torch.from_numpy(sd["head.bias"])
    model.load_state_dict(state, strict=True)

    epochs, batch = int(g["epochs"]), int(g["batch"])
    cfg = _set(get_default_config(), {
        "DATASET.NUM_CLASSES": classes, "MODEL.NUM_CLASSES": classes,
        "TRAIN.BATCH_SIZE_PER_GPU": batch, "TRAIN.END_EPOCH": epochs,
        "TRAIN.LR": float(g["lr"]), "TRAIN.WD": float(g["wd"]), "TRAIN.OPTIMIZER": "sgd",
        "TRAIN.MOMENTUM": 0.9, "TRAIN.NESTEROV": True,
        "TRAIN.CLIP_GRAD_NORM": float(g["clip_norm"]),
        "TRAIN.LR_SCHEDULER.METHOD": "multistep",
        "TRAIN.SCHEDULE": [int(m) for m in g["milestones"]], "PRINT_FREQ": 1,
        "AUG.RANDOM_FLIP": False, "LOSS.LOSS": "soft_target",
        "TRAIN.EMA_DECAY": float(g["ema_decay"])})
    per = g["mixed_x"].shape[0] // epochs
    trainer = Trainer(cfg, model, build_mask(model, "full", num_layers=layers), per)

    def val():
        for i in range(0, len(g["y_val"]), batch):
            yield np.ascontiguousarray(g["x_val"][i:i + batch].transpose(0, 2, 3, 1)), \
                g["y_val"][i:i + batch]

    losses, top1, top1_ema = [], [], []
    for e in range(epochs):
        batches = ((np.ascontiguousarray(g["mixed_x"][e * per + i].transpose(0, 2, 3, 1)),
                    g["mixed_y"][e * per + i]) for i in range(per))
        losses.append(trainer.train_one_epoch(batches, e)["loss"])
        top1.append(trainer.evaluate(val()))
        top1_ema.append(trainer.evaluate(val(), use_ema=True))
    np.testing.assert_allclose(losses, g["epoch_losses"], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(top1, g["val_top1"], atol=1e-6)
    np.testing.assert_allclose(top1_ema, g["val_top1_ema"], atol=1e-6)
    lrs = [float(trainer.schedule(e * per)) for e in range(epochs)]
    np.testing.assert_allclose(lrs, g["lrs"], rtol=1e-6)


# -- the commands against the JAX commands -------------------------------------------

TINY = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 4, "MODEL.NUM_CLASSES": 4,
        "MODEL.NAME": "cls_vit_tiny", "MODEL.SPEC.VISION.PATCH_SIZE": 8,
        "MODEL.SPEC.VISION.WIDTH": 32, "MODEL.SPEC.VISION.LAYERS": 2,
        "MODEL.SPEC.VISION.HEADS": 2, "TRAIN.IMAGE_SIZE": [16, 16],
        "TEST.BATCH_SIZE_PER_GPU": 16, "TRAIN.END_EPOCH": 2, "TRAIN.LR": 0.01,
        "TRAIN.MOMENTUM": 0.9, "TRAIN.LR_SCHEDULER.METHOD": "warmupcosine",
        "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 1, "PRINT_FREQ": 1, "NAME": "tiny"}
BATCH = 8


@pytest.fixture
def one_jax_device(monkeypatch):
    """The JAX command on one device, as the port runs: without it the JAX
    command builds a data-parallel mesh over the 8 virtual CPU devices of
    the test session (the same sums, sharded, and many times the compile)."""
    monkeypatch.setattr(jax_train.jax, "device_count", lambda: 1)


def _jax_variables(cfg, num_classes=4):
    """The JAX command's own weights: its builder at PRNGKey(0)."""
    import jax

    _, variables, _ = jax_factory.build_image_classifier(cfg, jax_spec(cfg), num_classes)
    return jax.device_get(variables)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny tensors: as fast alone, and it
    does not contend with the other test processes for the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The commands' TensorBoard writers off (``test_torch_port_trainer``
    holds the port's): importing the backend costs seconds."""
    import peft_vit_tpu.utils.tb as jax_tb
    import peft_vit_tpu_torch.utils.tb as port_tb

    for module in (jax_tb, port_tb):
        monkeypatch.setattr(module, "create_scalar_writer", lambda log_dir: None)


def _epoch_losses(monkeypatch, module):
    seen = []
    original = module.Trainer.train_one_epoch

    def spy(self, *args, **kwargs):
        stats = original(self, *args, **kwargs)
        seen.append(stats["loss"])
        return stats

    monkeypatch.setattr(module.Trainer, "train_one_epoch", spy)
    return seen


def _graft_jax_weights(monkeypatch, variables):
    """``commands.train`` builds its model, then takes the JAX weights."""
    original = port_train.build_image_classifier

    def build(*args, **kwargs):
        model, params, encode = original(*args, **kwargs)
        load_jax_variables(model, variables)
        return model, dict(model.named_parameters()), encode

    monkeypatch.setattr(port_train, "build_image_classifier", build)


@pytest.mark.parametrize("command", ["train", "swa_finetune"])
def test_train_and_swa_commands_match_the_jax_commands(command, monkeypatch, tmp_path,
                                                       one_jax_device):
    over = dict(TINY)
    if command == "swa_finetune":
        over.update({"SWA.BEGIN_EPOCH": 1, "SWA.ANNEAL_EPOCHS": 1, "TRAIN.END_EPOCH": 3})
    jcfg = _set(jax_config(), {**over, "TRAIN.BATCH_SIZE_PER_GPU": BATCH,
                               "OUTPUT_DIR": str(tmp_path / "jax")})
    variables = _jax_variables(jcfg)
    jax_losses = _epoch_losses(monkeypatch, jax_trainer)
    port_losses = _epoch_losses(monkeypatch, port_trainer)
    _graft_jax_weights(monkeypatch, variables)
    argv = [str(a) for k, v in over.items() for a in (k, v if not isinstance(v, list) else
                                                      str(v))]
    if command == "train":
        want = jax_train.train_main(jcfg)
        got = port_train.main(argv + ["TRAIN.BATCH_SIZE_PER_GPU", str(BATCH), "OUTPUT_DIR",
                                      str(tmp_path / "port")], device="cpu")
    else:
        want = jax_swa.main(argv + ["TRAIN.BATCH_SIZE_PER_GPU", str(BATCH), "OUTPUT_DIR",
                                    str(tmp_path / "jax")])
        got = port_swa.main(argv + ["TRAIN.BATCH_SIZE_PER_GPU", str(BATCH), "OUTPUT_DIR",
                                    str(tmp_path / "port")], device="cpu")
    assert len(port_losses) == len(jax_losses) == int(over["TRAIN.END_EPOCH"])
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    assert got == want
    ckpts = tmp_path / "port" / "synthetic" / "tiny" / "checkpoints"
    assert sorted(os.listdir(ckpts))[-1].endswith(".pt")


def test_swa_finetune_forces_swa_swalr_and_resume():
    cfg = port_swa.swa_config(_set(get_default_config(), {"TRAIN.BEGIN_EPOCH": 3}))
    assert cfg.SWA.ENABLED and cfg.SWA.BEGIN_EPOCH == 3 and cfg.TRAIN.AUTO_RESUME
    assert cfg.TRAIN.LR_SCHEDULER.METHOD == "swalr"


def test_bit_finetune_matches_the_jax_command(monkeypatch, tmp_path):
    """The HyperRule on 64 training images: 500 steps in 62 epochs of 8, the
    step decay at 200, 300 and 400, lr 0.003 x 8 / 512, no weight decay."""
    # PRINT_FREQ 8: an epoch's loss is the mean of its first and last steps
    over = {**TINY, "TRAIN.BATCH_SIZE_PER_GPU": 8, "TRAIN.LR_SCHEDULER.METHOD": "step",
            "PRINT_FREQ": 8}
    jcfg = _set(jax_config(), {**over, "OUTPUT_DIR": str(tmp_path / "jax")})
    pcfg = _set(get_default_config(), {**over, "OUTPUT_DIR": str(tmp_path / "port")})
    variables = _jax_variables(jcfg)
    jax_losses = _epoch_losses(monkeypatch, jax_trainer)
    port_losses = _epoch_losses(monkeypatch, port_trainer)
    want = jax_bit.bit_main(jcfg)
    got = port_bit.bit_main(pcfg, device="cpu", variables=variables)
    assert port_bit.bit_hyperrule(64) == jax_bit.bit_hyperrule(64) == (500, (200, 300, 400))
    assert pcfg.TRAIN.END_EPOCH == 62 and pcfg.TRAIN.SCHEDULE == [25, 37, 50]
    assert pcfg.TRAIN.LR == pytest.approx(0.003 * 8 / 512)
    assert len(port_losses) == len(jax_losses) == 62
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-5)
    assert got == want


@pytest.mark.parametrize("over", [{"DATASET.TRAIN_TSV_LIST": ["train.tsv"]},
                                  {"DATASET.TRAIN_SET": "train"}])
def test_train_main_refuses_streaming_sources(over, tmp_path, monkeypatch):
    """The JAX command streams TSV shards and ImageFolder trees, and so does
    the port's now (it once refused them): the batches come from
    ``StreamingSource`` through the native decode ring, raw uint8 at
    B granularity, and evaluation streams the test split
    (``tests/test_torch_port_data_sources.py`` holds the run against JAX)."""
    from _port_data import images, write_folder, write_tsv
    from peft_vit_tpu_torch.data import streaming

    train, test = images(4, 6, seed=1), images(4, 2, seed=2)
    if "DATASET.TRAIN_TSV_LIST" in over:
        write_tsv(tmp_path / "train.tsv", train)
        write_tsv(tmp_path / "test.tsv", test)
    else:
        write_folder(tmp_path / "train", train, ["a", "b", "c", "d"])
        write_folder(tmp_path / "test", test, ["a", "b", "c", "d"])
    seen = []
    original = streaming.StreamingSource.batches

    def spy(self, *args, **kwargs):
        for item in original(self, *args, **kwargs):
            seen.append((self.split, item[0].dtype, item[0].shape))
            yield item

    monkeypatch.setattr(streaming.StreamingSource, "batches", spy)
    cfg = _set(get_default_config(), {**TINY, "DATASET.DATASET": "folder_task",
                                      "DATASET.ROOT": str(tmp_path),
                                      "DATASET.TEST_SET": "test",
                                      "TRAIN.BATCH_SIZE_PER_GPU": BATCH,
                                      "OUTPUT_DIR": str(tmp_path / "out"),
                                      "DATASET.TEST_TSV_LIST": (
                                          ["test.tsv"] if "DATASET.TRAIN_TSV_LIST" in over
                                          else []), **over})
    best = port_train.train_main(cfg, device="cpu")
    assert 0.0 <= best <= 100.0
    trains = [s for s in seen if s[0] == "train"]
    assert len(trains) == 2 * (24 // BATCH)  # 2 epochs, drop_last at B
    assert all(d == np.uint8 and shape == (BATCH, 16, 16, 3) for _, d, shape in trains)
    assert sum(s[2][0] for s in seen if s[0] == "test") == 2 * 8  # an eval an epoch
