"""The port's on-disk data sources (``peft_vit_tpu_torch/data/{registry,
elevater,custom,hub}.py``) and the two drivers on them, against the JAX
package on the CPU: ``load_tsv`` and ``load_imagefolder`` (PIL, bicubic, as
in JAX), the ELEVATER coco and txt splits with their class names registered
for the prompts, ``scan_zip_split``, the VOC2007 and ChestX-ray8 parsers, the
hub's resolution and its refusal to download; then ``finetune_main`` on a
tiny ELEVATER manifest and ``train_main`` streaming TSV shards, through both
packages.

Tolerances: the loaders and parsers exactly (the same decoder on both
sides: PIL, or the native runtime built from one source); the sweep's
per-cell val scores within 1e-4 with the same cells, choice and score, as
``test_torch_port_sweep``; the full-shot epoch losses within 1e-4 relative
and the same best top-1.  Every registration (datasets, prompts) is undone
after each test, in both packages.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
from PIL import Image

from _port_data import images, png, write_folder, write_manifest, write_tsv
from peft_vit_tpu.data import custom as jax_custom
from peft_vit_tpu.data import elevater as jax_elevater
from peft_vit_tpu.data import hub as jax_hub
from peft_vit_tpu.data import prompts as jax_prompts
from peft_vit_tpu.data import registry as jax_registry
from peft_vit_tpu_torch.data import custom, elevater, hub, prompts, registry
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

CLASSES = ["ant", "bee", "cat"]


@pytest.fixture(autouse=True)
def isolated_registries():
    """Undo what a manifest registers (its DatasetInfo, its class names)."""
    saved = [(m, dict(getattr(m, a))) for m, a in (
        (registry, "_INFO"), (jax_registry, "_INFO"), (prompts, "_builtin_cache"),
        (jax_prompts, "_builtin_cache"))]
    yield
    for (module, copy), attr in zip(saved, ("_INFO", "_INFO", "_builtin_cache",
                                            "_builtin_cache")):
        live = getattr(module, attr)
        live.clear()
        live.update(copy)


def _cfg(factory, **over):
    cfg = factory()
    cfg.TRAIN.IMAGE_SIZE = [16, 16]
    for key, value in over.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


def _both(**over):
    from peft_vit_tpu.config import get_default_config as jax_config
    from peft_vit_tpu_torch.config import get_default_config as port_config

    return _cfg(port_config, **over), _cfg(jax_config, **over)


def _equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_tsv_and_imagefolder_loaders_equal_jax(tmp_path):
    items = images(3, 3, seed=1)
    write_tsv(tmp_path / "a.tsv", items[:5])
    write_tsv(tmp_path / "b.tsv", items[5:])
    paths = [str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")]
    _equal(registry.load_tsv(paths, 16), jax_registry.load_tsv(paths, 16))
    with open(tmp_path / "multi.tsv", "w") as f:  # a multilabel row one-hots the split
        f.write(f"k0\t{__import__('base64').b64encode(png(items[0][0])).decode()}\t0;2\n")
    got = registry.load_tsv(str(tmp_path / "multi.tsv"), 16, num_classes=3)
    _equal(got, jax_registry.load_tsv(str(tmp_path / "multi.tsv"), 16, num_classes=3))
    assert got[1].tolist() == [[1, 0, 1]]
    write_folder(tmp_path / "tree", items, CLASSES)
    (tmp_path / "tree" / "ant" / "notes.txt").write_text("not an image")
    _equal(registry.load_imagefolder(str(tmp_path / "tree"), 16),
           jax_registry.load_imagefolder(str(tmp_path / "tree"), 16))


@pytest.mark.parametrize("fmt", ["coco", "txt"])
def test_elevater_splits_equal_jax_and_register_their_classes(tmp_path, fmt):
    """``load_split`` through a manifest: the images (the native decode),
    labels, the class names registered for the prompts and the dataset's
    DatasetInfo; ``scan_zip_split``'s (zip, members, labels)."""
    write_manifest(tmp_path, f"toy-{fmt}", {"train": images(3, 3, seed=2),
                                            "test": images(3, 1, seed=3)}, CLASSES, fmt)
    over = {"DATASET.DATASET": f"toy-{fmt}", "DATASET.ROOT": str(tmp_path)}
    for split in ("train", "test"):
        pc, jc = _both(**over)
        got = registry.load_split(pc, split)
        _equal(got, jax_registry.load_split(jc, split))
        assert got[0].shape == ((9 if split == "train" else 3), 16, 16, 3)
    assert prompts.class_map(f"toy-{fmt}") == jax_prompts.class_map(f"toy-{fmt}") == CLASSES
    assert dataclasses.asdict(registry.dataset_info(f"toy-{fmt}")) == dataclasses.asdict(
        jax_registry.dataset_info(f"toy-{fmt}"))
    pc, jc = _both(**over)
    if fmt == "coco":
        got = elevater.scan_zip_split(pc, "train")
        assert got == jax_elevater.scan_zip_split(jc, "train") and len(got[1]) == 9
    else:  # the JAX quirk kept: the streaming scan reads every index as json
        for scan, cfg in ((elevater.scan_zip_split, pc), (jax_elevater.scan_zip_split, jc)):
            with pytest.raises(ValueError):
                scan(cfg, "train")


def test_voc_and_chestx_parsers_equal_jax(tmp_path):
    voc = tmp_path / "VOCdevkit" / "VOC2007"
    (voc / "ImageSets" / "Main").mkdir(parents=True)
    (voc / "JPEGImages").mkdir()
    for i, (x, _) in enumerate(images(2, 2, seed=4)):
        Image.fromarray(x).save(voc / "JPEGImages" / f"00{i}.jpg", quality=95)
    for cls, flags in (("cat", "1 -1 0 1"), ("dog", "-1 1 1 -1")):
        lines = [f"00{i} {f}" for i, f in enumerate(flags.split())]
        (voc / "ImageSets" / "Main" / f"{cls}_train.txt").write_text("\n".join(lines) + "\n")
    got, want = custom.voc2007_classification(str(tmp_path)), jax_custom.voc2007_classification(
        str(tmp_path))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    _equal([custom.load_image_paths(got[0], 16)], [jax_custom.load_image_paths(want[0], 16)])
    chest = tmp_path / "chest"
    (chest / "images").mkdir(parents=True)
    (chest / "Data_Entry_2017.csv").write_text(
        "Image Index,Finding Labels\na.png,Mass|Nodule\nb.png,No Finding\nc.png,Effusion\n")
    (chest / "train_val_list.txt").write_text("a.png\nc.png\n")
    for split in ("train", "test"):
        got, want = custom.chestxray8(str(chest), split), jax_custom.chestxray8(str(chest), split)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


def test_hub_resolves_provisioned_files_and_refuses_to_download(tmp_path):
    """The shipped registry, entry resolution and file lists equal JAX's;
    provisioned files resolve with no network; missing files raise the
    provisioning message, and the port never fetches, with ``download`` or
    without (the JAX side is called without it only: it would fetch)."""
    assert hub.load_registry() == jax_hub.load_registry()
    entry = hub.resolve_entry("cifar-10")
    assert entry == jax_hub.resolve_entry("cifar-10")
    assert hub.dataset_files(entry) == jax_hub.dataset_files(entry)
    assert hub.split_files(entry, "test") == jax_hub.split_files(entry, "test")
    dest = str(tmp_path)
    assert hub.missing_files(entry, dest) == jax_hub.missing_files(entry, dest)
    with pytest.raises(FileNotFoundError, match="Provision these blobs offline") as port_err:
        hub.ensure_dataset("cifar-10", dest)
    with pytest.raises(FileNotFoundError, match="Provision these blobs offline") as jax_err:
        jax_hub.ensure_dataset("cifar-10", dest)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(FileNotFoundError, match="does not download"):
        hub.ensure_dataset("cifar-10", dest, download=True)
    with pytest.raises(KeyError, match="not in the hub registry"):
        hub.resolve_entry("no-such-set")
    for f in hub.dataset_files(entry):  # provisioned: resolves, nothing fetched
        path = tmp_path / entry["root_folder"] / f
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")
    want = jax_hub.ensure_dataset("cifar-10", dest)
    assert hub.ensure_dataset("cifar-10", dest, download=True) == want
    pc, _ = _both(**{"DATASET.DATASET": "cifar-10", "DATASET.ROOT": str(tmp_path / "fresh"),
                     "DATASET.DOWNLOAD": True})
    with pytest.raises(FileNotFoundError, match="does not download"):
        registry.load_split(pc, "train")
    assert (tmp_path / "fresh" / "vision_datasets.json").exists()  # copied as in JAX


# -- the drivers -------------------------------------------------------------------


def test_finetune_main_on_an_elevater_manifest_matches_jax(monkeypatch, tmp_path):
    """The few-shot driver on a 3-way zip manifest (4 shots): one round of 3
    (lr, wd) cells, their scores, the choice and the final score, as on the
    synthetic task (``test_torch_port_sweep``)."""
    from test_torch_port_driver import _run_both

    write_manifest(tmp_path / "data", "toy-set", {"train": images(3, 6, seed=5),
                                                  "test": images(3, 2, seed=6)}, CLASSES)
    over = {"DATASET.DATASET": "toy-set", "DATASET.ROOT": str(tmp_path / "data"),
            "DATASET.NUM_CLASSES": 3, "DATASET.NUM_SAMPLES_PER_CLASS": 4,
            "TRAIN.NO_TUNING": False, "TRAIN.END_EPOCH": 2, "TRAIN.SEARCH_WD_POINTS": 3,
            "TRAIN.SEARCH_WD_INIT_POINTS": 3, "MODEL.SPEC.VISION.LAYERS": 1}
    want, got = _run_both(monkeypatch, tmp_path, lr_grid=[3e-2], **over)
    assert [len(c[0]) for c in want["cells"]] == [3]
    assert [c[:2] for c in got["cells"]] == [c[:2] for c in want["cells"]]
    for g, w in zip(got["cells"], want["cells"]):
        np.testing.assert_allclose(g[2], w[2], atol=1e-4)
    assert (got["record"]["lr"], got["record"]["wd"]) == (want["record"]["lr"],
                                                          want["record"]["wd"])
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)


def test_train_main_streams_tsv_shards_as_jax(monkeypatch, tmp_path):
    """The full-shot command's streaming branch through both packages: the
    same TSV shards through the native ring, the JAX weights grafted into the
    port; the epoch losses and the best top-1 (the flip off: the two
    trainers draw it from different generators)."""
    from peft_vit_tpu.commands import train as jax_train
    from peft_vit_tpu.config import get_default_config as jax_config
    from peft_vit_tpu.engine import trainer as jax_trainer
    from peft_vit_tpu_torch.commands import train as port_train
    from peft_vit_tpu_torch.engine import trainer as port_trainer
    from test_torch_port_fullshot import (TINY, _epoch_losses, _graft_jax_weights,
                                          _jax_variables, _set)
    from peft_vit_tpu_torch.config import get_default_config as port_config

    import peft_vit_tpu.utils.tb as jax_tb
    import peft_vit_tpu_torch.utils.tb as port_tb

    for module in (jax_tb, port_tb):
        monkeypatch.setattr(module, "create_scalar_writer", lambda log_dir: None)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    write_tsv(tmp_path / "train.tsv", images(4, 8, seed=7))
    write_tsv(tmp_path / "test.tsv", images(4, 3, seed=8))
    over = {**TINY, "DATASET.DATASET": "tsv_task", "DATASET.ROOT": str(tmp_path),
            "DATASET.TRAIN_TSV_LIST": ["train.tsv"], "DATASET.TEST_TSV_LIST": ["test.tsv"],
            "AUG.RANDOM_FLIP": False, "TRAIN.BATCH_SIZE_PER_GPU": 8, "WORKERS": 2}
    jcfg = _set(jax_config(), {**over, "OUTPUT_DIR": str(tmp_path / "jax")})
    variables = _jax_variables(jcfg)
    jax_losses = _epoch_losses(monkeypatch, jax_trainer)
    port_losses = _epoch_losses(monkeypatch, port_trainer)
    _graft_jax_weights(monkeypatch, variables)
    want = jax_train.train_main(jcfg)
    got = port_train.train_main(_set(port_config(), {**over, "OUTPUT_DIR": str(tmp_path / "p")}),
                                device="cpu")
    assert len(port_losses) == len(jax_losses) == 2
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert got == pytest.approx(want, abs=1e-4)
    assert os.path.isdir(tmp_path / "p")
