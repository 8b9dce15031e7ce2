"""The port's few-shot driver against the JAX package on the CPU, module by
module and end to end: the config tree, ``spec_from_config``, the data
(synthetic sources, few-shot sampling, ``construct_splits``: bit-equal for
the same seeds), the metrics, ``build_image_classifier`` (an OpenAI CLIP
checkpoint loaded through the same names), ``SweepEngine.sweep`` and
``finetune_main``, each package's driver fed the same weights and initial
trainables (the JAX ones, handed to the port through ``finetune_main``'s
``variables=`` and ``init_trainables=``).  Tolerances are stated where they
are used."""

import dataclasses
import inspect
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import peft_vit_tpu.commands.run as jax_run
import peft_vit_tpu.engine.sweep as jax_sweep
import peft_vit_tpu_torch.commands.run as port_run
import peft_vit_tpu_torch.engine.sweep as port_sweep
from peft_vit_tpu import config as jax_config
from peft_vit_tpu.data import few_shot as jax_few_shot
from peft_vit_tpu.data import pipeline as jax_pipeline
from peft_vit_tpu.data import registry as jax_registry
from peft_vit_tpu.data import transforms as jax_transforms
from peft_vit_tpu.engine import metrics as jax_metrics
from peft_vit_tpu.models import factory as jax_factory
from peft_vit_tpu.peft import spec as jax_spec
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.data import few_shot as port_few_shot
from peft_vit_tpu_torch.data import pipeline as port_pipeline
from peft_vit_tpu_torch.data import registry as port_registry
from peft_vit_tpu_torch.data import transforms as port_transforms
from peft_vit_tpu_torch.engine import metrics as port_metrics
from peft_vit_tpu_torch.models import factory as port_factory
from peft_vit_tpu_torch.models import params_from_jax, params_to_jax
from peft_vit_tpu_torch.peft import spec as port_spec
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
MODEL_YAMLS = sorted((REPO / "peft_vit_tpu" / "resources" / "model").glob("*.yaml"))


def _plain(node):
    """A config tree as nested plain dicts, tuples as lists."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def tiny_cfg(pkg, **over):
    """The SKILL.md tiny drive: synthetic 4-way 8-shot, 16 px, clip_tiny
    (width 32, 2 layers, 2 heads, patch 8), LoRA, batch 8."""
    cfg = pkg.get_default_config()
    cfg.DATASET.DATASET = "synthetic"
    cfg.DATASET.NUM_CLASSES = 4
    cfg.DATASET.NUM_SAMPLES_PER_CLASS = 8
    cfg.TRAIN.IMAGE_SIZE = [16, 16]
    cfg.TRAIN.BATCH_SIZE_PER_GPU = 8
    cfg.TRAIN.END_EPOCH = 8
    cfg.TRAIN.SCHEDULE = []
    cfg.TRAIN.NO_TUNING = True
    cfg.TRAIN.LR = 0.02
    cfg.MODEL.NAME = "clip_tiny"
    cfg.MODEL.SPEC.EMBED_DIM = 32
    cfg.MODEL.SPEC.VISION.PATCH_SIZE = 8
    cfg.MODEL.SPEC.VISION.WIDTH = 32
    cfg.MODEL.SPEC.VISION.LAYERS = 2
    cfg.MODEL.SPEC.VISION.HEADS = 2
    cfg.PEFT.METHOD = "lora"
    for key, value in over.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


# ---------------------------------------------------------------- config


def test_default_config_equals_jax():
    assert _plain(port_config.get_default_config()) == _plain(jax_config.get_default_config())


@pytest.mark.parametrize("yaml_file", MODEL_YAMLS, ids=lambda p: p.stem)
def test_model_yaml_merges_equal(yaml_file):
    """BASE inheritance and every key of each shipped model yaml."""
    got, want = port_config.get_default_config(), jax_config.get_default_config()
    got.merge_from_file(str(yaml_file))
    want.merge_from_file(str(yaml_file))
    assert _plain(got) == _plain(want)


def test_update_config_equals_jax():
    class Args:
        cfg = str(REPO / "peft_vit_tpu" / "resources" / "model" / "vitb16_CLIP.yaml")
        opts = ["TRAIN.LR", "0.5", "DATASET.NUM_SAMPLES_PER_CLASS", "4", "AUG.MIXUP", "0.2"]

    got, want = port_config.get_default_config(), jax_config.get_default_config()
    port_config.update_config(got, Args)
    jax_config.update_config(want, Args)
    assert got.is_frozen() and _plain(got) == _plain(want)
    assert got.TRAIN.LR == 0.5 and got.NAME == "vitb16_CLIP" and got.AUG.MIXUP_PROB == 1.0
    with pytest.raises(AttributeError, match="frozen"):
        got.TRAIN.LR = 1.0
    with pytest.raises(KeyError):
        got.clone().merge_from_other_cfg({"SWEEP": {"NOT_A_KEY": 1}})


# ---------------------------------------------------------------- spec


METHODS = sorted(set(jax_spec._METHOD_ALIASES))
OPTIONS = [
    {},
    {"PEFT.LORA_RANK": 8, "PEFT.LORA_ALPHA": 16.0, "PEFT.LORA_TARGETS": ["q", "k", "v"],
     "PEFT.LORA_POST_SCALE_Q": False},
    {"PEFT.ADAPTER_LAYERS": [3, 7], "PEFT.PROMPT_TOKENS": 4, "PEFT.EXTRA_BLOCK": True,
     "PEFT.ADAPTER_DIM": 16, "PEFT.PROMPT_DEEP": True},
]


@pytest.mark.parametrize("method", METHODS)
def test_spec_from_config_equals_jax(method):
    for over in OPTIONS:
        got = port_spec.spec_from_config(tiny_cfg(port_config, **{"PEFT.METHOD": method, **over}))
        want = jax_spec.spec_from_config(tiny_cfg(jax_config, **{"PEFT.METHOD": method, **over}))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unknown_method_raises_in_both():
    for pkg in (port_spec, jax_spec):
        with pytest.raises(ValueError, match="Unknown PEFT method"):
            pkg.canonical_method("not_a_method")


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("kw", [dict(num_classes=5, n_per_class=20, image_size=16, seed=0),
                                dict(num_classes=3, n_per_class=7, image_size=32, seed=2)])
def test_synthetic_data_equals_jax(kw):
    for gen in ("synthetic_dataset", "synthetic_multilabel_dataset"):
        for got, want in zip(getattr(port_registry, gen)(**kw), getattr(jax_registry, gen)(**kw)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,seed", [(1, 0), (4, 0), (4, 3), (16, 1)])
def test_few_shot_sampling_and_split_equal_jax(k, seed):
    rng = np.random.RandomState(seed)
    multiclass = rng.randint(0, 6, 90)
    multilabel = (rng.uniform(size=(90, 5)) < 0.3).astype(np.int64)
    for labels in (multiclass, multilabel):
        got = port_few_shot.sample_few_shot_subset(labels, k, seed)
        np.testing.assert_array_equal(got, jax_few_shot.sample_few_shot_subset(labels, k, seed))
        for split in (0.2, 0.5):
            for g, w in zip(port_few_shot.balanced_val_split(labels[got], split),
                            jax_few_shot.balanced_val_split(labels[got], split)):
                np.testing.assert_array_equal(g, w)
    for shots, ds in ((1, "cifar-10"), (5, "dtd"), (10000, "patch-camelyon")):
        assert port_few_shot.effective_shots(shots, ds) == jax_few_shot.effective_shots(shots, ds)


@pytest.mark.parametrize("dataset,shots,seed", [("synthetic", 4, 0), ("synthetic", 8, 2),
                                                ("synthetic", -1, 0),
                                                ("synthetic_multilabel", 4, 1)])
def test_construct_splits_bit_equal_jax(dataset, shots, seed):
    over = {"DATASET.DATASET": dataset, "DATASET.NUM_SAMPLES_PER_CLASS": shots,
            "DATASET.RANDOM_SEED_SAMPLING": seed, "DATASET.NUM_CLASSES": 5}
    got = port_pipeline.construct_splits(tiny_cfg(port_config, **over))
    want = jax_pipeline.construct_splits(tiny_cfg(jax_config, **over))
    for field in dataclasses.fields(want):
        g, w = getattr(got, field.name), getattr(want, field.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    for g, w in zip(port_pipeline.merge_trainval(got), jax_pipeline.merge_trainval(want)):
        np.testing.assert_array_equal(g, w)


def test_npz_source_equals_jax_and_other_sources_raise(tmp_path):
    rng = np.random.RandomState(4)
    x, y = rng.randint(0, 256, (12, 16, 16, 3)).astype(np.uint8), rng.randint(0, 3, 12)
    for split in ("train", "test"):
        port_registry.save_npz(str(tmp_path / "mine" / f"{split}.npz"), x, y)
    over = {"DATASET.DATASET": "mine", "DATASET.ROOT": str(tmp_path),
            "DATASET.NUM_CLASSES": 3, "DATASET.NUM_SAMPLES_PER_CLASS": 2}
    got = port_pipeline.construct_splits(tiny_cfg(port_config, **over))
    want = jax_pipeline.construct_splits(tiny_cfg(jax_config, **over))
    np.testing.assert_array_equal(got.x_train, want.x_train)
    np.testing.assert_array_equal(got.y_val, want.y_val)
    # the sources the port once refused now load as JAX's do (exactly: both
    # decode with PIL, bicubic): TSV shards; DATASET.DOWNLOAD on a name the
    # hub does not know, which falls through to the npz; an ImageFolder tree;
    # an ELEVATER registry without the dataset, which falls through to it
    from _port_data import images, write_folder, write_tsv

    items = images(3, 3)
    write_tsv(tmp_path / "a.tsv", items)
    (tmp_path / "other" / "train").mkdir(parents=True)
    write_folder(tmp_path / "other" / "train", items, ["cat", "dog", "emu"])
    folder = {**over, "DATASET.DATASET": "other", "DATASET.ROOT": str(tmp_path / "other")}
    cases = [{"DATASET.TRAIN_TSV_LIST": ["a.tsv"]}, {"DATASET.DOWNLOAD": True}, folder]
    for extra in cases + ["manifest"]:
        if extra == "manifest":
            (tmp_path / "other" / "vision_datasets.json").write_text("[]")
            extra = folder
        got = port_registry.load_split(tiny_cfg(port_config, **{**over, **extra}), "train")
        want = jax_registry.load_split(tiny_cfg(jax_config, **{**over, **extra}), "train")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert port_registry.list_datasets() == jax_registry.list_datasets()
    for name in port_registry.list_datasets() + ["unknown"]:
        assert (dataclasses.asdict(port_registry.dataset_info(name))
                == dataclasses.asdict(jax_registry.dataset_info(name)))


def test_transforms_equal_jax():
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (40, 30, 3)).astype(np.uint8)
    np.testing.assert_array_equal(port_transforms.resize_center_crop(img, 16),
                                  jax_transforms.resize_center_crop(img, 16))
    for mean, std in ((port_transforms.CLIP_MEAN, port_transforms.CLIP_STD), ((0.5,) * 3, (0.25,) * 3)):
        np.testing.assert_array_equal(port_transforms.to_normalized_array(img, mean, std),
                                      jax_transforms.to_normalized_array(img, mean, std))
        got = port_transforms.normalize_batch(torch.from_numpy(img[None]), mean, std, torch.float32)
        want = jax_transforms.normalize_batch(jnp.asarray(img[None]), mean, std, jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("name", sorted(jax_metrics._REGISTRY))
def test_metrics_equal_jax(name):
    rng = np.random.RandomState(6)
    scores = rng.standard_normal((30, 5)).astype(np.float32)
    for target in (rng.randint(0, 5, 30), (rng.uniform(size=(30, 5)) < 0.3).astype(np.int64)):
        if target.ndim == 2 and name in ("accuracy", "top1", "mean-per-class", "balanced"):
            continue  # those score integer labels
        assert port_metrics.get_metric(name)(scores, target) == pytest.approx(
            jax_metrics.get_metric(name)(scores, target), abs=1e-9)


def test_topk_and_metric_for_dataset_equal_jax():
    rng = np.random.RandomState(7)
    logits, target = rng.standard_normal((20, 6)).astype(np.float32), rng.randint(0, 6, 20)
    got = port_metrics.topk_accuracy(torch.from_numpy(logits), torch.from_numpy(target), (1, 3))
    want = jax_metrics.topk_accuracy(jnp.asarray(logits), jnp.asarray(target), (1, 3))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), abs=1e-5)
    for ds in jax_registry.list_datasets() + ["unknown"]:
        assert port_metrics.metric_for_dataset(ds) == jax_metrics.metric_for_dataset(ds)
    with pytest.raises(ValueError):
        port_metrics.get_metric("nope")


# ---------------------------------------------------------------- model build


def _fake_clip_state_dict(width=32, layers=2, patch=8, grid=2, embed=24, seed=8):
    """A small visual-only OpenAI CLIP ViT export (the visual tower, a logit
    scale, and block 0 with reference-trained LoRA q/v pairs)."""
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1)

    sd = {"visual.conv1.weight": t(width, 3, patch, patch), "visual.class_embedding": t(width),
          "visual.positional_embedding": t(grid * grid + 1, width),
          "visual.ln_pre.weight": t(width), "visual.ln_pre.bias": t(width),
          "visual.ln_post.weight": t(width), "visual.ln_post.bias": t(width),
          "visual.proj": t(width, embed), "logit_scale": t(1)[0]}
    for i in range(layers):
        p = f"visual.transformer.resblocks.{i}"
        sd.update({f"{p}.ln_1.weight": t(width), f"{p}.ln_1.bias": t(width),
                   f"{p}.ln_2.weight": t(width), f"{p}.ln_2.bias": t(width),
                   f"{p}.attn.in_proj_weight": t(3 * width, width),
                   f"{p}.attn.in_proj_bias": t(3 * width),
                   f"{p}.attn.out_proj.weight": t(width, width),
                   f"{p}.attn.out_proj.bias": t(width),
                   f"{p}.mlp.c_fc.weight": t(4 * width, width), f"{p}.mlp.c_fc.bias": t(4 * width),
                   f"{p}.mlp.c_proj.weight": t(width, 4 * width),
                   f"{p}.mlp.c_proj.bias": t(width)})
    for tgt in ("q", "v"):
        sd[f"visual.transformer.resblocks.0.attn.{tgt}_proj_adapter1.weight"] = t(4, width)
        sd[f"visual.transformer.resblocks.0.attn.{tgt}_proj_adapter2.weight"] = t(width, 4)
    return sd


def test_build_image_classifier_loads_a_clip_checkpoint_as_jax_does(tmp_path):
    path = tmp_path / "clip.pt"
    torch.save(_fake_clip_state_dict(), path)
    over = {"MODEL.PRETRAINED": str(path), "MODEL.SPEC.VISION.HEADS": 2}
    spec = port_spec.spec_from_config(tiny_cfg(port_config))
    model, params, encode_text = port_factory.build_image_classifier(
        tiny_cfg(port_config, **over), spec, 4, use_bn=True, device="cpu")
    assert encode_text is None and set(params) == {k for k, _ in model.named_parameters()}
    jax_model, variables, _ = jax_factory.build_image_classifier(
        tiny_cfg(jax_config, **over), jax_spec.spec_from_config(tiny_cfg(jax_config)), 4,
        use_bn=True)
    got = traverse_util.flatten_dict(params_to_jax(model.state_dict())["params"], sep="/")
    want = traverse_util.flatten_dict(variables["params"], sep="/")
    assert set(got) == set(want)
    grafted = [k for k in want if k.startswith("backbone/") and "adapter" not in k]
    grafted += [f"backbone/blocks_0/attn/{t}_adapter{i}/kernel" for t in "qv" for i in (1, 2)]
    for k in grafted:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert model.backbone.conv1.weight.dtype == torch.float32


@pytest.mark.parametrize("key,value,match", [
    # a CLIP tower other than the ViT, the ModifiedResNet and Swin
    ("MODEL.SPEC.VISION.MODEL", "rexnet", "ROADMAP §1, the backbone zoo"),
    ("MODEL.SPEC.VISION.MODEL", "ttnet", "ROADMAP §1, the backbone zoo"),
    ("MODEL.SPEC.VISION.MODEL", "efficientnet", "ROADMAP §1, the backbone zoo"),
    ("MODEL.SPEC.VISION.MODEL", "hrnet", "ROADMAP §1, the backbone zoo"),
])
def test_build_image_classifier_refuses_what_is_not_ported(key, value, match):
    cfg = tiny_cfg(port_config, **{key: value})
    with pytest.raises(NotImplementedError, match=match):
        port_factory.build_image_classifier(cfg, port_spec.spec_from_config(cfg), 4,
                                            device="cpu")


@pytest.mark.parametrize("over", [
    {"TPU.SCAN_LAYERS": True},
    {"TPU.SEQUENCE_PARALLEL": True},
    {"TPU.SEQUENCE_PARALLEL": True, "TPU.MESH.MODEL": 2},
], ids=["scan_layers", "sequence_parallel", "sequence_parallel_model_2"])
def test_build_image_classifier_builds_scan_layers_and_sequence_parallel(over):
    """What the builder refused before: ``TPU.SCAN_LAYERS`` builds the stacked
    blocks; ``TPU.SEQUENCE_PARALLEL`` builds where the 5 tokens (2 x 2
    patches and the class token) split over ``TPU.MESH.MODEL`` and raises the
    JAX builder's ``ValueError`` where they do not."""
    cfg = tiny_cfg(port_config, **over)
    spec = port_spec.spec_from_config(cfg)
    if over.get("TPU.MESH.MODEL", 1) > 1:
        with pytest.raises(ValueError, match=r"5-token sequence .* PEFT\.PROMPT_TOKENS=1 "):
            port_factory.build_image_classifier(cfg, spec, 4, device="cpu")
        return
    model, params, _ = port_factory.build_image_classifier(cfg, spec, 4, device="cpu")
    stacked = any(".blocks.block." in k for k in params)
    assert model.backbone.scan_layers == stacked == bool(over.get("TPU.SCAN_LAYERS"))


def test_build_image_classifier_builds_int8_attention_and_the_text_tower():
    """What the builder refused before: ``TPU.INT8_ATTN`` (with the JAX
    builder's ValueError when the static recipe is not set) and
    ``TRAIN.INIT_HEAD_WITH_TEXT_ENCODER``, and the text tower, returned as
    ``encode_text`` with the config's context length and built on first use."""
    with pytest.raises(ValueError, match="INT8_STATIC_ACT"):
        port_factory.build_image_classifier(
            tiny_cfg(port_config, **{"TPU.INT8_ATTN": True}),
            port_spec.spec_from_config(tiny_cfg(port_config)), 4, device="cpu")
    cfg = tiny_cfg(port_config, **{"TPU.INT8_ATTN": True, "TPU.INT8_ATTN_PV": True,
                                   "TPU.INT8_FWD_TRAIN": True, "TPU.INT8_STATIC_ACT": True,
                                   "TRAIN.INIT_HEAD_WITH_TEXT_ENCODER": True,
                                   "MODEL.SPEC.TEXT.WIDTH": 32, "MODEL.SPEC.TEXT.LAYERS": 1,
                                   "MODEL.SPEC.TEXT.HEADS": 2,
                                   "MODEL.SPEC.TEXT.CONTEXT_LENGTH": 16})
    model, _, encode_text = port_factory.build_image_classifier(
        cfg, port_spec.spec_from_config(cfg), 4, device="cpu")
    attn = model.backbone.blocks[0].attn
    assert attn.int8_attn and attn.int8_attn_pv
    assert encode_text.context_length == 16 and encode_text._module is None
    feats = encode_text(np.ones((3, 16), np.int64))
    assert feats.shape == (3, 32) and torch.isfinite(feats).all()
    assert not any(p.requires_grad for p in encode_text.module.parameters())


def test_bf16_softmax_is_refused_on_the_card_and_honoured_on_the_cpu(monkeypatch):
    cfg = tiny_cfg(port_config, **{"TPU.BF16_SOFTMAX": True})
    spec = port_spec.spec_from_config(cfg)
    model, _, _ = port_factory.build_image_classifier(cfg, spec, 4, device="cpu")
    assert not model.backbone.blocks[0].attn.softmax_fp32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="BF16_SOFTMAX"):
        port_factory.build_image_classifier(cfg, spec, 4, device="cuda")
    assert port_factory.compute_dtype(cfg, torch.device("cuda")) == torch.bfloat16
    assert port_factory.compute_dtype(cfg, torch.device("cpu")) == torch.float32


# ---------------------------------------------------------------- sweep and driver


def _jax_key(key):
    if key.round_size is None:
        return jax.random.PRNGKey(key.seed)
    return jax.random.split(jax.random.PRNGKey(key.seed), key.round_size)[key.index]


def jax_text_variables(encode_text, over):
    """The JAX builder's text-tower weights (``{"params": ...}``, the
    ``tparams`` its ``encode_text`` closes over) when the run of ``over``
    encodes text (the contrastive methods, the head's init from text), else
    None: the port then never builds its text tower."""
    uses_text = over.get("PEFT.METHOD") in ("finetune_contrast", "linear_probe_contrast") or \
        over.get("TRAIN.INIT_HEAD_WITH_TEXT_ENCODER")
    if encode_text is None or not uses_text:
        return None
    tparams = inspect.getclosurevars(encode_text).nonlocals["tparams"]
    return {"params": jax.tree_util.tree_map(np.asarray, tparams)}


def _run_both(monkeypatch, tmp_path, lr_grid=None, **over):
    """``finetune_main`` of both packages on the tiny config: the JAX run
    records its variables and init function, the port gets them through
    its seam.  Returns, per package, the score, the final-train losses per
    epoch, the sweep's rounds ``(lrs, wds, scores)`` and the results.jsonl
    record."""
    rec = {"jax": {"losses": [], "cells": []}, "port": {"losses": [], "cells": []}}

    def spy(base, name):
        class Spy(base):
            def __init__(self, cfg, apply_fn, init_trainable, *a, **kw):
                super().__init__(cfg, apply_fn, init_trainable, *a, **kw)
                rec[name]["init"] = init_trainable
                attr = "_epoch_one" if name == "jax" else "_epoch_fn"
                fn = getattr(self, attr)

                def recorded(*args):
                    out = fn(*args)
                    if name == "port" or attr == "_epoch_one":
                        rec[name]["losses"].append(float(out[1]))
                    return out

                setattr(self, attr, recorded)

            def train_cells(self, lrs, wds, *a, **kw):
                out = super().train_cells(lrs, wds, *a, **kw)
                rec[name]["cells"].append((tuple(lrs), tuple(wds), tuple(np.asarray(out))))
                return out

            def sweep(self, task, end_epoch, lr_grid_=None):
                return super().sweep(task, end_epoch, lr_grid)

        return Spy

    built = {}
    real_build = jax_run.build_image_classifier

    def build(*a, **kw):
        built["out"] = real_build(*a, **kw)
        return built["out"]

    monkeypatch.setattr(jax_run, "build_image_classifier", build)
    monkeypatch.setattr(jax_run, "SweepEngine", spy(jax_sweep.SweepEngine, "jax"))
    monkeypatch.setattr(port_run, "SweepEngine", spy(port_sweep.SweepEngine, "port"))
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    rec["jax"]["score"] = jax_run.finetune_main(tiny_cfg(jax_config, **over), str(tmp_path / "jax"))
    variables = jax.tree_util.tree_map(np.asarray, dict(built["out"][1]))
    jax_init = rec["jax"]["init"]

    def init_trainables(key):
        flat = traverse_util.flatten_dict(jax_init(_jax_key(key)))
        tree = traverse_util.unflatten_dict({k: np.asarray(v) for k, v in flat.items()
                                             if v is not None})
        return params_from_jax({"params": tree})

    rec["port"]["score"] = port_run.finetune_main(
        tiny_cfg(port_config, **over), str(tmp_path / "port"), device="cpu",
        variables=variables, text_variables=jax_text_variables(built["out"][2], over),
        init_trainables=init_trainables)
    for name in ("jax", "port"):
        lines = (tmp_path / name / "results.jsonl").read_text().splitlines()
        rec[name]["record"] = json.loads(lines[-1])
    return rec["jax"], rec["port"]


def test_finetune_main_matches_jax_end_to_end(monkeypatch, tmp_path):
    """NO_TUNING, 3 epochs: per-epoch losses within 1e-4 relative (fp32, the
    same arithmetic summed in other orders over 12 steps), the same score
    and the same results.jsonl fields."""
    want, got = _run_both(monkeypatch, tmp_path, **{"TRAIN.END_EPOCH": 3, "TRAIN.LR": 1e-4})
    assert len(got["losses"]) == len(want["losses"]) == 3
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert set(got["record"]) == set(want["record"])
    for k in set(want["record"]) - {"time", "score"}:
        assert got["record"][k] == want["record"][k], k


def test_cell_keys_draw_reproducibly():
    a = port_sweep.CellKey(0, 3, 1)
    assert torch.equal(torch.randn(4, generator=a.generator()),
                       torch.randn(4, generator=port_sweep.CellKey(0, 3, 1).generator()))
    draws = {torch.randn(1, generator=k.generator()).item() for k in (
        a, port_sweep.CellKey(0, 3, 2), port_sweep.CellKey(0, 2, 1), port_sweep.CellKey(0, None),
        port_sweep.CellKey(1, 3, 1))}
    assert len(draws) == 5


def test_fresh_leaves_follow_the_jax_init():
    gen = torch.Generator().manual_seed(0)
    a1 = port_run._fresh_leaf("backbone.blocks.0.attn.q_adapter1.weight", (4, 512), gen)
    a2 = port_run._fresh_leaf("backbone.blocks.0.attn.q_adapter2.weight", (512, 4), gen)
    head = port_run._fresh_leaf("classifier.head.weight", (100, 512), gen)
    bias = port_run._fresh_leaf("classifier.head.bias", (100,), gen)
    assert float(a1.std()) == pytest.approx(0.02, rel=0.05)
    assert not a2.any() and not bias.any()
    # lecun normal: variance 1 / fan_in, truncated at 2 std of the underlying normal
    assert float(head.var()) == pytest.approx(1.0 / 512, rel=0.05)
    assert float(head.abs().max()) <= 2 * math.sqrt(1.0 / 512) / 0.87962566103423978


def test_driver_default_method_and_cache_rules(monkeypatch, tmp_path):
    """Intrinsic dimension runs as the JAX driver runs it: the head alone
    (``test_torch_port_intrinsic.py`` holds the run against the JAX driver);
    the contrastive methods and the cached-prefix sweep, refused before, run
    (every trainable leaf past block 0: the prefix is computed once,
    ``test_torch_port_cached_probes.py`` holds it against the JAX driver)."""
    masks = []
    real_split = port_run.split_params

    def split(model, mask):
        masks.append(dict(mask))
        return real_split(model, mask)

    monkeypatch.setattr(port_run, "split_params", split)
    score = port_run.finetune_main(tiny_cfg(port_config, **{"PEFT.METHOD": "intrinsic",
                                                            "TRAIN.END_EPOCH": 1}),
                                   device="cpu")
    monkeypatch.setattr(port_run, "split_params", real_split)
    assert 0.0 <= score <= 100.0
    assert sorted(k for k, on in masks[0].items() if on) == ["classifier.head.bias",
                                                             "classifier.head.weight"]
    text = {"MODEL.SPEC.TEXT.WIDTH": 32, "MODEL.SPEC.TEXT.LAYERS": 1,
            "MODEL.SPEC.TEXT.HEADS": 2, "MODEL.SPEC.TEXT.CONTEXT_LENGTH": 16}
    for method in ("finetune_contrast", "linear_probe_contrast"):
        score = port_run.finetune_main(tiny_cfg(port_config, **{"PEFT.METHOD": method,
                                                                "TRAIN.END_EPOCH": 1, **text}),
                                       device="cpu")
        assert 0.0 <= score <= 100.0
    # first_attention and first_mlp train block 1
    prefixes = []
    real = port_run.cached_prefix.precompute_prefix_tokens
    monkeypatch.setattr(port_run.cached_prefix, "precompute_prefix_tokens",
                        lambda model, x, cut, *a: prefixes.append(cut) or real(model, x, cut, *a))
    for method in ("linear", "adapterdrop", "transformer_probe", "first_attention",
                   "first_mlp"):
        score = port_run.finetune_main(tiny_cfg(port_config, **{"PEFT.METHOD": method,
                                                                "TRAIN.END_EPOCH": 1}),
                                       device="cpu")
        assert 0.0 <= score <= 100.0
    # the tiny tower has 2 blocks: AdapterDrop's default block 11 is not one
    # of them, so only its head trains, as the linear probe's and the probe's
    assert prefixes == [2] * 3 * 3 + [1] * 3 * 2
    score = port_run.finetune_main(
        tiny_cfg(port_config, **{"PEFT.METHOD": "linear", "TRAIN.CACHE_FROZEN_PREFIX": False,
                                 "TRAIN.END_EPOCH": 2}), device="cpu")
    assert 0.0 <= score <= 100.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_run.finetune_main(tiny_cfg(port_config))


def test_main_parses_yaml_and_writes_logs(tmp_path):
    """``main``: the model yaml by path, the tiny overrides as the opts
    remainder, the reference-shaped log and results.jsonl under OUTPUT_DIR."""
    argv = ["--model", str(REPO / "peft_vit_tpu" / "resources" / "model" / "vitb32_CLIP.yaml"),
            "--no-tuning", "true", "--lr", "0.02", "--num-shots", "4",
            "OUTPUT_DIR", str(tmp_path), "NAME", "tiny", "DATASET.DATASET", "synthetic",
            "DATASET.NUM_CLASSES", "3", "TRAIN.IMAGE_SIZE", "[16, 16]",
            "TRAIN.BATCH_SIZE_PER_GPU", "4", "TRAIN.END_EPOCH", "1",
            "TRAIN.EXTRA_FINAL_TRAIN_EPOCH", "0", "PEFT.METHOD", "lora",
            "MODEL.SPEC.VISION.PATCH_SIZE", "8", "MODEL.SPEC.VISION.WIDTH", "32",
            "MODEL.SPEC.VISION.LAYERS", "1", "MODEL.SPEC.VISION.HEADS", "2",
            "MODEL.SPEC.EMBED_DIM", "16"]
    import logging

    root = logging.getLogger()
    try:
        score = port_run.main(argv, device="cpu")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
    out = tmp_path / "synthetic" / "tiny"
    logs = list(out.glob("finetuning_4_*_rank0.txt"))
    assert len(logs) == 1
    text = logs[0].read_text()
    assert "trainable params:" in text and "=> The final classifier is on training" in text
    assert text.strip().splitlines()[-1].endswith(f"{score:.3f}%")
    record = json.loads((out / "results.jsonl").read_text().splitlines()[-1])
    assert record["score"] == pytest.approx(score) and record["num_shots"] == 4
