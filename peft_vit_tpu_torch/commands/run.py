"""The PEFT fine-tuning driver through the port (counterpart of
``peft_vit_tpu/commands/run.py``):

  config -> PEFTSpec -> few-shot splits -> build_image_classifier ->
  trainable mask -> lr x wd sweep -> final train on train+val (+extra
  epochs) -> test metric -> reference-shaped logs + results.jsonl

on the card unless the caller asks for the CPU (``device="cpu"``).  The
port runs LoRA and the linear probe (``PEFT.METHOD`` lora, linear, or none,
which the JAX driver trains as linear); other methods, and the cached-prefix
sweep the JAX driver takes when every trainable leaf sits past block 0
(``engine/cached.py``; LoRA on every block never takes it), raise
``NotImplementedError``.

    python -m peft_vit_tpu_torch.commands.run --ds DS.yaml --model MODEL.yaml [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import logging
import math
import time
from typing import Callable, Dict, Mapping, Optional

import torch

from ..data import construct_splits, merge_trainval
from ..engine import SweepEngine, bce_per_example, ce_per_example, make_apply_fn, make_array_task
from ..engine.metrics import metric_for_dataset
from ..engine.sweep import CellKey
from ..models import build_image_classifier, cast_frozen_, load_jax_variables
from ..ops import int8 as int8_ops
from ..peft import build_mask, count_trainable, describe_mask, spec_from_config, split_params
from ..utils import resolve_device
from ..utils.logging import final_result_line, log_trainable_params
from ..utils.results import append_jsonl
from .common import add_finetuning_args, fix_seeds, load_config, setup_run_logger

logger = logging.getLogger(__name__)

PORTED_METHODS = ("lora", "linear", "none")
# where ROADMAP queues the rest: the contrastive methods need the text tower
_CONTRASTIVE = ("finetune_contrast", "linear_probe_contrast")


def _first_trainable_layer(mask: Mapping[str, bool], num_layers: int) -> int:
    """Depth of the first backbone block with a trainable leaf: 0 when
    anything at or before block 0 trains, ``num_layers`` when only the head
    does (``engine/cached.py::first_trainable_layer``)."""
    cut = num_layers
    for name, trainable in mask.items():
        if not trainable or name.startswith("classifier."):
            continue
        parts = name.split(".")
        if parts[:2] != ["backbone", "blocks"]:
            return 0
        cut = min(cut, int(parts[2]))
    return cut


def _fresh_leaf(name: str, shape, generator: torch.Generator) -> torch.Tensor:
    """A freshly initialised trainable leaf, drawn as the JAX package's
    flax init draws it: LoRA ``*_adapter1`` N(0, 0.02^2) and ``*_adapter2``
    zeros, a Dense kernel lecun-normal (truncated at 2 std), a bias zeros."""
    module, leaf = name.rsplit(".", 1)
    t = torch.zeros(shape, dtype=torch.float32)
    if leaf == "bias" or module.endswith("_adapter2"):
        return t
    if module.endswith("_adapter1"):
        return torch.nn.init.normal_(t, std=0.02, generator=generator)
    if leaf == "weight" and len(shape) == 2:
        std = math.sqrt(1.0 / shape[1]) / 0.87962566103423978
        return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator)
    raise NotImplementedError(f"no fresh initialiser for {name}")


def finetune_main(
    cfg,
    out_dir: Optional[str] = None,
    *,
    device=None,
    variables: Optional[Mapping] = None,
    init_trainables: Optional[Callable[[CellKey], Mapping[str, torch.Tensor]]] = None,
) -> float:
    """Run the few-shot protocol of ``cfg``; returns the test score.

    ``device``: None is the card.  ``variables`` (a JAX-layout variables
    tree, ``models.load_jax_variables``) replaces the built weights, and
    ``init_trainables`` (``CellKey -> {name: tensor}``) replaces the cells'
    draws: the seam through which a test hands the driver the JAX package's
    weights and initial trainables.  Nothing on the normal path sets them."""
    device = resolve_device(device)
    fix_seeds(int(cfg.DATASET.RANDOM_SEED_SAMPLING))
    spec = spec_from_config(cfg)
    logger.info("=> PEFT method: %s (%s)", cfg.PEFT.METHOD, spec)
    if spec.method not in PORTED_METHODS:
        item = ("item 5, probes and zero-shot" if spec.method in _CONTRASTIVE
                else "item 4, the remaining PEFT hooks")
        raise NotImplementedError(
            f"PEFT method {spec.method!r} is not ported to peft_vit_tpu_torch yet "
            f"(ported: {', '.join(PORTED_METHODS)}; ROADMAP: {item})"
        )

    splits = construct_splits(cfg)
    num_classes = splits.num_classes
    criterion = bce_per_example if splits.multilabel else ce_per_example
    model, _, _ = build_image_classifier(
        cfg, spec, num_classes, use_bn=bool(cfg.TRAIN.CHANNEL_BN), device=device)
    if variables is not None:
        load_jax_variables(model, variables)

    num_layers = len(model.backbone.blocks)
    mask = build_mask(
        model,
        spec.method if spec.method != "none" else "linear",
        num_layers=num_layers,
        train_head=bool(cfg.PEFT.TRAIN_HEAD),
        extra_regex=str(cfg.PEFT.TRAINABLE_REGEX),
        adapter_layers=spec.adapter_layers,
    )
    logger.info("trainable:\n%s", describe_mask(model, mask))
    n_trainable = count_trainable(model, mask)
    log_trainable_params(n_trainable)
    if bool(cfg.TRAIN.get("CACHE_FROZEN_PREFIX", True)) and _first_trainable_layer(
            mask, num_layers) > 0:
        raise NotImplementedError(
            "the cached-prefix sweep (every trainable leaf past block 0) is not ported to "
            "peft_vit_tpu_torch yet (ROADMAP: item 5, probes and zero-shot); set "
            "TRAIN.CACHE_FROZEN_PREFIX False to train through the whole tower"
        )
    trainable0, frozen = split_params(model, mask)
    # TPU.INT8_FWD_TRAIN: quantize the frozen tower ONCE for the whole sweep
    # (every cell shares it), from the stored fp32 weights, before the cast
    qkernel = None
    if bool(cfg.TPU.get("INT8_FWD_TRAIN", False)):
        qkernel = int8_ops.quantize_frozen_tree(
            frozen,
            targets=tuple(cfg.TPU.get("INT8_TARGETS", int8_ops.INT8_TARGET_MODULES)),
            bwd_dx=bool(cfg.TPU.get("INT8_BWD_DX", False)),
        )
    cast_frozen_(model)

    if init_trainables is None:
        base = {k: v.detach().cpu().clone() for k, v in trainable0.items()}

        def init_trainables(key: CellKey) -> Dict[str, torch.Tensor]:
            # every trainable leaf of LoRA and the linear probe is an injected
            # PEFT leaf or the head: all of them are drawn fresh per cell
            gen = key.generator()
            return {k: _fresh_leaf(k, v.shape, gen) for k, v in base.items()}

    bn_template = {k: v for k, v in model.named_buffers()
                   if k.rsplit(".", 1)[-1] in ("bn_mean", "bn_var")} or None
    metric_name = cfg.TEST.METRIC or metric_for_dataset(cfg.DATASET.DATASET)
    engine = SweepEngine(
        cfg, make_apply_fn(model), init_trainables, {}, criterion,
        metric=metric_name, bn_template=bn_template, qkernel=qkernel,
    )

    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
    task = make_array_task(splits.x_train, splits.y_train, splits.x_val, splits.y_val, batch,
                           device=device)
    end_epoch = int(cfg.TRAIN.END_EPOCH)
    if bool(cfg.TRAIN.get("NO_TUNING", False)):
        best_lr, best_wd = float(cfg.TRAIN.LR), float(cfg.TRAIN.WD)
    else:
        best_lr, best_wd, _ = engine.sweep(task, end_epoch)

    # final run: merge train+val, extra epochs (adapter_tuning_clip.py:429-481)
    logger.info("=> The final classifier is on training ...")
    logger.info("Hyperparameters: learning_rate = %s, l2_lambda = %s", best_lr, best_wd)
    xt, yt = merge_trainval(splits)
    logger.info("Using the full trainval set to train final model. len(dataset)=%d", len(yt))
    final_task = make_array_task(xt, yt, splits.x_test, splits.y_test, batch, device=device)
    final_epochs = end_epoch + int(cfg.TRAIN.EXTRA_FINAL_TRAIN_EPOCH)
    state, _ = engine.train_final(best_lr, best_wd, final_task, final_epochs)
    score = engine._score(engine.evaluate(state, final_task.x_val), final_task.y_val,
                          final_task.valid_val)

    if out_dir:
        append_jsonl(
            f"{out_dir}/results.jsonl",
            {
                "dataset": cfg.DATASET.DATASET,
                "method": cfg.PEFT.METHOD,
                "num_shots": int(cfg.DATASET.NUM_SAMPLES_PER_CLASS),
                "seed": int(cfg.DATASET.RANDOM_SEED_SAMPLING),
                "lr": best_lr,
                "wd": best_wd,
                "metric": metric_name,
                "score": float(score),
                "trainable_params": n_trainable,
                "time": time.time(),
            },
        )
    final_result_line(metric_name, float(score))
    return float(score)


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser(description="PEFT fine-tuning on the H100 (PyTorch port)")
    add_finetuning_args(parser)
    args = parser.parse_args(argv)
    cfg = load_config(args)
    if args.no_tuning:
        cfg.TRAIN.NO_TUNING = True
    out = setup_run_logger(cfg)
    cfg.freeze()
    return finetune_main(cfg, out, device=device)


if __name__ == "__main__":
    main()
