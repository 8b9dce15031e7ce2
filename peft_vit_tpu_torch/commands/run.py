"""The PEFT fine-tuning driver through the port (counterpart of
``peft_vit_tpu/commands/run.py``):

  config -> PEFTSpec -> few-shot splits -> build_image_classifier ->
  trainable mask -> lr x wd sweep -> final train on train+val (+extra
  epochs) -> test metric -> reference-shaped logs + results.jsonl

on the card unless the caller asks for the CPU (``device="cpu"``).  The
port runs the linear probe (``PEFT.METHOD`` linear, or none, which the JAX
driver trains as linear), every method whose trainable leaves are injected
PEFT leaves (LoRA and its variants lora_fix_one, lora_moe, lora_adapter,
lora_compacter and lora_drop_adapter, KAdaptation, the Houlsby adapter and
AdapterDrop, Compacter, RPB, LePE, VPT and the transformer probe), whose
cells draw every trainable leaf fresh, and the methods that train a subset
of the pretrained tower (full, bitfit, layernorm, attention,
first_attention, first_mlp), whose cells draw only the head fresh and start
every other trainable leaf from its grafted fp32 value (the JAX driver's
``fresh_mask``).  The contrastive methods and intrinsic dimension raise
``NotImplementedError``, and so does the cached-prefix sweep the JAX driver
takes when every trainable leaf sits past block 0 (``engine/cached.py``:
AdapterDrop on its last blocks, the transformer probe, first_attention and
first_mlp take it unless ``TRAIN.CACHE_FROZEN_PREFIX`` is False).

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

#: the methods whose trainable leaves (beside the head) are injected PEFT
#: leaves, drawn fresh for every cell (the JAX driver's ``injected``)
INJECTED_METHODS = (
    "lora", "lora_fix_one", "lora_moe", "lora_adapter", "lora_compacter", "lora_drop_adapter",
    "kadaptation", "adapter", "adapterdrop", "compacter", "rpb", "lepe", "vpt",
    "transformer_probe",
)
#: the methods that train a subset of the pretrained tower: a cell resets it
#: to the grafted values and draws only the head fresh
TOWER_METHODS = ("full", "bitfit", "layernorm", "attention", "first_attention", "first_mlp")
PORTED_METHODS = ("linear", "none", *INJECTED_METHODS, *TOWER_METHODS)
# the ROADMAP §1 item that queues each method still refused
_QUEUED = {
    # the contrastive methods need the text tower
    "finetune_contrast": "probes and zero-shot",
    "linear_probe_contrast": "probes and zero-shot",
    "intrinsic": "intrinsic dimension",
}


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
    """A freshly initialised trainable leaf, drawn as the JAX package's flax
    init draws it:

    * biases, Compacter's ``b``, KAdaptation's ``phmb``, RPB's
      ``relative_position_bias_table`` and LoRA's ``*_adapter2``: zeros; a
      LayerNorm scale (a rank-1 ``weight``): ones;
    * LoRA's ``*_adapter1`` and the MoE gates ``*_moe_adapter1``, the
      adapters' ``down`` and ``up``, the prompts: N(0, 0.02^2);
    * KAdaptation's ``phm_rule``, ``W_left*`` and ``W_right*``, Compacter's
      ``phm_rule``: N(0, 0.01^2);
    * Compacter's ``W`` (n, in/n, out/n): ``variance_scaling(2, fan_avg,
      uniform)`` with flax's fans (fan in = in, fan out = out);
    * LePE's depthwise ``get_v`` (d, 1, 3, 3): lecun normal, fan in 9;
    * ``in_proj``: xavier uniform; any other Dense kernel (the head, the
      probe block's ``out_proj``, ``c_fc``, ``c_proj``): lecun normal.

    Lecun normal is flax's: a normal truncated at 2 std, scaled to variance
    1 / fan_in."""
    module, _, leaf = name.rpartition(".")
    last = module.rpartition(".")[2]
    t = torch.zeros(shape, dtype=torch.float32)

    def lecun_normal(fan_in: int) -> torch.Tensor:
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        return torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                           generator=generator)

    def uniform(limit: float) -> torch.Tensor:
        return torch.nn.init.uniform_(t, -limit, limit, generator=generator)

    if leaf in ("bias", "b", "phmb", "relative_position_bias_table") or last.endswith(
            "_adapter2"):
        return t
    if leaf in ("prompt_embeddings", "deep_prompt_embeddings") or last.endswith("_adapter1") or (
            leaf == "weight" and last in ("down", "up")):
        return torch.nn.init.normal_(t, std=0.02, generator=generator)
    if leaf == "phm_rule" or leaf.startswith(("W_left", "W_right")):
        return torch.nn.init.normal_(t, std=0.01, generator=generator)
    if leaf == "W":
        fan_in, fan_out = shape[1] * shape[0], shape[2] * shape[0]
        return uniform(math.sqrt(3.0 * 2.0 / ((fan_in + fan_out) / 2.0)))
    if leaf == "weight" and len(shape) == 1:
        return t.fill_(1.0)
    if leaf == "weight" and last == "get_v":
        return lecun_normal(shape[1] * shape[2] * shape[3])
    if leaf == "weight" and last == "in_proj":
        return uniform(math.sqrt(6.0 / (shape[0] + shape[1])))
    if leaf == "weight" and len(shape) == 2:
        return lecun_normal(shape[1])
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
        raise NotImplementedError(
            f"PEFT method {spec.method!r} is not ported to peft_vit_tpu_torch yet "
            f"(ported: {', '.join(PORTED_METHODS)}; ROADMAP §1, {_QUEUED[spec.method]})"
        )

    splits = construct_splits(cfg)
    num_classes = splits.num_classes
    criterion = bce_per_example if splits.multilabel else ce_per_example
    model, _, _ = build_image_classifier(
        cfg, spec, num_classes, use_bn=bool(cfg.TRAIN.CHANNEL_BN), device=device)
    if variables is not None:
        load_jax_variables(model, variables)

    # the tower's depth, the probe's extra block not counted (the JAX driver's
    # model.backbone.layers): transformer_probe's mask is blocks_<num_layers>
    num_layers = model.backbone.layers
    mask = build_mask(
        model,
        spec.method if spec.method != "none" else "linear",
        num_layers=num_layers,
        train_head=bool(cfg.PEFT.TRAIN_HEAD),
        extra_regex=str(cfg.PEFT.TRAINABLE_REGEX),
        adapter_layers=spec.adapter_layers,
    )
    logger.info("trainable:\n%s", describe_mask(model, mask))
    # the leaves a cell draws fresh: every trainable one of an injected
    # method; only the head (train_head) of the others, whose tower leaves
    # start from the grafted values (adapter_tuning_clip.py:231 re-loads the
    # pretrained backbone per cell)
    fresh_mask = mask if spec.method not in TOWER_METHODS else build_mask(
        model, "linear", num_layers=num_layers, train_head=bool(cfg.PEFT.TRAIN_HEAD),
        extra_regex="logit_scale")
    n_trainable = count_trainable(model, mask)
    log_trainable_params(n_trainable)
    if bool(cfg.TRAIN.get("CACHE_FROZEN_PREFIX", True)) and _first_trainable_layer(
            mask, num_layers) > 0:
        raise NotImplementedError(
            "the cached-prefix sweep (every trainable leaf past block 0) is not ported to "
            "peft_vit_tpu_torch yet (ROADMAP §1, probes and zero-shot); set "
            "TRAIN.CACHE_FROZEN_PREFIX False to train through the whole tower"
        )
    trainable0, frozen = split_params(model, mask)
    # the grafted values of the trainable leaves, fp32, taken before anything
    # casts the tower (the JAX driver resets from its fp32 params)
    grafted = {k: v.detach().cpu().clone() for k, v in trainable0.items()}
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
        def init_trainables(key: CellKey) -> Dict[str, torch.Tensor]:
            gen = key.generator()
            return {k: _fresh_leaf(k, v.shape, gen) if fresh_mask[k] else v.clone()
                    for k, v in grafted.items()}

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
