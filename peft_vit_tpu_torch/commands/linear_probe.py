"""Linear and logistic probes through the port (counterpart of
``peft_vit_tpu/commands/linear_probe.py``), on the card unless the caller
asks for the CPU.

``--classifier logistic``: the frozen tower's features and the L-BFGS
logistic regression over the 97-point C sweep (``engine.probes``; the
reference's evaluation/logistic_classifier.py protocol).
``--classifier linear``: the few-shot driver with ``PEFT.METHOD`` linear
and ``TRAIN.FREEZE_IMAGE_BACKBONE`` (the reference's
commands/linear_probe.py:183-195), which takes the cached prefix.

    python -m peft_vit_tpu_torch.commands.linear_probe --classifier logistic --ds DS.yaml --model MODEL.yaml
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Mapping, Optional

from ..data import construct_splits
from ..engine.probes import logistic_probe_sweep
from ..engine.zeroshot import extract_image_features
from ..models import build_image_classifier, load_jax_variables
from ..peft import PEFTSpec
from ..utils import resolve_device
from ..utils.logging import final_result_line, log_trainable_params
from .common import add_finetuning_args, load_config, setup_run_logger
from .run import finetune_main
from .zeroshot_eval import image_encoder

logger = logging.getLogger(__name__)


def logistic_main(cfg, out_dir: str, *, device=None,
                  variables: Optional[Mapping] = None) -> float:
    """The logistic probe's test accuracy, the features cached under
    ``out_dir/feature_cache``.  ``device``: None is the card; ``variables``
    (a JAX-layout tree of the classifier) replaces the built weights."""
    device = resolve_device(device)
    splits = construct_splits(cfg)
    model, _, _ = build_image_classifier(cfg, PEFTSpec(), splits.num_classes, device=device)
    if variables is not None:
        load_jax_variables(model, variables)
    encode_image = image_encoder(model)
    cache_dir = os.path.join(out_dir, "feature_cache")
    batch = int(cfg.TEST.BATCH_SIZE_PER_GPU)

    def feats(x, tag):
        name = (f"{cfg.DATASET.DATASET}_{tag}_{cfg.DATASET.NUM_SAMPLES_PER_CLASS}_"
                f"{cfg.DATASET.RANDOM_SEED_SAMPLING}.npz")
        return extract_image_features(encode_image, x, batch_size=batch,
                                      cache_path=os.path.join(cache_dir, name))

    ftr, fva, fte = feats(splits.x_train, "train"), feats(splits.x_val, "val"), feats(
        splits.x_test, "test")
    acc, _ = logistic_probe_sweep(
        ftr, splits.y_train, fva, splits.y_val, fte, splits.y_test, splits.num_classes,
        log_lower=float(cfg.TRAIN.SEARCH_WD_LOG_LOWER),
        log_upper=float(cfg.TRAIN.SEARCH_WD_LOG_UPPER), device=device)
    log_trainable_params((ftr.shape[1] + 1) * splits.num_classes)
    final_result_line("accuracy", acc)
    return acc


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser(description="linear / logistic probe (PyTorch port)")
    add_finetuning_args(parser)
    args = parser.parse_args(argv)
    cfg = load_config(args)
    out = setup_run_logger(cfg, "linear_probe")
    if args.classifier == "logistic":
        cfg.freeze()
        return logistic_main(cfg, out, device=device)
    cfg.PEFT.METHOD = "linear"
    cfg.TRAIN.FREEZE_IMAGE_BACKBONE = True
    cfg.freeze()
    return finetune_main(cfg, out, device=device)


if __name__ == "__main__":
    main()
