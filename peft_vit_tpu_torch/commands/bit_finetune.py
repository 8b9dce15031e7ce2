"""BiT-HyperRule fine-tuning (counterpart of
``peft_vit_tpu/commands/bit_finetune.py``; the reference's
tools/bit_finetune.py:98-275).

Big Transfer's step-based schedule: the total steps and decay boundaries
follow the dataset's size; SGD, the base lr scaled by batch / 512, no
weight decay, mixup 0.1 from 20,000 images on.  Every leaf trains.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Mapping, Optional

from ..config import get_default_config
from ..data import construct_splits
from ..engine.trainer import Trainer, batch_iterator
from ..models import build_image_classifier, load_jax_variables
from ..peft import build_mask, spec_from_config
from ..utils import resolve_device
from ..utils.logging import create_logger, final_result_line

logger = logging.getLogger(__name__)


def bit_hyperrule(n_examples: int):
    """(total_steps, decay boundaries) per the BiT paper."""
    if n_examples < 20_000:
        return 500, (200, 300, 400)
    if n_examples < 500_000:
        return 10_000, (3000, 6000, 9000)
    return 20_000, (6000, 12_000, 18_000)


def bit_main(cfg, *, device=None, variables: Optional[Mapping] = None) -> float:
    """Fine-tune ``cfg``'s model under the HyperRule (which sets
    ``TRAIN.END_EPOCH``, ``LR``, ``WD``, the step schedule and ``AUG.MIXUP``
    in ``cfg``); returns the best top-1.  ``variables``: as in
    ``commands.train.build_trainer``."""
    device = resolve_device(device)
    splits = construct_splits(cfg)
    spec = spec_from_config(cfg)
    model, _, _ = build_image_classifier(cfg, spec, splits.num_classes, device=device)
    if variables is not None:
        load_jax_variables(model, variables)
    mask = build_mask(model, "full", num_layers=12)

    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
    n = len(splits.y_train)
    total_steps, boundaries = bit_hyperrule(n)
    steps_per_epoch = max(n // batch, 1)
    epochs = max(total_steps // steps_per_epoch, 1)

    cfg.defrost()
    cfg.TRAIN.END_EPOCH = epochs
    cfg.TRAIN.LR = float(cfg.FINETUNE.BASE_LR) * batch / 512.0
    cfg.TRAIN.WD = 0.0
    cfg.TRAIN.LR_SCHEDULER.METHOD = "step"
    cfg.TRAIN.SCHEDULE = [b // steps_per_epoch for b in boundaries]
    cfg.AUG.MIXUP = 0.1 if n >= 20_000 else 0.0
    cfg.freeze()

    trainer = Trainer(cfg, model, mask, steps_per_epoch)
    best = trainer.fit(
        lambda e: batch_iterator(splits.x_train, splits.y_train, batch, seed=e),
        lambda: batch_iterator(splits.x_test, splits.y_test, batch, shuffle=False,
                               drop_last=False),
        tb_log_dir=os.path.join(cfg.OUTPUT_DIR, cfg.DATASET.DATASET, cfg.NAME, "tb_log"),
    )
    final_result_line("accuracy", best)
    return best


def main(argv=None, *, device=None):
    p = argparse.ArgumentParser(description="BiT fine-tune (PyTorch port)")
    p.add_argument("--cfg", default=None)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cfg = get_default_config()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.NAME = cfg.NAME or "bit_finetune"
    create_logger(cfg, "bit_finetune")
    return bit_main(cfg, device=device)


if __name__ == "__main__":
    main()
