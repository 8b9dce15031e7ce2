"""The full-shot training command (counterpart of
``peft_vit_tpu/commands/train.py``; the reference's full_shot/main/tools/train.py).

    python -m peft_vit_tpu_torch.commands.train --cfg MODEL.yaml [KEY VALUE ...]

config -> ``PEFTSpec`` -> ``construct_splits`` -> ``build_image_classifier``
-> the trainable mask (``PEFT.METHOD``, none meaning full) -> ``Trainer.fit``
with the checkpoint and TensorBoard directories under
``OUTPUT_DIR/<dataset>/<NAME>``, on the card unless the caller asks for the
CPU (``device="cpu"``).  The JAX command's streaming branch (TSV shards, an
ImageFolder tree, ELEVATER zips through the native decode ring) is not
ported: ``construct_splits`` raises for those sources (ROADMAP §1, streaming
data), as it does for the few-shot driver.  ``main`` exits 75 (EX_TEMPFAIL) when a
SIGTERM stopped the run at a checkpoint.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Mapping, Optional

from ..config import get_default_config
from ..data import construct_splits
from ..engine.trainer import PreemptedError, Trainer, batch_iterator
from ..models import build_image_classifier, load_jax_variables
from ..peft import build_mask, count_trainable, spec_from_config
from ..utils import resolve_device
from ..utils.logging import create_logger, final_result_line, log_trainable_params

logger = logging.getLogger(__name__)


def build_trainer(cfg, device=None, variables: Optional[Mapping] = None):
    """The splits, the model and its ``Trainer`` of ``cfg``: what
    ``train_main`` fits.  ``variables`` (a JAX-layout variables tree of the
    classifier) replaces the built weights: the seam through which a test
    hands the port the JAX package's weights."""
    device = resolve_device(device)
    spec = spec_from_config(cfg)
    splits = construct_splits(cfg)
    model, _, _ = build_image_classifier(cfg, spec, splits.num_classes, device=device)
    if variables is not None:
        load_jax_variables(model, variables)
    method = cfg.PEFT.METHOD if cfg.PEFT.METHOD != "none" else "full"
    mask = build_mask(model, method, num_layers=getattr(model.backbone, "layers", 12))
    log_trainable_params(count_trainable(model, mask))
    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
    steps_per_epoch = max(len(splits.y_train) // batch, 1)
    return splits, Trainer(cfg, model, mask, steps_per_epoch)


def run_dirs(cfg):
    """The checkpoint and TensorBoard directories of ``cfg``."""
    root = os.path.join(cfg.OUTPUT_DIR, cfg.DATASET.DATASET, cfg.NAME)
    return os.path.join(root, "checkpoints"), os.path.join(root, "tb_log")


def train_main(cfg, *, device=None, variables: Optional[Mapping] = None) -> float:
    """Train ``cfg`` to ``TRAIN.END_EPOCH``; returns the best top-1 (raw,
    EMA or SWA) and logs it as the run's last line."""
    splits, trainer = build_trainer(cfg, device=device, variables=variables)
    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU)

    def train_batches(epoch):
        return batch_iterator(splits.x_train, splits.y_train, batch,
                              shuffle=bool(cfg.TRAIN.SHUFFLE), seed=epoch)

    def eval_batches():
        return batch_iterator(splits.x_test, splits.y_test, int(cfg.TEST.BATCH_SIZE_PER_GPU),
                              shuffle=False, drop_last=False)

    ckpt_dir, tb_dir = run_dirs(cfg)
    best = trainer.fit(train_batches, eval_batches, ckpt_dir, tb_dir)
    final_result_line("accuracy", best)
    return best


def load_cfg(argv, name: str, parser_description: str):
    """``--cfg`` and the ``KEY VALUE`` overrides; ``NAME`` defaults to the
    YAML's base name, else ``name``."""
    parser = argparse.ArgumentParser(description=parser_description)
    parser.add_argument("--cfg", required=False, default=None)
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = get_default_config()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
        cfg.NAME = cfg.NAME or os.path.splitext(os.path.basename(args.cfg))[0]
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.NAME = cfg.NAME or name
    return cfg


def main(argv=None, *, device=None):
    cfg = load_cfg(argv, "train", "full-shot training (PyTorch port)")
    create_logger(cfg, "train")
    cfg.freeze()
    try:
        return train_main(cfg, device=device)
    except PreemptedError as e:
        # a clean preemption: the state is checkpointed; EX_TEMPFAIL tells
        # the scheduler this is a retry, not a failure
        logger.warning("=> %s", e)
        sys.exit(75)


if __name__ == "__main__":
    main()
