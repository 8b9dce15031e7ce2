"""SWA fine-tuning (counterpart of ``peft_vit_tpu/commands/swa_finetune.py``;
the reference's tools/swa_finetune.py:74-304).

A thin override layer on the full-shot trainer: ``SWA.ENABLED``, the swalr
schedule and ``TRAIN.AUTO_RESUME`` forced, so that it continues a finished
run's checkpoint, keeps the running average of the weights after
``SWA.BEGIN_EPOCH`` (default ``TRAIN.BEGIN_EPOCH``), refreshes BN statistics
for the average and evaluates it.

    python -m peft_vit_tpu_torch.commands.swa_finetune --cfg MODEL.yaml \\
        TRAIN.END_EPOCH 110 SWA.BEGIN_EPOCH 100
"""

from __future__ import annotations

from ..utils.logging import create_logger
from .train import load_cfg, train_main


def swa_config(cfg):
    """``cfg`` with the SWA overrides, in place."""
    cfg.SWA.ENABLED = True
    if int(cfg.SWA.BEGIN_EPOCH) < 0:
        cfg.SWA.BEGIN_EPOCH = int(cfg.TRAIN.BEGIN_EPOCH)
    cfg.TRAIN.LR_SCHEDULER.METHOD = "swalr"
    cfg.TRAIN.AUTO_RESUME = True
    return cfg


def main(argv=None, *, device=None):
    cfg = swa_config(load_cfg(argv, "swa_finetune", "SWA fine-tuning (PyTorch port)"))
    create_logger(cfg, "swa_finetune")
    cfg.freeze()
    return train_main(cfg, device=device)


if __name__ == "__main__":
    main()
