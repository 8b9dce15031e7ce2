"""Debugging driver: the few-shot fine-tune under forensics (counterpart of
``peft_vit_tpu/commands/debug_run.py``).

Not another copy of the driver: the same ``finetune_main``
(``commands/run.py``) forced into debug mode, so a debugging run exercises
exactly the code being debugged:

* anomaly detection on (``utils.profiling.enable_anomaly_detection``,
  ``torch.autograd.set_detect_anomaly`` with its NaN checks: the
  reference's ``TRAIN.DETECT_ANOMALY``); its checks wait for the card, so
  every step, eval batch and serving bucket runs eagerly
  (``engine.train.runs_captured``);
* ``--no-jit``: every step eagerly, no ``StepGraph`` (what anomaly
  detection already implies; kept so that a JAX command line works
  unchanged);
* ``--check-leaks`` (``jax.checking_leaks``) has no counterpart: PyTorch
  has no tracers to leak, and the option is refused;
* DEBUG-level logging, one epoch and the sweep off unless ``--full``.

Shares ``add_finetuning_args`` (--ds/--model/--method/--lr/--l2/opts), so a
``commands.run`` command line becomes a debugging session by swapping the
module name.
"""

from __future__ import annotations

import argparse
import logging

from .common import add_finetuning_args, load_config, setup_run_logger
from .run import finetune_main

logger = logging.getLogger(__name__)


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser(
        description="PEFT fine-tune under debug forensics (commands.run with anomaly "
                    "detection and eager steps)")
    add_finetuning_args(parser)
    parser.add_argument("--no-jit", dest="no_jit", action="store_true",
                        help="run every step eagerly (implied by the anomaly detection)")
    parser.add_argument("--check-leaks", dest="check_leaks", action="store_true",
                        help="refused: jax.checking_leaks has no PyTorch counterpart")
    parser.add_argument("--full", action="store_true",
                        help="keep the configured epoch count and sweep (default: 1 epoch, "
                             "sweep off, for a fast repro loop)")
    args = parser.parse_args(argv)
    if args.check_leaks:
        parser.error("--check-leaks is jax.checking_leaks, which has no PyTorch counterpart: "
                     "PyTorch has no tracers to leak")
    cfg = load_config(args)
    cfg.TRAIN.DETECT_ANOMALY = True
    if args.no_tuning or not args.full:
        cfg.TRAIN.NO_TUNING = True
    if not args.full:
        cfg.TRAIN.END_EPOCH = min(int(cfg.TRAIN.END_EPOCH), 1)
    logging.getLogger("peft_vit_tpu_torch").setLevel(logging.DEBUG)
    out = setup_run_logger(cfg)
    cfg.freeze()

    from ..utils.profiling import enable_anomaly_detection

    logger.info("=> debug: anomaly detection on, every step eager%s",
                " (--no-jit)" if args.no_jit else "")
    enable_anomaly_detection(True)
    try:
        return finetune_main(cfg, out, device=device)
    finally:
        enable_anomaly_detection(False)


if __name__ == "__main__":
    main()
