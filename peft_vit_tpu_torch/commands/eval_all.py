"""Multi-dataset evaluation through the port (counterpart of
``peft_vit_tpu/commands/eval_all.py``): one in-process loop runs (dataset x
shot x seed) through the few-shot driver, collects the logs and prints the
summary table (the reference's read_results extract_finetune_results).
A run that raises scores 0 (the reference's sweep-cell semantics, logged
with its traceback), so a score of 0 is no proof that a run worked.

    python -m peft_vit_tpu_torch.commands.eval_all --model MODEL.yaml --datasets DS.yaml ... [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from ..config import get_default_config
from ..utils.logging import create_logger
from ..utils.results import summarize
from .common import fix_seeds
from .run import finetune_main

logger = logging.getLogger(__name__)


def main(argv=None, *, device=None):
    """The score of each (dataset, shots, seed), 0 for a run that raised."""
    p = argparse.ArgumentParser(description="multi-dataset PEFT eval (PyTorch port)")
    p.add_argument("--model", required=False, default=None)
    p.add_argument("--datasets", nargs="+", required=True, help="dataset yaml paths or names")
    p.add_argument("--method", default="lora")
    p.add_argument("--shots", nargs="+", type=int, default=[5])
    p.add_argument("--seeds", nargs="+", type=int, default=[0])
    p.add_argument("--output", default="output")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    results = {}
    ds_names = []
    for ds in args.datasets:
        for n in args.shots:
            for seed in args.seeds:
                cfg = get_default_config()
                if args.model:
                    cfg.merge_from_file(args.model)
                if os.path.exists(ds):
                    cfg.merge_from_file(ds)
                else:
                    cfg.DATASET.DATASET = ds
                if args.opts:
                    cfg.merge_from_list(args.opts)
                cfg.PEFT.METHOD = args.method
                cfg.DATASET.NUM_SAMPLES_PER_CLASS = n
                cfg.DATASET.RANDOM_SEED_SAMPLING = seed
                cfg.OUTPUT_DIR = args.output
                cfg.NAME = cfg.NAME or f"{args.method}"
                name = cfg.DATASET.DATASET
                if name not in ds_names:
                    ds_names.append(name)
                out = create_logger(cfg, f"finetuning_{n}")
                cfg.freeze()
                fix_seeds(seed)
                try:
                    score = finetune_main(cfg, out, device=device)
                except Exception as e:  # the reference's sweep-cell semantics: score 0
                    logger.exception("run failed: %s", e)
                    score = 0.0
                results[(name, n, seed)] = score

    table = summarize(args.output, ds_names, args.shots, args.seeds)
    print("\n=== summary (mean over seeds) ===")
    for ds in ds_names:
        print(f"{ds:<40s} " + "  ".join(f"{n}-shot: {table[ds][n]:.2f}" for n in args.shots))
    print(f"{'AVERAGE':<40s} {np.nanmean([table[ds][n] for ds in ds_names for n in args.shots]):.2f}")
    return results


if __name__ == "__main__":
    main()
