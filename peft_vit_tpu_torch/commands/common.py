"""Shared CLI plumbing (counterpart of ``peft_vit_tpu/commands/common.py``).

One parser serves every method (the reference duplicates this into 24
command scripts; template: commands/adapter_clip.py:30-165): two YAML
configs (dataset, model) merged in order, ``--target/--ds/--model``,
few-shot controls, seed fixing, the 1-shot->2-shot promotion, and a yacs
``opts`` remainder.
"""

from __future__ import annotations

import argparse
import logging
import random

import numpy as np
import torch

from ..config import get_default_config
from ..data.few_shot import effective_shots
from ..utils.logging import create_logger


def add_finetuning_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--ds", help="dataset config yaml", default=None)
    parser.add_argument("--model", help="model config yaml", default=None)
    parser.add_argument(
        "--method",
        default=None,
        help="PEFT method (overrides config PEFT.METHOD)",
    )
    parser.add_argument(
        "--no-tuning",
        dest="no_tuning",
        type=lambda s: s.lower() in ("true", "1", "yes"),
        default=False,
        help="skip the lr x wd sweep; use --lr/--l2",
    )
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--l2", type=float, default=None)
    parser.add_argument(
        "--num-shots", dest="num_shots", type=int, default=None
    )
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--classifier",
        choices=["linear", "logistic"],
        default="linear",
        help="probe type for linear_probe",
    )
    parser.add_argument(
        "opts",
        nargs=argparse.REMAINDER,
        help="yacs-style KEY VALUE overrides",
    )


def load_config(args):
    cfg = get_default_config()
    for yaml_file in (args.ds, args.model):
        if yaml_file:
            cfg.merge_from_file(yaml_file)
            cfg.NAME = cfg.NAME or yaml_file
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.method:
        cfg.PEFT.METHOD = args.method
    if args.lr is not None:
        cfg.TRAIN.LR = args.lr
    if args.l2 is not None:
        cfg.TRAIN.WD = args.l2
    if args.num_shots is not None:
        cfg.DATASET.NUM_SAMPLES_PER_CLASS = args.num_shots
    if args.seed is not None:
        cfg.DATASET.RANDOM_SEED_SAMPLING = args.seed
    # 1-shot -> 2-shot promotion (commands/adapter_clip.py:112-133)
    k = int(cfg.DATASET.NUM_SAMPLES_PER_CLASS)
    if k > 0:
        cfg.DATASET.NUM_SAMPLES_PER_CLASS = effective_shots(
            k, cfg.DATASET.DATASET
        )
    if not cfg.NAME:
        cfg.NAME = f"{cfg.MODEL.NAME}_{cfg.PEFT.METHOD}"
    return cfg


def fix_seeds(seed: int = 0) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def setup_run_logger(cfg, phase_prefix: str = "finetuning") -> str:
    n = cfg.DATASET.NUM_SAMPLES_PER_CLASS
    phase = f"{phase_prefix}_{n}" if int(n) > 0 else phase_prefix
    out = create_logger(cfg, phase)
    logging.info("=> config:\n%s", cfg.dump())
    return out
