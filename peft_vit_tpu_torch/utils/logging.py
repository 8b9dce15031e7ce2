"""Logger with reference-compatible file layout and line shapes (a copy of
``peft_vit_tpu/utils/logging.py``: the port's driver writes the same logs).

The reference recovers results by *parsing logs* (read_results.py:40-88):
files named ``{phase}_{time}_rank{N}.txt`` under
``OUTPUT_DIR/{dataset}/{cfg_name}``, the LAST line's last token is the
accuracy, and ``trainable params: X M`` appears somewhere in the file.
``create_logger`` / ``final_result_line`` keep those contracts.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path


def setup_logger(final_output_dir: str, rank: int, phase: str) -> str:
    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_file = f"{phase}_{time_str}_rank{rank}.txt"
    final_log_file = os.path.join(final_output_dir, log_file)
    head = "%(asctime)-15s:[P:%(process)d]: %(message)s"
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    logging.basicConfig(filename=str(final_log_file), format=head)
    root.setLevel(logging.INFO)
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter(head))
    root.addHandler(console)
    return final_log_file


def create_logger(cfg, phase: str = "train") -> str:
    root_output_dir = Path(cfg.OUTPUT_DIR or "output")
    final_output_dir = root_output_dir / cfg.DATASET.DATASET / cfg.NAME
    final_output_dir.mkdir(parents=True, exist_ok=True)
    setup_logger(str(final_output_dir), int(cfg.RANK), phase)
    return str(final_output_dir)


def log_trainable_params(count: int) -> None:
    """The line read_results.py greps: 'trainable params: X M'."""
    logging.info(f"Number of trainable params: {count / 1e6}M.")
    logging.info(f"trainable params: {count / 1e6}M")


def final_result_line(metric_name: str, value: float) -> None:
    """Last line of the run log; read_results takes the last token."""
    logging.info(f"=> TEST {metric_name}: {value:.3f}%")
