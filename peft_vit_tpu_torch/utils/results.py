"""Structured results (counterpart of ``peft_vit_tpu/utils/results.py``):
the driver appends one JSON line per run to ``results.jsonl`` beside its
text log, and ``summarize`` reads the accuracies back from the logs as the
reference's read_results.py:40-160 does (the last line's last token, the
mean over seeds)."""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Tuple

import numpy as np


def append_jsonl(path: str, record: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def read_log_results(log_path: str, dataset_name: str = "",
                     file_prefix: str = "") -> Tuple[List[float], List[str]]:
    """The accuracies (each log's last token) and trainable-parameter
    markers of the logs ``log_path/dataset/[*/]file_prefix*.txt``."""
    accs: List[float] = []
    num_para: List[str] = []
    patterns = [os.path.join(log_path, dataset_name, file_prefix + "*.txt"),
                os.path.join(log_path, dataset_name, "*", file_prefix + "*.txt")]
    for file in sorted({f for p in patterns for f in glob.glob(p)}):
        try:
            with open(file) as f:
                lines = f.readlines()
            text = "".join(lines)
            accs.append(float(lines[-1].strip().split(" ")[-1].replace("%", "")))
            num_para.append(text.strip().split("trainable params: ")[-1].split("M")[0])
        except Exception:
            continue
    return accs, num_para


def summarize(output_dir: str, datasets: List[str], shots: List[int], seeds: List[int],
              prefix: str = "finetuning") -> Dict[str, Dict[int, float]]:
    """The mean accuracy per (dataset, n-shot) over the seeds' logs."""
    out: Dict[str, Dict[int, float]] = {}
    for ds in datasets:
        out[ds] = {}
        for n in shots:
            accs, _ = read_log_results(output_dir, ds, f"{prefix}_{n}_")
            out[ds][n] = float(np.mean(accs)) if accs else float("nan")
    return out
