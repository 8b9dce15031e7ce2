"""Profiling and tracing helpers (counterpart of
``peft_vit_tpu/utils/profiling.py``).

* ``enable_anomaly_detection``: ``torch.autograd.set_detect_anomaly`` with
  its NaN checks (the reference's ``TRAIN.DETECT_ANOMALY``; JAX's
  ``jax_debug_nans``).  Its checks wait for the card, so no step is captured
  while it is on (``engine.train.runs_captured``).
* ``trace``: a ``torch.profiler`` window written to a directory
  (``utils.xprof`` reads it).
* ``StepTimer``: a throughput meter that synchronises the card.
* ``MetricsWriter``: scalars as JSONL, and to TensorBoard where it imports
  (``utils.tb``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Iterator, Optional

import torch


def enable_anomaly_detection(enabled: bool = True) -> None:
    """A backward op whose result holds a NaN raises, naming the forward op
    (slows every step; process-wide until turned off)."""
    torch.autograd.set_detect_anomaly(enabled, check_nan=enabled)


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` window over the block, its Chrome trace written
    to ``log_dir/trace.json``.  ``cuda`` (default: whether CUDA is
    available) records the card's kernels beside the host's ops; the block
    should end with the card synchronised, so that the window holds whole
    steps."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Samples a second and milliseconds a step since the last ``reset``;
    ``step(batch, sync_value)`` waits for the card (or for ``sync_value``'s
    device) before counting the step, so the clock holds finished work."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._samples = 0
        self._steps = 0

    def step(self, batch_size: int, sync_value=None):
        if isinstance(sync_value, torch.Tensor) and sync_value.device.type == "cuda":
            torch.cuda.synchronize(sync_value.device)
        elif sync_value is None and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._samples += batch_size
        self._steps += 1

    @property
    def samples_per_sec(self) -> float:
        return self._samples / max(time.perf_counter() - self._t0, 1e-9)

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * (time.perf_counter() - self._t0) / max(self._steps, 1)


class MetricsWriter:
    """Structured scalar log: ``log_dir/metrics.jsonl`` always, TensorBoard
    when it imports."""

    def __init__(self, log_dir: str):
        from .tb import create_scalar_writer

        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = create_scalar_writer(log_dir)

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.scalar(k, float(v), step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
