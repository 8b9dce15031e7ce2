"""TensorBoard scalars (counterpart of ``peft_vit_tpu/utils/tb.py``).

The reference logs per-epoch scalars through tensorboardX on the main
process only (tools/train.py:101-105; lib/core/function.py:165-170,
258-263).  The port runs one process, so the writer is always rank 0's; it
exists only when a TensorBoard backend is importable, otherwise
``create_scalar_writer`` returns None and the trainer skips it.
"""

from __future__ import annotations

import logging
from typing import Optional

logger = logging.getLogger(__name__)


class ScalarWriter:
    """Thin add_scalar/close wrapper over torch's SummaryWriter."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir=log_dir)
        self.log_dir = log_dir

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._writer.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def create_scalar_writer(log_dir: str) -> Optional[ScalarWriter]:
    """A ScalarWriter, or None when tensorboard is missing or ``log_dir``
    cannot be written."""
    try:
        return ScalarWriter(log_dir)
    except Exception as e:
        logger.warning("tensorboard writer disabled: %s", e)
        return None
