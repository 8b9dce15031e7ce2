"""Structured results (the ``append_jsonl`` of ``peft_vit_tpu/utils/results.py``):
the driver appends one JSON line per run to ``results.jsonl`` beside its
text log."""

from __future__ import annotations

import json
import os
from typing import Dict


def append_jsonl(path: str, record: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
