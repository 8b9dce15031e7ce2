"""Prediction-submission validation (counterpart of
``peft_vit_tpu/utils/submission.py``; the reference's
common/prediction_submission.py:47-109).

The ELEVATER leaderboard takes a structured prediction blob, validated
before upload.  Validation and local serialization work; the upload itself
(AzureML, credentials) is not made here, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List

import numpy as np

KNOWN_TASKS = ("classification_multiclass", "classification_multilabel")


@dataclasses.dataclass
class PredictionSubmission:
    dataset_name: str
    model_name: str
    task: str
    predictions: List[List[float]]  # (num_images, num_classes) scores
    num_shots: int = -1
    random_seed: int = 0
    created_by: str = "peft_vit_tpu"

    def validate(self) -> None:
        if not self.dataset_name:
            raise ValueError("dataset_name is required")
        if not self.model_name:
            raise ValueError("model_name is required")
        if self.task not in KNOWN_TASKS:
            raise ValueError(f"task must be one of {KNOWN_TASKS}, got {self.task!r}")
        arr = np.asarray(self.predictions, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[0] == 0:
            raise ValueError(f"predictions must be (num_images, num_classes), got {arr.shape}")
        if not np.isfinite(arr).all():
            raise ValueError("predictions contain non-finite values")

    def save(self, path: str) -> None:
        self.validate()
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def load(cls, path: str) -> "PredictionSubmission":
        with open(path) as f:
            obj = cls(**json.load(f))
        obj.validate()
        return obj


def submit_predictions(submission: PredictionSubmission, path: str) -> str:
    """Local submission: validate and write (the AzureML upload of the
    reference's common/utils.py:15-38 needs credentials this package never
    holds)."""
    submission.save(path)
    return path
