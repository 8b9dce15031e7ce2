"""In-process serving (counterpart of ``peft_vit_tpu/engine/serving.py``).

``ServingSession`` keeps a classifier on the card for a fixed set of batch
buckets and pads each request up to the smallest bucket that holds it;
oversize requests are split into max-bucket chunks.  Each bucket runs once
at construction, so the kernels are built and the library plans chosen
before the first request, as the JAX session compiles every bucket at load.
Requests are NHWC numpy images; logits come back as float32 numpy.

A model built with ``int8=True`` is served through the int8 path: the
session freezes and casts every weight as for any model, and each request
then quantizes weight and activation per call (``ops.int8.int8_matmul``) for
the tower's four GEMMs per block.  Nothing else in the session changes.

``export_classifier`` and ``load_exported`` are not ported yet.
"""

from __future__ import annotations

import logging
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.layers import cast_frozen_
from ..utils import resolve_device

logger = logging.getLogger(__name__)


def make_infer_fn(
    model: nn.Module, state: Optional[Mapping[str, torch.Tensor]] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Deterministic logits fn(images) of ``model`` in eval mode.

    ``state`` (a ``state_dict``, e.g. from ``models.params_from_jax``) is
    loaded strictly first.  Serving trains nothing, so every weight is then
    frozen and cast once to the model's compute dtype (LayerNorm and BN
    statistics stay fp32)."""
    if state is not None:
        model.load_state_dict(state, strict=True)
    cast_frozen_(model.requires_grad_(False))
    model.eval()

    def infer(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(images)

    return infer


class ServingSession:
    """Static-bucket batched inference.

    >>> sess = ServingSession(model, state, image_size=224)
    >>> logits = sess.predict(images)          # (N, num_classes) np array

    ``dtype`` is the dtype the request images travel to the device in
    (the model casts them to its compute dtype).  ``device=None`` is the
    card; without CUDA the session raises unless ``device='cpu'``.
    """

    def __init__(
        self,
        model: nn.Module,
        state: Optional[Mapping[str, torch.Tensor]],
        image_size: int,
        *,
        buckets: Sequence[int] = (1, 8, 32),
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.device = resolve_device(device)
        self.image_size = int(image_size)
        self.dtype = dtype
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"bad buckets: {buckets}")
        self._infer = make_infer_fn(model.to(self.device), state)
        for b in self.buckets:
            self._infer(torch.zeros(self._shape(b), dtype=dtype, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logger.info(
            "=> serving session ready on %s: buckets %s, image %d",
            self.device, self.buckets, self.image_size,
        )

    def _shape(self, b: int) -> Tuple[int, int, int, int]:
        return (b, self.image_size, self.image_size, 3)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, images: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) -> (N, num_classes) float32 logits; N arbitrary."""
        images = np.asarray(images)
        n = images.shape[0]
        if n == 0:
            raise ValueError("empty request")
        if images.shape[1:] != self._shape(1)[1:]:
            raise ValueError(f"images must be (N, {self.image_size}, {self.image_size}, 3), "
                             f"got {images.shape}")
        out = []
        start = 0
        max_b = self.buckets[-1]
        while start < n:
            take = min(max_b, n - start)
            chunk = torch.zeros(self._shape(self._bucket_for(take)), dtype=self.dtype)
            chunk[:take] = torch.from_numpy(images[start : start + take])
            logits = self._infer(chunk.to(self.device))
            out.append(logits[:take].float().cpu().numpy())
            start += take
        return np.concatenate(out, axis=0)
