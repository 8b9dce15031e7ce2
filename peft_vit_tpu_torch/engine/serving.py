"""In-process serving (counterpart of ``peft_vit_tpu/engine/serving.py``).

``ServingSession`` keeps a classifier on the card for a fixed set of batch
buckets and pads each request up to the smallest bucket that holds it;
oversize requests are split into max-bucket chunks.  Each bucket is captured
at construction as a CUDA graph over a static input (``engine.train.StepGraph``,
after a warm-up that builds the kernels and chooses the library plans), as
the JAX session compiles every bucket at load with the weights as
constants; a request copies its padded images into the bucket's input and
replays the graph.  The CPU runs each bucket eagerly.  Requests are NHWC
numpy images; logits come back as float32 numpy.

A model built with ``int8=True`` is served through the int8 path: the
session freezes and casts every weight as for any model, then quantizes the
tower's ``Int8Dense`` weights once, at load (``ops.int8.quantize_frozen_tree``
of the cast weights, into the modules' ``w_i8`` / ``s_w`` buffers: the codes
a per-request quantize would make), so that a request quantizes only its
activations, inside the int8 kernel.

``export_classifier`` serializes that eval forward through ``torch.export``
with a symbolic batch, the counterpart of the JAX artifact (StableHLO
through ``jax.export``): every kernel launch is a registered op of
``peft_vit_tpu_torch::`` in its graph (``ops._library``), so
``load_exported`` needs torch and this package's ``ops``, which registers
the ops and builds the kernels at first use, and none of the model code.
Every artifact is traced on the card's route (``ops.attention.card_route``),
so its graph is the same whichever device it was traced on: the attention
is K1's op, which the CPU runs as its plain version and the card launches.
"""

from __future__ import annotations

import io
import logging
import os
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..models.layers import Int8Dense, cast_frozen_
from ..ops.attention import card_route
from ..ops.int8 import quantize_frozen_tree
from ..utils import resolve_device
from .train import StepGraph, runs_captured

logger = logging.getLogger(__name__)


def make_infer_fn(
    model: nn.Module, state: Optional[Mapping[str, torch.Tensor]] = None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Deterministic logits fn(images) of ``model`` in eval mode.

    ``state`` (a ``state_dict``, e.g. from ``models.params_from_jax``) is
    loaded strictly first.  Serving trains nothing, so every weight is then
    frozen and cast once to the model's compute dtype (LayerNorm and BN
    statistics stay fp32), and every ``Int8Dense`` weight quantized once
    (``quantize_int8_tower``)."""
    if state is not None:
        model.load_state_dict(state, strict=True)
    cast_frozen_(model.requires_grad_(False))
    quantize_int8_tower(model)
    model.eval()

    def infer(images: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(images)

    return infer


def quantize_int8_tower(model: nn.Module) -> None:
    """Quantize the weight of every ``Int8Dense`` of ``model`` into its
    ``w_i8`` / ``s_w`` buffers (``ops.int8.quantize_frozen_tree`` of the
    weights as stored, after ``cast_frozen_``: the codes that
    ``ops.int8.int8_matmul`` would make of them per call)."""
    modules = {name: m for name, m in model.named_modules() if isinstance(m, Int8Dense)}
    if not modules:
        return
    weights = {f"{name}.weight": m.weight for name, m in modules.items()}
    tree = quantize_frozen_tree(
        weights, targets=tuple({name.rsplit(".", 1)[-1] for name in modules}),
        param_dtype=next(iter(weights.values())).dtype)
    for name, m in modules.items():
        m.w_i8, m.s_w = tree[f"{name}.w_i8"], tree[f"{name}.s_w"]


class ServingSession:
    """Static-bucket batched inference.

    >>> sess = ServingSession(model, state, image_size=224)
    >>> logits = sess.predict(images)          # (N, num_classes) np array

    ``dtype`` is the dtype the request images travel to the device in
    (the model casts them to its compute dtype).  ``device=None`` is the
    card; without CUDA the session raises unless ``device='cpu'``.  On the
    card each bucket is a CUDA-graph replay.
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
        self._graphs = {}
        for b in self.buckets:
            images = torch.zeros(self._shape(b), dtype=dtype, device=self.device)
            if runs_captured(images):
                self._graphs[b] = StepGraph(lambda inputs: self._infer(inputs["images"]),
                                            {"images": images})
            else:
                self._infer(images)
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
            bucket = self._bucket_for(take)
            chunk = torch.zeros(self._shape(bucket), dtype=self.dtype)
            chunk[:take] = torch.from_numpy(images[start : start + take])
            if bucket in self._graphs:
                logits = self._graphs[bucket](images=chunk)
            else:
                logits = self._infer(chunk.to(self.device))
            # a copy: the next replay overwrites a graph's output
            out.append(logits[:take].to("cpu", torch.float32, copy=True).numpy())
            start += take
        return np.concatenate(out, axis=0)


#: the platforms an artifact can be traced for; the JAX package's "tpu" has no
#: counterpart here
EXPORT_PLATFORMS = ("cpu", "cuda")


class _Logits(nn.Module):
    """The eval forward as ``torch.export`` takes it: images -> fp32 logits."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images).to(torch.float32)


def _platform(platforms: Optional[Sequence[str]], model: nn.Module) -> torch.device:
    """The one device an artifact is traced on: the model's by default."""
    if not platforms:
        return next(model.parameters()).device
    names = {str(p).lower() for p in platforms}
    if "tpu" in names:
        raise ValueError("platform 'tpu' is the JAX package's: the port exports for 'cpu' or "
                         "'cuda'")
    unknown = names - set(EXPORT_PLATFORMS)
    if unknown:
        raise ValueError(f"unknown platform(s) {sorted(unknown)}: take one of {EXPORT_PLATFORMS}")
    if len(names) > 1:
        raise ValueError("a torch.export artifact holds one device's graph: export once for "
                         f"each of {sorted(names)}")
    return resolve_device(names.pop())


def export_classifier(
    model: nn.Module,
    state: Optional[Mapping[str, torch.Tensor]],
    image_size: int,
    *,
    dtype: torch.dtype = torch.float32,
    path: Optional[str] = None,
    platforms: Optional[Sequence[str]] = None,
) -> bytes:
    """Serialize the eval forward as a batch-polymorphic ``torch.export``
    artifact and return its bytes (written to ``path`` too, if given).

    The model is prepared as ``make_infer_fn`` prepares it (``state``
    loaded, every weight frozen and cast, the int8 tower quantized once) and
    traced with a symbolic batch (``Dim`` "b", at least 1) on images
    (b, image_size, image_size, 3) of ``dtype``; the artifact returns fp32
    logits.  ``platforms``: ("cpu",) or ("cuda",), the device it is traced
    on (default: the model's).  The trace takes the card's route on either
    device (``card_route``), so a model the card refuses (a bf16 softmax)
    cannot be exported."""
    device = _platform(platforms, model)
    make_infer_fn(model.to(device), state)
    example = torch.zeros((2, image_size, image_size, 3), dtype=dtype, device=device)
    batch = torch.export.Dim("b", min=1)
    # the card's route on either device: the graph names K1's op, never the
    # CPU's plain attention, which a reload on the card would run as it is
    with torch.no_grad(), card_route():
        exported = torch.export.export(_Logits(model), (example,),
                                       dynamic_shapes={"images": {0: batch}})
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    data = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(data)
        logger.info("=> exported %d-byte artifact (%s) to %s", len(data), device.type, path)
    return data


def _input_dtype(exported) -> torch.dtype:
    """The dtype of the images an artifact was traced on."""
    name = exported.graph_signature.user_inputs[0]
    node = next(n for n in exported.graph.nodes if n.op == "placeholder" and n.name == name)
    return node.meta["val"].dtype


def load_exported(src: Union[str, os.PathLike, bytes],
                  device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load an ``export_classifier`` artifact from a path or its bytes ->
    ``fn(images) -> logits``: NHWC images (a tensor or numpy array, any
    batch; cast to the dtype the artifact was traced on) to fp32 logits on
    ``device`` (None: the card, which raises without CUDA).  An artifact
    traced on another device is moved to this one: its graph is the card's
    route on either device, so its kernels' ops launch on the card and run
    their plain versions on the CPU.  Needs torch and
    ``peft_vit_tpu_torch.ops``, not the model code."""
    from .. import ops  # noqa: F401  (registers the kernels' ops the graph names)

    device = resolve_device(device)
    if isinstance(src, (bytes, bytearray)):
        exported = torch.export.load(io.BytesIO(bytes(src)))
    else:
        with open(src, "rb") as f:
            exported = torch.export.load(io.BytesIO(f.read()))
    dtype = _input_dtype(exported)
    traced_on = next((t.device for t in exported.state_dict.values()), device)
    if traced_on.type != device.type:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, device)
    module = exported.module()

    def fn(images) -> torch.Tensor:
        with torch.no_grad():
            return module(torch.as_tensor(images).to(device, dtype))

    return fn
