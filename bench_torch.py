#!/usr/bin/env python3
"""Benchmark: ViT-B/16 + LoRA fine-tuning throughput of the PyTorch/CUDA port
on one NVIDIA GPU (the counterpart of ``bench.py``).

    python3 bench_torch.py                      # on the card: bf16, B=16, k=8
    python3 bench_torch.py --int8 --bwd-dx --static-act   # the int8 frozen tower
    python3 bench_torch.py --device cpu --tiny  # a rehearsal at a tiny size

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "img/s/chip", "vs_baseline": null}
``vs_baseline`` is null: the JAX benchmark's baseline is a TPU figure and
does not carry over.  The per-window rates and the card's name and power
limit go to standard error.

What is timed, as in ``bench.py``: the flagship classifier
(``models.factory.flagship``: CLIP ViT-B/16, LoRA rank 4 on q and v, linear
head) in bf16 compute with fp32 master weights, fp32 gradients and fp32
momentum, masked with ``build_mask(..., "lora")``.  A timing window is
``k`` chained SGD steps (lr 1e-3, wd 1e-4, momentum 0.9, nesterov) with one
synchronisation at its end, run as the engine runs a step
(``make_epoch_step``): the window is one ``engine.train.make_epoch_fn``
epoch over the k distinct batches in order, each step a CUDA-graph replay
on the card.  Each step takes its own uint8 batch, already on the device,
and normalizes it there in fp32 before the cast to bf16, inside the step.
Host-to-device transfer is outside the window.  The same windows run
eagerly first (``eager_on_card``) and their rate is printed on an earlier
line.

``ln_fp32=False`` as in ``bench.py``: LayerNorm runs in bf16.  ``bench.py``
also asks for ``softmax_fp32=False``; on the card attention is the flash
kernels (forward, dq, dk/dv), which keep the softmax in fp32 for every
setting.

The int8 cases of ``bench.py`` are arguments: ``--int8`` runs the frozen
tower's GEMMs (in_proj, out_proj, c_fc, c_proj) through the int8 kernel on
the training forward, ``--bwd-dx`` their dx products too, ``--static-act``
quantizes the activations with calibrated per-tensor scales.  As in
``bench.py`` the tree is quantized once from the stored fp32 weights and the
scales are calibrated once (a batch from seed 7, margin 1.5), both outside
the timed windows.  ``--patch-gemm`` computes the patch embedding as one
matrix product.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from typing import List, Tuple

import numpy as np
import torch

from peft_vit_tpu_torch.engine import (
    INT8_CALIB_MARGIN,
    TrainCellState,
    calibrate,
    ce_per_example,
    init_cell_state,
    make_apply_fn,
    make_epoch_fn,
    make_train_step,
)
from peft_vit_tpu_torch.models import cast_frozen_, flagship
from peft_vit_tpu_torch.ops.int8 import quantize_frozen_tree
from peft_vit_tpu_torch.peft import build_mask, split_params
from peft_vit_tpu_torch.utils import resolve_device

# production normalize constants, pre-scaled to the raw-uint8 range
NORM_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32) * 255.0
NORM_STD = np.asarray([0.229, 0.224, 0.225], np.float32) * 255.0
LR, WD = 1e-3, 1e-4
TINY = dict(width=64, layers=2, heads=4, image=32, patch=16, num_classes=10)


def norm_constants(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``NORM_MEAN`` and ``NORM_STD`` on ``device``."""
    return (torch.as_tensor(NORM_MEAN, device=device),
            torch.as_tensor(NORM_STD, device=device))


def normalize(x: torch.Tensor, compute_dtype: torch.dtype, constants=None) -> torch.Tensor:
    """A uint8 batch normalized in fp32 on its device, handed to the model in
    its compute dtype.  ``constants``: ``norm_constants`` already on the
    device (a CUDA graph cannot copy them there)."""
    mean, std = constants or norm_constants(x.device)
    return ((x.to(torch.float32) - mean) / std).to(compute_dtype)


@contextlib.contextmanager
def eager_on_card():
    """Inside the block the engine runs its steps, evals and serving buckets
    eagerly on the card, as it does on the CPU, instead of as CUDA-graph
    replays: the eager side of a comparison."""
    from peft_vit_tpu_torch.engine import serving, train

    saved = train.runs_captured, serving.runs_captured
    train.runs_captured = serving.runs_captured = lambda t: False
    try:
        yield
    finally:
        train.runs_captured, serving.runs_captured = saved


def prepare(model, num_layers: int = 12, int8: bool = False, bwd_dx: bool = False):
    """Apply the LoRA mask to ``model`` and store its frozen tower in the
    compute dtype: ``(trainable, frozen leaves, quantized tree)``.  With
    ``int8`` the tree is quantized from the stored fp32 weights first; the
    order matters, since the cast rounds them."""
    trainable, frozen = split_params(model, build_mask(model, "lora", num_layers=num_layers))
    qtree = quantize_frozen_tree(frozen, bwd_dx=bwd_dx) if int8 else {}
    cast_frozen_(model)
    return trainable, frozen, qtree


def calibration_scales(model, apply_fn, batch: int, image: int, compute_dtype: torch.dtype,
                       device):
    """The static activation scales from one batch drawn from seed 7, as
    ``bench.py`` calibrates: margin 1.5, the weights quantized per call."""
    xc = torch.as_tensor(
        np.random.RandomState(7).randint(0, 256, (batch, image, image, 3), dtype=np.uint8),
        device=device)
    return calibrate(model, apply_fn, {}, normalize(xc, compute_dtype), INT8_CALIB_MARGIN)


def make_step(apply_fn, compute_dtype: torch.dtype = torch.bfloat16, has_bn: bool = False,
              lr: float = LR, wd: float = WD):
    """``step_fn(state, frozen, xs, ys) -> (state, last loss)``: one SGD step
    per leading row of the (K, B, H, W, 3) uint8 chunk ``xs``, each
    normalizing its own batch on the device.  ``lr`` and ``wd`` default to
    the benchmark's."""
    train_step = make_train_step(apply_fn, ce_per_example, has_bn=has_bn)

    def step_fn(state: TrainCellState, frozen, xs: torch.Tensor, ys: torch.Tensor):
        loss = None
        for x, y in zip(xs, ys):
            state, loss = train_step(state, frozen, normalize(x, compute_dtype), y, None, lr, wd)
        return state, loss

    return step_fn


def make_epoch_step(apply_fn, compute_dtype: torch.dtype = torch.bfloat16, has_bn: bool = False,
                    lr: float = LR, wd: float = WD):
    """``step_fn(state, frozen, xs, ys) -> (state, mean loss)`` as the engine
    runs steps: the (K, B, H, W, 3) uint8 chunk ``xs`` is a device-resident
    dataset of K x B rows, and a call is one epoch of ``make_epoch_fn`` over
    it in order, K steps, each gathering its uint8 batch and normalizing it
    inside the step; on the card each a CUDA-graph replay, captured on the
    first call for a chunk (``eager_on_card``: eager)."""
    data = {}

    def step_fn(state: TrainCellState, frozen, xs: torch.Tensor, ys: torch.Tensor):
        k, b = ys.shape
        if data.get("xs") is not xs:
            constants = norm_constants(xs.device)
            apply = lambda variables, bx, train: apply_fn(
                variables, normalize(bx, compute_dtype, constants), train)
            data.update(xs=xs, x=xs.flatten(0, 1), y=ys.flatten(),
                        valid=torch.ones(k * b, dtype=torch.bool, device=xs.device),
                        perm=np.arange(k * b),
                        epoch=make_epoch_fn(apply, ce_per_example, b, has_bn=has_bn))
        return data["epoch"](state, frozen, data["x"], data["y"], data["valid"], data["perm"],
                             lr, wd)

    return step_fn


def measure(step_fn, state, frozen, batch: int, k_chain: int, n_windows: int, warmup: int,
            image: int = 224, num_classes: int = 100, device=None
            ) -> Tuple[List[float], TrainCellState]:
    """Images/s of each of ``n_windows`` timing windows of ``k_chain`` chained
    steps at batch ``batch``, after ``warmup`` untimed windows.  The chunk of
    K distinct uint8 batches is made from a seed and put on the device once,
    outside the windows."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    xs = torch.as_tensor(
        rng.randint(0, 256, (k_chain, batch, image, image, 3), dtype=np.uint8), device=device)
    ys = torch.as_tensor(rng.randint(0, num_classes, (k_chain, batch)), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        state, loss = step_fn(state, frozen, xs, ys)
    sync()
    rates = []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        state, loss = step_fn(state, frozen, xs, ys)
        sync()
        rates.append(batch * k_chain / (time.perf_counter() - t0))
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"the loss is not finite: {float(loss)}")
    return rates, state


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="default: the card; 'cpu' to rehearse")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--k-chain", type=int, default=8, help="chained steps per window")
    parser.add_argument("--windows", type=int, default=7)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--tiny", action="store_true",
                        help="a 2-layer, 64-wide model at 32 px (rehearsal only)")
    parser.add_argument("--int8", action="store_true",
                        help="the frozen tower's GEMMs int8 on the training forward")
    parser.add_argument("--bwd-dx", action="store_true",
                        help="with --int8: their dx products int8 too")
    parser.add_argument("--static-act", action="store_true",
                        help="with --int8: calibrated per-tensor activation scales")
    parser.add_argument("--patch-gemm", action="store_true",
                        help="the patch embedding as one matrix product")
    args = parser.parse_args(argv)
    if (args.bwd_dx or args.static_act) and not args.int8:
        parser.error("--bwd-dx and --static-act need --int8")

    device = resolve_device(args.device)
    shape = TINY if args.tiny else {}
    image = shape.get("image", 224)
    model = flagship(**shape, dtype=torch.bfloat16, ln_fp32=False, int8_train=args.int8,
                     patch_gemm=args.patch_gemm, device=device)
    trainable, _, frozen = prepare(model, int8=args.int8, bwd_dx=args.bwd_dx)
    apply_fn = make_apply_fn(model)
    if args.static_act:
        frozen.update(calibration_scales(model, apply_fn, args.batch, image, torch.bfloat16,
                                         device))
    where = card() if device.type == "cuda" else "cpu (a rehearsal, not a device number)"
    case = (f"B={args.batch} k={args.k_chain} bf16 int8={args.int8} dx={args.bwd_dx} "
            f"static={args.static_act} patch_gemm={args.patch_gemm}")
    for capture in (False, True):
        with contextlib.nullcontext() if capture else eager_on_card():
            rates, _ = measure(
                make_epoch_step(apply_fn), init_cell_state(trainable), frozen,
                args.batch, args.k_chain, args.windows, args.warmup, image=image,
                num_classes=shape.get("num_classes", 100), device=device,
            )
        print(f"# {'captured' if capture else 'eager'} step, case {case}: median "
              f"{statistics.median(rates):.1f} img/s; per window "
              + " ".join(f"{r:.1f}" for r in rates) + f"; {where}", file=sys.stderr, flush=True)
    # a CPU or tiny-model run is a rehearsal and never carries the device metric's name
    real = device.type == "cuda" and not args.tiny
    print(json.dumps({
        "metric": "vitb16_lora_train_throughput" if real else "rehearsal_train_throughput",
        "value": round(statistics.median(rates), 1),
        "unit": "img/s/chip" if real else f"img/s ({device.type}, not a device number)",
        "vs_baseline": None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
