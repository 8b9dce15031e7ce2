"""Per-kernel device profile of a train or eval step (counterpart of
``peft_vit_tpu/commands/profile.py``).

Builds the configured model, runs a few real dispatches of ``k_chain``
steps on the card, traces them with ``torch.profiler`` and prints the
device time by category and kernel with the achieved rates
(``utils.xprof``)::

    python -m peft_vit_tpu_torch.commands.profile --cfg experiments/vit.yaml --method lora --batch 16
    python -m peft_vit_tpu_torch.commands.profile --mode eval --batch 64
    python -m peft_vit_tpu_torch.commands.profile --trace output/profile/trace.json   # parse only

The trace (``--logdir``/trace.json) stays for a timeline viewer
(chrome://tracing, Perfetto).  On the CPU the same steps run and the trace
holds host events only (``main(argv, device="cpu")``).
"""

from __future__ import annotations

import argparse
import logging
import subprocess
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import resolve_device

logger = logging.getLogger(__name__)


class ProfiledSteps:
    """``k_chain`` train (or eval) steps a call, as the engine runs them: on
    the card each a ``StepGraph`` replay of ``engine.train.make_epoch_fn``'s
    step (``make_eval_fn``'s batch), over a device-resident chunk of
    ``k_chain`` uint8 batches normalized inside the step; eagerly on the CPU.
    A call returns the steps' mean loss (eval: the logits' sum).  The train
    state carries over from call to call."""

    def __init__(self, cfg, method: str, batch: int, mode: str, k_chain: int, device=None):
        from ..engine.train import (calibrate, ce_per_example, init_cell_state, make_apply_fn,
                                    make_epoch_fn, make_eval_fn)
        from ..models.factory import build_image_classifier, compute_dtype
        from ..models.layers import cast_frozen_
        from ..ops.int8 import INT8_TARGET_MODULES, quantize_frozen_tree
        from ..peft import build_mask, spec_from_config, split_params

        device = resolve_device(device)
        self.mode, self.k_chain, self.batch = mode, int(k_chain), int(batch)
        num_classes = int(cfg.MODEL.NUM_CLASSES) or int(cfg.DATASET.NUM_CLASSES) or 100
        model, _, _ = build_image_classifier(cfg, spec_from_config(cfg), max(num_classes, 2),
                                             device=device)
        num_layers = getattr(model.backbone, "layers", 12)
        mask = build_mask(model, method if method != "none" else "full", num_layers=num_layers)
        trainable, frozen = split_params(model, mask)
        tpu = cfg.TPU
        # the Trainer's int8 wiring: the frozen tower quantized once a run
        # (with the transposed codes of the int8 dx), from the stored weights
        # before the cast; the static scales calibrated once
        if mode == "train" and bool(tpu.get("INT8_FWD_TRAIN", False)):
            frozen = {**frozen, **quantize_frozen_tree(
                frozen, targets=tuple(tpu.get("INT8_TARGETS", INT8_TARGET_MODULES)),
                bwd_dx=bool(tpu.get("INT8_BWD_DX", False)))}
        cast_frozen_(model)
        apply_fn = make_apply_fn(model)
        compute = compute_dtype(cfg, device)
        size = int(cfg.TRAIN.IMAGE_SIZE[0])
        rng = np.random.RandomState(0)
        xs = torch.as_tensor(rng.randint(0, 256, (k_chain * batch, size, size, 3),
                                         dtype=np.uint8), device=device)
        ys = torch.as_tensor(rng.randint(0, max(num_classes, 2), k_chain * batch), device=device)
        mean = torch.as_tensor(cfg.INPUT.MEAN, dtype=torch.float32, device=device) * 255.0
        std = torch.as_tensor(cfg.INPUT.STD, dtype=torch.float32, device=device) * 255.0

        def normalized(bx):
            return ((bx.to(torch.float32) - mean) / std).to(compute)

        def apply(variables, bx, train):
            return apply_fn(variables, normalized(bx), train)

        if mode == "train" and bool(tpu.get("INT8_STATIC_ACT", False)):
            frozen.update(calibrate(model, apply_fn, {**frozen, **trainable},
                                    normalized(xs[:batch]),
                                    float(tpu.get("INT8_CALIB_MARGIN", 1.5))))
        self.has_bn = any(k.rsplit(".", 1)[-1] in ("bn_mean", "bn_var")
                          for k, _ in model.named_buffers())
        bn = {k: v for k, v in model.named_buffers()
              if k.rsplit(".", 1)[-1] in ("bn_mean", "bn_var")} if self.has_bn else None
        self.frozen, self.xs, self.ys = frozen, xs, ys
        self.valid = torch.ones(k_chain * batch, dtype=torch.bool, device=device)
        self.perm = np.arange(k_chain * batch)
        self.apply = apply
        self.state = init_cell_state(trainable, bn)
        if mode == "train":
            self.epoch = make_epoch_fn(apply, ce_per_example, batch, has_bn=self.has_bn)
        else:
            self.eval = make_eval_fn(apply, batch, has_bn=self.has_bn)

    def __call__(self) -> torch.Tensor:
        if self.mode == "eval":
            return self.eval(self.state.trainable, self.frozen, self.xs, self.state.bn).float().sum()
        self.state, loss = self.epoch(self.state, self.frozen, self.xs, self.ys, self.valid,
                                      self.perm, 1e-3, 1e-4)
        return loss

    def costs(self) -> Dict[str, Tuple[float, float]]:
        """``utils.xprof.op_costs`` of one call: one eager step (or eval
        batch) counted, times ``k_chain``; the state does not move."""
        from ..engine.train import ce_per_example, make_train_step
        from ..utils.xprof import op_costs

        bx, by = self.xs[: self.batch], self.ys[: self.batch]
        if self.mode == "eval":
            def one():
                with torch.no_grad():
                    merged = {**self.frozen, **self.state.trainable, **(self.state.bn or {})}
                    return self.apply(merged, bx, False)
        else:
            step = make_train_step(self.apply, ce_per_example, has_bn=self.has_bn)

            def one():
                return step(self.state, self.frozen, bx, by, None, 1e-3, 1e-4)
        return {k: (f * self.k_chain, b * self.k_chain) for k, (f, b) in op_costs(one).items()}


def build_step(cfg, method: str, batch: int, mode: str, k_chain: int,
               device=None) -> ProfiledSteps:
    """A callable running ``k_chain`` train (or eval) steps a dispatch on the
    configured model (``ProfiledSteps``)."""
    return ProfiledSteps(cfg, method, batch, mode, k_chain, device)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them ("" when
    it cannot be asked)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0]


def main(argv=None, *, device=None):
    from ..config import get_default_config
    from ..utils.xprof import capture_trace, format_op_profile, parse_op_profile

    p = argparse.ArgumentParser(description="per-kernel profile of a train/eval step "
                                            "(PyTorch port)")
    p.add_argument("--cfg", default=None)
    p.add_argument("--method", default="lora")
    p.add_argument("--mode", choices=["train", "eval"], default="train")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--k-chain", type=int, default=8,
                   help="steps per dispatch (amortizes dispatch latency)")
    p.add_argument("--steps", type=int, default=3, help="traced dispatches")
    p.add_argument("--logdir", default="output/profile")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--trace", default=None,
                   help="parse an existing trace.json instead of tracing")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    costs = None
    trace = args.trace
    if trace is None:
        cfg = get_default_config()
        if args.cfg:
            cfg.merge_from_file(args.cfg)
        if args.opts:
            cfg.merge_from_list(args.opts)
        cfg.freeze()
        step = build_step(cfg, args.method, args.batch, args.mode, args.k_chain, device=device)
        costs = {k: (f * args.steps, b * args.steps) for k, (f, b) in step.costs().items()}
        trace = capture_trace(step, args.logdir, steps=args.steps)
        print(f"trace: {trace}")
    profile = parse_op_profile(trace, costs, top=args.top)
    print(format_op_profile(profile, top=args.top, card=card_line()))
    return profile


if __name__ == "__main__":
    main()
