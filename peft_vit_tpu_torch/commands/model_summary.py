"""Model summary (counterpart of ``peft_vit_tpu/commands/model_summary.py``).

``python -m peft_vit_tpu_torch.commands.model_summary --cfg experiments/vit.yaml
[--method lora] [--scaling [STEP_MS]]`` prints the per-leaf parameter table
(shape, count, trainable / frozen), the trainable fraction, and the FLOPs of
one forward and of one train step's gradient at batch 1 (``utils.summary``:
the products of every matrix product, convolution and kernel launch, counted
as they run; on the CPU through the card's attention route,
``ops.attention.card_route``, so that both devices count the card's
program).  ``--scaling`` appends the predicted multi-card table
(``utils.scaling``) for a measured single-card step time.
"""

from __future__ import annotations

import argparse
import logging
from typing import Tuple

import torch

from ..utils import resolve_device

logger = logging.getLogger(__name__)


def summarize(cfg, method: str, device=None) -> Tuple[str, dict, dict, int, dict]:
    """``(text, named parameters, mask, layers, flops)``: the table, the
    forward FLOPs and the train step's gradient FLOPs (B = 1, ``flops``
    ``{"forward", "grad"}``) of ``cfg``'s model under ``method``'s mask,
    built on ``device`` (None: the card)."""
    from ..engine.train import ce_per_example, make_apply_fn
    from ..models.factory import build_image_classifier
    from ..ops.attention import card_route
    from ..peft import build_mask, merge_params, spec_from_config, split_params
    from ..utils.summary import flops_of, param_summary

    device = resolve_device(device)
    spec = spec_from_config(cfg)
    num_classes = int(cfg.MODEL.NUM_CLASSES) or int(cfg.DATASET.NUM_CLASSES)
    model, _, _ = build_image_classifier(cfg, spec, max(num_classes, 2), device=device)
    params = dict(model.named_parameters())
    num_layers = getattr(model.backbone, "layers", 12)
    mask = build_mask(model, method if method != "none" else "full", num_layers=num_layers)
    lines = [param_summary(params, mask)]

    size = int(cfg.TRAIN.IMAGE_SIZE[0])
    x = torch.zeros((1, size, size, 3), device=device)
    y = torch.zeros((1,), dtype=torch.long, device=device)
    trainable, frozen = split_params(model, mask)
    apply_fn = make_apply_fn(model)

    def forward(p, xx):
        with torch.no_grad():
            return apply_fn(p, xx, False)

    def grad(t, xx, yy):
        t = {k: v.detach().requires_grad_() for k, v in t.items()}
        logits = apply_fn(merge_params(t, frozen), xx, True)
        loss = ce_per_example(logits.to(torch.float32), yy).mean()
        return torch.autograd.grad(loss, list(t.values()), allow_unused=True)

    with card_route():
        fwd_flops = flops_of(forward, params, x)
        grad_flops = flops_of(grad, trainable, x, y)
    lines.append(f"forward FLOPs (B=1, {size}x{size}): {fwd_flops:.4g}")
    lines.append(f"train-step grad FLOPs (B=1): {grad_flops:.4g} "
                 f"({grad_flops / max(fwd_flops, 1): .2f}x forward; frozen-weight dW GEMMs are "
                 "never built)")
    return "\n".join(lines), params, mask, num_layers, {"forward": fwd_flops, "grad": grad_flops}


def scaling_report(cfg, params, mask, num_layers: int, step_ms: float, batch: int) -> str:
    """The predicted multi-card scaling of this config's trainable set
    (``utils.scaling``; weak scaling against the measured step time)."""
    from ..utils.scaling import profile_from_params, scaling_table

    size = int(cfg.TRAIN.IMAGE_SIZE[0])
    patch = int(getattr(cfg.MODEL.SPEC.VISION, "PATCH_SIZE", 16) or 16)
    prof = profile_from_params(params, mask, step_time_s=step_ms * 1e-3, per_chip_batch=batch,
                               seq_len=(size // patch) ** 2 + 1, layers=num_layers)
    return ("PREDICTED multi-card scaling (weak scaling, ring collectives over H100 NVLink, "
            "450 GB/s each way):\n" + scaling_table(prof))


def main(argv=None, *, device=None):
    from ..config import get_default_config

    p = argparse.ArgumentParser(description="model summary + FLOPs (PyTorch port)")
    p.add_argument("--cfg", default=None)
    p.add_argument("--method", default="full")
    p.add_argument("--scaling", type=float, default=None, metavar="STEP_MS",
                   help="append the predicted multi-card scaling table for this measured "
                        "single-card ms/step")
    p.add_argument("--batch", type=int, default=16, help="per-card batch for --scaling")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cfg = get_default_config()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    out, params, mask, num_layers, _ = summarize(cfg, args.method, device=device)
    if args.scaling is not None:
        out += "\n\n" + scaling_report(cfg, params, mask, num_layers, args.scaling, args.batch)
    print(out)
    return out


if __name__ == "__main__":
    main()
