"""Export a (PEFT-tuned) classifier as a portable serving artifact
(counterpart of ``peft_vit_tpu/commands/export_model.py``).

``python -m peft_vit_tpu_torch.commands.export_model --cfg experiments/vit.yaml
--method lora --checkpoint output/ds/name/checkpoints --output model.pt2``

Builds the model from the config (grafting ``MODEL.PRETRAINED``), restores
the trained PEFT subtree from the port's checkpoint directory
(``engine.checkpoint``) when one is given, and writes the eval forward as a
batch-polymorphic ``torch.export`` artifact (``engine.serving.export_classifier``).
``--platforms cuda`` (the default on the card) or ``cpu`` picks the device
it is traced on; ``--check`` reloads the artifact and holds its logits to
the live model's (max |err| <= 1e-4, the JAX command's bound).
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from ..utils import resolve_device

logger = logging.getLogger(__name__)

CHECK_TOL = 1e-4  # the JAX command's bound on the reloaded artifact's logits


def export_main(cfg, method: str, output: str, checkpoint: str = "", platforms: str = "",
                check: bool = False, device=None) -> bytes:
    """Build, graft, export (and with ``check`` reload and compare); returns
    the artifact's bytes.  ``device``: None is the card; ``platforms`` (a
    comma list) defaults to it."""
    from ..engine.checkpoint import restore_checkpoint
    from ..engine.serving import export_classifier, load_exported, make_infer_fn
    from ..models.factory import build_image_classifier
    from ..peft import build_mask, spec_from_config

    device = resolve_device(device)
    spec = spec_from_config(cfg)
    # DATASET.NUM_CLASSES (the trained head) wins over MODEL.NUM_CLASSES, as
    # commands/train.py sizes the head
    num_classes = int(cfg.DATASET.NUM_CLASSES) or int(cfg.MODEL.NUM_CLASSES)
    model, _, _ = build_image_classifier(cfg, spec, max(num_classes, 2), device=device)
    if checkpoint:
        num_layers = getattr(model.backbone, "layers", 12)
        mask = build_mask(model, method if method != "none" else "full", num_layers=num_layers)
        named = dict(model.named_parameters())
        trainable = {k: v for k, v in named.items() if mask[k]}
        restored = restore_checkpoint(checkpoint, {"trainable": trainable})
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint!r}")
        with torch.no_grad():
            for k, v in restored["trainable"].items():
                named[k].copy_(v)
        logger.info("=> grafted trained %s subtree from %s", method, checkpoint)

    size = int(cfg.TRAIN.IMAGE_SIZE[0])
    plats = [p.strip() for p in platforms.split(",") if p.strip()] or [device.type]
    data = export_classifier(model, None, size, path=output, platforms=plats)
    if check:
        served = load_exported(output, device=plats[0])
        x = torch.from_numpy(np.random.RandomState(0).randn(2, size, size, 3).astype(np.float32))
        live = make_infer_fn(model)
        want = live(x.to(next(model.parameters()).device)).to("cpu", torch.float32)
        got = served(x).to("cpu")
        err = float((got - want).abs().max())
        logger.info("=> roundtrip max |err| %.3g", err)
        if err > CHECK_TOL:
            raise AssertionError(f"exported artifact mismatch: {err}")
        print(f"export check OK (max err {err:.3g})")
    return data


def main(argv=None, *, device=None):
    from ..config import get_default_config

    p = argparse.ArgumentParser(description="export serving artifact (PyTorch port)")
    p.add_argument("--cfg", default=None)
    p.add_argument("--method", default="full")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint directory with the trained subtree")
    p.add_argument("--output", required=True)
    p.add_argument("--platforms", default="",
                   help="cpu or cuda (default: the device it runs on)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and compare logits")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    cfg = get_default_config()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    return export_main(cfg, args.method, args.output, checkpoint=args.checkpoint,
                       platforms=args.platforms, check=args.check, device=device)


if __name__ == "__main__":
    main()
