"""CLIP contrastive pre-training through the port (counterpart of
``peft_vit_tpu/commands/train_clip.py``; the reference's
full_shot/main/tools/train_clip.py:76+ driving lib/core/function_clip.py
with the clip_openai.py model, :380-552).

    python -m peft_vit_tpu_torch.commands.train_clip --cfg MODEL.yaml \\
        DATASET.TRAIN_TSV_LIST "['pairs.tsv']" MODEL.SPEC.GATHER_TENSORS True

on the card unless the caller asks for the CPU (``device="cpu"``); over
several processes (``torchrun``, or ``utils.dist.init_distributed`` before
the call) each process takes its rows of every global batch and the loss is
the global batch's (``engine.contrastive.make_clip_train_step``).  Pair TSVs
are ``key<TAB>base64(image)<TAB>caption`` rows; with no TSV configured a
deterministic synthetic pair set is used.
"""

from __future__ import annotations

import argparse
import base64
import io
import logging
import os
import time
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import get_default_config
from ..data.tokenizer import tokenize
from ..data.transforms import resize_center_crop
from ..engine.checkpoint import save_checkpoint
from ..engine.contrastive import clip_opt_state, make_clip_train_step
from ..engine.optim import build_lr_schedule, build_optimizer
from ..models import load_jax_variables
from ..models.clip import clip_from_config
from ..parallel import batch_rows, mesh_from_config
from ..peft import spec_from_config
from ..utils import dist, resolve_device
from ..utils.logging import create_logger, final_result_line

logger = logging.getLogger(__name__)


def load_pairs(cfg) -> Tuple[np.ndarray, List[str]]:
    """(images_u8 (N, S, S, 3), captions) from the pair TSVs, or a synthetic
    learnable pair set when none is configured."""
    size = int(cfg.TRAIN.IMAGE_SIZE[0])
    tsv_list = cfg.DATASET.TRAIN_TSV_LIST
    if tsv_list:
        from PIL import Image

        xs, caps = [], []
        root = cfg.DATASET.ROOT
        for p in tsv_list:
            path = os.path.join(root, p) if root else p
            with open(path) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) < 3:
                        continue
                    img = Image.open(io.BytesIO(base64.b64decode(parts[1])))
                    xs.append(resize_center_crop(img, size))
                    caps.append(parts[2])
        return np.stack(xs), caps
    from ..data.registry import synthetic_dataset

    n_cls = int(cfg.DATASET.NUM_CLASSES) or 8
    x, y = synthetic_dataset(n_cls, 16, size, seed=0)
    caps = [f"a photo of a thing number {int(c)}" for c in y]
    return x, caps


def train_clip_main(cfg, *, device=None, variables: Optional[Mapping] = None) -> float:
    """Train CLIP on ``cfg``'s pairs; returns the last loss read.  The
    global batch is ``TRAIN.BATCH_SIZE_PER_GPU`` times the group's size,
    each epoch's order ``RandomState(0)``'s permutation, as in the JAX
    command; the main process alone writes ``OUTPUT_DIR/clip_checkpoints``.
    ``variables`` (the JAX package's CLIP variables tree) replaces the built
    weights: the seam through which a test hands over the JAX weights."""
    device = resolve_device(device)
    spec = spec_from_config(cfg)
    torch.manual_seed(int(cfg.DATASET.RANDOM_SEED_SAMPLING))  # the built weights' draws
    model = clip_from_config(cfg, spec, device=device)
    if variables is not None:
        load_jax_variables(model, variables)
    x_u8, caps = load_pairs(cfg)
    mean = np.asarray(cfg.INPUT.MEAN, np.float32) * 255.0
    std = np.asarray(cfg.INPUT.STD, np.float32) * 255.0
    x = torch.from_numpy((x_u8.astype(np.float32) - mean) / std).to(device)
    ctx = int(cfg.MODEL.SPEC.TEXT.CONTEXT_LENGTH)
    tokens = torch.from_numpy(tokenize(caps, ctx).astype(np.int64)).to(device)
    n = len(x)
    logger.info("=> %d image-text pairs", n)

    mesh = mesh_from_config(cfg) if dist.group_initialized() else None
    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU) * dist.world_size()
    rows = batch_rows(mesh, batch) if mesh is not None else slice(0, batch)
    steps_per_epoch = max(n // batch, 1)
    params = {k: v.detach() for k, v in model.named_parameters()}
    schedule = build_lr_schedule(cfg, steps_per_epoch)
    tx = build_optimizer(cfg, params, steps_per_epoch, schedule)
    gather = bool(cfg.MODEL.SPEC.get("GATHER_TENSORS", False))
    step = make_clip_train_step(model, tx, mesh=mesh, gather=gather)
    opt_state = clip_opt_state(tx, params)

    rng = np.random.RandomState(0)
    loss_v = float("nan")
    for epoch in range(int(cfg.TRAIN.BEGIN_EPOCH), int(cfg.TRAIN.END_EPOCH)):
        perm = rng.permutation(n)
        t0 = time.time()
        losses = []
        for i in range(steps_per_epoch):
            j = perm[i * batch: (i + 1) * batch]
            if len(j) < batch:
                break
            idx = torch.as_tensor(j[rows], device=device)
            params, opt_state, loss = step(params, opt_state, x[idx], tokens[idx])
            if (i + 1) % int(cfg.PRINT_FREQ) == 0 or i == 0:
                loss_v = float(loss)  # a host fetch: the sync
                losses.append(loss_v)
                if not np.isfinite(loss_v):
                    raise FloatingPointError(f"NaN loss at epoch {epoch} step {i}")
        dt = time.time() - t0
        logger.info("=> Epoch %d: loss %.4f (%.1f pairs/s)", epoch,
                    float(np.mean(losses)) if losses else float("nan"),
                    steps_per_epoch * batch / max(dt, 1e-9))
        if cfg.OUTPUT_DIR and dist.is_main_process():
            save_checkpoint(os.path.join(cfg.OUTPUT_DIR, "clip_checkpoints"), epoch,
                            {"params": params, "epoch": epoch})
    final_result_line("clip_loss", loss_v)
    return loss_v


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser(description="CLIP pre-training (PyTorch port)")
    parser.add_argument("--cfg", required=False, default=None)
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = get_default_config()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
        cfg.NAME = cfg.NAME or os.path.splitext(os.path.basename(args.cfg))[0]
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.NAME = cfg.NAME or "train_clip"
    dist.init_distributed(device=device)
    cfg.RANK = dist.rank()
    create_logger(cfg, "train_clip")
    cfg.freeze()
    return train_clip_main(cfg, device=device)


if __name__ == "__main__":
    main()
