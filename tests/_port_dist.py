"""Gloo process groups for the port's data-parallel tests: ``spawn(fn, world,
tmp_path, *args)`` runs ``fn(rank, *args)`` in ``world`` spawned CPU
processes that have joined one group (a file rendezvous under ``tmp_path``:
no port, so concurrent test workers cannot collide; one torch thread each)
and returns each rank's result.  This module imports torch and the port
only, so that the spawned processes do not import JAX; the functions they
run live here."""

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.engine import ce_per_example, init_cell_state, make_apply_fn
from peft_vit_tpu_torch.engine.contrastive import clip_opt_state, make_clip_train_step
from peft_vit_tpu_torch.engine.optim import build_optimizer
from peft_vit_tpu_torch.models import flagship, load_jax_variables
from peft_vit_tpu_torch.models.clip import clip_from_config
from peft_vit_tpu_torch.parallel import (
    allgather_ragged,
    gather_features,
    host_allgather,
    make_mesh,
    make_sharded_eval_step,
    make_sharded_train_step,
    psum_mean,
    reduce_mean_metrics,
    shard_batch,
)
from peft_vit_tpu_torch.parallel.collectives import all_gather_dim
from peft_vit_tpu_torch.peft import build_mask, spec_from_config, split_params
from peft_vit_tpu_torch.utils import dist as port_dist

#: the tiny LoRA flagship of the sharded-step tests; 5 classes, so that the
#: head's bias has no dim that splits over 2 processes (ZeRO-1 keeps it whole)
TINY_DP = dict(width=64, layers=2, heads=4, image=32, patch=16, num_classes=5)
SPAWN_TIMEOUT_S = 150


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    port_dist.init_distributed(init_method=f"file://{tmp}/rendezvous", num_processes=world,
                               process_id=rank, device="cpu")
    try:
        torch.save(fn(rank, *args), os.path.join(tmp, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args):
    """``[fn(rank, *args) for rank in range(world)]``, each in its own process
    of one gloo group."""
    tmp = str(tmp_path)
    ctx = mp.start_processes(_entry, args=(fn, world, tmp, args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} spawned processes still ran after {SPAWN_TIMEOUT_S} s")
    return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
            for r in range(world)]


def tiny_lora(variables):
    """The port's tiny fp32 LoRA flagship on ``variables`` (the JAX tree),
    its trainable leaves and frozen remainder (the module's own)."""
    model = flagship(**TINY_DP, dtype=torch.float32, device="cpu")
    load_jax_variables(model, variables)
    mask = build_mask(model, "lora", num_layers=TINY_DP["layers"])
    trainable, _ = split_params(model, mask)
    return model, trainable


def sharded_steps(rank, variables, x, y, lr, wd, steps):
    """Two ``steps``-step runs of the sharded train step (replicated, then
    ZeRO-1) on this rank's rows of (x, y), and the eval step's logits of the
    rows, gathered."""
    model, trainable = tiny_lora(variables)
    mesh = make_mesh()
    apply_fn = make_apply_fn(model)
    xs, ys = shard_batch(mesh, torch.from_numpy(x)), shard_batch(mesh, torch.from_numpy(y))
    out = {"mesh": tuple(mesh)}
    for zero1 in (False, True):
        step, place = make_sharded_train_step(apply_fn, ce_per_example, mesh, zero1=zero1)
        state, frozen = place(init_cell_state(trainable), {})
        out[f"momentum_shapes_{zero1}"] = {k: tuple(v.shape) for k, v in state.momentum.items()}
        losses = []
        for _ in range(steps):
            state, loss = step(state, frozen, xs, ys, lr, wd)
            losses.append(float(loss))
        out[f"trainable_{zero1}"] = {k: v.numpy() for k, v in state.trainable.items()}
        out[f"losses_{zero1}"] = losses
    ev = make_sharded_eval_step(apply_fn, mesh)
    out["logits"] = all_gather_dim(ev(trainable, {}, xs), 0).numpy()
    return out


def collectives(rank, feats, ragged_lengths, img, txt, scale):
    """``gather_features`` forward and gradient on this rank's rows of
    ``feats`` (JAX's test_gather_features_grad: every output row carries
    sum_j x_j^2), ``psum_mean``, ``reduce_mean_metrics``, ``host_allgather``
    and ``allgather_ragged`` of shards of ``ragged_lengths[rank]`` rows, and
    the gathered CLIP loss (``clip_contrastive_step_fn(gather=True)``) of
    this rank's rows of the features ``img``, ``txt`` with its gradients."""
    from peft_vit_tpu_torch.engine.contrastive import clip_contrastive_step_fn

    mesh = make_mesh()
    fi = shard_batch(mesh, torch.from_numpy(img)).requires_grad_()
    ft = shard_batch(mesh, torch.from_numpy(txt)).requires_grad_()
    loss_fn = clip_contrastive_step_fn(lambda p, x: x, lambda p, x: x, gather=True)
    clip_loss = loss_fn(None, fi, ft, torch.tensor(scale))
    clip_grads = torch.autograd.grad(clip_loss, (fi, ft))
    xs = shard_batch(mesh, torch.from_numpy(feats)).requires_grad_()
    g = gather_features(xs)
    local = (g ** 2).sum() * torch.ones_like(xs)
    (grad,) = torch.autograd.grad(local.sum(), xs)
    start = sum(ragged_lengths[:rank])
    shard = np.arange(start, start + ragged_lengths[rank], dtype=np.float32)[:, None] * [1, -1]
    return {
        "gathered": g.detach().numpy(), "grad": grad.numpy(),
        "psum_mean": float(psum_mean(torch.tensor(float(rank + 1)))),
        "metrics": {k: float(v) for k, v in reduce_mean_metrics(
            {"a": torch.tensor(float(rank)), "b": torch.tensor(2.0 * rank + 1)}).items()},
        "host": host_allgather(np.full((2,), rank, np.int64)),
        "ragged": allgather_ragged(shard),
        "clip_loss": float(clip_loss), "clip_grads": [g.numpy() for g in clip_grads],
    }


def tiny_clip_cfg(pkg, **over):
    """The tiny CLIP of the JAX package's tests/test_train_clip.py (width 32,
    2 layers and 2 heads a tower, 16 px, context 16), synthetic 4-way pairs,
    in fp32 (the JAX ``clip_from_config`` takes ``TPU.COMPUTE_DTYPE``'s bf16
    on the CPU too, the port fp32 there), ``pkg`` either package's
    ``config``; ``over`` maps dotted keys to values."""
    cfg = pkg.get_default_config()
    base = {
        "DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 4, "TRAIN.IMAGE_SIZE": [16, 16],
        "TRAIN.BATCH_SIZE_PER_GPU": 8, "TRAIN.BEGIN_EPOCH": 0, "TRAIN.END_EPOCH": 3,
        "TRAIN.LR": 0.005, "TRAIN.OPTIMIZER": "adamW", "TRAIN.LR_SCHEDULER.METHOD": "constant",
        "PRINT_FREQ": 1, "OUTPUT_DIR": "", "MODEL.NAME": "clip_tiny", "MODEL.SPEC.EMBED_DIM": 32,
        "MODEL.SPEC.GATHER_TENSORS": False, "MODEL.SPEC.VISION.PATCH_SIZE": 8,
        "MODEL.SPEC.VISION.WIDTH": 32, "MODEL.SPEC.VISION.LAYERS": 2,
        "MODEL.SPEC.VISION.HEADS": 2, "MODEL.SPEC.TEXT.WIDTH": 32, "MODEL.SPEC.TEXT.LAYERS": 2,
        "MODEL.SPEC.TEXT.HEADS": 2, "MODEL.SPEC.TEXT.CONTEXT_LENGTH": 16, "PEFT.METHOD": "full",
        "TPU.FLASH_ATTENTION": False, "TPU.COMPUTE_DTYPE": "float32"}
    for key, value in {**base, **over}.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


def clip_steps(rank, over, variables, images, tokens, steps):
    """``steps`` CLIP pre-training steps of ``make_clip_train_step`` over the
    group (this rank's rows of the global batch) from ``variables``, with
    GATHER_TENSORS on and off: each step's loss and the parameters after
    them, by the flag."""
    cfg = tiny_clip_cfg(port_config, **over)
    mesh = make_mesh()
    xs = shard_batch(mesh, torch.from_numpy(images))
    ts = shard_batch(mesh, torch.from_numpy(tokens))
    out = {}
    for gather in (True, False):
        model = clip_from_config(cfg, spec_from_config(cfg), device="cpu")
        load_jax_variables(model, variables)
        params = {k: v.detach() for k, v in model.named_parameters()}
        tx = build_optimizer(cfg, params, 4)
        step = make_clip_train_step(model, tx, mesh=mesh, gather=gather)
        opt = clip_opt_state(tx, params)
        losses = []
        for _ in range(steps):
            params, opt, loss = step(params, opt, xs, ts)
            losses.append(float(loss))
        out[gather] = {"losses": losses,
                       "params": {k: v.detach().numpy().copy() for k, v in params.items()}}
    return out
