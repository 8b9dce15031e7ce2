"""Gloo process groups for the port's data- and tensor-parallel tests:
``spawn(fn, world, tmp_path, *args)`` runs ``fn(rank, *args)`` in ``world``
spawned CPU processes that have joined one group (a file rendezvous under
``tmp_path``: no port, so concurrent test workers cannot collide; one torch
thread each) and returns each rank's result.  This module imports torch and
the port only, so that the spawned processes do not import JAX; the
functions they run live here."""

import faulthandler
import os
import time

import numpy as np
import torch
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
    faulthandler.enable()  # a crash in a spawned process prints its stack
    torch.set_num_threads(1)
    port_dist.init_distributed(init_method=f"file://{tmp}/rendezvous", num_processes=world,
                               process_id=rank, device="cpu")
    try:
        torch.save(fn(rank, *args), os.path.join(tmp, f"result{rank}.pt"))
    finally:
        port_dist.destroy_distributed()


def spawn(fn, world: int, tmp_path, *args):
    """``[fn(rank, *args) for rank in range(world)]``, each in its own process
    of one gloo group."""
    return spawn_start(fn, world, tmp_path, *args)()


def spawn_start(fn, world: int, tmp_path, *args):
    """``spawn`` without the wait: the processes start, and the function
    returned waits for them and returns their results, so that the caller
    works meanwhile."""
    tmp = str(tmp_path)
    ctx = mp.start_processes(_entry, args=(fn, world, tmp, args), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S

    def results():
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} spawned processes still ran after "
                                   f"{SPAWN_TIMEOUT_S} s")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(world)]

    return results


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


def set_keys(cfg, over: dict):
    """``cfg`` with the dotted keys of ``over`` set."""
    for key, value in over.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


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
    return set_keys(cfg, {**base, **over})


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


# -- the multi-process Trainer (tests/test_torch_port_trainer_dist.py) ----------

#: the global batch of the Trainer runs, 4 rows a rank over 2 processes
TRAINER_BATCH = 8
TRAINER_STEPS = 8  # a step per 8 of the 64 synthetic images
#: the tiny ResNet with BN of the Trainer runs, and the DropBlock one
RN_BN = dict(layers=(1, 1, 1, 1), width=8)
RN_DROPBLOCK = dict(RN_BN, dropblock_stages=(3, 4), dropblock_keep_prob=0.8,
                    dropblock_block_size=3)
#: the full fine-tune of the timm ViT: adamW with the gradient-norm clip
VIT_FULL = {"TRAIN.OPTIMIZER": "adamw", "TRAIN.WD": 0.05, "TRAIN.LR": 1e-3,
            "TRAIN.CLIP_GRAD_NORM": 0.5}
#: the ResNet runs: SGD at the rate two train-mode BN runs stay together at
RN_SGD = {"TRAIN.IMAGE_SIZE": [64, 64], "TRAIN.WD": 1e-4, "TRAIN.MOMENTUM": 0.9,
          "TRAIN.LR": 1e-5, "TRAIN.END_EPOCH": 1}
INT8_STATIC = {"TPU.INT8_FWD_TRAIN": True, "TPU.INT8_STATIC_ACT": True,
               "TPU.INT8_BWD_DX": True}
#: every draw of the step on: the uint8 flip inside the timm augmentation
#: (RandAugment, the pixel erase), mixup / cutmix, under ZeRO-1
DRAWS = {"AUG.TIMM_AUG.USE_TRANSFORM": True, "AUG.TIMM_AUG.RE_PROB": 0.5,
         "AUG.MIXUP": 0.8, "AUG.MIXCUT": 1.0, "TPU.ZERO1": True}
RN_DRAWS = {**RN_SGD, "AUG.DROPBLOCK_KEEP_PROB": 0.8, "AUG.DROPBLOCK_LAYERS": [3, 4],
            "AUG.DROPBLOCK_BLOCK_SIZE": 3, "TPU.ZERO1": True}
#: preemption flagged on rank 1 after this many steps, a checkpoint crossing
PREEMPT = {"TRAIN.CHECKPOINT_EVERY_STEPS": 3, "TRAIN.AUTO_RESUME": True, "PRINT_FREQ": 2,
           "TPU.ZERO1": True, "TRAIN.EVAL_BEGIN_EPOCH": 5}
PREEMPT_AT = 3
#: ``commands.train.train_main`` on the tiny timm ViT (the JAX command tests')
TRAIN_MAIN = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 4, "MODEL.NUM_CLASSES": 4,
              "MODEL.NAME": "cls_vit_tiny", "MODEL.SPEC.VISION.PATCH_SIZE": 8,
              "MODEL.SPEC.VISION.WIDTH": 32, "MODEL.SPEC.VISION.LAYERS": 2,
              "MODEL.SPEC.VISION.HEADS": 2, "TRAIN.IMAGE_SIZE": [16, 16],
              "TEST.BATCH_SIZE_PER_GPU": 16, "TRAIN.END_EPOCH": 2, "TRAIN.LR": 0.01,
              "TRAIN.MOMENTUM": 0.9, "TRAIN.LR_SCHEDULER.METHOD": "warmupcosine",
              "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 1, "PRINT_FREQ": 1, "NAME": "tiny"}


def train_main_run(params, out_dir: str, batch: int) -> dict:
    """``train_main`` of ``TRAIN_MAIN`` at ``BATCH_SIZE_PER_GPU`` = ``batch``
    on ``params`` (the JAX tree): the best top-1 and the last checkpoint's
    trainable leaves."""
    from peft_vit_tpu_torch.commands.train import run_dirs, train_main
    from peft_vit_tpu_torch.engine.checkpoint import _load, latest_step

    cfg = set_keys(port_config.get_default_config(),
                   {**TRAIN_MAIN, "TRAIN.BATCH_SIZE_PER_GPU": batch, "OUTPUT_DIR": out_dir})
    best = train_main(cfg, device="cpu", variables={"params": params})
    ckpt = run_dirs(cfg)[0]
    stored = _load(ckpt, latest_step(ckpt))
    return {"best": best, "trainable": _numpy(stored["trainable"]),
            "step": int(stored["step"])}


def trainer_cfg(pkg, **over):
    """The JAX trainer tests' config: synthetic 4-way at 16 px, 2 epochs of
    warmup cosine, ``BATCH_SIZE_PER_GPU`` 4 (a rank's part of the global 8)."""
    cfg = pkg.get_default_config()
    base = {"DATASET.DATASET": "synthetic", "DATASET.NUM_CLASSES": 4, "MODEL.NUM_CLASSES": 4,
            "TRAIN.IMAGE_SIZE": [16, 16], "TRAIN.BATCH_SIZE_PER_GPU": TRAINER_BATCH // 2,
            "TRAIN.END_EPOCH": 2, "TRAIN.LR": 0.01, "TRAIN.LR_SCHEDULER.METHOD": "warmupcosine",
            "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 1, "PRINT_FREQ": 1, "OUTPUT_DIR": ""}
    return set_keys(cfg, {**base, **over})


def vit_trainer(cfg, params, method="full", int8=False, size=16, layers=2, scan_layers=False):
    """The port's Trainer of the JAX trainer tests' timm ViT (patch 8, width
    32, 2 heads; 16 px and 2 blocks unless ``size`` and ``layers`` say
    otherwise, the blocks stacked with ``scan_layers``) on ``params`` (the
    JAX tree)."""
    from peft_vit_tpu_torch.engine.trainer import Trainer
    from peft_vit_tpu_torch.models import ImageClassifier
    from peft_vit_tpu_torch.models.vit import VisionTransformer

    model = ImageClassifier(VisionTransformer(image_size=size, patch_size=8, width=32,
                                              layers=layers, heads=2, style="timm",
                                              int8_train=int8, scan_layers=scan_layers,
                                              device="cpu"), num_classes=4, device="cpu")
    load_jax_variables(model, {"params": params})
    return Trainer(cfg, model, build_mask(model, method, num_layers=layers), TRAINER_STEPS)


def rn_trainer(cfg, variables, kw):
    """The port's Trainer of the tiny ResNet ``kw`` on ``variables`` (the
    JAX tree, or None: the port's own init from torch's seed 0)."""
    from peft_vit_tpu_torch.engine.trainer import Trainer
    from peft_vit_tpu_torch.models import ImageClassifier
    from peft_vit_tpu_torch.models.resnet import ResNet

    torch.manual_seed(0)
    model = ImageClassifier(ResNet(**kw, device="cpu"), num_classes=4, device="cpu")
    if variables is not None:
        load_jax_variables(model, variables)
    return Trainer(cfg, model, build_mask(model, "full", num_layers=0), TRAINER_STEPS)


def rank_batches(x, y, epoch: int, rank: int, world: int):
    """This rank's rows of each global batch of the epoch (``batch_iterator``'s
    order, seed ``epoch``)."""
    from peft_vit_tpu_torch.engine.trainer import batch_iterator

    for bx, by in batch_iterator(x, y, TRAINER_BATCH, seed=epoch):
        b = len(by) // world
        yield bx[rank * b:(rank + 1) * b], by[rank * b:(rank + 1) * b]


def eval_stripe(x, y, rank: int, world: int):
    """This rank's stripe of the test set, in batches of 8."""
    from peft_vit_tpu_torch.engine.trainer import batch_iterator

    idx = np.arange(len(y))[rank::world]
    return batch_iterator(x[idx], y[idx], TRAINER_BATCH, shuffle=False, drop_last=False)


def _numpy(tensors):
    return {k: v.detach().numpy().copy() for k, v in (tensors or {}).items()}


def run_trainer(tr, x, y, rank: int, world: int, epochs: int) -> dict:
    """``epochs`` epochs of this rank's rows: each epoch's loss, the trainable
    leaves, the whole optimizer state, the BN statistics and the eval top-1
    over the ranks' stripes."""
    losses = [tr.train_one_epoch(rank_batches(x, y, e, rank, world), e)["loss"]
              for e in range(epochs)]
    return {"losses": losses, "trainable": _numpy(tr.state.trainable),
            "opt": _numpy(tr._whole_opt(tr.state.opt_state)),
            "bn": _numpy(tr.state.batch_stats), "top1": tr.evaluate(eval_stripe(x, y, rank, world)),
            "opt_shapes": {k: tuple(v.shape) for k, v in tr.state.opt_state.items()}}


def _preempted_fit(tr, x, y, rank: int, world: int, ckpt: str, flag_rank) -> dict:
    """``tr.fit`` into ``ckpt``, rank ``flag_rank`` flagging a preemption
    after ``PREEMPT_AT`` steps (None: never): the PreemptedError's message
    (None: the run finished) and the state."""
    from peft_vit_tpu_torch.engine.trainer import PreemptedError

    real, seen = tr.train_step, [0]

    def step(*a):
        out = real(*a)
        seen[0] += 1
        if rank == flag_rank and seen[0] == PREEMPT_AT:
            tr._preempted = True
        return out

    tr.train_step = step
    try:
        tr.fit(lambda e: rank_batches(x, y, e, rank, world),
               lambda: eval_stripe(x, y, rank, world), ckpt)
        stopped = None
    except PreemptedError as e:
        stopped = str(e)
    return {"stopped": stopped, "trainable": _numpy(tr.state.trainable),
            "opt": _numpy(tr.state.opt_state), "step": int(tr.state.step)}


def trainer_runs(rank, vit_params, rn_variables, x, y, xu8, rn_x, rn_y, tmp):
    """The port's multi-process Trainer on this rank: the timm ViT's full
    fine-tune replicated and under ZeRO-1, the ResNet with BN, the int8
    static scales of the first batch, every draw on (the ViT and the
    DropBlock ResNet), a preemption flagged on rank 1 then resumed, beside
    the uninterrupted run, and ``train_main`` over the group."""
    world = 2
    out = {}
    for zero1 in (False, True):
        tr = vit_trainer(trainer_cfg(port_config, **VIT_FULL, **{"TPU.ZERO1": zero1}),
                         vit_params)
        out[("vit", zero1)] = run_trainer(tr, x, y, rank, world, epochs=2)
    out["rn"] = run_trainer(rn_trainer(trainer_cfg(port_config, **RN_SGD), rn_variables, RN_BN),
                            rn_x, rn_y, rank, world, epochs=1)
    tr = vit_trainer(trainer_cfg(port_config, **INT8_STATIC), vit_params, "bitfit", int8=True)
    bx, by = next(rank_batches(x, y, 0, rank, world))
    tr.train_step(bx, by, 0)
    out["scales"] = _numpy(tr._qscale)
    out["draws"] = run_trainer(vit_trainer(trainer_cfg(port_config, **DRAWS), vit_params),
                               xu8, y, rank, world, epochs=1)
    out["rn_draws"] = run_trainer(rn_trainer(trainer_cfg(port_config, **RN_DRAWS), None,
                                             RN_DROPBLOCK), rn_x, rn_y, rank, world, epochs=1)
    cfg = trainer_cfg(port_config, **VIT_FULL, **PREEMPT)
    out["whole"] = _preempted_fit(vit_trainer(cfg, vit_params), x, y, rank, world,
                                  os.path.join(tmp, "whole"), None)
    resumed = os.path.join(tmp, "resumed")
    out["preempted"] = _preempted_fit(vit_trainer(cfg, vit_params), x, y, rank, world,
                                      resumed, 1)
    out["resumed"] = _preempted_fit(vit_trainer(cfg, vit_params), x, y, rank, world,
                                    resumed, None)
    out["train_main"] = train_main_run(vit_params, os.path.join(tmp, "main"),
                                       TRAINER_BATCH // world)
    return out


# -- tensor parallelism (tests/test_torch_port_tensor_parallel.py) --------------


def tiny_moe(variables):
    """The tiny flagship's tower with the LoRA-MoE gate (group 2) on
    ``variables``, and its trainable leaves."""
    from peft_vit_tpu_torch.models import ImageClassifier, VisionTransformer
    from peft_vit_tpu_torch.peft import PEFTSpec

    t = TINY_DP
    spec = PEFTSpec(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
                    lora_post_scale_q=True, lora_moe=True, lora_moe_group=2)
    model = ImageClassifier(
        VisionTransformer(image_size=t["image"], patch_size=t["patch"], width=t["width"],
                          layers=t["layers"], heads=t["heads"], output_dim=512, spec=spec,
                          dtype=torch.float32, device="cpu"),
        num_classes=t["num_classes"], dtype=torch.float32, device="cpu")
    load_jax_variables(model, variables)
    trainable, _ = split_params(model, build_mask(model, "lora", num_layers=t["layers"]))
    return model, trainable


def tp_steps(rank, variables, moe_variables, x, y, lr, wd, steps):
    """On a mesh of data 1 x model 2: the cut of every leaf, ``steps``
    sharded LoRA steps (their losses and the whole leaves gathered from the
    model ranks), the eval step's logits, and ``steps`` ZeRO-1 steps of the
    LoRA-MoE tower."""
    from peft_vit_tpu_torch.parallel import tp_gather

    mesh = make_mesh(data=1, model=2)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    out = {"mesh": (tuple(mesh), mesh.model_rank)}
    for key, (model, trainable) in (("lora", tiny_lora(variables)),
                                    ("moe", tiny_moe(moe_variables))):
        apply_fn = make_apply_fn(model)
        step, place = make_sharded_train_step(apply_fn, ce_per_example, mesh,
                                              zero1=key == "moe", model=model)
        state, frozen = place(init_cell_state(trainable), {})
        if key == "lora":
            out["cut"] = {k: tuple(v.shape) for k, v in {**state.trainable, **frozen}.items()}
            out["logits"] = make_sharded_eval_step(apply_fn, mesh)(
                state.trainable, frozen, xs).numpy()
        losses = []
        for _ in range(steps):
            state, loss = step(state, frozen, xs, ys, lr, wd)
            losses.append(float(loss))
        out[key] = {"losses": losses,
                    "trainable": {k: v.numpy() for k, v in tp_gather(mesh, state.trainable).items()},
                    "own": {k: v.numpy() for k, v in state.trainable.items()}}
    return out


# -- sequence parallelism (tests/test_torch_port_seqpar.py) -----------------------

#: the tiny LoRA flagship at 48 px: 3 x 3 patches + the class token = 10
#: tokens, 5 a rank over model 2 (the JAX dryrun's third step)
SP_DP = dict(TINY_DP, image=48)
#: the JAX TestSequenceParallelTrainer's config: the timm ViT at 24 px, patch
#: 8 (3 x 3 + cls = 10 tokens), full fine-tune, SGD at a constant 0.05, one
#: global batch of 8 on data 1 x model 2
SP_TRAINER = {"TRAIN.IMAGE_SIZE": [24, 24], "TRAIN.LR": 0.05, "TRAIN.BATCH_SIZE_PER_GPU": 8,
              "TRAIN.LR_SCHEDULER.METHOD": "constant", "TRAIN.END_EPOCH": 1}
SP_MESH = {"TPU.SEQUENCE_PARALLEL": True, "TPU.MESH.DATA": 1, "TPU.MESH.MODEL": 2}


def sp_flagship(variables, method):
    """The port's fp32 flagship at ``SP_DP`` on ``variables`` (the JAX tree),
    and its trainable leaves under ``method``."""
    model = flagship(**SP_DP, dtype=torch.float32, device="cpu")
    load_jax_variables(model, variables)
    trainable, _ = split_params(model, build_mask(model, method, num_layers=SP_DP["layers"]))
    return model, trainable


def sp_runs(rank, variables, x, y, lr, wd, steps, trainer_params, stacked_params, tx, ty):
    """On a mesh of data 1 x model 2 under sequence parallelism: ``steps``
    sharded LoRA steps, one full fine-tune step, the same step with the model
    group's sum of the partial gradients left out (``sp_partial`` patched to
    name no leaf), each with its losses and the whole leaves gathered from the
    model ranks; and an epoch of the Trainer at ``SP_TRAINER`` on
    ``trainer_params``, and on ``stacked_params`` (the same tree stacked)
    with the blocks stacked, both ranks on the whole global batch."""
    from peft_vit_tpu_torch.parallel import tp_gather
    from peft_vit_tpu_torch.parallel import train_step as ts

    mesh = make_mesh(data=1, model=2)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    out = {"mesh": (tuple(mesh), mesh.model_rank)}
    for key, method, n, summed in (("lora", "lora", steps, True), ("full", "full", 1, True),
                                   ("unsummed", "full", 1, False)):
        model, trainable = sp_flagship(variables, method)
        saved = ts.sp_partial
        if not summed:
            ts.sp_partial = lambda name: False
        try:
            step, place = make_sharded_train_step(make_apply_fn(model), ce_per_example, mesh,
                                                  model=model, sequence_parallel=True)
            state, frozen = place(init_cell_state(trainable), {})
            losses = []
            for _ in range(n):
                state, loss = step(state, frozen, xs, ys, lr, wd)
                losses.append(float(loss))
        finally:
            ts.sp_partial = saved
        out[key] = {"losses": losses, "trainable": _numpy(tp_gather(mesh, state.trainable))}
    cfg = trainer_cfg(port_config, **SP_TRAINER, **SP_MESH)
    for key, params, scan in (("trainer", trainer_params, False),
                              ("trainer_stacked", stacked_params, True)):
        out[key] = run_trainer(vit_trainer(cfg, params, size=24, scan_layers=scan), tx, ty, 0, 1,
                               epochs=1)
    return out


# -- GPipe (tests/test_torch_port_pipeline.py) -----------------------------------------

#: the JAX TestPipelineTrainer's config: the stacked timm ViT at 16 px, 4
#: blocks, full fine-tune, LR 0.05 (warmup cosine), 2 epochs of 8 steps
PIPE_TRAINER = {"TRAIN.LR": 0.05, "TRAIN.BATCH_SIZE_PER_GPU": 8}
PIPE_MESH = {"TPU.SCAN_LAYERS": True, "TPU.MESH.DATA": 1, "TPU.MESH.PIPE": 2}
PIPE_MICROBATCHES = (1, 2, 4)


def pipe_stack(stacked, x, microbatches, transport):
    """``pipeline_apply`` of the stacked blocks ``stacked`` (the port's
    names under ``blocks.block.``, numpy) of width 32, 2 heads, on the
    tokens ``x`` over ``transport``: the output and the gradients of the
    leaves and of ``x`` of the output's sum of squares."""
    from torch.func import functional_call

    from peft_vit_tpu_torch.models.layers import Block
    from peft_vit_tpu_torch.parallel import pipeline_apply, stage_params

    block = Block(32, 2, act="gelu", device="cpu")
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in stacked.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = pipeline_apply(lambda p, h: functional_call(block, p, (h,)),
                         stage_params(leaves, transport.n_stages), xt,
                         microbatches=microbatches, transport=transport)
    grads = torch.autograd.grad(out.square().sum(), [xt, *leaves.values()])
    return {"out": out.detach().numpy(), "dx": grads[0].numpy(),
            "grads": {k: g.numpy() for k, g in zip(leaves, grads[1:])}}


def pipe_runs(rank, stacked, x, trainer_params, tx, ty):
    """On a mesh of data 1 x pipe 2: ``pipe_stack`` over the group at each of
    ``PIPE_MICROBATCHES`` (the stage leaves' gradients summed over the pipe
    group), and two epochs of the Trainer at ``PIPE_TRAINER`` on
    ``trainer_params`` (the stacked JAX tree), both ranks on the whole
    global batch."""
    from peft_vit_tpu_torch.parallel import GroupRing, sum_all_reduce

    mesh = make_mesh(data=1, model=1, pipe=2)
    ring = GroupRing(mesh.pipe_group, 2)
    out = {"mesh": (tuple(mesh), mesh.pipe_rank)}
    for m in PIPE_MICROBATCHES:
        got = pipe_stack(stacked, x, m, ring)
        dx = sum_all_reduce(torch.from_numpy(got["dx"]), mesh.pipe_group).numpy()
        got["grads"] = {k: sum_all_reduce(torch.from_numpy(v), mesh.pipe_group).numpy()
                        for k, v in got["grads"].items()}
        out[m] = {**got, "dx": dx}
    cfg = trainer_cfg(port_config, **PIPE_TRAINER, **PIPE_MESH)
    tr = vit_trainer(cfg, trainer_params, layers=4, scan_layers=True)
    out["trainer"] = run_trainer(tr, tx, ty, 0, 1, epochs=2)
    out["microbatches"] = tr.pp_microbatches
    return out


# -- tensor and sequence parallelism under the hooks and int8 -------------------------
# (tests/test_torch_port_tp_hooks.py)

#: the base LoRA of the int8 recipes (the tiny flagship's)
HOOK_LORA = dict(attn_delta="lora", lora_rank=4, lora_alpha=128.0, lora_post_scale_q=True)
#: every int8 recipe: (int8 dx, static scales, int8 attention)
INT8_RECIPES = {"int8": (True, True, False), "int8_prequant": (False, False, False),
                "int8_prequant_dx": (True, False, False), "int8_static": (False, True, False),
                "int8_attn": (True, True, True)}
#: each hook alone: its PEFTSpec fields, its mask's method and the image size
#: (48 px: 3 x 3 patches and the class token, 10 tokens, 5 a rank; the deep
#: prompts at 32 px: 2 x 2 + 1 + 5 prompts, so that the prompts' rows 1-5
#: straddle the ranks' slices 0-4 and 5-9)
HOOKS = {
    "adapter": (dict(adapter="houlsby", adapter_dim=8), "adapter", 48),
    "adapterdrop": (dict(adapter="houlsby", adapter_dim=8, adapter_layers=(1,)), "adapterdrop",
                    48),
    "compacter": (dict(adapter="compacter", compacter_phm_dim_down=4), "compacter", 48),
    "kadaptation": (dict(attn_delta="kron"), "kadaptation", 48),
    "shared_qkv": (dict(HOOK_LORA, attn_adapter="shared_qkv"), "lora", 48),
    "lepe": (dict(lepe=True), "lepe", 48),
    "lepe_ref_qkv": (dict(lepe=True, lepe_ref_qkv=True), "lepe", 48),
    "rpb": (dict(attn_bias="rpb"), "rpb", 48),
    "lora_ref_reshape": (dict(HOOK_LORA, lora_ref_reshape=True), "lora", 48),
    "vpt": (dict(prompt_tokens=5, prompt_deep=True), "vpt", 32),
    **{k: (HOOK_LORA, "lora", 48) for k in INT8_RECIPES},
}
HOOK_SEED = 30
HOOK_STEPS = 2


def hook_model(hook: str):
    """The tiny fp32 flagship (width 64, 2 blocks, 4 heads) with ``hook``
    alone, drawn from ``HOOK_SEED`` (every zero leaf redrawn at 0.02 so that
    each acts): the model, its trainable leaves and the frozen tensors a step
    takes (the int8 tree, quantized whole, and the static scales of one
    whole-model calibration forward of ``hook_batch``'s images)."""
    from peft_vit_tpu_torch.engine.train import calibrate
    from peft_vit_tpu_torch.models import ImageClassifier, VisionTransformer
    from peft_vit_tpu_torch.ops.int8 import quantize_frozen_tree
    from peft_vit_tpu_torch.peft import PEFTSpec

    fields, method, image = HOOKS[hook]
    dx, static, attn = INT8_RECIPES.get(hook, (False, False, False))
    torch.manual_seed(HOOK_SEED)
    t = TINY_DP
    model = ImageClassifier(
        VisionTransformer(image_size=image, patch_size=t["patch"], width=t["width"],
                          layers=t["layers"], heads=t["heads"], output_dim=512,
                          spec=PEFTSpec(method=method, **fields), int8_train=hook in INT8_RECIPES,
                          int8_attn=attn, dtype=torch.float32, device="cpu"),
        num_classes=t["num_classes"], dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            if not p.abs().sum():
                p.normal_(0.0, 0.02)
    trainable, frozen = split_params(model, build_mask(model, method, num_layers=t["layers"]))
    extra = {}
    if hook in INT8_RECIPES:
        extra = quantize_frozen_tree(frozen, bwd_dx=dx)
        if static:
            extra.update(calibrate(model, make_apply_fn(model), dict(trainable),
                                   hook_batch(image)[0], 1.5))
    return model, trainable, extra


def hook_batch(image: int):
    rng = np.random.RandomState(HOOK_SEED + 1)
    x = rng.standard_normal((8, image, image, 3)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(np.arange(8) % TINY_DP["num_classes"])


def local_steps(model, trainable, frozen, x, y, lr, wd, steps) -> dict:
    """``steps`` SGD steps of the sharded step's arithmetic in one process
    (no group): the losses and the trainable leaves."""
    from peft_vit_tpu_torch.engine.train import TrainCellState, sgd_update
    from peft_vit_tpu_torch.peft import merge_params

    apply_fn = make_apply_fn(model)
    state = init_cell_state(trainable)
    lr, wd = torch.tensor(lr, dtype=torch.float32), torch.tensor(wd, dtype=torch.float32)
    losses = []
    for i in range(steps):
        leaves = {k: v.detach().requires_grad_() for k, v in state.trainable.items()}
        logits = apply_fn(merge_params(leaves, frozen), x, True)
        loss = ce_per_example(logits.to(torch.float32), y).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        with torch.no_grad():
            g = {k: torch.zeros_like(v) if d is None else d
                 for (k, v), d in zip(leaves.items(), grads)}
            new = sgd_update(g, TrainCellState(state.trainable, state.momentum, i), lr, wd,
                             0.9, True)
        state = TrainCellState(new.trainable, new.momentum, i + 1)
        losses.append(float(loss.detach()))
    return {"losses": losses, "trainable": _numpy(state.trainable)}


def _sharded(mesh, model, trainable, frozen, x, y, lr, wd, steps, seq) -> dict:
    from peft_vit_tpu_torch.parallel import tp_gather

    step, place = make_sharded_train_step(make_apply_fn(model), ce_per_example, mesh,
                                          model=model, sequence_parallel=seq)
    state, frozen = place(init_cell_state(trainable), frozen)
    losses = []
    for _ in range(steps):
        state, loss = step(state, frozen, x, y, lr, wd)
        losses.append(float(loss))
    return {"losses": losses, "trainable": _numpy(tp_gather(mesh, state.trainable))}


def hooked_trainer(cfg):
    """The Trainer of the JAX trainer tests' timm ViT (16 px, patch 8: 2 x 2
    + cls, width 32, 2 heads, 2 blocks) with 5 deep prompts (rows 1-5 of 10
    tokens), the Houlsby adapter and the int8 GEMMs, drawn from
    ``HOOK_SEED``; the prompts, adapters and head train."""
    from peft_vit_tpu_torch.engine.trainer import Trainer
    from peft_vit_tpu_torch.models import ImageClassifier
    from peft_vit_tpu_torch.models.vit import VisionTransformer
    from peft_vit_tpu_torch.peft import PEFTSpec

    torch.manual_seed(HOOK_SEED + 2)
    spec = PEFTSpec(method="vpt", prompt_tokens=5, prompt_deep=True, adapter="houlsby",
                    adapter_dim=8)
    model = ImageClassifier(VisionTransformer(image_size=16, patch_size=8, width=32, layers=2,
                                              heads=2, style="timm", spec=spec, int8_train=True,
                                              device="cpu"), num_classes=4, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            if not p.abs().sum():
                p.normal_(0.0, 0.02)
    mask = build_mask(model, "vpt", num_layers=2, extra_regex="/adapter/")
    return Trainer(cfg, model, mask, TRAINER_STEPS)


#: the hooked Trainer's config: one epoch of SGD at a constant rate under
#: the int8 static recipe (the int8 dx is held by the sharded steps: over an
#: epoch a last-bit difference of the shards' upstream sums flipped one dx
#: code, 9.3e-6 on one prompt row)
HOOK_TRAINER = {"TRAIN.LR": 0.05, "TRAIN.BATCH_SIZE_PER_GPU": 8,
                "TRAIN.LR_SCHEDULER.METHOD": "constant", "TRAIN.END_EPOCH": 1,
                "TPU.INT8_FWD_TRAIN": True, "TPU.INT8_STATIC_ACT": True}


def tp_hook_runs(rank, combined, int8_model, lr, wd, steps, tx, ty):
    """On a mesh of data 1 x model 2: ``steps`` sharded steps under tensor
    and under sequence parallelism of the JAX-drawn models, each given as
    (variables, frozen tensors, x, y) (``combined``: the tower with every
    hook at once, no frozen tensors; ``int8_model``: the LoRA tower with
    int8, the bridged int8 tree and scales), of each hook and int8 recipe alone
    (``HOOKS``), the same step with the model group's sum of the kron leaves
    (tensor parallelism) and of the deep prompts (sequence parallelism) left
    out, an epoch of the hooked Trainer under sequence parallelism (both
    ranks on the whole batch), and a step of ViT-B/16's geometry with one
    prompt (``VITB16_SP``)."""
    from peft_vit_tpu_torch.parallel import train_step as ts

    mesh = make_mesh(data=1, model=2)
    out = {"mesh": (tuple(mesh), mesh.model_rank)}
    for key, (variables, extra, x, y) in (("combined", combined), ("int8_model", int8_model)):
        model = combined_model(variables) if key == "combined" else int8_tower(variables)
        method = "full" if key == "combined" else "lora"
        trainable, _ = split_params(model, build_mask(model, method, num_layers=2))
        frozen = {k: torch.from_numpy(v) for k, v in extra.items()}
        xs, ys = torch.from_numpy(x), torch.from_numpy(y)
        for seq in (False, True):
            out[(key, seq)] = _sharded(mesh, model, trainable, frozen, xs, ys, lr, wd, steps, seq)
    for hook, (_, _, image) in HOOKS.items():
        model, trainable, frozen = hook_model(hook)
        hx, hy = hook_batch(image)
        for seq in (False, True):
            out[(hook, seq)] = _sharded(mesh, model, trainable, frozen, hx, hy, lr, wd,
                                        HOOK_STEPS, seq)
    saved = ts.tp_partial, ts.sp_partial
    for hook, seq in (("kadaptation", False), ("vpt", True)):
        model, trainable, frozen = hook_model(hook)
        hx, hy = hook_batch(HOOKS[hook][2])
        ts.tp_partial = lambda name: False
        ts.sp_partial = lambda name: saved[1](name) and "prompt" not in name
        try:
            out[(hook, "unsummed")] = _sharded(mesh, model, trainable, frozen, hx, hy, lr, wd,
                                               HOOK_STEPS, seq)
        finally:
            ts.tp_partial, ts.sp_partial = saved
    cfg = trainer_cfg(port_config, **HOOK_TRAINER, **SP_MESH)
    out["trainer"] = run_trainer(hooked_trainer(cfg), tx, ty, 0, 1, epochs=1)
    model, trainable = vitb16_prompt_model()
    vx, vy = vitb16_batch()
    out["vitb16"] = _sharded(mesh, model, trainable, {}, vx, vy, lr, wd, 1, True)
    return out


#: ViT-B/16's token geometry (224 px, patch 16: 196 patches and the class
#: token) with the one VPT prompt the JAX factory prescribes for a model
#: degree of 2 (198 tokens, 99 a rank), deep, at the JAX contract test's
#: width 64, 2 blocks, 2 heads
VITB16_SP = {"MODEL.NAME": "clip_tiny", "TRAIN.IMAGE_SIZE": [224, 224],
             "MODEL.SPEC.VISION.PATCH_SIZE": 16, "MODEL.SPEC.VISION.WIDTH": 64,
             "MODEL.SPEC.VISION.LAYERS": 2, "MODEL.SPEC.VISION.HEADS": 2,
             "PEFT.METHOD": "vpt", "PEFT.PROMPT_TOKENS": 1, "PEFT.PROMPT_DEEP": True,
             "TPU.SEQUENCE_PARALLEL": True, "TPU.MESH.MODEL": 2}


def vitb16_prompt_model():
    """``build_image_classifier`` at ``VITB16_SP`` (5 classes, the factory's
    seed; every zero leaf redrawn from ``HOOK_SEED``) and its VPT leaves."""
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.peft import spec_from_config

    cfg = set_keys(port_config.get_default_config(), VITB16_SP)
    model, _, _ = build_image_classifier(cfg, spec_from_config(cfg), 5, device="cpu")
    gen = torch.Generator().manual_seed(HOOK_SEED)
    with torch.no_grad():
        for p in model.parameters():
            if not p.abs().sum():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    trainable, _ = split_params(model, build_mask(model, "vpt", num_layers=2))
    return model, trainable


def vitb16_batch():
    rng = np.random.RandomState(HOOK_SEED + 3)
    x = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(np.arange(2, dtype=np.int64))


def combined_model(variables):
    """The tiny fp32 tower (32 px: 2 x 2 patches, the class token and 5 deep
    prompts, 10 tokens) with every hook the JAX PEFTSpec takes at once:
    KAdaptation's kron deltas, the Houlsby adapter, the shared qkv adapter,
    LePE, RPB and deep VPT, on ``variables`` (the JAX tree)."""
    from peft_vit_tpu_torch.models import ImageClassifier, VisionTransformer
    from peft_vit_tpu_torch.peft import PEFTSpec

    t = TINY_DP
    model = ImageClassifier(
        VisionTransformer(image_size=t["image"], patch_size=t["patch"], width=t["width"],
                          layers=t["layers"], heads=t["heads"], output_dim=512,
                          spec=PEFTSpec(**COMBINED), dtype=torch.float32, device="cpu"),
        num_classes=t["num_classes"], dtype=torch.float32, device="cpu")
    return load_jax_variables(model, variables)


#: every hook at once (``combined_model``), the JAX PEFTSpec's fields
COMBINED = dict(method="full", attn_delta="kron", adapter="houlsby", adapter_dim=8,
                attn_adapter="shared_qkv", lepe=True, attn_bias="rpb", prompt_tokens=5,
                prompt_deep=True)


def int8_tower(variables):
    """The tiny fp32 LoRA flagship at 48 px with the int8 GEMMs (static
    scales, int8 dx) on ``variables`` (the JAX tree)."""
    return load_jax_variables(flagship(**SP_DP, dtype=torch.float32, int8_train=True,
                                       device="cpu"), variables)
