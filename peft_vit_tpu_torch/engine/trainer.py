"""The full-shot trainer (counterpart of ``peft_vit_tpu/engine/trainer.py``)
for one process on one card.

The reference's trainer (full_shot/main/tools/train.py:64-291 +
lib/core/function.py:46-268), as the JAX package redesigned it: the epoch
loop with train and eval, best-model tracking and auto-resume; mixup/cutmix
and label smoothing inside the step; the optimizer chain and schedule of
``engine.optim``; the EMA shadow every step and the SWA average after
``SWA.BEGIN_EPOCH``; the NaN guard with its forensic dump; checkpoints every
``TRAIN.CHECKPOINT_EVERY_STEPS`` with exact mid-epoch resume; the SIGTERM
handler that checkpoints and stops (``PreemptedError``).

The train step is the counterpart of ``jax.jit(train_step,
donate_argnums=0)``: one function that updates the state's tensors in place
(the uint8 batch's flip and normalisation, mixup/cutmix, the forward, the
backward, the optimizer chain, EMA, SWA where the device flag ``swa_on`` says
so, the ``finite`` AND).  On the card it is a ``StepGraph`` replay, captured
once per batch shape: the state lives in the graph's static buffers, and a
replay copies in only the batch and its draws.  The random draws (the flip,
mixup's switch, lam and box) come from the trainer's explicit
``torch.Generator`` on the host and enter each replay as inputs; the
generator's state is checkpointed, so a resumed run draws what the
uninterrupted run drew.  The CPU runs the same function eagerly.
``TPU.STEPS_PER_DISPATCH`` = K runs K replays of the one-step graph per
chunk, the chunk copied to the card once (one program for the K steps waits
for the epoch as one program, ROADMAP §1).  Eval batches are replays of an
eval graph too.

``AUG.TIMM_AUG`` (``data.augment``) runs inside the step on the raw batch:
the flip, RandAugment and random erasing, then the normalisation; eval
normalises raw batches on the card.  Its host draws come from the trainer's
generator with the others; the erase's pixel noise is drawn in the step from
``noise_generator``, a generator on the trainer's device (registered with the
train graph), whose state is checkpointed too.  ``TPU.PREFETCH_DEPTH`` items
are staged ahead through pinned buffers and a side stream
(``data.streaming.prefetch_to_device``).

``AUG.DROPBLOCK_KEEP_PROB`` < 1 (a ResNet backbone only) runs DropBlock in
the step: its anneal's position, step / total steps, is computed on the
device from the step count, and its masks are drawn from ``drop_generator``,
a generator on the trainer's device registered with the train graph and
checkpointed (``drop_rng``).  A backbone with stochastic depth
(``drop_path_rate`` > 0: ConvViT's ``DROP_PATH_RATE``, an SSL-Swin) draws
its drop-path masks from the same generator.  ``update_bn`` refreshes the BN statistics of a
CNN backbone as of the channel-BN head.

``TPU.INT8_FWD_TRAIN`` quantizes the frozen tree once per run (before
``models.cast_frozen_``); ``TPU.INT8_STATIC_ACT`` recalibrates the static
activation scales on the first batch of every epoch (``engine.train.calibrate``).

Over a data group (``mesh``: the JAX trainer's mesh, batch sharded, state
replicated) each rank runs its rows of the global batch, one process a card:
the step's forward runs under ``utils.dist.data_shard``, so that BatchNorm
takes the global batch's moments and the device draws (the erase's noise,
DropBlock, drop path) are the global batch's, cut to the rank's rows; the
host draws (the flip of each global row, mixup's switch, lam and box) are
drawn whole from the one generator state every rank holds, and mixup pairs
rows across the ranks (``parallel.roll_rows``).  The gradients are
mean-all-reduced; under ``TPU.ZERO1`` each leaf's gradient is
reduce-scattered along ``parallel.zero_dim`` instead, the optimizer chain
updates the rank's slice of the leaf and of its state (the clip's and LARC's
norms summed over the group), and the leaf is all-gathered.  So two ranks
compute the one-process run of the global batch.  The collectives are
captured with the step.  The loss meter is the group's mean; eval gathers
the ranks' scores (``parallel.allgather_ragged``); the static int8 scales
are the global batch's absmax; the ranks agree on a SIGTERM at checkpoint
crossings and ``PRINT_FREQ`` boundaries; rank 0 writes whole leaves (the
ZeRO-1 slices gathered) and every rank reads them back and cuts its slice.

A ``model`` degree runs with ``TPU.SEQUENCE_PARALLEL`` only (the JAX trainer
uses a model axis for nothing else; without it the degree raises):
Megatron-SP over the model group (``parallel.train_step``'s, with the same
coverage: every hook and int8).  Every rank keeps the whole leaves, the
int8 tree quantized once from them, and cuts them at use
(``parallel.tp_place``, differentiable), so that the gradient of a block
leaf on a rank is its part (its heads' rows and columns, its tokens' share
of a LayerNorm, a row-parallel bias, LoRA A, an adapter) and the model
group's sum is the whole gradient, as is the deep prompts' (only the rank
that holds a prompt's position replaces it); the embedding's and the head's
are whole on every model rank.  The static int8 scales are calibrated by the
sequence-parallel forward, each absmax the maximum over the data and the
model group.  ``TPU.MESH.PIPE`` > 1 pipelines the stacked block stack over the pipe
group (GPipe, ``parallel.pipeline``; the JAX trainer's ``ValueError`` without
``TPU.SCAN_LAYERS`` or with BatchNorm), ``TPU.PP_MICROBATCHES`` microbatches
(default the pipe degree).  Again every rank keeps the whole leaves; the last
stage's loss drives the backward, so that the head's gradient stands on the
last stage, the embedding's on stage 0 and each stage's block rows on their
stage, and the pipe group's sum of every gradient is the whole one, as JAX's
psum broadcast makes it.  The summed gradients then take the data group's
mean (or ZeRO-1's reduce-scatter).  Eval runs the whole, unpipelined model
on each rank's stripe.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..data.augment import make_train_transform
from ..data.streaming import prefetch_to_device
from ..models.layers import cast_frozen_
from ..models.resnet import ResNet
from ..ops.int8 import INT8_TARGET_MODULES, quantize_frozen_tree
from ..parallel import collectives as _coll
from ..parallel.mesh import Mesh, mesh_from_config, zero_dim
from ..parallel.pipeline import GroupRing, vit_pipeline_forward
from ..parallel.train_step import check_tensor_parallel, sp_partial, tp_context, tp_place
from ..peft.masks import merge_params, split_params
from ..utils import dist as _dist
from . import train as _train
from .checkpoint import dump_nan_state, restore_checkpoint, save_checkpoint
from .ema import EmaState, SwaState, ema_init, ema_update_, swa_init, swa_update_
from .loss import build_criterion, soft_target_cross_entropy
from .mixup import draw_mixup_cutmix, mixup_cutmix
from .optim import build_lr_schedule, build_optimizer, leaf_norms

logger = logging.getLogger(__name__)

Tensors = Dict[str, torch.Tensor]
_BN_STATS = ("bn_mean", "bn_var")


class PreemptedError(RuntimeError):
    """Raised after a SIGTERM-triggered checkpoint: the run stopped cleanly
    at a step boundary and will resume at that exact batch."""


class FullTrainState(NamedTuple):
    trainable: Tensors
    opt_state: Tensors
    step: torch.Tensor  # int32
    ema: Optional[EmaState]
    swa: Optional[SwaState]
    batch_stats: Optional[Tensors] = None  # the BN running statistics
    # the AND of isfinite(loss) over every step since init, read at each
    # host fetch, so that a NaN between fetches cannot train through
    finite: Optional[torch.Tensor] = None


def check_mesh(cfg, model: torch.nn.Module, mesh: Optional[Mesh], has_bn: bool) -> None:
    """Raise where the trainer cannot run over ``mesh``: a model degree
    without ``TPU.SEQUENCE_PARALLEL`` (no JAX trainer runs one), a pipe degree
    without a stacked backbone or with BatchNorm (the JAX trainer's
    ``ValueError``s), or with a model degree."""
    if mesh is None:
        return
    if mesh.model > 1 and not bool(cfg.TPU.get("SEQUENCE_PARALLEL", False)):
        raise NotImplementedError(
            f"a model degree of {mesh.model} in the Trainer without TPU.SEQUENCE_PARALLEL "
            "(the JAX trainer uses a model axis only with sequence parallelism)")
    if mesh.pipe > 1:
        if not getattr(getattr(model, "backbone", None), "scan_layers", False):
            raise ValueError("TPU.MESH.PIPE > 1 needs TPU.SCAN_LAYERS=True "
                             "(the pipeline stages the stacked block params)")
        if has_bn:
            raise ValueError("pipeline parallelism supports LN towers only "
                             "(no batch_stats)")
        if mesh.model > 1:
            raise ValueError("TPU.MESH.PIPE > 1 runs over data x pipe: set TPU.MESH.MODEL 1")


class Trainer:
    """The train and eval steps and the host-side epoch loop of one config.

    ``model`` holds the weights (fp32, on the device the trainer runs on);
    ``mask`` names its trainable parameters (``peft.build_mask``).  The
    trainer trains copies of the trainable leaves; the frozen ones are the
    model's own (stored in the compute dtype once the int8 tree, if any, is
    quantized).  The BN running statistics are the model's ``bn_mean`` /
    ``bn_var`` buffers (the JAX trainer's ``batch_stats``).  ``seed`` seeds
    the generator of the random draws (the JAX trainer's ``PRNGKey(0)``).
    In a process group the trainer runs over ``TPU.MESH``'s mesh
    (``self.mesh``; None without a group: one process, no collective)."""

    def __init__(self, cfg, model: torch.nn.Module, mask, steps_per_epoch: int, seed: int = 0):
        mesh = mesh_from_config(cfg) if _dist.group_initialized() else None
        self.mesh = mesh
        self.group = mesh.data_group if mesh is not None else None
        self.world = mesh.data if mesh is not None else 1
        self.cfg = cfg
        self.model = model
        self.steps_per_epoch = steps_per_epoch
        self.eager = bool(cfg.TRAIN.DETECT_ANOMALY)
        if self.eager:
            # torch.autograd.set_detect_anomaly (tools/train.py:159); the
            # anomaly checks cannot be captured, so the steps run eagerly
            from ..utils.profiling import enable_anomaly_detection

            enable_anomaly_detection(True)
        self.generator = torch.Generator().manual_seed(int(seed))
        batch_stats = {k: v for k, v in model.named_buffers()
                       if k.rsplit(".", 1)[-1] in _BN_STATS}
        self.has_bn = bool(batch_stats)
        check_mesh(cfg, model, mesh, self.has_bn)
        # sequence parallelism over the model group; GPipe over the pipe group
        self.seq = mesh is not None and mesh.model > 1
        if self.seq:
            check_tensor_parallel(model, mesh.model)
        self.pipe = mesh.pipe if mesh is not None else 1
        self.pp_microbatches = int(cfg.TPU.get("PP_MICROBATCHES", 0)) or self.pipe
        self.transport = GroupRing(mesh.pipe_group, self.pipe) if self.pipe > 1 else None
        self.use_dropblock = float(cfg.AUG.get("DROPBLOCK_KEEP_PROB", 1.0)) < 1.0
        if self.use_dropblock and not isinstance(getattr(model, "backbone", None), ResNet):
            # the JAX trainer's build-time guard: only a ResNet takes DropBlock
            raise ValueError(
                "AUG.DROPBLOCK_KEEP_PROB < 1 requires a ResNet backbone (got "
                f"{type(getattr(model, 'backbone', None)).__name__}); DropBlock is a CNN "
                "regularizer (reference cls_resnet.py:409-419)")
        self.total_steps = max(1, int(cfg.TRAIN.END_EPOCH) * int(steps_per_epoch))
        # stochastic depth (ConvViT, SSL-Swin): masks drawn in the step
        self.drop_path = float(getattr(getattr(model, "backbone", None), "drop_path_rate",
                                       0.0)) > 0.0

        trainable, frozen = split_params(model, mask)
        trainable = {k: v.detach().clone() for k, v in trainable.items()}
        self.device = next(iter(trainable.values())).device
        tpu = cfg.TPU
        self.qtree: Tensors = {}
        if bool(tpu.get("INT8_FWD_TRAIN", False)):
            # the frozen tower never changes during a run: its GEMM weights
            # are quantized once, from the stored fp32 weights
            self.qtree = quantize_frozen_tree(
                frozen, targets=tuple(tpu.get("INT8_TARGETS", INT8_TARGET_MODULES)),
                bwd_dx=bool(tpu.get("INT8_BWD_DX", False)))
        cast_frozen_(model)
        self.frozen = dict(frozen)
        self.int8_static = bool(self.qtree) and bool(tpu.get("INT8_STATIC_ACT", False))
        self.calib_margin = float(tpu.get("INT8_CALIB_MARGIN", _train.INT8_CALIB_MARGIN))
        self._qscale: Optional[Tensors] = None

        self.schedule = build_lr_schedule(cfg, steps_per_epoch)
        self.tx = build_optimizer(cfg, trainable, steps_per_epoch, self.schedule)
        # TPU.ZERO1: the dim of each leaf (and of its optimizer state) cut
        # over the data group; None keeps the leaf whole
        self.zero1 = bool(cfg.TPU.get("ZERO1", False)) and mesh is not None
        self.zero_dims = {k: zero_dim(tuple(v.shape), self.world) if self.zero1 else None
                          for k, v in trainable.items()}
        decay = float(cfg.TRAIN.EMA_DECAY)
        self.state = FullTrainState(
            trainable=trainable,
            opt_state=self._cut_opt(self.tx.init(trainable)),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            ema=ema_init(trainable, decay) if decay > 0 else None,
            swa=swa_init(trainable) if bool(cfg.SWA.ENABLED) else None,
            batch_stats=({k: v.detach().clone() for k, v in batch_stats.items()}
                         if self.has_bn else None),
            finite=torch.ones((), dtype=torch.bool, device=self.device),
        )

        aug = cfg.AUG
        self.use_mixup = float(aug.MIXUP) > 0.0 or float(aug.MIXCUT) > 0.0
        self.mixup_alpha = float(aug.MIXUP) or 0.2
        self.cutmix_alpha = float(aug.MIXCUT) or 1.0
        self.switch_prob = float(aug.MIXUP_SWITCH_PROB)
        self.smoothing = float(cfg.LOSS.LABEL_SMOOTHING)
        self.criterion = build_criterion(cfg, train=True)
        if self.use_mixup and cfg.LOSS.LOSS in ("softmax", "CE", "softmax_smooth",
                                                "labelSmoothCE", "soft_target", "softTargetCE"):
            # timm convention: mixup owns label smoothing; its soft targets
            # are already smoothed, so the criterion must not smooth again
            self.criterion = soft_target_cross_entropy
        self.eval_criterion = build_criterion(cfg, train=False)
        self.num_classes = int(cfg.MODEL.NUM_CLASSES) or int(cfg.DATASET.NUM_CLASSES)
        self.do_flip = bool(aug.get("RANDOM_FLIP", True))
        self.norm_mean = torch.tensor(list(cfg.INPUT.MEAN), dtype=torch.float32,
                                      device=self.device) * 255.0
        self.norm_std = torch.tensor(list(cfg.INPUT.STD), dtype=torch.float32,
                                     device=self.device) * 255.0
        self.swa_begin = int(cfg.SWA.BEGIN_EPOCH)
        self.transform = make_train_transform(cfg)
        self.noise_generator: Optional[torch.Generator] = None
        if self.transform is not None and self.transform.needs_noise:
            self.noise_generator = torch.Generator(device=self.device).manual_seed(int(seed) + 1)
        # DropBlock's masks are drawn in the step from a generator on the
        # device (registered with the train graph, checkpointed as drop_rng)
        self.drop_generator: Optional[torch.Generator] = None
        if self.use_dropblock or self.drop_path:
            self.drop_generator = torch.Generator(device=self.device).manual_seed(int(seed) + 2)
        self.apply_fn = _train.make_apply_fn(model)
        # which of the optimizer's leaves are ZeRO-1 slices (made here: a
        # captured step may copy no host list to the card)
        self._sliced = torch.tensor([self.zero_dims[k] is not None for k in self.tx.names],
                                    dtype=torch.bool, device=self.device)
        self._roll = (functools.partial(_coll.roll_rows, group=self.group)
                      if mesh is not None else None)
        self.graphs: Dict[Any, Any] = {}
        # set by the SIGTERM handler fit() installs: train_one_epoch
        # checkpoints at the next step boundary and raises PreemptedError
        self._preempted = False

    # -- the steps -----------------------------------------------------------

    def _normalize(self, x: torch.Tensor, flip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A raw uint8 batch, or any batch under the timm augmentation (whose
        batches arrive raw): flipped where ``flip`` says (NHWC, along W) and
        normalised on the device; another float batch as it is."""
        if x.dtype != torch.uint8 and self.transform is None:
            return x
        if flip is not None:
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
        return (x.to(torch.float32) - self.norm_mean) / self.norm_std

    def _variables(self, trainable: Tensors, bn: Optional[Tensors], scales: Tensors) -> Tensors:
        variables = merge_params(trainable, {**self.frozen, **self.qtree, **scales})
        if self.has_bn:
            variables.update(bn)
        return variables

    # -- the data group ------------------------------------------------------------

    def _rows(self, b: int) -> slice:
        """This rank's rows of a global batch whose part here is ``b`` rows."""
        if self.mesh is None:
            return slice(None)
        return slice(self.mesh.rank * b, (self.mesh.rank + 1) * b)

    def _shard(self, b: int):
        """The context of a forward of this rank's ``b`` rows."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return _dist.data_shard(self.mesh.rank * b, b * self.world,
                                functools.partial(_coll.sum_over_group, group=self.group))

    def _zero_slice(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        size = t.shape[dim] // self.world
        return t.narrow(dim, self.mesh.rank * size, size)

    def _opt_dim(self, key: str) -> Optional[int]:
        """The ZeRO-1 dim of the optimizer state ``key`` (``<slot>.<leaf>``)."""
        return self.zero_dims.get(key.partition(".")[2])

    def _cut_opt(self, opt: Tensors) -> Tensors:
        """The optimizer state with each ZeRO-1 leaf's state cut to this
        rank's slice."""
        if not self.zero1:
            return opt
        return {k: v if self._opt_dim(k) is None else self._zero_slice(v, self._opt_dim(k)).clone()
                for k, v in opt.items()}

    def _whole_opt(self, opt: Tensors) -> Tensors:
        """The whole optimizer state: the ranks' ZeRO-1 slices gathered (a
        collective: every rank calls it)."""
        if not self.zero1:
            return opt
        return {k: v if self._opt_dim(k) is None else _coll.all_gather_dim(
            v, self._opt_dim(k), self.group) for k, v in opt.items()}

    def _norms(self, ts):
        """Each leaf's norm over the group: a ZeRO-1 slice's squared norm
        summed over the ranks, a whole leaf's counted once."""
        n = leaf_norms(ts)
        return torch.where(self._sliced, _coll.sum_all_reduce(n.square(), self.group).sqrt(), n)

    def _reduce_and_update(self, trainable: Tensors, grads: Tensors, buf: Dict[str, Any]):
        """The optimizer step over the data group: the gradients mean
        all-reduced, or under ZeRO-1 reduce-scattered to this rank's slice,
        the chain on the slices, the leaves all-gathered."""
        if self.mesh is None:
            return self.tx.step(trainable, grads, buf["opt"], buf["step"])
        params, part = {}, {}
        whole = [k for k in trainable if self.zero_dims[k] is None]
        for k, g in zip(whole, _coll.mean_all_reduce([grads[k] for k in whole], self.group)):
            params[k], part[k] = trainable[k], g
        for k, v in trainable.items():
            dim = self.zero_dims[k]
            if dim is not None:
                params[k] = self._zero_slice(v, dim)
                part[k] = _coll.reduce_scatter_dim(grads[k], dim, self.group).div_(self.world)
        lr = self.tx.step(params, part, buf["opt"], buf["step"],
                          self._norms if self.zero1 else leaf_norms)
        for k, v in trainable.items():
            if self.zero_dims[k] is not None:
                v.copy_(_coll.all_gather_dim(params[k], self.zero_dims[k], self.group))
        return lr

    # -- the steps -----------------------------------------------------------------

    def _axis_sums(self, grads: Tensors) -> Tensors:
        """Each rank's part of a gradient summed over the model group (a
        block leaf under sequence parallelism) and over the pipe group (every
        leaf under GPipe): the whole gradient on every rank."""
        if self.seq:
            grads = {k: _coll.sum_all_reduce(g, self.mesh.model_group)
                     if ".blocks." in f".{k}" or sp_partial(k) else g for k, g in grads.items()}
        if self.pipe > 1:
            grads = {k: _coll.sum_all_reduce(g, self.mesh.pipe_group) for k, g in grads.items()}
        return grads

    def _train_body(self, buf: Dict[str, Any]):
        """One step on the state buffers of ``buf``, in place; returns the
        loss (the group's mean) and the learning rate it used."""
        with self._shard(buf["x"].shape[0]):
            loss, grads = self._loss_and_grads(buf)
        trainable = buf["trainable"]
        with torch.no_grad():
            grads = self._axis_sums(grads)
            lr = self._reduce_and_update(trainable, grads, buf)
            if self.mesh is not None:
                loss = _coll.psum_mean(loss, self.group)
            if self.state.ema is not None:
                ema_update_(buf["ema"], trainable, self.state.ema.decay)
            if self.state.swa is not None:
                swa_update_(SwaState(buf["swa_average"], buf["swa_count"]), trainable,
                            buf["swa_on"])
            buf["finite"].logical_and_(torch.isfinite(loss))
            buf["step"].add_(1)
        return loss.detach(), lr

    def _loss_and_grads(self, buf: Dict[str, Any]):
        """The loss of this rank's rows and its gradients."""
        if self.transform is not None:
            noise = (_dist.draw_rows(lambda s: self.transform.noise(s, self.noise_generator),
                                     buf["x"].shape)
                     if self.noise_generator is not None else None)
            x = self.transform(buf["x"], buf["aug"], noise)
        else:
            x = self._normalize(buf["x"], buf.get("flip"))
        y = buf["y"]
        if self.use_mixup:
            x, y = mixup_cutmix(x, y, self.num_classes, buf["mix"], self.smoothing, self._roll)
        trainable = buf["trainable"]
        for v in trainable.values():
            v.requires_grad_()
        kw = {}
        if self.use_dropblock:
            # the anneal's position, step / total steps, computed on the device
            total = torch.full((), float(self.total_steps), dtype=torch.float32,
                               device=self.device)
            kw = {"progress": buf["step"].to(torch.float32) / total,
                  "generator": self.drop_generator}
        elif self.drop_path:
            kw = {"generator": self.drop_generator}
        variables = self._variables(trainable, buf["bn"], buf["scales"])
        drive = 1.0
        if self.seq:  # the whole leaves cut at use
            with tp_context(self.mesh, sequence_parallel=True):
                logits = self.apply_fn(tp_place(self.mesh, variables), x, True, **kw)
        elif self.pipe > 1:
            logits = vit_pipeline_forward(self.model, variables, x,
                                          microbatches=self.pp_microbatches,
                                          transport=self.transport)
            # the last stage's loss drives the backward (see the module docstring)
            drive = float(self.mesh.pipe_rank == self.pipe - 1)
        else:
            logits = self.apply_fn(variables, x, True, **kw)
        loss = self.criterion(logits.to(torch.float32), y)
        grads = torch.autograd.grad(loss * drive if drive != 1.0 else loss,
                                    list(trainable.values()), allow_unused=True)
        return loss, {k: torch.zeros_like(v) if g is None else g
                      for (k, v), g in zip(trainable.items(), grads)}

    def _state_buffers(self) -> Dict[str, Any]:
        s = self.state
        return {
            "trainable": s.trainable, "opt": s.opt_state, "step": s.step,
            "ema": s.ema.shadow if s.ema is not None else {},
            "swa_average": s.swa.average if s.swa is not None else {},
            "swa_count": s.swa.count if s.swa is not None else torch.zeros(
                (), dtype=torch.int32, device=self.device),
            "bn": s.batch_stats or {}, "finite": s.finite,
        }

    def _adopt(self, buf: Dict[str, Any]) -> None:
        """Make the state the tensors of ``buf`` (a graph's static buffers)."""
        s = self.state
        self.state = FullTrainState(
            buf["trainable"], buf["opt"], buf["step"],
            s.ema._replace(shadow=buf["ema"]) if s.ema is not None else None,
            SwaState(buf["swa_average"], buf["swa_count"]) if s.swa is not None else None,
            buf["bn"] if self.has_bn else None, buf["finite"])

    def _draws(self, x: torch.Tensor) -> Dict[str, Any]:
        """The step's random inputs from the generator: the timm
        augmentation's host draws, or the flip of a uint8 batch; then the
        mixup/cutmix draws.  Over a data group the draws of the global
        batch, cut to this rank's rows."""
        out: Dict[str, Any] = {}
        rows, total = self._rows(x.shape[0]), x.shape[0] * self.world
        if self.transform is not None:
            drawn = self.transform.draw(self.generator, (total, *x.shape[1:]))
            out["aug"] = {k: v[rows].to(x.device) for k, v in drawn.items()}
        elif x.dtype == torch.uint8 and self.do_flip:
            out["flip"] = (torch.rand(total, generator=self.generator)[rows] < 0.5).to(x.device)
        if self.use_mixup:
            d = draw_mixup_cutmix(self.generator, self.mixup_alpha, self.cutmix_alpha,
                                  self.switch_prob, x.shape[1], x.shape[2])
            out["mix"] = {"use_cutmix": torch.tensor(d["use_cutmix"], device=x.device),
                          "lam_mix": torch.tensor(d["lam_mix"], dtype=torch.float32,
                                                  device=x.device),
                          "lam_cut": torch.tensor(d["lam_cut"], dtype=torch.float32,
                                                  device=x.device),
                          "cy": torch.tensor(d["cy"], dtype=torch.int32, device=x.device),
                          "cx": torch.tensor(d["cx"], dtype=torch.int32, device=x.device)}
        return out

    def _scales(self, x: torch.Tensor) -> Tensors:
        """The static activation scales, calibrated on the epoch's first
        batch (without the flip, as the JAX trainer calibrates)."""
        if not self.int8_static:
            return {}
        if self._qscale is None:
            s = self.state
            variables = merge_params(s.trainable, self.frozen)
            if self.has_bn:
                variables.update(s.batch_stats)
            amax_over = self._amax_over if self.mesh is not None else None  # the global batch's
            apply_fn, ctx = self.apply_fn, contextlib.nullcontext()
            if self.seq:  # the sequence-parallel forward, on the leaves cut at use
                def apply_fn(v, xx, train):
                    return self.apply_fn(tp_place(self.mesh, v), xx, train)

                ctx = tp_context(self.mesh, sequence_parallel=True)
            with self._shard(x.shape[0]), ctx:
                self._qscale = _train.calibrate(self.model, apply_fn, variables,
                                                self._normalize(x), self.calib_margin,
                                                amax_over)
        return self._qscale

    def _amax_over(self, t: torch.Tensor) -> torch.Tensor:
        """An absmax over the data group and, under sequence parallelism,
        the model group (each rank sees its tokens, or its heads' columns)."""
        t = _coll.max_all_reduce(t, self.group)
        return _coll.max_all_reduce(t, self.mesh.model_group) if self.seq else t

    def train_step(self, x, y, epoch: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step on the host batch ``(x, y)``; returns the loss
        and the learning rate (device tensors; a replay's are overwritten by
        the next replay)."""
        x, y = self._on_device(x), self._on_device(y)
        inputs = {"x": x, "y": y, **self._draws(x), "scales": self._scales(x),
                  "swa_on": torch.tensor(self.swa_begin >= 0 and epoch >= self.swa_begin,
                                         device=self.device)}
        if self.eager or not _train.runs_captured(x):
            return self._train_body({**self._state_buffers(), **inputs})
        key = ("train", tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
        graph = self.graphs.get(key)
        if graph is None or not graph.holds(tuple(self._keep())):
            self.graphs.pop(key, None)
            if self.mesh is not None:  # the communicator exists before a capture
                _dist.barrier()
            graph = self.graphs[key] = _train.StepGraph(
                self._train_body, {**self._state_buffers(), **inputs}, keep=self._keep(),
                generators=tuple(g for g in (self.noise_generator, self.drop_generator)
                                 if g is not None))
            self._sync(graph, force=True)
        else:
            self._sync(graph)
        return graph(**inputs)

    def _on_device(self, a) -> torch.Tensor:
        return (a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))).to(self.device)

    def _keep(self):
        return [*self.frozen.values(), *self.qtree.values()]

    def _sync(self, graph, force: bool = False) -> None:
        """Copy the state into ``graph``'s buffers unless it lives there, and
        adopt them as the state."""
        if force or self.state.step is not graph.inputs["step"]:
            buf = self._state_buffers()
            with torch.no_grad():
                for name in ("trainable", "opt", "ema", "swa_average", "bn"):
                    for k, t in buf[name].items():
                        graph.inputs[name][k].copy_(t)
                for name in ("step", "swa_count", "finite"):
                    graph.inputs[name].copy_(buf[name])
            self._adopt(graph.inputs)

    @torch.no_grad()
    def eval_logits(self, trainable: Tensors, x, loaded: Optional[set] = None) -> torch.Tensor:
        """The eval-mode logits of the host batch ``x`` under ``trainable``
        (the raw, EMA or SWA leaves): a replay of the eval graph of ``x``'s
        shape on the card, which copies ``trainable`` in unless its key is in
        ``loaded`` (the graphs an eval pass has loaded them into; the key is
        added).  The int8 tree rides along; the static scales do not (the
        JAX eval step passes the parameters only)."""
        x = self._on_device(x)
        bn = self.state.batch_stats or {}

        def body(inputs):
            with torch.no_grad():
                return self.apply_fn(self._variables(inputs["trainable"], inputs["bn"], {}),
                                     self._normalize(inputs["x"]), False)

        inputs = {"trainable": trainable, "bn": bn, "x": x}
        if self.eager or not _train.runs_captured(x):
            return body(inputs)
        key = ("eval", tuple(x.shape), x.dtype)
        graph = self.graphs.get(key)
        if graph is None or not graph.holds(tuple(self._keep())):
            self.graphs.pop(key, None)
            graph = self.graphs[key] = _train.StepGraph(body, inputs, keep=self._keep())
        if loaded is not None and key in loaded:
            return graph(x=x)
        if loaded is not None:
            loaded.add(key)
        return graph(**inputs)

    # -- the host loop ---------------------------------------------------------

    def _preempt_agreed(self) -> bool:
        """Whether to stop at this boundary: the SIGTERM flag, over several
        processes the OR of the ranks' flags (a host all-gather), so that
        every rank saves at the same boundary or none does."""
        if _dist.world_size() == 1:
            return self._preempted
        return bool(np.max(_coll.host_allgather(np.asarray(self._preempted, np.int32))))

    def _check_finite(self, epoch: int, i: int, x, y) -> None:
        """Abort with a forensic dump when any step since init went
        non-finite."""
        if bool(self.state.finite):
            return
        rank = f"_rank{_dist.rank()}" if _dist.world_size() > 1 else ""
        dump_nan_state(f"{self.cfg.OUTPUT_DIR}/nan_dump_e{epoch}_i{i}{rank}.npz", x=x, y=y)
        raise FloatingPointError(
            f"NaN/Inf loss detected by epoch {epoch} iter {i} (see the forensic dump; with "
            "STEPS_PER_DISPATCH > 1 the dump holds the whole (K, B, ...) chunk)")

    def train_one_epoch(self, batches: Iterator, epoch: int, start_batch: int = 0,
                        checkpoint_dir: Optional[str] = None) -> Dict[str, float]:
        cfg = self.cfg
        losses, seen = [], 0
        if self.int8_static:
            # recalibrate the static scales at every epoch start: the
            # trained leaves move the layers' input ranges, and stale scales
            # saturate
            self._qscale = None
        consumed = int(start_batch)
        ckpt_every = int(cfg.TRAIN.get("CHECKPOINT_EVERY_STEPS", 0)) if checkpoint_dir else 0
        t_start = time.time()
        k_disp = int(cfg.TPU.get("STEPS_PER_DISPATCH", 1))
        if k_disp > 1:
            batches = _chunk_batches(batches, k_disp)
        depth = int(cfg.TPU.get("PREFETCH_DEPTH", 2))
        if depth > 0:
            # the card: pinned staging and a side-stream copy, depth items
            # ahead; the CPU: the items as they are
            batches = prefetch_to_device(batches, self.device, depth)
        x = y = loss = None
        i = -1
        for i, item in enumerate(batches):
            if len(item) == 3:  # a stacked (K, B, ...) chunk: one copy, K replays
                x, y = self._on_device(item[0]), self._on_device(item[1])
                for j in range(x.shape[0]):
                    loss, _ = self.train_step(x[j], y[j], epoch)
                seen += x.shape[0] * x.shape[1]
                k_item = x.shape[0]
            else:
                x, y = item
                loss, _ = self.train_step(x, y, epoch)
                seen += x.shape[0]
                k_item = 1
            consumed += k_item
            crossed = ckpt_every > 0 and (consumed // ckpt_every) > ((consumed - k_item)
                                                                      // ckpt_every)
            if crossed:
                self._check_finite(epoch, i, x, y)
                self.save(checkpoint_dir, epoch, batch_in_epoch=consumed)
            # the preemption poll: a local flag in one process; over several a
            # host collective, so only at checkpoint crossings and PRINT_FREQ
            # boundaries, never every step
            if checkpoint_dir and (_dist.world_size() == 1 or crossed
                                   or (i + 1) % int(cfg.PRINT_FREQ) == 0) and (
                    self._preempt_agreed()):
                # SIGTERM: flush an exact-step checkpoint and stop; the
                # restarted run resumes this very batch
                self._check_finite(epoch, i, x, y)
                self.save(checkpoint_dir, epoch, batch_in_epoch=consumed)
                raise PreemptedError(
                    f"SIGTERM: checkpointed at epoch {epoch} batch {consumed} and stopped")
            if (i + 1) % int(cfg.PRINT_FREQ) == 0 or i == 0:
                loss_v = float(loss)  # the host fetch: a sync point
                losses.append(loss_v)
                self._check_finite(epoch, i, x, y)
                logger.info("Epoch[%d] iter %d: loss %.4f lr %.3g (%.1f samples/s)", epoch, i,
                            loss_v, float(self.schedule(self.state.step)),
                            seen / max(time.time() - t_start, 1e-9))
        self._check_finite(epoch, i, x, y)
        dt = time.time() - t_start
        if i < 0 and start_batch == 0:
            logger.warning("Epoch[%d]: the input yielded no batch (a dataset smaller than "
                           "the batch?)", epoch)
        return {"loss": float(np.mean(losses)) if losses else float("nan"),
                "samples_per_sec": seen / max(dt, 1e-9), "epoch_time": dt}

    def evaluate(self, batches: Iterator, use_ema: bool = False, use_swa: bool = False,
                 metric: Optional[str] = None) -> float:
        """A full test pass (lib/core/function.py:173-279): top-1 (and top-5,
        logged) for integer targets; the dataset metric (``get_metric``) for
        (B, C) multilabel targets or when ``metric`` names one."""
        from .metrics import get_metric

        trainable = self.state.trainable
        if use_ema and self.state.ema is not None:
            trainable = self.state.ema.shadow
        if use_swa and self.state.swa is not None:
            trainable = self.state.swa.average
        all_logits, all_y, loaded = [], [], set()
        for x, y in batches:
            all_logits.append(
                self.eval_logits(trainable, x, loaded).to(torch.float32).cpu().numpy())
            all_y.append(y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y))
        if not all_logits and self.mesh is None:
            return 0.0
        if all_logits:
            scores, target = np.concatenate(all_logits), np.concatenate(all_y)
        else:  # an empty stripe still takes part in the gather
            scores = np.zeros((0, self.num_classes), np.float32)
            target = np.zeros((0,), np.int64)
        if self.mesh is not None:
            # each rank scored its stripe of the test set: combine them
            scores, target = _coll.allgather_ragged(scores), _coll.allgather_ragged(target)
            if scores.shape[0] == 0:
                return 0.0
        if metric is None and target.ndim == 2:
            metric = "11point_mAP"
        if metric is not None and metric not in ("accuracy", "top1"):
            return get_metric(metric)(scores, target)
        ranked = np.argsort(-scores, axis=-1)
        top1 = 100.0 * float((ranked[:, 0] == target).mean())
        k = min(5, scores.shape[-1])
        top5 = 100.0 * float((ranked[:, :k] == target[:, None]).any(-1).mean())
        logger.info("=> eval top1 %.3f top5 %.3f", top1, top5)
        return top1

    @torch.no_grad()
    def update_bn(self, batches, trainable: Optional[Tensors] = None) -> Optional[Tensors]:
        """torch.optim.swa_utils.update_bn (tools/swa_finetune.py:74-304): the
        BN running statistics become the equal-weight average of the batch
        statistics over ``batches``, under ``trainable`` (default the SWA
        average, else the trained leaves).  As in the JAX trainer, one batch's
        train-mode forward from all-zero and all-one statistics measures each
        statistic's momentum m (new = m old + (1 - m) batch), and each batch
        statistic is new0 / (1 - m).  A DropBlock or drop-path backbone runs
        its masks live, as torch's update_bn runs train-mode regularizers, each
        pass drawing from a generator seeded 0 (the JAX trainer's ``PRNGKey(0)``) at the
        target keep probability.  Installs and returns the statistics."""
        if not self.has_bn:
            return None
        if trainable is None:
            trainable = (self.state.swa.average if self.state.swa is not None
                         else self.state.trainable)

        def batch_pass(stats: Tensors, x) -> Tensors:
            stats = {k: v.clone() for k, v in stats.items()}
            x = self._normalize(self._on_device(x))
            kw = ({"generator": torch.Generator(device=self.device).manual_seed(0)}
                  if self.use_dropblock or self.drop_path else {})
            with self._shard(x.shape[0]):  # the global batch's moments
                self.apply_fn(self._variables(trainable, stats, {}), x, True, **kw)
            return stats

        zeros = {k: torch.zeros_like(v) for k, v in self.state.batch_stats.items()}
        ones = {k: torch.ones_like(v) for k, v in self.state.batch_stats.items()}
        total, count, momentum = None, 0, None
        for x, _ in batches:
            n0 = batch_pass(zeros, x)
            if momentum is None:
                n1 = batch_pass(ones, x)
                momentum = {k: n1[k] - n0[k] for k in n0}
            stat = {k: n0[k] / torch.clamp(1.0 - momentum[k], min=1e-6) for k in n0}
            total = stat if total is None else {k: total[k] + stat[k] for k in total}
            count += 1
        if total is None:
            return None
        new = {k: t / count for k, t in total.items()}
        for k, t in new.items():
            self.state.batch_stats[k].copy_(t)
        return self.state.batch_stats

    # -- checkpointing -----------------------------------------------------------

    def _ckpt_state(self, epoch: int = 0, batch_in_epoch: int = 0,
                    whole: bool = True) -> Dict[str, Any]:
        """The checkpoint's dict; ``whole``: the optimizer state's ZeRO-1
        slices gathered (a collective)."""
        s = self.state
        out = {
            "trainable": s.trainable,
            "opt_state": self._whole_opt(s.opt_state) if whole else s.opt_state,
            "step": s.step,
            "epoch": torch.tensor(epoch, dtype=torch.int32),
            # raw batches already trained in `epoch` (0: the epoch is
            # complete) and the generator, so that a resumed run replays the
            # remaining data order and draws exactly
            "batch_in_epoch": torch.tensor(batch_in_epoch, dtype=torch.int32),
            "rng": self.generator.get_state(),
        }
        if self.noise_generator is not None:
            out["noise_rng"] = self.noise_generator.get_state()
        if self.drop_generator is not None:
            out["drop_rng"] = self.drop_generator.get_state()
        if s.ema is not None:
            out["ema_shadow"] = s.ema.shadow
        if s.swa is not None:
            out["swa_average"] = s.swa.average
            out["swa_count"] = s.swa.count
        if self.has_bn:
            out["batch_stats"] = s.batch_stats
        return out

    def save(self, directory: str, epoch: int, batch_in_epoch: int = 0) -> None:
        """Checkpoint under the global step (unique and increasing for
        mid-epoch saves).  A save that repeats what is on disk for this step
        is skipped; one that only advances the batch position overwrites.
        Over several processes rank 0 writes the whole leaves and the ranks
        meet at a barrier."""
        index = int(self.state.step)
        prev_batch = None
        if index == getattr(self, "_last_saved_index", None):
            prev_batch = self._last_saved_batch
        elif getattr(self, "_last_saved_index", None) is None and (
                index == getattr(self, "_resumed_index", None)):
            prev_batch = self.resume_batch_in_epoch
        if prev_batch is not None and prev_batch == batch_in_epoch:
            return
        state = self._ckpt_state(epoch, batch_in_epoch)
        if _dist.is_main_process():
            save_checkpoint(directory, index, state, overwrite=prev_batch is not None)
        _dist.barrier()
        self._last_saved_index = index
        self._last_saved_batch = batch_in_epoch

    def maybe_resume(self, directory: str) -> Optional[int]:
        """Under ``TRAIN.AUTO_RESUME``, restore the latest checkpoint of
        ``directory``; returns its epoch (None: nothing to resume).  Keys a
        checkpoint predates (swa, ema, batch_stats, rng, batch_in_epoch) stay
        fresh."""
        if not bool(self.cfg.TRAIN.AUTO_RESUME):
            return None
        from .checkpoint import checkpoint_keys, latest_step

        step = latest_step(directory)
        if step is None:
            return None
        template = self._ckpt_state(whole=False)  # only its devices and dtypes matter
        stored = checkpoint_keys(directory, step)
        if stored is not None:
            template = {k: v for k, v in template.items() if k in stored}
        restored = restore_checkpoint(directory, template, step=step)
        if restored is None:
            return None
        self._resumed_index = step
        s = self.state
        ema = s.ema
        if ema is not None and "ema_shadow" in restored:
            ema = ema._replace(shadow=restored["ema_shadow"])
        swa = s.swa
        if swa is not None and "swa_average" in restored:
            swa = SwaState(restored["swa_average"], restored["swa_count"])
        bn = s.batch_stats
        if self.has_bn and "batch_stats" in restored:
            bn = restored["batch_stats"]
        self.state = FullTrainState(restored["trainable"], self._cut_opt(restored["opt_state"]),
                                    restored["step"], ema, swa, bn,
                                    torch.ones((), dtype=torch.bool, device=self.device))
        if "rng" in restored:
            self.generator.set_state(restored["rng"])
        if self.noise_generator is not None and "noise_rng" in restored:
            self.noise_generator.set_state(restored["noise_rng"])
        if self.drop_generator is not None and "drop_rng" in restored:
            self.drop_generator.set_state(restored["drop_rng"])
        self.resume_batch_in_epoch = int(restored.get("batch_in_epoch", 0))
        return int(restored["epoch"])

    def fit(self, train_batches_fn: Callable, eval_batches_fn: Callable[[], Iterator],
            checkpoint_dir: Optional[str] = None, tb_log_dir: Optional[str] = None) -> float:
        """The epoch loop from ``TRAIN.BEGIN_EPOCH`` (or the resumed position)
        to ``TRAIN.END_EPOCH``: train, evaluate from ``EVAL_BEGIN_EPOCH``
        (raw and, with EMA, the shadow), checkpoint each epoch, and at the
        end the SWA average (with the BN refresh); returns the best top-1.
        ``train_batches_fn(epoch)`` gives an epoch's batches;
        ``train_batches_fn(epoch, start)`` from batch ``start`` where it can
        seek.  A SIGTERM checkpoints at the next step boundary and raises
        ``PreemptedError``."""
        cfg = self.cfg
        begin = int(cfg.TRAIN.BEGIN_EPOCH)
        start_batch = 0
        if checkpoint_dir:
            resumed = self.maybe_resume(checkpoint_dir)
            if resumed is not None:
                start_batch = getattr(self, "resume_batch_in_epoch", 0)
                # a mid-epoch checkpoint re-enters that epoch at the batch;
                # an end-of-epoch checkpoint starts the next one
                begin = resumed if start_batch > 0 else resumed + 1
                if start_batch:
                    logger.info("=> resuming mid-epoch: epoch %d batch %d", begin, start_batch)
        tb = None
        if tb_log_dir:
            from ..utils.tb import create_scalar_writer

            tb = create_scalar_writer(tb_log_dir)
        prev_handler = None
        if checkpoint_dir:
            import signal

            def _on_sigterm(signum, frame):
                logger.warning("=> SIGTERM: will checkpoint at the next step boundary and stop")
                self._preempted = True

            try:
                prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
            except ValueError:
                prev_handler = None  # not the main thread: flag-only mode
        best = 0.0
        try:
            for epoch in range(begin, int(cfg.TRAIN.END_EPOCH)):
                sb, start_batch = start_batch, 0
                if sb:
                    try:
                        batches = train_batches_fn(epoch, sb)
                    except TypeError:
                        batches = _skip_batches(train_batches_fn(epoch), sb)
                else:
                    batches = train_batches_fn(epoch)
                stats = self.train_one_epoch(batches, epoch, start_batch=sb,
                                             checkpoint_dir=checkpoint_dir)
                logger.info("=> Epoch %d done: loss %.4f (%.1f samples/s)", epoch,
                            stats["loss"], stats["samples_per_sec"])
                if tb is not None:
                    tb.scalar("train_loss", stats["loss"], epoch)
                    tb.scalar("train_samples_per_sec", stats["samples_per_sec"], epoch)
                    tb.scalar("lr", float(self.schedule(self.state.step)), epoch)
                if epoch >= int(cfg.TRAIN.EVAL_BEGIN_EPOCH):
                    acc = self.evaluate(eval_batches_fn())
                    best = max(best, acc)
                    logger.info("=> Epoch %d val acc %.3f (best %.3f)", epoch, acc, best)
                    if tb is not None:
                        tb.scalar("valid_top1", acc, epoch)
                    if float(cfg.TRAIN.EMA_DECAY) > 0:
                        ema_acc = self.evaluate(eval_batches_fn(), use_ema=True)
                        logger.info("=> Epoch %d EMA acc %.3f", epoch, ema_acc)
                        if tb is not None:
                            tb.scalar("valid_top1_ema", ema_acc, epoch)
                        best = max(best, ema_acc)
                if checkpoint_dir:
                    self.save(checkpoint_dir, epoch)
                    if self._preempt_agreed():
                        # SIGTERM during the epoch's tail or the eval: the
                        # end-of-epoch checkpoint is the resume point
                        raise PreemptedError(
                            f"SIGTERM: checkpointed completed epoch {epoch} and stopped")
            if self.state.swa is not None:
                if self.has_bn:
                    self.update_bn(train_batches_fn(int(cfg.TRAIN.END_EPOCH)))
                swa_acc = self.evaluate(eval_batches_fn(), use_swa=True)
                logger.info("=> SWA acc %.3f", swa_acc)
                if tb is not None:
                    tb.scalar("valid_top1_swa", swa_acc, int(cfg.TRAIN.END_EPOCH))
                best = max(best, swa_acc)
        finally:
            if prev_handler is not None:
                import signal

                signal.signal(signal.SIGTERM, prev_handler)
        if tb is not None:
            tb.close()
        return best


def _skip_batches(batches, n: int):
    """Drop the first ``n`` raw batches of an epoch iterator (counting K per
    pre-chunked (K, B, ...) item): the mid-epoch resume of a source that
    cannot seek.  The skipped items are consumed, so the data order past the
    skip is the uninterrupted run's."""
    it = iter(batches)
    consumed = 0
    while consumed < n:
        item = next(it, None)
        if item is None:
            return
        consumed += item[0].shape[0] if len(item) == 3 else 1
    yield from it


def _chunk_batches(batches, k: int):
    """Group consecutive equal-shape (x, y) batches into (K, B, ...) stacks;
    tails (fewer than k, or a ragged last batch) pass through unstacked."""
    buf = []
    for item in batches:
        if len(item) == 3:  # already a tagged (K, B, ...) chunk
            yield from buf
            buf = []
            yield item
            continue
        x, y = item
        if buf and x.shape != buf[-1][0].shape:
            yield from buf
            buf = []
            yield (x, y)
            continue
        buf.append((x, y))
        if len(buf) == k:
            yield (np.stack([b[0] for b in buf]), np.stack([b[1] for b in buf]), True)
            buf = []
    yield from buf


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = True):
    """Host batches of (x, y), shuffled by ``np.random.RandomState(seed)`` as
    the JAX iterator shuffles them."""
    n = len(x)
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    end = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, end, batch_size):
        j = idx[i: i + batch_size]
        yield x[j], y[j]
