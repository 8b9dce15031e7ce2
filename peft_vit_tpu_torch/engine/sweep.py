"""The lr x wd hyper-parameter sweep (counterpart of ``peft_vit_tpu/engine/sweep.py``).

Reference protocol (evaluation/adapter_tuning_clip.py, written once here as
in the JAX package):

* outer: lr in logspace(-6, -1, 6)                    (:406-426)
* inner: wd in logspace(lo, hi, 97); evaluate the 7 coarse points that lie
  on logspace(lo, hi, 7), take the peak, then binary-refine with spans
  8, 4, 2, 1 around the peak                          (:173-225)
* each cell trains a FRESH model for END_EPOCH epochs with step-decay lr
  and reports best (or last) val score                (:228-280)
* failures score 0 (NaN -> 0)
* final run: merge train+val, add EXTRA_FINAL_TRAIN_EPOCH, train once with
  the winning (lr, wd), evaluate on test              (:429-481)

``TRAIN.VMAP_SWEEP`` keeps the JAX package's meaning: it decides which cells
form a round (every new coarse or refinement probe of one lr together, else
one cell a round) and so how a round's initial trainables are drawn (a
``CellKey`` per cell: its round's size and its index in it).  As the JAX
engine vmaps a round's cells into one program, a round here trains its cells
together (``engine.train``'s ``cells``): their states stacked on a leading
axis, one forward and backward per batch under ``torch.func.vmap``, the
frozen tower's GEMMs over every cell's rows at once, one SGD update with one
lr and wd per cell, and one vmapped eval an epoch.  A diverging cell touches
no other: every cell's rows and leaves are its own.  The final run trains
one cell.  On the card every step and eval batch is a CUDA-graph replay; the
engine keeps one graph per (kind, round size, batch) in ``graphs`` and
frees them with itself.

``SWEEP.REF_COMPAT=True`` replays the reference's refine loop verbatim,
including its left-wd bug (every refine probe trains with the LEFT
candidate's wd) and its re-probes; the default trains each candidate with
its own wd.

The model's trainable leaves come from ``init_trainable(CellKey)``; the
frozen tower stays in the module and ``frozen`` names what a step
substitutes for it (the int8 tree under ``TPU.INT8_FWD_TRAIN``, quantized
once for the whole sweep and shared by every cell).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .metrics import get_metric
from .train import (
    ApplyFn,
    ArrayTask,
    PerExampleCriterion,
    TrainCellState,
    init_cell_state,
    make_epoch_fn,
    make_eval_fn,
    step_decay_lr,
)

logger = logging.getLogger(__name__)


class CellKey(NamedTuple):
    """Which initial trainables a cell draws: cell ``index`` of a round of
    ``round_size`` cells trained from ``seed`` (the JAX engine's
    ``split(PRNGKey(seed), round_size)[index]``), or, with ``round_size``
    None, the final run's one cell (``PRNGKey(seed)``)."""

    seed: int
    round_size: Optional[int]
    index: int = 0

    def generator(self) -> torch.Generator:
        """A CPU generator seeded from the key alone, so that every device
        draws the same initial trainables."""
        words = [self.seed, 0 if self.round_size is None else 1, self.round_size or 0, self.index]
        state = np.random.SeedSequence(words).generate_state(1, np.uint64)[0]
        return torch.Generator().manual_seed(int(state))


InitTrainable = Callable[[CellKey], Mapping[str, torch.Tensor]]


class SweepEngine:
    """Drives the sweep for one (model, task) pair.

    Args:
      apply_fn: ``apply_fn(variables, x, train) -> logits``
        (``engine.train.make_apply_fn``).
      init_trainable: ``init_trainable(CellKey) -> {name: tensor}``, fresh
        per cell, mirroring the reference's fresh ``Classifier(config, 0)``
        per cell.
      frozen: the tensors a step substitutes for frozen ones ({}: the
        module's own).
      criterion: per-example loss.
      bn_template: the BN statistics every cell starts from, by buffer name
        (``bn_mean`` / ``bn_var``: the channel-BN head's and a CNN tower's,
        which the few-shot step runs in train mode as the JAX step does);
        each cell trains its own copy.  None: no BN.
      qkernel: the int8 tree of ``ops.int8.quantize_frozen_tree``, merged
        into ``frozen`` for every cell.
    """

    def __init__(
        self,
        cfg,
        apply_fn: ApplyFn,
        init_trainable: InitTrainable,
        frozen: Mapping[str, torch.Tensor],
        criterion: PerExampleCriterion,
        batch_size: Optional[int] = None,
        metric: str = "accuracy",
        bn_template: Optional[Mapping[str, torch.Tensor]] = None,
        qkernel: Optional[Mapping[str, torch.Tensor]] = None,
    ):
        self.cfg = cfg
        self.metric = metric
        self._metric_fn = get_metric(metric)
        self.frozen = {**frozen, **(qkernel or {})}
        self.init_trainable = init_trainable
        self.criterion = criterion
        self.bn_template = bn_template
        has_bn = bn_template is not None
        self.batch_size = batch_size or int(cfg.TRAIN.BATCH_SIZE_PER_GPU)
        self.schedule = tuple(int(m) for m in cfg.TRAIN.SCHEDULE)

        lr_scale = None
        if bool(cfg.TRAIN.TWO_LR):
            # backbone at 0.1x lr, head at lr (optim/build.py:102-117)
            names = init_trainable(CellKey(0, None))
            lr_scale = {k: 1.0 if k.startswith("classifier.") else 0.1 for k in names}
        #: the CUDA graphs of the steps and evals, one per (kind, round size,
        #: batch); they hold their own device memory until the engine goes
        self.graphs: Dict[tuple, object] = {}
        epoch = dict(momentum=float(cfg.TRAIN.MOMENTUM), nesterov=bool(cfg.TRAIN.NESTEROV),
                     lr_scale=lr_scale, has_bn=has_bn, graphs=self.graphs)
        self._epoch_fn = make_epoch_fn(apply_fn, criterion, self.batch_size, **epoch)
        self._epoch_cells = make_epoch_fn(apply_fn, criterion, self.batch_size, cells=True,
                                          **epoch)
        self._eval_fn = make_eval_fn(apply_fn, self.batch_size, has_bn=has_bn,
                                     graphs=self.graphs)
        self._eval_cells = make_eval_fn(apply_fn, self.batch_size, has_bn=has_bn, cells=True,
                                        graphs=self.graphs)

    # -- scoring --------------------------------------------------------------

    def _score_cells(self, logits: torch.Tensor, y: torch.Tensor,
                     valid: torch.Tensor) -> np.ndarray:
        """Score each cell's (N, C) logits of the (cells, N, C) ``logits`` with
        the dataset metric: top-1 on integer labels on the device (one host
        read for the round), every other metric on the host over the valid
        rows (a cell's non-finite logits score 0)."""
        if self.metric in ("accuracy", "top1") and y.dim() == 1:
            correct = (logits.argmax(dim=-1) == y) & valid
            return (100.0 * correct.sum(dim=-1) / valid.sum().clamp_min(1)).cpu().numpy()
        v = valid.cpu().numpy()
        scores = logits.float().cpu().numpy()[:, v]
        target = y.cpu().numpy()[v]
        if self.metric in ("accuracy", "top1") and target.ndim == 2:
            target = target.argmax(-1)  # one-hot multiclass scored as top-1
        return np.array([float(self._metric_fn(s, target)) if np.isfinite(s).all() else 0.0
                         for s in scores], np.float64)

    def _score(self, logits: torch.Tensor, y: torch.Tensor, valid: torch.Tensor) -> float:
        """Score one cell's (N, C) logits (``_score_cells``)."""
        return float(self._score_cells(logits[None], y, valid)[0])

    def evaluate(self, state: TrainCellState, x: torch.Tensor) -> torch.Tensor:
        """Logits of ``state`` over the device-resident ``x``."""
        return self._eval_fn(state.trainable, self.frozen, x, state.bn)

    def _train(self, key: CellKey, lr: float, wd: float, task: ArrayTask,
               perms: Sequence[np.ndarray]):
        """One cell from its initial trainables, one epoch per permutation:
        yields ``(state, val score)`` after each epoch."""
        device = task.x_train.device
        trainable = {k: v.detach().to(device=device, dtype=torch.float32)
                     for k, v in self.init_trainable(key).items()}
        state = init_cell_state(trainable, self.bn_template)
        for epoch, perm in enumerate(perms):
            state, _ = self._epoch_fn(
                state, self.frozen, task.x_train, task.y_train, task.valid_train,
                perm, step_decay_lr(lr, epoch, self.schedule), wd,
            )
            yield state, self._score(self.evaluate(state, task.x_val), task.y_val,
                                     task.valid_val)

    @staticmethod
    def _perms(n: int, end_epoch: int, seed: int) -> List[np.ndarray]:
        rng = np.random.RandomState(seed)
        return [rng.permutation(n) for _ in range(end_epoch)]

    # -- cell training ------------------------------------------------------

    def train_cells(
        self,
        lrs: Sequence[float],
        wds: Sequence[float],
        task: ArrayTask,
        end_epoch: int,
        seed: int = 0,
    ) -> np.ndarray:
        """Train the round of ``len(lrs)`` cells together; returns their val
        scores (%): the best over the epochs, or the last
        (``SEARCH_RESULT_ON_LAST_EPOCH``)."""
        k = len(lrs)
        assert k == len(wds)
        device = task.x_train.device
        perms = self._perms(task.x_train.shape[0], end_epoch, seed)
        draws = [self.init_trainable(CellKey(seed, k, i)) for i in range(k)]
        trainable = {name: torch.stack([d[name].detach() for d in draws]).to(
            device=device, dtype=torch.float32) for name in draws[0]}
        bn = None if self.bn_template is None else {
            name: v.expand(k, *v.shape) for name, v in self.bn_template.items()}
        state = init_cell_state(trainable, bn)
        wd = torch.tensor([float(w) for w in wds], dtype=torch.float32)
        best = np.zeros((k,), np.float64)
        last = np.zeros((k,), np.float64)
        for epoch, perm in enumerate(perms):
            state, _ = self._epoch_cells(
                state, self.frozen, task.x_train, task.y_train, task.valid_train, perm,
                step_decay_lr([float(lr) for lr in lrs], epoch, self.schedule), wd,
            )
            logits = self._eval_cells(state.trainable, self.frozen, task.x_val, state.bn)
            last = self._score_cells(logits, task.y_val, task.valid_val)
            best = np.where(np.isfinite(last), np.maximum(best, last), np.nan)
        scores = last if bool(self.cfg.TRAIN.SEARCH_RESULT_ON_LAST_EPOCH) else best
        return np.where(np.isfinite(scores), scores, 0.0).astype(np.float32)

    def train_final(
        self,
        lr: float,
        wd: float,
        task: ArrayTask,
        end_epoch: int,
        seed: int = 0,
    ) -> Tuple[TrainCellState, float]:
        """Single-cell training; returns (state of the best val score, that
        score), a later epoch winning a tie."""
        perms = self._perms(task.x_train.shape[0], end_epoch, seed)
        best, best_state = 0.0, None
        for state, score in self._train(CellKey(seed, None), float(lr), float(wd), task, perms):
            if best_state is None or score >= best:
                best, best_state = score, state
        return best_state, best

    # -- the search ---------------------------------------------------------

    def sweep_wd(self, lr: float, task: ArrayTask, end_epoch: int) -> Tuple[float, float]:
        """97-point wd grid: 7 coarse + binary refinement
        (hyperparameter_sweep, adapter_tuning_clip.py:173-225)."""
        cfg = self.cfg
        lo = float(cfg.TRAIN.SEARCH_WD_LOG_LOWER)
        hi = float(cfg.TRAIN.SEARCH_WD_LOG_UPPER)
        n_pts = int(cfg.TRAIN.SEARCH_WD_POINTS)
        grid = np.logspace(lo, hi, num=n_pts)
        # coarse points by INDEX into the fine grid
        init_idx = [
            int(i)
            for i in np.linspace(
                0, n_pts - 1, num=min(int(cfg.TRAIN.SEARCH_WD_INIT_POINTS), n_pts)
            ).round()
        ]
        scores: Dict[int, float] = {}

        def probe(idxs: List[int]):
            new = [i for i in idxs if i not in scores]
            if not new:
                return
            if bool(cfg.TRAIN.VMAP_SWEEP) and len(new) > 1:
                accs = self.train_cells([lr] * len(new), [float(grid[i]) for i in new], task,
                                        end_epoch)
                for i, a in zip(new, accs):
                    scores[i] = float(a)
            else:
                for i in new:
                    scores[i] = float(self.train_cells([lr], [float(grid[i])], task,
                                                       end_epoch)[0])
            for i in new:
                logger.info("=> lr %g wd %g: score %.3f", lr, grid[i], scores[i])

        probe(init_idx)
        peak = max(scores, key=scores.get)
        if bool(cfg.SWEEP.REF_COMPAT):
            # the reference's refine loop verbatim: every probe trains with
            # the LEFT candidate's wd, the score goes to the probed index, and
            # nothing is cached
            peak_score = scores[peak]
            span = 8
            while span > 0:
                left = max(peak - span, 0)
                right = min(peak + span, len(grid) - 1)
                for idx in (i for i in (left, right) if i != peak):
                    acc = float(self.train_cells([lr], [float(grid[left])], task, end_epoch)[0])
                    logger.info("=> lr %g wd %g (ref-compat, idx %d): score %.3f",
                                lr, grid[left], idx, acc)
                    if acc > peak_score:
                        peak, peak_score = idx, acc
                span //= 2
            logger.info("=> Learning rate %g: best l2 lambda %g (score %.3f)",
                        lr, grid[peak], peak_score)
            return float(grid[peak]), peak_score
        span = 8
        while span > 0:
            left = max(peak - span, 0)
            right = min(peak + span, len(grid) - 1)
            probe([i for i in (left, right) if i != peak])
            peak = max(scores, key=scores.get)
            span //= 2
        logger.info("=> Learning rate %g: best l2 lambda %g (score %.3f)",
                    lr, grid[peak], scores[peak])
        return float(grid[peak]), scores[peak]

    def sweep(
        self,
        task: ArrayTask,
        end_epoch: int,
        lr_grid: Optional[Sequence[float]] = None,
    ) -> Tuple[float, float, float]:
        """Full lr x wd search (hyperparameter_sweep_lr, :406-426).
        Returns (best_lr, best_wd, best_score)."""
        t0 = time.time()
        lrs = list(lr_grid or np.logspace(-6, -1, num=6))
        best = (0.0, 0.0, -1.0)
        for lr in lrs:
            wd, score = self.sweep_wd(float(lr), task, end_epoch)
            logger.info("=> Learning rate: %g, best_score %.3f", lr, score)
            if score > best[2]:
                best = (float(lr), wd, score)
        logger.info(
            "Hyper parameter tuning result: learning rate %g, l2_lambda %g (%.2fs)",
            best[0], best[1], time.time() - t0,
        )
        return best
