"""The full-shot training command (counterpart of
``peft_vit_tpu/commands/train.py``; the reference's full_shot/main/tools/train.py).

    python -m peft_vit_tpu_torch.commands.train --cfg MODEL.yaml [KEY VALUE ...]

config -> ``PEFTSpec`` -> the data -> ``build_image_classifier`` -> the
trainable mask (``PEFT.METHOD``, none meaning full) -> ``Trainer.fit`` with
the checkpoint and TensorBoard directories under
``OUTPUT_DIR/<dataset>/<NAME>``, on the card unless the caller asks for the
CPU (``device="cpu"``).

As in the JAX command, the data streams when the config names TSV shards
(``DATASET.TRAIN_TSV_LIST``), an ImageFolder tree (``ROOT/TRAIN_SET``) or an
ELEVATER zip manifest and the native runtime loads: ``StreamingSource``
decodes in the C++ ring and ships raw uint8 (the trainer flips, or runs the
timm augmentation, and normalises on the card), ``TPU.STEPS_PER_DISPATCH`` =
K batches arrive as (K, B, ...) chunks, and a resumed epoch seeks past its
trained prefix without decoding it.  Without the runtime the splits are
loaded into memory (``construct_splits``).  ``main`` exits 75 (EX_TEMPFAIL)
when a SIGTERM stopped the run at a checkpoint.

Over several processes, one a card (``torchrun --nproc_per_node=N -m
peft_vit_tpu_torch.commands.train --cfg ...``), ``main`` joins the group
from torchrun's environment and the trainer runs over ``TPU.MESH``'s data
axis: in memory the global batch is ``BATCH_SIZE_PER_GPU`` times the data
degree (the JAX command's times the device count) and each rank takes its
rows (``parallel.batch_rows``); streaming, each rank reads its stripe of
``BATCH_SIZE_PER_GPU``.  Eval gives each rank its stripe of the test set.
Only rank 0 writes TensorBoard and the final result line.  A model degree
(``TPU.MESH.MODEL`` with ``TPU.SEQUENCE_PARALLEL``) or a pipe degree
(``TPU.MESH.PIPE`` with ``TPU.SCAN_LAYERS``) divides the processes as the
JAX mesh does; the ranks of one data index share its rows
(``engine.trainer``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Mapping, Optional, Tuple

import numpy as np

from ..config import get_default_config
from ..data import construct_splits
from ..data.augment import make_train_transform
from ..data.samplers import shard_order
from ..engine.trainer import PreemptedError, Trainer, batch_iterator
from ..models import build_image_classifier, load_jax_variables
from ..parallel.mesh import batch_rows, mesh_from_config
from ..peft import build_mask, count_trainable, spec_from_config
from ..utils import dist as _dist
from ..utils import resolve_device
from ..utils.logging import create_logger, final_result_line, log_trainable_params

logger = logging.getLogger(__name__)


def build_trainer(cfg, device=None, variables: Optional[Mapping] = None, *,
                  num_classes: Optional[int] = None, steps_per_epoch: Optional[int] = None):
    """The in-memory splits (None when ``num_classes`` is given: the data
    streams), the model and its ``Trainer`` of ``cfg``: what ``train_main``
    fits.  Under the timm augmentation the splits stay raw.  ``variables`` (a
    JAX-layout variables tree of the classifier) replaces the built weights:
    the seam through which a test hands the port the JAX package's weights.
    In a process group the trainer runs over ``TPU.MESH``'s mesh, and
    ``steps_per_epoch`` counts global batches."""
    device = resolve_device(device)
    spec = spec_from_config(cfg)
    data = 1
    if _dist.group_initialized():
        mesh = mesh_from_config(cfg)
        logger.info("=> mesh %s over %d processes", mesh.shape, _dist.world_size())
        data = mesh.data
    batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU) * data
    splits = None
    if num_classes is None:
        splits = construct_splits(cfg, normalize=make_train_transform(cfg) is None)
        num_classes = splits.num_classes
        steps_per_epoch = max(len(splits.y_train) // batch, 1)
    model, _, _ = build_image_classifier(cfg, spec, num_classes, device=device)
    if variables is not None:
        load_jax_variables(model, variables)
    method = cfg.PEFT.METHOD if cfg.PEFT.METHOD != "none" else "full"
    mask = build_mask(model, method, num_layers=getattr(model.backbone, "layers", 12))
    log_trainable_params(count_trainable(model, mask))
    return splits, Trainer(cfg, model, mask, steps_per_epoch)


def streaming_sources(cfg) -> Optional[Tuple[object, object]]:
    """(train source, eval source or None) when ``cfg`` names a streamable
    source and the native runtime loads; None otherwise (the JAX command's
    folder / zip / TSV choice)."""
    from ..data.native import native_available

    train_folder = (os.path.join(cfg.DATASET.ROOT, cfg.DATASET.TRAIN_SET)
                    if cfg.DATASET.TRAIN_SET else "")
    test_dir = cfg.DATASET.TEST_SET or cfg.DATASET.VAL_SET
    test_folder = os.path.join(cfg.DATASET.ROOT, test_dir) if test_dir else ""
    folder_mode = (not cfg.DATASET.TRAIN_TSV_LIST and bool(cfg.DATASET.ROOT)
                   and os.path.isdir(train_folder))
    zip_mode = False
    if not cfg.DATASET.TRAIN_TSV_LIST and not folder_mode and native_available():
        from ..data.elevater import scan_zip_split

        zip_mode = scan_zip_split(cfg, "train") is not None
    if not ((cfg.DATASET.TRAIN_TSV_LIST or folder_mode or zip_mode) and native_available()):
        if cfg.DATASET.TRAIN_TSV_LIST:
            logger.warning("native runtime unavailable: TSV data will be fully materialized "
                           "in host RAM")
        return None
    from ..data.streaming import StreamingSource

    # raw uint8 always: the step flips (or augments) and normalises on the
    # card; K = STEPS_PER_DISPATCH makes the loader emit (K, B, ...) chunks
    k_disp = int(cfg.TPU.get("STEPS_PER_DISPATCH", 1))
    train_src = StreamingSource(cfg, "train", normalize=False, batch_multiplier=k_disp)
    has_eval = bool(cfg.DATASET.TEST_TSV_LIST) or (folder_mode and os.path.isdir(test_folder))
    if zip_mode and not has_eval:
        from ..data.elevater import scan_zip_split

        has_eval = scan_zip_split(cfg, "test") is not None
    eval_src = StreamingSource(cfg, "test", normalize=False) if has_eval else None
    return train_src, eval_src


def _streamed_classes(cfg, train_src) -> int:
    """``DATASET.NUM_CLASSES``, else the classes of the ImageFolder tree, else
    (not from TSV shards) the loader's largest label + 1."""
    num_classes = int(cfg.DATASET.NUM_CLASSES)
    folder = (os.path.join(cfg.DATASET.ROOT, cfg.DATASET.TRAIN_SET)
              if cfg.DATASET.TRAIN_SET else "")
    if num_classes <= 0 and not cfg.DATASET.TRAIN_TSV_LIST and cfg.DATASET.ROOT and (
            os.path.isdir(folder)):
        num_classes = sum(os.path.isdir(os.path.join(folder, d)) for d in os.listdir(folder))
    if num_classes <= 0 and not cfg.DATASET.TRAIN_TSV_LIST:
        num_classes = int(np.max(train_src._labels_fn())) + 1
    if num_classes <= 0:
        raise ValueError("streaming training needs DATASET.NUM_CLASSES (or an ImageFolder "
                         "tree to count classes from)")
    return num_classes


def run_dirs(cfg):
    """The checkpoint and TensorBoard directories of ``cfg``."""
    root = os.path.join(cfg.OUTPUT_DIR, cfg.DATASET.DATASET, cfg.NAME)
    return os.path.join(root, "checkpoints"), os.path.join(root, "tb_log")


def train_main(cfg, *, device=None, variables: Optional[Mapping] = None,
               sources: Optional[Tuple[object, object]] = None) -> float:
    """Train ``cfg`` to ``TRAIN.END_EPOCH``; returns the best top-1 (raw,
    EMA or SWA) and logs it as the run's last line.  ``sources``: the
    (train, eval or None) streaming sources in place of the ones ``cfg``
    names (``streaming_sources``)."""
    from ..data.streaming import host_prefetch

    if sources is None:
        sources = streaming_sources(cfg)
    test_batch = int(cfg.TEST.BATCH_SIZE_PER_GPU)
    if sources is not None:
        train_src, eval_src = sources
        _, trainer = build_trainer(cfg, device, variables,
                                   num_classes=_streamed_classes(cfg, train_src),
                                   steps_per_epoch=train_src.steps_per_epoch)

        # (epoch, skip): a resumed epoch seeks past its trained prefix in
        # the source; host_prefetch keeps the decode ring draining while
        # the consumer waits on the card
        def train_batches(epoch, skip=0):
            return host_prefetch(train_src.batches(epoch, skip_batches=skip), depth=2)

        if eval_src is not None:
            def eval_batches():
                return eval_src.device_batches(0, device=trainer.device)
        else:
            eval_splits = construct_splits(cfg, test_split_only=True,
                                           normalize=trainer.transform is None)

            def eval_batches():
                return _eval_stripe(eval_splits.x_test, eval_splits.y_test, test_batch)
    else:
        splits, trainer = build_trainer(cfg, device=device, variables=variables)
        batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU) * trainer.world

        def train_batches(epoch):
            rows = batch_rows(trainer.mesh, batch) if trainer.mesh is not None else slice(None)
            for x, y in batch_iterator(splits.x_train, splits.y_train, batch,
                                       shuffle=bool(cfg.TRAIN.SHUFFLE), seed=epoch):
                yield x[rows], y[rows]

        def eval_batches():
            return _eval_stripe(splits.x_test, splits.y_test, test_batch)

    ckpt_dir, tb_dir = run_dirs(cfg)
    main_rank = _dist.is_main_process()
    best = trainer.fit(train_batches, eval_batches, ckpt_dir, tb_dir if main_rank else None)
    if main_rank:
        final_result_line("accuracy", best)
    return best


def _eval_stripe(x, y, batch: int):
    """The test set's batches, over several processes this rank's stripe of
    it (``shard_order``; the trainer gathers the ranks' scores)."""
    idx = shard_order(np.arange(len(y)), _dist.rank(), _dist.world_size())
    if len(idx) < len(y):
        x, y = x[idx], y[idx]
    return batch_iterator(x, y, batch, shuffle=False, drop_last=False)


def load_cfg(argv, name: str, parser_description: str):
    """``--cfg`` and the ``KEY VALUE`` overrides; ``NAME`` defaults to the
    YAML's base name, else ``name``."""
    parser = argparse.ArgumentParser(description=parser_description)
    parser.add_argument("--cfg", required=False, default=None)
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = get_default_config()
    if args.cfg:
        cfg.merge_from_file(args.cfg)
        cfg.NAME = cfg.NAME or os.path.splitext(os.path.basename(args.cfg))[0]
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.NAME = cfg.NAME or name
    return cfg


def main(argv=None, *, device=None):
    cfg = load_cfg(argv, "train", "full-shot training (PyTorch port)")
    # torchrun's environment, if any: one process a card
    cfg.RANK = _dist.init_distributed(device=device)[0]
    create_logger(cfg, "train")
    cfg.freeze()
    try:
        return train_main(cfg, device=device)
    except PreemptedError as e:
        # a clean preemption: the state is checkpointed; EX_TEMPFAIL tells
        # the scheduler this is a retry, not a failure
        logger.warning("=> %s", e)
        sys.exit(75)


if __name__ == "__main__":
    main()
