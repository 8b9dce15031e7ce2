"""The streaming full-shot input pipeline (counterpart of
``peft_vit_tpu/data/streaming.py``), one process a card.

* decode and prefetch run in the C++ runtime's threads (``NativeTsvLoader``
  over ``runtime/pvtio.cpp``): a bounded ring, so the host holds O(ring),
  never O(dataset);
* the sampler (``TRAIN.SAMPLER``: default / class_aware / chunk) is a host
  numpy order over sample indices (``data/samplers.py``);
* ``prefetch_to_device`` stages each batch or (K, B, ...) chunk in a pinned
  host buffer and copies it to the card on a side CUDA stream,
  ``TPU.PREFETCH_DEPTH`` ahead, while the card runs the current step (the
  counterpart of the JAX trainer's ``_device_prefetch``);
* a producer thread's exception is re-raised at the consumer: a silently
  short epoch must not look like a normal epoch end.

The batch is ``BATCH_SIZE_PER_GPU`` (the JAX source multiplies it by the
local device count, one here); over several processes each reads its
stripe, in lockstep for training (``StreamingSource``).
``ArrayLoader`` gives an in-memory uint8 dataset ``NativeTsvLoader``'s
interface, so that the source's orders, flips, chunks and resume run
without decoding.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..utils.dist import rank, world_size
from .native import NativeTsvLoader, native_available, native_error
from .samplers import build_order, shard_order

logger = logging.getLogger(__name__)


class _Raise:
    """An exception captured on a producer thread, re-raised at the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _threaded_pipe(batches: Iterator, transform, depth: int):
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()

    def producer():
        try:
            for item in batches:
                q.put(transform(item))
        except BaseException as e:  # noqa: BLE001 -- forwarded, not swallowed
            q.put(_Raise(e))
        finally:
            q.put(end)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, _Raise):
            raise item.exc
        yield item


def host_prefetch(batches: Iterator, depth: int = 8):
    """Buffer host batches on a background thread (keeps the native decode
    ring draining while the consumer waits on the card).  A producer's
    error is re-raised at the consumer rather than ending the epoch."""
    return _threaded_pipe(batches, lambda item: item, depth)


class _Slot:
    """A pinned host buffer and its device buffer for one staged item."""

    def __init__(self):
        self.host = self.dev = None
        self.copied = torch.cuda.Event()  # the host -> card copy finished
        self.released = torch.cuda.Event()  # the step that read ``dev`` finished


def prefetch_to_device(batches: Iterator, device, depth: int = 2):
    """Items ``(x, y)`` or ``(xs, ys, tag)`` with ``x`` and ``y`` on
    ``device``, copied ``depth`` items ahead of the consumer.

    On the card a background thread copies each item into a pinned host
    buffer and from there into a device buffer on a side stream; the
    consumer's stream waits for that copy's event.  A slot (pinned buffer and
    device buffer) is refilled only after the consumer has taken the next
    item and the work it queued on the previous one has finished on the
    card.  The thread's CUDA calls hold ``engine.train.capture_lock``, so
    none falls inside a graph capture.  On the CPU the items pass through."""
    device = torch.device(device)
    if device.type != "cuda":
        return iter(batches)
    return _CudaPrefetch(batches, device, max(int(depth), 1))


class _CudaPrefetch:
    def __init__(self, batches, device, depth):
        from ..engine.train import capture_lock

        self.lock = capture_lock
        self.device = device
        self.side = torch.cuda.Stream(device)
        self.free: "queue.Queue" = queue.Queue()
        for _ in range(depth + 1):
            self.free.put(_Slot())
        self.items = _threaded_pipe(batches, self._stage, depth)

    def _stage(self, item):
        """Producer thread: item -> a slot holding it on the card."""
        slot = self.free.get()
        arrays = [torch.from_numpy(np.ascontiguousarray(a)) if not torch.is_tensor(a) else a
                  for a in item[:2]]
        with self.lock:
            slot.copied.synchronize()  # the pinned buffers' last copy is done
            if slot.host is None or any(h.shape != a.shape or h.dtype != a.dtype
                                        for h, a in zip(slot.host, arrays)):
                slot.host = [torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                             for a in arrays]
                with torch.cuda.stream(self.side):
                    slot.dev = [torch.empty(a.shape, dtype=a.dtype, device=self.device)
                                for a in arrays]
        for h, a in zip(slot.host, arrays):
            h.copy_(a)
        with self.lock, torch.cuda.stream(self.side):
            self.side.wait_event(slot.released)
            for d, h in zip(slot.dev, slot.host):
                d.copy_(h, non_blocking=True)
            slot.copied.record(self.side)
        return (*slot.dev, *item[2:]), slot

    def __iter__(self):
        prev = None
        for out, slot in self.items:
            stream = torch.cuda.current_stream(self.device)
            if prev is not None:
                prev.released.record(stream)
                self.free.put(prev)
            stream.wait_event(slot.copied)
            for t in slot.dev:
                t.record_stream(stream)
            yield out
            prev = slot


_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp", ".jfif")


def scan_imagefolder(folder: str):
    """Class-per-subdirectory tree -> (file_paths, labels); classes sorted by
    name (as ``registry.load_imagefolder`` assigns them); image extensions
    only (the torchvision ImageFolder convention)."""
    classes = sorted(d for d in os.listdir(folder) if os.path.isdir(os.path.join(folder, d)))
    paths, labels = [], []
    for ci, c in enumerate(classes):
        cdir = os.path.join(folder, c)
        for f in sorted(os.listdir(cdir)):
            if not f.lower().endswith(_IMAGE_EXTS):
                continue
            paths.append(os.path.join(cdir, f))
            labels.append(ci)
    return paths, np.asarray(labels, np.int64)


class ArrayLoader:
    """An in-memory uint8 dataset behind ``NativeTsvLoader``'s interface:
    ``epoch(order=...)`` yields (x (B, ...), y (B,), count) with the last
    partial batch zero-padded; without an order, in index order."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int):
        self.x, self.y = np.asarray(x), np.asarray(y, np.int64)
        self.batch_size = int(batch_size)

    def __len__(self) -> int:
        return len(self.x)

    def labels(self) -> np.ndarray:
        return self.y.copy()

    def epoch(self, epoch: int = 0, order: Optional[np.ndarray] = None):
        if order is None:
            order = np.arange(len(self))
        b = self.batch_size
        for i in range(0, len(order), b):
            idx = order[i:i + b]
            x = np.zeros((b, *self.x.shape[1:]), self.x.dtype)
            y = np.zeros((b,), np.int64)
            x[:len(idx)], y[:len(idx)] = self.x[idx], self.y[idx]
            yield x, y, len(idx)

    def close(self):
        pass


class StreamingSource:
    """Config -> per-epoch batch iterators over TSV shards, an ImageFolder
    tree or an ELEVATER zip manifest (native decode threads each way).

    ``normalize=False`` yields raw uint8 batches (the trainer flips or
    augments and normalises them on the card); ``batch_multiplier`` = K
    (``TPU.STEPS_PER_DISPATCH``) makes the loader emit K*B-sample batches,
    reshaped (a view) into (K, B, ...) chunks.  ``loader``: a loader of
    ``NativeTsvLoader``'s interface with batch size K*B (``ArrayLoader``) in
    place of the one the config names.

    Over several processes (``utils.dist``) each rank reads its stripe of
    the data (``shard_order``), a batch of ``BATCH_SIZE_PER_GPU`` its part of
    the global batch.  A training epoch truncates every stripe to
    ``n_global // world`` samples, so that the ranks yield the same number
    of batches in lockstep; eval gives each rank its stripe of every sample,
    the partial last batch kept (the trainer gathers the scores)."""

    def __init__(self, cfg, split: str = "train", normalize: bool = True,
                 batch_multiplier: int = 1, loader=None):
        self.normalize = normalize
        self.chunk = max(int(batch_multiplier), 1)
        self.split = split
        self.train = split == "train"
        self.batch = int(cfg.TRAIN.BATCH_SIZE_PER_GPU if self.train
                         else cfg.TEST.BATCH_SIZE_PER_GPU)
        if loader is not None:
            self.loader = loader
        else:
            if not native_available():
                raise RuntimeError("the streaming path needs the native runtime "
                                   f"(libpvtio.so): {native_error()}")
            self.loader = self._native_loader(cfg)
        self.sampler = str(cfg.TRAIN.SAMPLER)
        self.seed = int(cfg.DATASET.RANDOM_SEED_SAMPLING)
        self.flip = self.train and bool(cfg.AUG.get("RANDOM_FLIP", True))
        self.mean = np.asarray(cfg.INPUT.MEAN, np.float32) * 255.0
        self.std = np.asarray(cfg.INPUT.STD, np.float32) * 255.0
        self._labels: Optional[np.ndarray] = None
        self.process_index, self.process_count = rank(), world_size()
        self.n_global = len(self.loader)
        self.samples_this_process = len(shard_order(np.arange(self.n_global),
                                                    self.process_index, self.process_count))
        if self.train and self.process_count > 1:
            # every step is a collective: the ranks' stripes differ by up to
            # one sample, so each is cut to the shortest (DistributedSampler's
            # drop to equal)
            self.samples_this_process = self.n_global // self.process_count
        # drop_last at B granularity: full K*B chunks, then the epoch's tail
        # (< K full batches) as single batches
        self.steps_per_epoch = max(self.samples_this_process // self.batch, 1)
        if self.train and self.samples_this_process < self.batch:
            logger.warning("=> streaming %s: only %d samples for batch size %d -- every epoch "
                           "will yield ZERO batches (drop_last)", split,
                           self.samples_this_process, self.batch)
        logger.info("=> streaming %s: %d samples (%d this process), batch %d, sampler %s",
                    split, self.n_global, self.samples_this_process, self.batch, self.sampler)

    def _native_loader(self, cfg):
        tsv_list = cfg.DATASET.TRAIN_TSV_LIST if self.train else cfg.DATASET.TEST_TSV_LIST
        root = cfg.DATASET.ROOT
        split_dir = (cfg.DATASET.TRAIN_SET if self.train
                     else (cfg.DATASET.TEST_SET or cfg.DATASET.VAL_SET))
        # an empty split dir would resolve to ROOT itself, whose
        # subdirectories are splits, not classes: never scan that
        folder = os.path.join(root, split_dir) if split_dir else ""
        kw = dict(image_size=int(cfg.TRAIN.IMAGE_SIZE[0]), batch_size=self.batch * self.chunk,
                  shuffle=self.train and bool(cfg.TRAIN.SHUFFLE),
                  seed=int(cfg.DATASET.RANDOM_SEED_SAMPLING), num_threads=int(cfg.WORKERS or 4))
        if tsv_list:
            return NativeTsvLoader([os.path.join(root, p) if root else p for p in tsv_list], **kw)
        if os.path.isdir(folder):
            files, labels = scan_imagefolder(folder)
            return NativeTsvLoader.from_files(files, labels, **kw)
        from .elevater import scan_zip_split

        hit = scan_zip_split(cfg, "train" if self.train else "test")
        if hit is None:
            raise ValueError(f"no TSV list, ImageFolder dir ({folder!r}), or streamable zip "
                             f"manifest for split {self.split!r}")
        return NativeTsvLoader.from_zip(*hit, **kw)

    def _labels_fn(self) -> np.ndarray:
        if self._labels is None:
            self._labels = self.loader.labels()
        return self._labels

    def _normalize(self, x_u8: np.ndarray) -> np.ndarray:
        if not self.normalize:
            return x_u8
        return (x_u8.astype(np.float32) - self.mean) / self.std

    def batches(self, epoch: int = 0, skip_batches: int = 0):
        """One epoch of (x, y) host batches, or (xs, ys, True) chunks.

        Train: sampler-ordered, drop_last, random horizontal flip (normalised
        mode; raw mode leaves it to the card).  Eval: sequential, the partial
        final batch kept.  ``skip_batches`` resumes an epoch without decoding
        the trained prefix: whole K*B emissions are trimmed from the order
        (the flip RNG burned in lockstep), and a misaligned remainder
        re-decodes one emission and drops its leading batches after the flip,
        so the rest sees the uninterrupted epoch's flips."""
        if not self.train:
            order = shard_order(np.arange(self.n_global, dtype=np.int64), self.process_index,
                                self.process_count)
            for x, y, count in self.loader.epoch(0, order=order):
                yield self._normalize(x[:count]), y[:count]
            return
        order = build_order(self.sampler, len(self.loader), epoch, self.seed,
                            labels_fn=self._labels_fn)
        order = shard_order(order, self.process_index, self.process_count)
        if self.process_count > 1:
            order = order[:self.samples_this_process]  # lockstep
        rng = np.random.RandomState(self.seed + 7919 * (epoch + 1))
        big = self.batch * self.chunk
        lead = 0  # batches to drop from the first decoded emission
        if skip_batches:
            n_em, rem = divmod(int(skip_batches) * self.batch, big)
            order = order[n_em * big:]
            lead = rem // self.batch
            if self.flip and self.normalize:
                for _ in range(n_em):
                    rng.rand(big)  # keep the flip masks epoch-identical
        for x, y, count in self.loader.epoch(epoch, order=order):
            tail = count < big
            n_full = count // self.batch
            if tail and n_full == 0:
                break  # drop_last at B granularity
            x = self._normalize(x)
            if self.flip and self.normalize:
                sel = rng.rand(len(x)) < 0.5
                x[sel] = x[sel, :, ::-1]
            if tail or lead:
                # the epoch's tail, or the partly skipped first emission of a
                # misaligned resume: single batches
                for j in range(lead, n_full if tail else self.chunk):
                    s = slice(j * self.batch, (j + 1) * self.batch)
                    yield x[s], y[s]
                lead = 0
                if tail:
                    break
                continue
            if self.chunk > 1:
                yield (x.reshape(self.chunk, self.batch, *x.shape[1:]),
                       y.reshape(self.chunk, self.batch), True)
            else:
                yield x, y

    def device_batches(self, epoch: int = 0, depth: int = 2, device="cuda"):
        return prefetch_to_device(self.batches(epoch), device, depth=depth)

    def close(self):
        self.loader.close()
