"""The port's streaming input (``peft_vit_tpu_torch/data/{native,samplers,
streaming}.py``) against the JAX package's on the CPU: the samplers' orders
and shards, the native decode, ``StreamingSource``'s batches over TSV shards,
an ImageFolder tree and an ELEVATER zip manifest (flips, K-chunks, drop_last
and the tail, the eval split, mid-epoch ``skip_batches``), a producer's error
re-raised, and the device prefetch's CPU pass-through.

Both packages decode through the same ``runtime/pvtio.cpp`` (the JAX package
its ``runtime/libpvtio.so``, the port its own build of the source), so every
comparison is exact: orders, batches and labels equal element for element.
The JAX source multiplies its batch by the local device count; the tests
hold it to one device, as the port runs.
"""

import jax
import numpy as np
import pytest

from _port_data import images, write_folder, write_manifest, write_tsv
from peft_vit_tpu.config import get_default_config as jax_config
from peft_vit_tpu.data import native as jax_native
from peft_vit_tpu.data import samplers as jax_samplers
from peft_vit_tpu.data import streaming as jax_streaming
from peft_vit_tpu_torch.config import get_default_config as port_config
from peft_vit_tpu_torch.data import native, samplers, streaming

CLASSES = ["ant", "bee", "cat"]
B = 4


@pytest.fixture(autouse=True)
def one_jax_device(monkeypatch):
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The same 27 train and 7 test images as TSV shards (two train shards),
    an ImageFolder tree and an ELEVATER coco manifest."""
    root = tmp_path_factory.mktemp("streaming")
    train, test = images(3, 9, seed=3), images(3, 3, seed=4)[:7]
    write_tsv(root / "train0.tsv", train[:13])
    write_tsv(root / "train1.tsv", train[13:])
    write_tsv(root / "test.tsv", test)
    write_folder(root / "folder" / "train", train, CLASSES)
    write_folder(root / "folder" / "test", test, CLASSES)
    write_manifest(root / "zip", "zipped", {"train": train, "test": test}, CLASSES)
    return root


def _cfg(factory, root, source, **over):
    cfg = factory()
    cfg.TRAIN.IMAGE_SIZE = [16, 16]
    cfg.TRAIN.BATCH_SIZE_PER_GPU = B
    cfg.TEST.BATCH_SIZE_PER_GPU = B
    cfg.WORKERS = 2
    cfg.DATASET.RANDOM_SEED_SAMPLING = 5
    if source == "tsv":
        cfg.DATASET.ROOT = str(root)
        cfg.DATASET.TRAIN_TSV_LIST = ["train0.tsv", "train1.tsv"]
        cfg.DATASET.TEST_TSV_LIST = ["test.tsv"]
    elif source == "folder":
        cfg.DATASET.ROOT = str(root / "folder")
        cfg.DATASET.TRAIN_SET, cfg.DATASET.TEST_SET = "train", "test"
    else:
        cfg.DATASET.ROOT = str(root / "zip")
        cfg.DATASET.DATASET = "zipped"
        cfg.DATASET.TRAIN_SET = cfg.DATASET.TEST_SET = ""
    for key, value in over.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


def _sources(root, source, split="train", normalize=True, k=1, **over):
    port = streaming.StreamingSource(_cfg(port_config, root, source, **over), split,
                                     normalize=normalize, batch_multiplier=k)
    want = jax_streaming.StreamingSource(_cfg(jax_config, root, source, **over), split,
                                         normalize=normalize, batch_multiplier=k)
    return port, want


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return got


@pytest.mark.parametrize("sampler", ["default", "class_aware", "chunk"])
def test_samplers_and_shards_equal_jax(sampler):
    labels = np.random.RandomState(0).randint(0, 5, 37)
    for epoch, seed in ((0, 0), (1, 0), (2, 7)):
        got = samplers.build_order(sampler, 37, epoch, seed, labels_fn=lambda: labels,
                                   chunk_size=8)
        want = jax_samplers.build_order(sampler, 37, epoch, seed, labels_fn=lambda: labels,
                                        chunk_size=8)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.int64
        for i in range(3):
            np.testing.assert_array_equal(samplers.shard_order(got, i, 3),
                                          jax_samplers.shard_order(want, i, 3))
    with pytest.raises(ValueError, match="Unknown TRAIN.SAMPLER"):
        samplers.build_order("nope", 4, 0)


def test_native_runtime_builds_into_build_and_decodes_as_jax():
    from _port_data import png

    assert native.native_available() and native.native_error() is None
    assert native.LIBRARY.parent.name == "peft_vit_tpu_torch" and native.LIBRARY.exists()
    for arr, _ in images(2, 2, seed=6):
        raw = png(arr)
        np.testing.assert_array_equal(native.decode_resize(raw, 16),
                                      jax_native.decode_resize(raw, 16))
    assert native.decode_resize(b"not an image", 16) is None


def test_build_failure_names_what_is_missing():
    out = ("runtime/pvtio.cpp:27:10: fatal error: jpeglib.h: No such file or directory\n"
           "/usr/bin/ld: cannot find -lpng: No such file or directory")
    assert "missing: header jpeglib.h, library libpng" in native._diagnose(out)


@pytest.mark.parametrize("source", ["tsv", "folder", "zip"])
def test_streaming_batches_equal_jax(root, source):
    """Two epochs of normalised, flipped train batches (the per-epoch flip
    RNG), a raw uint8 epoch, and the eval split with its partial last
    batch."""
    port, want = _sources(root, source)
    assert port.steps_per_epoch == want.steps_per_epoch == 27 // B
    for epoch in (0, 1):
        got = _same(port.batches(epoch), want.batches(epoch))
        assert len(got) == 27 // B and got[0][0].dtype == np.float32
    raw, raw_want = _sources(root, source, normalize=False)
    assert _same(raw.batches(1), raw_want.batches(1))[0][0].dtype == np.uint8
    ev, ev_want = _sources(root, source, split="test", normalize=False)
    got = _same(ev.batches(), ev_want.batches())
    assert [len(y) for _, y in got] == [4, 3]


def test_sources_give_the_same_images(root):
    """TSV shards, the ImageFolder tree and the zip manifest hold the same
    images: their loaders decode the same (image, label) pairs, each in its
    own order."""
    seen = []
    for source in ("tsv", "folder", "zip"):
        src, _ = _sources(root, source, normalize=False)
        seen.append(sorted((int(y), x.tobytes()) for xs, ys, c in
                           src.loader.epoch(0, order=np.arange(27))
                           for x, y in zip(xs[:c], ys[:c])))
    assert len(seen[0]) == 27 and seen[0] == seen[1] == seen[2]


@pytest.mark.parametrize("k,skip", [(1, 3), (2, 2), (2, 3), (3, 1)])
def test_skip_batches_resume_equals_the_epochs_tail(root, k, skip):
    """``batches(e, skip)`` equals the uninterrupted epoch's tail bit for bit
    (chunk-aligned and misaligned, flips included), as JAX's does."""
    port, want = _sources(root, "tsv", k=k)

    def flat(items):
        out = []
        for item in items:
            if len(item) == 3:
                out += [(item[0][j], item[1][j]) for j in range(item[0].shape[0])]
            else:
                out.append(item)
        return out

    full = flat(port.batches(1))
    resumed = flat(_same(port.batches(1, skip_batches=skip),
                         want.batches(1, skip_batches=skip)))
    assert len(resumed) == len(full) - skip
    for (x, y), (fx, fy) in zip(resumed, full[skip:]):
        np.testing.assert_array_equal(x, fx)
        np.testing.assert_array_equal(y, fy)


def test_chunks_equal_single_batches_and_the_tail(root):
    """(K, B, ...) chunks reshape to the K = 1 batches: 27 samples give three
    chunks at K = 2 (3 samples dropped), one chunk and the tail's two single
    batches at K = 4, and single batches when K*B exceeds the dataset."""
    singles = list(_sources(root, "tsv")[0].batches(0))
    for k, lens in ((2, [3, 3, 3]), (4, [3, 2, 2]), (8, [2] * 6)):
        src, want = _sources(root, "tsv", k=k)
        items = _same(src.batches(0), want.batches(0))
        assert [len(c) for c in items] == lens
        flat = [pair for c in items for pair in (
            [(c[0][j], c[1][j]) for j in range(k)] if len(c) == 3 else [c])]
        assert len(flat) == len(singles) == 6
        for (x, y), (sx, sy) in zip(flat, singles):
            np.testing.assert_array_equal(x, sx)
            np.testing.assert_array_equal(y, sy)


def test_array_loader_streams_what_the_native_loader_does(root):
    """The in-memory ``ArrayLoader`` behind the same source (the card's
    narrowed path) yields the TSV source's epoch when it holds the decoded
    images in the shards' order."""
    src, _ = _sources(root, "tsv", normalize=False, k=2)
    decoded = [x[:c] for x, _, c in src.loader.epoch(0, order=np.arange(27))]
    labels = src.loader.labels()
    mem = streaming.StreamingSource(
        _cfg(port_config, root, "tsv"), "train", normalize=False, batch_multiplier=2,
        loader=streaming.ArrayLoader(np.concatenate(decoded), labels, 2 * B))
    for epoch in (0, 1):
        _same(mem.batches(epoch, skip_batches=epoch * 3),
              src.batches(epoch, skip_batches=epoch * 3))


def test_producer_errors_reach_the_consumer():
    def bad():
        yield np.zeros(1), np.zeros(1)
        yield np.ones(1), np.ones(1)
        raise OSError("shard vanished")

    it = streaming.host_prefetch(bad(), depth=1)
    assert next(it)[0][0] == 0 and next(it)[0][0] == 1
    with pytest.raises(OSError, match="shard vanished"):
        next(it)


def test_pipes_deliver_every_item_in_order_under_thread_switching():
    """16 pipes at once (more threads than cores), the interpreter switching
    threads every microsecond: each delivers all its 500 items in order."""
    import sys
    import threading

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    got = {}
    try:
        def consume(i):
            got[i] = [v for v, _ in streaming.host_prefetch(((j, i) for j in range(500)),
                                                            depth=2)]

        threads = [threading.Thread(target=consume, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert got == {i: list(range(500)) for i in range(16)}


def test_device_prefetch_passes_cpu_items_through():
    items = [(np.zeros((2, 3)), np.arange(2)), (np.ones((2, 2, 3)), np.ones((2, 2)), True)]
    out = list(streaming.prefetch_to_device(iter(items), "cpu", depth=2))
    assert all(a is b for got, want in zip(out, items) for a, b in zip(got, want))


def _as_rank(monkeypatch, r: int, world: int = 2) -> None:
    """Both packages' sources see process ``r`` of ``world``."""
    monkeypatch.setattr(jax, "process_index", lambda: r)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(streaming, "rank", lambda: r)
    monkeypatch.setattr(streaming, "world_size", lambda: world)


def test_several_processes_are_refused(root, monkeypatch):
    """No longer refused: rank 1 of 2 reads its stripe of the 27 samples, cut
    to 27 // 2 for training (lockstep) and whole for eval (4 of 7)."""
    _as_rank(monkeypatch, 1)
    src = streaming.StreamingSource(_cfg(port_config, root, "tsv"), "train")
    assert (src.process_index, src.process_count) == (1, 2)
    assert (src.samples_this_process, src.steps_per_epoch) == (13, 13 // B)
    ev = streaming.StreamingSource(_cfg(port_config, root, "tsv"), "test")
    assert ev.samples_this_process == 3


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("source", ["tsv", "folder"])
def test_stripes_over_two_processes_equal_jax(root, monkeypatch, source, k):
    """Each of 2 ranks' train epochs (flips, K-chunks, a resumed tail) and
    eval stripe against the JAX source as that process: the ranks yield the
    same number of batches, and the eval stripes cover the 7 test images
    once."""
    counts, eval_items = [], []
    for r in range(2):
        _as_rank(monkeypatch, r)
        port, want = _sources(root, source, k=k)
        assert port.samples_this_process == want.samples_this_process == 13
        assert port.steps_per_epoch == want.steps_per_epoch == 13 // B
        got = _same(port.batches(1), want.batches(1))
        counts.append(sum(item[0].shape[0] if len(item) == 3 else 1 for item in got))
        _same(port.batches(1, skip_batches=1), want.batches(1, skip_batches=1))
        ev, ev_want = _sources(root, source, split="test", normalize=False)
        eval_items += _same(ev.batches(), ev_want.batches())
    assert counts[0] == counts[1] == 13 // B
    monkeypatch.setattr(streaming, "world_size", lambda: 1)
    monkeypatch.setattr(streaming, "rank", lambda: 0)
    whole = streaming.StreamingSource(_cfg(port_config, root, source), "test", normalize=False)
    seen = sorted((int(y), x.tobytes()) for xs, ys in eval_items for x, y in zip(xs, ys))
    want_all = sorted((int(y), x.tobytes()) for xs, ys in whole.batches()
                      for x, y in zip(xs, ys))
    assert len(seen) == 7 and seen == want_all
