"""The input pipeline's throughput (counterpart of
``peft_vit_tpu/commands/test_io.py``; the reference's tools/test_io.py).

    python -m peft_vit_tpu_torch.commands.test_io [--shards A.tsv ...] [--threads N]

Synthesises a JPEG TSV shard with PIL when ``--shards`` is not given, then
measures the native loader's decode + resize rate (images/s) over one timed
epoch after a warm one.  This is the number that says whether the host can
feed the card.  Exits 1 when the native runtime is unavailable, naming what
is missing.
"""

from __future__ import annotations

import argparse
import base64
import io
import os
import sys
import tempfile
import time

import numpy as np


def synth_shard(n: int, hw: int = 256, path: str | None = None) -> str:
    from PIL import Image

    rng = np.random.RandomState(0)
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".tsv")
        os.close(fd)
    with open(path, "w") as f:
        for i in range(n):
            arr = rng.randint(0, 255, (hw, hw, 3), np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="JPEG", quality=90)
            f.write(f"img{i}\t{base64.b64encode(buf.getvalue()).decode()}\t{i % 10}\n")
    return path


def measure(shards, image_size: int = 224, batch: int = 64, threads: int = 4) -> dict:
    """{'images', 'seconds', 'images_per_s'} of one timed epoch of the native
    loader over ``shards`` (after a warm epoch)."""
    from ..data.native import NativeTsvLoader

    ld = NativeTsvLoader(shards, image_size=image_size, batch_size=batch, num_threads=threads)
    try:
        for _ in ld.epoch(0):
            pass
        t0 = time.perf_counter()
        total = sum(c for _, _, c in ld.epoch(1))
        dt = time.perf_counter() - t0
    finally:
        ld.close()
    return {"images": total, "seconds": dt, "images_per_s": total / dt}


def main(argv=None):
    p = argparse.ArgumentParser(description="native loader throughput (PyTorch port)")
    p.add_argument("--shards", nargs="*", default=None)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--threads", type=int, default=os.cpu_count() or 1)
    args = p.parse_args(argv)

    from ..data.native import native_available, native_error

    if not native_available():
        print(f"native runtime unavailable: {native_error()}")
        sys.exit(1)
    shards = args.shards or [synth_shard(args.n)]
    r = measure(shards, args.image_size, args.batch, args.threads)
    print(f"{r['images']} images in {r['seconds']:.2f}s -> {r['images_per_s']:.1f} img/s "
          f"({args.threads} threads, {args.image_size}px)")
    return r


if __name__ == "__main__":
    main()
