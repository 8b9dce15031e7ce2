"""ctypes bindings of the native IO runtime (counterpart of
``peft_vit_tpu/data/native.py``; the C++ source is ``runtime/pvtio.cpp``).

The port never writes into ``runtime/``.  At first use it builds
``runtime/pvtio.cpp`` with ``g++`` into the git-ignored
``build/peft_vit_tpu_torch/libpvtio.so`` with the flags of
``runtime/Makefile`` (through a temporary file and ``os.replace``, so that
several processes may build at once), and rebuilds it when the source is
newer.  When the build or the load fails, ``native_available()`` is False
and ``native_error()`` names what is missing: the compiler, a header or a
library.

* ``decode_resize``   -- libjpeg/libpng decode + bilinear shorter-side
                         resize + centre crop, one C call an image (as in the
                         JAX module, PIL's bicubic ``resize_center_crop`` when
                         the runtime is missing)
* ``NativeTsvLoader`` -- the threaded prefetching batch loader over TSV
                         shards, image files (``from_files``) or the members
                         of a zip archive (``from_zip``)
"""

from __future__ import annotations

import ctypes
import logging
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = REPO_ROOT / "runtime" / "pvtio.cpp"
BUILD_DIR = REPO_ROOT / "build" / "peft_vit_tpu_torch"
LIBRARY = BUILD_DIR / "libpvtio.so"
# runtime/Makefile's CXXFLAGS and LDLIBS
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native", "-shared")
LD_LIBS = ("-ljpeg", "-lpng", "-lz", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None

P = ctypes.POINTER


def _diagnose(output: str) -> str:
    """What a failed build lacks, from the compiler's output."""
    headers = re.findall(r"fatal error: ([\w./]+): No such file", output)
    libs = re.findall(r"cannot find -l(\w+)", output)
    parts = [f"header {h}" for h in headers] + [f"library lib{lib}" for lib in libs]
    what = ", ".join(parts) if parts else "see the compiler output"
    return f"building {SOURCE.name} failed (missing: {what}):\n{output.strip()[-2000:]}"


def build() -> Path:
    """Build ``libpvtio.so`` into ``BUILD_DIR`` unless it is newer than its
    source; returns its path.  Raises ``RuntimeError`` naming what is missing."""
    if LIBRARY.exists() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    if not SOURCE.exists():
        raise RuntimeError(f"the native runtime's source {SOURCE} is missing")
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ is not on PATH): libpvtio.so cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LD_LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(_diagnose(proc.stdout + proc.stderr))
    os.replace(tmp, LIBRARY)
    return LIBRARY


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, c_i64, c_u64, c_size = ctypes.c_int, ctypes.c_int64, ctypes.c_uint64, ctypes.c_size_t
    u8, i64 = P(ctypes.c_uint8), P(ctypes.c_int64)
    sig = {
        "pvtio_decode_resize": (c_int, [ctypes.c_char_p, c_size, c_int, u8]),
        "pvtio_loader_create": (ctypes.c_void_p, [P(ctypes.c_char_p), c_int, c_int, c_int,
                                                  c_int, c_u64, c_int, c_int]),
        "pvtio_loader_create_files": (ctypes.c_void_p, [P(ctypes.c_char_p), i64, c_i64, c_int,
                                                        c_int, c_int, c_u64, c_int, c_int]),
        "pvtio_loader_create_zip": (ctypes.c_void_p, [ctypes.c_char_p, P(ctypes.c_uint64),
                                                      P(ctypes.c_uint64), P(ctypes.c_uint16),
                                                      i64, c_i64, c_int, c_int, c_int, c_u64,
                                                      c_int, c_int]),
        "pvtio_loader_num_samples": (c_i64, [ctypes.c_void_p]),
        "pvtio_loader_labels": (None, [ctypes.c_void_p, i64]),
        "pvtio_loader_start_epoch": (None, [ctypes.c_void_p, c_int, c_int]),
        "pvtio_loader_start_epoch_order": (None, [ctypes.c_void_p, i64, c_i64, c_int]),
        "pvtio_loader_num_batches": (c_i64, [ctypes.c_void_p]),
        "pvtio_loader_next": (c_int, [ctypes.c_void_p, u8, i64]),
        "pvtio_loader_destroy": (None, [ctypes.c_void_p]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    if _lib is None and _error is None:
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            logger.warning("native runtime unavailable: %s", _error.splitlines()[0])
    return _lib


def native_available() -> bool:
    return _load() is not None


def native_error() -> Optional[str]:
    """Why the runtime is unavailable (None when it loaded)."""
    _load()
    return _error


def _require(what: str) -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable ({what}): {_error}")
    return lib


def decode_resize(image_bytes: bytes, size: int) -> Optional[np.ndarray]:
    """JPEG/PNG bytes -> (size, size, 3) uint8; None if undecodable."""
    lib = _load()
    if lib is None:
        from io import BytesIO

        from PIL import Image

        from .transforms import resize_center_crop

        try:
            return resize_center_crop(Image.open(BytesIO(image_bytes)), size)
        except Exception:
            return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.pvtio_decode_resize(image_bytes, len(image_bytes), size,
                                 out.ctypes.data_as(P(ctypes.c_uint8)))
    return out if rc == 0 else None


def _as(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(P(ctype))


class NativeTsvLoader:
    """Threaded prefetching loader over base64-TSV shards.

    Yields (images_u8 (B, S, S, 3), labels (B,), count) per batch; the
    final partial batch reports count < B (padding rows are zeros)."""

    def __init__(self, shard_paths: Sequence[str], image_size: int = 224, batch_size: int = 64,
                 shuffle: bool = True, seed: int = 0, num_threads: int = 4, ring_slots: int = 4):
        lib = _require("use data.registry.load_tsv")
        self._setup(lib, image_size, batch_size, num_threads)
        arr = (ctypes.c_char_p * len(shard_paths))(*[p.encode() for p in shard_paths])
        self._handle = lib.pvtio_loader_create(arr, len(shard_paths), image_size, batch_size,
                                               int(shuffle), seed, num_threads, ring_slots)
        if not self._handle:
            raise RuntimeError("pvtio_loader_create failed")

    def _setup(self, lib, image_size, batch_size, num_threads):
        self._lib = lib
        self.image_size = image_size
        self.batch_size = batch_size
        self.num_threads = num_threads

    @classmethod
    def from_files(cls, file_paths: Sequence[str], labels: Sequence[int], image_size: int = 224,
                   batch_size: int = 64, shuffle: bool = True, seed: int = 0,
                   num_threads: int = 4, ring_slots: int = 4) -> "NativeTsvLoader":
        """ImageFolder mode: one image file a sample, decoded in the native
        worker threads."""
        lib = _require("use data.registry.load_imagefolder")
        self = cls.__new__(cls)
        self._setup(lib, image_size, batch_size, num_threads)
        arr = (ctypes.c_char_p * len(file_paths))(*[p.encode() for p in file_paths])
        lab = np.ascontiguousarray(labels, np.int64)
        self._handle = lib.pvtio_loader_create_files(
            arr, _as(lab, ctypes.c_int64), len(file_paths), image_size, batch_size,
            int(shuffle), seed, num_threads, ring_slots)
        if not self._handle:
            raise RuntimeError("pvtio_loader_create_files failed")
        return self

    @classmethod
    def from_zip(cls, zip_path: str, members: Sequence[str], labels: Sequence[int],
                 image_size: int = 224, batch_size: int = 64, shuffle: bool = True, seed: int = 0,
                 num_threads: int = 4, ring_slots: int = 4) -> "NativeTsvLoader":
        """Zip-archive mode (ELEVATER dumps): the zip directory is read once
        here; the C workers pread + inflate + decode each entry, and the
        archive is never extracted.  STORED and DEFLATE entries only."""
        import struct
        import zipfile

        lib = _require("zip members")
        offs, sizes, methods = [], [], []
        with zipfile.ZipFile(zip_path) as zf, open(zip_path, "rb") as f:
            for name in members:
                zi = zf.getinfo(name)
                if zi.compress_type not in (0, 8):
                    raise ValueError(f"unsupported zip method {zi.compress_type} for {name!r}")
                # the local header's name/extra lengths can differ from the
                # central directory's: read them from the file
                f.seek(zi.header_offset + 26)
                nlen, elen = struct.unpack("<HH", f.read(4))
                offs.append(zi.header_offset + 30 + nlen + elen)
                sizes.append(zi.compress_size)
                methods.append(zi.compress_type)
        self = cls.__new__(cls)
        self._setup(lib, image_size, batch_size, num_threads)
        o = np.ascontiguousarray(offs, np.uint64)
        s = np.ascontiguousarray(sizes, np.uint64)
        m = np.ascontiguousarray(methods, np.uint16)
        lab = np.ascontiguousarray(labels, np.int64)
        self._handle = lib.pvtio_loader_create_zip(
            zip_path.encode(), _as(o, ctypes.c_uint64), _as(s, ctypes.c_uint64),
            _as(m, ctypes.c_uint16), _as(lab, ctypes.c_int64), len(members), image_size,
            batch_size, int(shuffle), seed, num_threads, ring_slots)
        if not self._handle:
            raise RuntimeError("pvtio_loader_create_zip failed")
        return self

    def __len__(self) -> int:
        return int(self._lib.pvtio_loader_num_samples(self._handle))

    def labels(self) -> np.ndarray:
        """All sample labels (for host-side samplers)."""
        out = np.empty((len(self),), np.int64)
        self._lib.pvtio_loader_labels(self._handle, _as(out, ctypes.c_int64))
        return out

    def epoch(self, epoch: int = 0, order: Optional[np.ndarray] = None):
        """Iterate one epoch of batches.  ``order``: an explicit sample-index
        order (host-side samplers); None uses the loader's seeded shuffle."""
        lib = self._lib
        if order is not None:
            order = np.ascontiguousarray(order, np.int64)
            lib.pvtio_loader_start_epoch_order(self._handle, _as(order, ctypes.c_int64),
                                               len(order), self.num_threads)
        else:
            lib.pvtio_loader_start_epoch(self._handle, epoch, self.num_threads)
        nb = int(lib.pvtio_loader_num_batches(self._handle))
        s = self.image_size
        for _ in range(nb):
            x = np.empty((self.batch_size, s, s, 3), np.uint8)
            y = np.empty((self.batch_size,), np.int64)
            count = lib.pvtio_loader_next(self._handle, _as(x, ctypes.c_uint8),
                                          _as(y, ctypes.c_int64))
            if count < 0:
                return
            yield x, y, count

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.pvtio_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
