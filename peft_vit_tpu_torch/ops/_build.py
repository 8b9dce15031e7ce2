"""Build the hand-written CUDA kernels of ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes
``build/peft_vit_tpu_torch/lib<name>.so`` under the repository root::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/peft_vit_tpu_torch/lib<name>.so csrc/<name>.cu

at first use, and again whenever a source is newer than its library.
Stale sources build in parallel, one ``nvcc`` each.  A failed build raises.
Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "peft_vit_tpu_torch"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_libraries: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = cuda_home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        f"nvcc is neither on PATH nor at {candidate}: the CUDA kernels "
        "cannot be built"
    )


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(src: Path) -> bool:
    lib = library_path(src.stem)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *CSRC_DIR.glob("*.cuh")))
    return newest > lib.stat().st_mtime


def build(names: Optional[Iterable[str]] = None, ptxas_verbose: bool = False,
          niceness: int = 0) -> Dict[str, str]:
    """Build the stale libraries among ``names`` (default: every source).

    ``niceness`` > 0 runs each ``nvcc`` at that lower CPU priority, for a
    caller that works beside the build.  Returns ``{name: compiler output}``
    for the libraries it built; raises ``RuntimeError`` with the compiler
    output if any build fails.
    """
    wanted = None if names is None else set(names)
    sources = [
        s for s in sorted(CSRC_DIR.glob("*.cu"))
        if (wanted is None or s.stem in wanted) and _stale(s)
    ]
    if wanted is not None:
        missing = wanted - {s.stem for s in CSRC_DIR.glob("*.cu")}
        if missing:
            raise FileNotFoundError(f"no CUDA source for {sorted(missing)} in {CSRC_DIR}")
    if not sources:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        lib = library_path(src.stem)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_name(f"{lib.name}.log")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose else ()),
               "-o", str(tmp), str(src)]
        with open(log, "w") as log_f:
            proc = subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT,
                                    preexec_fn=(lambda: os.nice(niceness)) if niceness else None)
        jobs.append((src, lib, tmp, log, proc))
    outputs, errors = {}, []
    for src, lib, tmp, log, proc in jobs:
        rc = proc.wait()
        text = log.read_text()
        if rc != 0:
            errors.append(f"nvcc failed on {src.name} (exit {rc}):\n{text}")
            continue
        os.replace(tmp, lib)
        outputs[src.stem] = text
    if errors:
        raise RuntimeError("\n".join(errors))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if stale."""
    lib = _libraries.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libraries[name] = lib
    return lib
