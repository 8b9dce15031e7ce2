#!/usr/bin/env python3
"""Split the time of the port's int8 GEMM kernel (K6, ``csrc/int8_gemm.cu``)
between its row quantize and its product mainloop, on one NVIDIA GPU.

    python3 bench_int8_split.py                # the 8 GEMMs of a block at B=16

Two timing-only builds of the same source are made with nvcc into
``build/bench_int8_split/`` (patched text, never committed; their outputs are
wrong and are not checked):

* ``no_products``: no weight copies and no products; the block quantizes its
  rows and rescales zero accumulators into the output (quantize + epilogue);
* ``no_quantize``: the rows are not read; the codes are whatever shared
  memory holds and every row scale is 1 (weight ring + products + epilogue).

They run in turns with the kernel itself (kernel, no_products, no_quantize,
kernel) on bf16 activations of M = B x 197 rows at the four GEMMs of a
ViT-B/16 block and their transposes (``chip_smoke.INT8_GEMMS``), dynamic
quantize; every time is ``chip_smoke._device_ms`` (median of five CUDA-graph
replays, L2-warm).  Prints a line per GEMM, the card's name and power limit,
and one JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build" / "bench_int8_split"
# (text in csrc/int8_gemm.cu, its replacement) for each timing-only build
VARIANTS = {
    "no_products": [
        ("const int total = my_tiles * slabs;", "const int total = 0 * my_tiles * slabs;"),
        ("for (int k0 = 0; k0 < K; k0 += kSlab, ++j) {",
         "for (int k0 = 0; k0 < 0; k0 += kSlab, ++j) {"),
    ],
    "no_quantize": [
        ("for (int r = warp; r < kBM; r += kThreads / 32) {",
         "if (tid < kBM) sScale[tid] = 1.0f;\n  for (int r = warp; r < 0; r += kThreads / 32) {"),
    ],
}


def build_variants() -> dict:
    """``{name: CDLL}`` of the timing-only builds, compiled in parallel."""
    from peft_vit_tpu_torch.ops import _build

    source = (_build.CSRC_DIR / "int8_gemm.cu").read_text()
    jobs = {}
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel source no longer holds {old!r} once")
            text = text.replace(old, new)
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            (out / header.name).write_text(header.read_text())
        (out / "int8_gemm.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "libint8_gemm.so"),
               str(out / "int8_gemm.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    libs = {}
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the {name} build:\n{log}")
        libs[name] = ctypes.CDLL(str(BUILD / name / "libint8_gemm.so"))
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--reps", type=int, default=40)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_int8_split: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    from peft_vit_tpu_torch.ops import _build
    from peft_vit_tpu_torch.ops import int8 as i8

    smi = c.nvidia_smi()
    libs = {"kernel": _build.load("int8_gemm"), **build_variants()}
    gen = torch.Generator(device="cuda").manual_seed(c.SEED)
    m = args.batch * c.N_TOKENS
    shapes = [(name, k, n) for name, k, n in c.INT8_GEMMS]
    shapes += [(name + "^T (dx)", n, k) for name, k, n in c.INT8_GEMMS]
    rows = []
    try:
        for name, k, n in shapes:
            w_i8, s_w = i8.quantize_cols(torch.randn((n, k), generator=gen, device="cuda")
                                         * k**-0.5)
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            row = {"gemm": name, "M": m, "K": k, "N": n}
            for variant in ("kernel", "no_products", "no_quantize", "kernel"):
                _build._libraries["int8_gemm"] = libs[variant]
                ms = c._device_ms(lambda: i8.int8_gemm_dynamic(x, w_i8, s_w), args.reps)
                row.setdefault(f"{variant}_ms", []).append(ms)
            kernel = sum(row["kernel_ms"]) / 2
            row["no_products_share"] = row["no_products_ms"][0] / kernel
            row["no_quantize_share"] = row["no_quantize_ms"][0] / kernel
            rows.append(row)
            print(f"split {name} M={m} K={k} N={n}: kernel "
                  + " / ".join(f"{t:.6f}" for t in row["kernel_ms"])
                  + f" ms, no_products {row['no_products_ms'][0]:.6f} "
                  f"({row['no_products_share']:.3f}), no_quantize "
                  f"{row['no_quantize_ms'][0]:.6f} ({row['no_quantize_share']:.3f})", flush=True)
    finally:
        _build._libraries["int8_gemm"] = libs["kernel"]
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi, "batch": args.batch,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
