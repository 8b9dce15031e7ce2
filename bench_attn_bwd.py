#!/usr/bin/env python3
"""Time the flash-attention backward of the PyTorch/CUDA port in turns with
the version before delta moved into the dq kernel, on one NVIDIA GPU.

    mkdir -p build/parent_bwd
    for f in flash_attn_bwd.cu flash_common.cuh; do
      git show <rev>:peft_vit_tpu_torch/csrc/$f > build/parent_bwd/$f
    done
    python3 bench_attn_bwd.py --parent build/parent_bwd

``--parent DIR`` holds that earlier ``flash_attn_bwd.cu`` (its dq entry
point takes delta) and the headers it includes.  It is built with nvcc into
``build/bench_attn_bwd/`` and timed as the backward ran then: delta =
rowsum(dO o O) in PyTorch (``ops.attention._row_dot``), then its dq and dk/dv
kernels.  The current backward is ``chip_smoke.flash_backward`` (K2 with
delta inside, then K3).  The two run in turns, parent, current, current,
parent, so that both see the same card.  Shapes: (B, 12, 197, 64) bf16 at
B = 8, 16, 32 (``--batches``), scale 1 with q at std 1/8, o and lse from the
forward kernel; every time is ``chip_smoke._device_ms`` (median of five
CUDA-graph replays of 200 calls, L2-warm).  Each kernel's own time, its
bound and SDPA's backward are in ``chip_smoke.py``'s kernel timing.

Prints a line per batch, the card's name and power limit, and one JSON
object last.
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
BUILD = ROOT / "build" / "bench_attn_bwd"
HEADS, N_TOKENS, HEAD_DIM = 12, 197, 64
REPS = 200
TOL_REL = 1e-2  # chip_smoke.TOL_BF16_GRAD_REL


def build_parent(src_dir: Path) -> ctypes.CDLL:
    from peft_vit_tpu_torch.ops import _build

    out = BUILD / "libparent_flash_attn_bwd.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src_dir / "flash_attn_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attn_bwd_dq.argtypes = [i32, *[ptr] * 7, *[i32] * 4, f32, i32, ptr]
    lib.flash_attn_bwd_dkv.argtypes = [i32, *[ptr] * 8, *[i32] * 4, f32, i32, ptr]
    lib.flash_attn_bwd_dq.restype = lib.flash_attn_bwd_dkv.restype = i32
    return lib


def parent_backward(lib, attn, q, k, v, o, lse, do):
    """The earlier backward: delta in PyTorch, then its two kernels."""
    b, h, n, d = q.shape
    delta = attn._row_dot(do, o)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream
    dev = q.device.index or 0
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    err = lib.flash_attn_bwd_dq(dev, *ptrs, dq.data_ptr(), b, h, n, d, 1.0, 1, stream)
    err |= lib.flash_attn_bwd_dkv(dev, *ptrs, dk.data_ptr(), dv.data_ptr(), b, h, n, d, 1.0, 1,
                                  stream)
    if err:
        raise RuntimeError(f"parent launch failed ({err})")
    return dq, dk, dv


def max_rel_err(got, want) -> float:
    return max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
               for g, w in zip(got, want))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 16, 32])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_attn_bwd: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import chip_smoke
    from peft_vit_tpu_torch.ops import _build
    from peft_vit_tpu_torch.ops import attention as attn

    smi = chip_smoke.nvidia_smi()
    print(f"nvidia-smi: {smi}", flush=True)
    _build.build(["flash_attn_fwd", "flash_attn_bwd"])
    parent = build_parent(args.parent)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda shape, std=1.0: (torch.randn(shape, generator=gen, device="cuda") * std).to(
        torch.bfloat16)
    results = []
    for b in args.batches:
        shape = (b, HEADS, N_TOKENS, HEAD_DIM)
        q, k, v, do = rand(shape, 0.125), rand(shape), rand(shape), rand(shape)
        o, lse = attn.flash_attention_fwd(q, k, v, None, 1.0, return_lse=True)
        want = attn._flash_attention_bwd_plain(q, k, v, o, lse, do, 1.0)
        run_parent = lambda: parent_backward(parent, attn, q, k, v, o, lse, do)
        run_current = lambda: chip_smoke.flash_backward(attn, q, k, v, o, lse, do)
        row = {"batch": b, "parent_err": max_rel_err(run_parent(), want),
               "current_err": max_rel_err(run_current(), want)}
        row["turns_ms"] = [chip_smoke._device_ms(fn, REPS)
                           for fn in (run_parent, run_current, run_current, run_parent)]
        print(f"B={b} parent / current / current / parent ms: {row['turns_ms']}; max rel err "
              f"parent {row['parent_err']:.3e}, current {row['current_err']:.3e}", flush=True)
        if max(row["parent_err"], row["current_err"]) > TOL_REL:
            print(f"bench_attn_bwd: a backward stands more than {TOL_REL} from its plain "
                  "version", file=sys.stderr)
            return 1
        results.append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "shape": [None, HEADS, N_TOKENS, HEAD_DIM], "rows": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
