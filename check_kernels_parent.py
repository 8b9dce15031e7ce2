#!/usr/bin/env python3
"""Hold the attention kernels at head dim 64 against an earlier tree's build
of the same kernels, bit for bit, on one NVIDIA GPU.

    mkdir -p build/parent
    git archive <rev> peft_vit_tpu_torch | tar -x -C build/parent
    python3 check_kernels_parent.py --parent build/parent

``--parent DIR`` holds an earlier ``peft_vit_tpu_torch`` package; its
``csrc/`` is built with its own ``ops/_build.py`` into ``DIR/build/``.  The
current wrappers of ``ops/attention.py`` then call both builds on the same
inputs: K1 (with and without a bias, with lse), K2 (dq and delta), K3 (dk,
dv), K7 (delta given, and from o), K4 and K5, bf16 and fp32, at N = 8, 50,
197, 257 and 577, one bias or three cells.  Every output must be equal.
Prints one line per case and kernel that differs, a summary, and exits 1
when any differs.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

import torch

HEADS, HEAD_DIM = 12, 64
CASES = ((2, 8), (4, 50), (8, 197), (2, 257), (1, 577))  # (B, N)


def parent_build(parent: Path):
    """The parent tree's ``ops/_build.py`` as a module: it builds the
    parent's ``csrc/`` into ``parent/build/peft_vit_tpu_torch``."""
    path = parent / "peft_vit_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location("parent_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def outputs(attn, q, k, v, do, bias, cells: int) -> dict:
    """Every kernel's outputs on one case (bias None: the bias-free kernels
    and the fused pair)."""
    o, lse = attn.flash_attention_fwd(q, k, v, bias, 0.125, return_lse=True)
    dq, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, 0.125, bias)
    dk, dv = attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta, 0.125, bias)
    out = {"K1 o": o, "K1 lse": lse, "K2 dq": dq, "K2 delta": delta, "K3 dk": dk, "K3 dv": dv}
    if bias is not None:
        out["K7"] = attn.attention_bias_grad(q, k, v, do, lse, 0.125, bias, delta=delta)
        out["K7 from o"] = attn.attention_bias_grad(q, k, v, do, lse, 0.125, bias, o=o)
    elif q.shape[2] <= attn.FUSED_MAX_SEQ:
        fo, flse = attn.fused_short_attention_fwd(q, k, v, 0.125, return_lse=True)
        out["K4 o"], out["K4 lse"] = fo, flse
        for name, t in zip(("K5 dq", "K5 dk", "K5 dv"),
                           attn.fused_short_attention_bwd(q, k, v, fo, flse, do, 0.125)):
            out[name] = t
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    args = ap.parse_args()
    from peft_vit_tpu_torch.ops import attention as attn

    current = attn._build
    older = parent_build(args.parent.resolve())
    older.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    checked, differ = 0, []
    for dtype in (torch.bfloat16, torch.float32):
        for b, n in CASES:
            for cells in (0, 1, 3):
                bb = b * max(cells, 1)
                shape = (bb, HEADS, n, HEAD_DIM)
                q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                               for _ in range(4))
                bias = None
                if cells:
                    bias = torch.randn((cells, HEADS, n, n), generator=gen, device="cuda")
                    bias = bias[0] if cells == 1 else bias
                got = {}
                for which, build in (("current", current), ("parent", older)):
                    attn._build = build
                    try:
                        got[which] = outputs(attn, q, k, v, do, bias, cells)
                    finally:
                        attn._build = current
                for name, t in got["current"].items():
                    checked += 1
                    if not torch.equal(t, got["parent"][name]):
                        diff = (t.float() - got["parent"][name].float()).abs().max().item()
                        differ.append(f"{name} {str(dtype)[6:]} {tuple(shape)} cells={cells}: "
                                      f"max abs diff {diff:.3e}")
    for line in differ:
        print(f"differs: {line}")
    print(f"check_kernels_parent: {checked} outputs at head dim 64, "
          f"{checked - len(differ)} equal to the parent's bit for bit, {len(differ)} differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
