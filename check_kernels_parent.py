#!/usr/bin/env python3
"""Hold the attention kernels at head dim 64 against an earlier tree's build
of the same kernels on one NVIDIA GPU, and time K7 of both builds.

    mkdir -p build/parent
    git archive <rev> peft_vit_tpu_torch | tar -x -C build/parent
    python3 check_kernels_parent.py --parent build/parent [--time]

``--parent DIR`` holds an earlier ``peft_vit_tpu_torch`` package.  Its
``ops/attention.py`` is loaded beside the current one, each with its own
``ops/_build.py`` (the parent's builds its ``csrc/`` into ``DIR/build/``),
so each build is called through its own wrappers, whatever its C
interface.  Both run on the same inputs: K1 (with and without a bias, with
lse), K2 (dq and delta), K3 (dk, dv), K7 (delta given, and from o), K4 and
K5, bf16 and fp32, at N = 8, 50, 197, 257 and 577, one bias or three cells.
Every output of K1-K5 must be equal bit for bit.  K7's bf16 sum over the
batch runs in chunks since its Hopper redesign, an order that no earlier
sequential sum can match, so K7 is held to ``TOL_DBIAS_REL`` of each cell's
max sum over its batch of |ds| (``chip_smoke.py``'s bound against the plain
version), its fp32 body bit for bit.  Prints one line per case and kernel
that differs (K7: the largest relative error), a summary, and exits 1 when
any differs.

``--time`` then times K7 (bf16, delta given) of both builds in turns
(parent, current, current, parent; CUDA-graph replay) at ViT-B/16 (16, 12,
197, 64) and Swin-T's stage-0 and stage-2 folds at B = 64 (64, 192 / 48,
49, 32, the shifted block's bias).
"""

from __future__ import annotations

import argparse
import importlib
import sys
import types
from pathlib import Path

import torch

import chip_smoke

HEADS, HEAD_DIM = 12, 64
CASES = ((2, 8), (4, 50), (8, 197), (2, 257), (1, 577))  # (B, N)
# bf16 K7 of both builds may differ in summation order only (see above)
ORDER_ONLY = ("K7", "K7 from o")


def parent_attention(parent: Path):
    """The parent tree's ``ops/attention.py`` as the module
    ``_parent_ops.attention``, beside the current one: its relative imports
    (``ops/_build.py``, which builds the parent's ``csrc/`` into
    ``parent/build/peft_vit_tpu_torch``) resolve in the parent's ``ops/``."""
    package = types.ModuleType("_parent_ops")
    package.__path__ = [str(parent / "peft_vit_tpu_torch" / "ops")]
    sys.modules["_parent_ops"] = package
    return importlib.import_module("_parent_ops.attention")


def outputs(attn, q, k, v, do, bias, cells: int) -> dict:
    """Every kernel's outputs on one case through the wrappers of ``attn``
    (bias None: the bias-free kernels and the fused pair)."""
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


def time_bias_grad(attn, older) -> None:
    """K7 (bf16, delta given) of both builds in turns at the ViT-B/16 and
    Swin-T stage-0 / stage-2 shapes, device time a call."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    cases = [("ViT-B/16", (16, HEADS, 197, HEAD_DIM), chip_smoke._bias(rand, 1, 197, True), 1.0)]
    for stage in (0, 2):
        res, heads = chip_smoke.SWIN_STAGES[stage]
        bias = chip_smoke.swin_bias(rand, 1, res, chip_smoke.SWIN_WINDOW, heads, True,
                                    torch.bfloat16)
        cases.append((f"Swin-T stage {stage}", (64, bias.shape[0], 49, 32), bias, 32 ** -0.5))
    for name, shape, bias, scale in cases:
        q, k, v, do = (rand(shape, torch.bfloat16) for _ in range(4))
        o, lse = attn.flash_attention_fwd(q, k, v, bias, scale, return_lse=True)
        _, delta = attn.flash_attention_bwd_dq(q, k, v, do, lse, o, scale, bias)
        times = {"parent": [], "current": []}
        for which in ("parent", "current", "current", "parent"):
            module = older if which == "parent" else attn
            times[which].append(chip_smoke._device_ms(lambda: module.attention_bias_grad(
                q, k, v, do, lse, scale, bias, delta=delta), 100))
        print(f"K7 time {name} {shape} bf16: parent " + " / ".join(
            f"{t * 1e3:.3f}" for t in times["parent"]) + " us, current " + " / ".join(
            f"{t * 1e3:.3f}" for t in times["current"]) + " us (parent, current, current, "
            "parent; graph replay)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--time", action="store_true", help="also time K7 of both builds")
    args = ap.parse_args()
    from peft_vit_tpu_torch.ops import attention as attn

    older = parent_attention(args.parent.resolve())
    for module in (attn, older):  # each build's sources in parallel
        module._build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    checked, differ, worst_k7 = 0, [], 0.0
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
                got = {"current": outputs(attn, q, k, v, do, bias, cells),
                       "parent": outputs(older, q, k, v, do, bias, cells)}
                if bias is not None:
                    cur = got["current"]
                    scale = chip_smoke._dbias_scale(attn, q, k, v, do, cur["K1 lse"],
                                                    cur["K2 delta"], bias, 0.125)
                for name, t in got["current"].items():
                    checked += 1
                    ref = got["parent"][name]
                    if name in ORDER_ONLY and dtype == torch.bfloat16:
                        per_cell = (t - ref).abs().reshape(max(cells, 1), -1).amax(1)
                        rel = (per_cell / scale).max().item()
                        worst_k7 = max(worst_k7, rel)
                        if rel > chip_smoke.TOL_DBIAS_REL:
                            differ.append(f"{name} bf16 {tuple(shape)} cells={cells}: max abs "
                                          f"diff a cell / its max sum_b |ds| {rel:.3e} > "
                                          f"{chip_smoke.TOL_DBIAS_REL:g}")
                    elif not torch.equal(t, ref):
                        diff = (t.float() - ref.float()).abs().max().item()
                        differ.append(f"{name} {str(dtype)[6:]} {tuple(shape)} cells={cells}: "
                                      f"max abs diff {diff:.3e}")
    for line in differ:
        print(f"differs: {line}")
    print(f"check_kernels_parent: {checked} outputs at head dim 64, "
          f"{checked - len(differ)} equal to the parent's (bf16 K7 within "
          f"{chip_smoke.TOL_DBIAS_REL:g} of each cell's max sum_b |ds|, largest "
          f"{worst_k7:.3e}; every other bit for bit), {len(differ)} differ", flush=True)
    if args.time:
        time_bias_grad(attn, older)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
