#!/usr/bin/env python3
"""Hold the attention kernels at head dim 64 and the int8 GEMM against an
earlier tree's build of the same kernels on one NVIDIA GPU, and time K7 of
both builds.

    mkdir -p build/parent
    git archive <rev> peft_vit_tpu_torch | tar -x -C build/parent
    python3 check_kernels_parent.py --parent build/parent [--time]

``--parent DIR`` holds an earlier ``peft_vit_tpu_torch`` package.  It is
loaded beside the current one as ``_parent_pkg`` (``parent_package``), its
``ops/_build.py`` building its ``csrc/`` into ``DIR/build/``, so each build
is called through its own wrappers, whatever its C interface.  Both run on the same inputs: K1 (with and without a bias, with
lse), K2 (dq and delta), K3 (dk, dv), K7 (delta given, and from o), K4 and
K5, bf16 and fp32, at N = 8, 50, 197, 257 and 577, one bias or three cells;
K6 dynamic and static, bf16 and fp32, at the ViT-B/16 GEMMs' shapes and
the layout's edges (``INT8_CASES``).  Every output of K1-K6 must be equal
bit for bit.  K7's bf16 sum over the
batch runs in chunks since its Hopper redesign, an order that no earlier
sequential sum can match, so K7 is held to ``TOL_DBIAS_REL`` of each cell's
max sum over its batch of |ds| (``chip_smoke.py``'s bound against the plain
version), its fp32 body bit for bit.  Prints one line per case and kernel
that differs (K7: the largest relative error), a summary, and exits 1 when
any differs.

``--time`` then times K7 (bf16, delta given) of both builds in turns
(parent, current, current, parent; CUDA-graph replay) at ViT-B/16 (16, 12,
197, 64) and Swin-T's stage-0 and stage-2 folds at B = 64 (64, 192 / 48,
49, 32, the shifted block's bias).  ``--host`` times, in the same turns,
the host cost of the K1 and K6 wrappers and of an eager ViT-B/16 forward,
the parent's models and serving beside the current ones (``time_host``).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import statistics
import sys
import time
from pathlib import Path

import torch

import chip_smoke

HEADS, HEAD_DIM = 12, 64
CASES = ((2, 8), (4, 50), (8, 197), (2, 257), (1, 577))  # (B, N)
# bf16 K7 of both builds may differ in summation order only (see above)
ORDER_ONLY = ("K7", "K7 from o")
# (M, K, N) of K6: a block's four GEMMs at B = 16 (M = 3152) and one image,
# a dx product, and the code slab's and column tile's edges
INT8_CASES = ((3152, 768, 2304), (3152, 768, 768), (3152, 768, 3072), (3152, 3072, 768),
              (197, 768, 2304), (3152, 2304, 768), (63, 192, 64), (65, 704, 192), (1, 3072, 64))


def parent_package(parent: Path):
    """The parent tree's ``peft_vit_tpu_torch`` as the package ``_parent_pkg``,
    beside the current one: its relative imports resolve in the parent's
    tree, its ``ops/_build.py`` builds the parent's ``csrc/`` into
    ``parent/build/peft_vit_tpu_torch``, and its kernels' ops (if it
    registers any) take the namespace ``_parent_pkg``."""
    root = parent / "peft_vit_tpu_torch"
    spec = importlib.util.spec_from_file_location("_parent_pkg", root / "__init__.py",
                                                  submodule_search_locations=[str(root)])
    package = importlib.util.module_from_spec(spec)
    sys.modules["_parent_pkg"] = package
    spec.loader.exec_module(package)
    return package


def _host_us(fn, calls: int) -> float:
    """Host time of ``calls`` back-to-back calls of ``fn``, µs a call (the
    card drained before and after, neither timed)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def time_host(older) -> None:
    """The host cost of the kernels' launches, the parent tree against the
    current one in turns (parent, current, current, parent): the public
    wrappers of K1 (1, 12, 197, 64) bf16 and K6 dynamic at in_proj's
    (197, 768) x (2304, 768), µs a call over 500 calls, 8 turns; and the
    eager ViT-B/16 LoRA eval forward (12 blocks, bf16 and int8, B = 1 and
    8) of each tree's ``flagship`` and ``make_infer_fn`` on the same
    weights, ms a forward ending in a synchronize, the median and the least
    of 8 turns of 20."""
    import numpy as np

    import peft_vit_tpu_torch as current
    from peft_vit_tpu_torch.engine.serving import make_infer_fn
    from peft_vit_tpu_torch.models import flagship, params_from_jax

    trees = {"parent": older, "current": current}
    infer = {"parent": importlib.import_module("_parent_pkg.engine.serving").make_infer_fn,
             "current": make_infer_fn}
    build = {"parent": importlib.import_module("_parent_pkg.models").flagship,
             "current": flagship}
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((1, HEADS, 197, HEAD_DIM), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    x = torch.randn((197, 768), generator=gen, device="cuda", dtype=torch.bfloat16)
    w_i8, s_w = current.ops.int8.quantize_cols(
        torch.randn((2304, 768), generator=gen, device="cuda"))
    calls = {"K1 flash_attention_fwd": lambda t: t.ops.attention.flash_attention_fwd(
                 q, k, v, None, 0.125),
             "K6 int8_gemm_dynamic": lambda t: t.ops.int8.int8_gemm_dynamic(x, w_i8, s_w)}
    order = ("parent", "current", "current", "parent")
    for name, call in calls.items():
        times = {w: [] for w in trees}
        for which in order * 2:
            times[which].append(_host_us(lambda: call(trees[which]), 500))
        print(f"host time {name} wrapper: parent " + " / ".join(
            f"{t:.2f}" for t in times["parent"]) + " us, current " + " / ".join(
            f"{t:.2f}" for t in times["current"]) + " us a call (turns parent, current, current, "
            f"parent, twice); {chip_smoke.nvidia_smi()}", flush=True)
    state = params_from_jax(chip_smoke.jax_layout_tree(np.random.RandomState(3), layers=12))
    shape = dict(width=768, layers=12, heads=HEADS, image=224, patch=16,
                 num_classes=chip_smoke.NUM_CLASSES, use_bn=True)
    for int8 in (False, True):
        fns = {w: infer[w](build[w](**shape, int8=int8, device="cuda"), state) for w in trees}
        for n in (1, 8):
            img = torch.randn((n, 224, 224, 3), generator=gen, device="cuda")
            same = torch.equal(fns["parent"](img), fns["current"](img))
            times = {w: [] for w in trees}
            for which in order * 2:
                fn = fns[which]
                for _ in range(20):
                    t0 = time.perf_counter()
                    fn(img)
                    torch.cuda.synchronize()
                    times[which].append((time.perf_counter() - t0) * 1e3)
            print(f"eager ViT-B/16 LoRA {'int8' if int8 else 'bf16'} forward B={n}: "
                  + "; ".join(f"{w} median {statistics.median(t):.3f} min {min(t):.3f} ms"
                              for w, t in times.items())
                  + " (8 turns of 20 forwards, parent first, host clock ending in a "
                  f"synchronize); logits equal: {same}; {chip_smoke.nvidia_smi()}", flush=True)
        del fns


def int8_outputs(i8, gen) -> dict:
    """K6's dynamic and static outputs through the wrappers of ``i8`` on the
    ``INT8_CASES``, from the generator ``gen`` (the same draws for both
    builds when it starts from the same seed)."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for m, k, n in INT8_CASES:
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = torch.randn((n, k), generator=gen, device="cuda") * k**-0.5
            w_i8, s_w = i8.quantize_cols(w)
            s_x = x.float().abs().max() * 1.5 / 127.0
            tag = f"{str(dtype)[6:]} M={m} K={k} N={n}"
            out[f"K6 dynamic {tag}"] = i8.int8_gemm_dynamic(x, w_i8, s_w)
            out[f"K6 static {tag}"] = i8.int8_gemm_static(x, w_i8, s_w, s_x)
    torch.cuda.synchronize()
    return out


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
    ap.add_argument("--host", action="store_true",
                    help="also time the K1 and K6 wrappers and an eager ViT-B/16 forward of "
                         "both trees on the host")
    args = ap.parse_args()
    from peft_vit_tpu_torch.ops import attention as attn

    from peft_vit_tpu_torch.ops import int8 as i8

    parent = parent_package(args.parent.resolve())
    older = importlib.import_module("_parent_pkg.ops.attention")
    older_i8 = importlib.import_module("_parent_pkg.ops.int8")
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
    got = {"current": int8_outputs(i8, torch.Generator(device="cuda").manual_seed(1)),
           "parent": int8_outputs(older_i8, torch.Generator(device="cuda").manual_seed(1))}
    for name, t in got["current"].items():
        checked += 1
        if not torch.equal(t, got["parent"][name]):
            diff = (t.float() - got["parent"][name].float()).abs().max().item()
            differ.append(f"{name}: max abs diff {diff:.3e}")
    for line in differ:
        print(f"differs: {line}")
    print(f"check_kernels_parent: {checked} outputs (K1-K5 and K7 at head dim 64, K6), "
          f"{checked - len(differ)} equal to the parent's (bf16 K7 within "
          f"{chip_smoke.TOL_DBIAS_REL:g} of each cell's max sum_b |ds|, largest "
          f"{worst_k7:.3e}; every other bit for bit), {len(differ)} differ", flush=True)
    if args.time:
        time_bias_grad(attn, older)
    if args.host:
        time_host(parent)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
