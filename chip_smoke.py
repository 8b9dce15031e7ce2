#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA H100 and check it.

    python3 chip_smoke.py          # from the repository root, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. environment: Python, torch and CUDA versions; the card's name and
   power limit from nvidia-smi;
2. build: every kernel of ``peft_vit_tpu_torch/csrc`` with nvcc for sm_90a;
3. kernel: ``flash_attention_fwd`` (the CUDA counterpart of the Pallas
   flash forward) against its plain PyTorch version on the card: bf16 and
   fp32, with a bias, with lse, ragged N; then its time at B in {1, 8, 32}
   beside its bound, the plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it);
4. slice: the ViT-B/16 LoRA flagship (bf16, channel BN) built from a numpy
   weight tree in the JAX package's layout, served by ``ServingSession``
   with buckets (1, 8, 32) for requests of 1, 5, 8, 32 and 40 images.  The
   logits must be finite; the 5-image request must agree with the same
   model run on the CPU in fp32; the kernel must have been launched once
   per layer per forward batch.

The last two lines of standard output are a JSON object with the kernel's
numbers and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # dense tensor-core bf16
WIDTH, LAYERS, HEADS, IMAGE, PATCH = 768, 12, 12, 224, 16
OUTPUT_DIM, NUM_CLASSES, LORA_RANK = 512, 100, 4
N_TOKENS, HEAD_DIM = (IMAGE // PATCH) ** 2 + 1, WIDTH // HEADS
BUCKETS = (1, 8, 32)
REQUESTS = (1, 5, 8, 32, 40)
CHECKED_REQUEST = 5

# Tolerances, each with its reason.
TOL_BF16_OUT = 2e-2  # the repo's bf16 flash pin: p and o rounded to bf16 at other points
TOL_F32_OUT = 1e-4  # fp32 throughout; sums in another order than cuBLAS
TOL_LSE = 1e-3  # fp32 log-sum-exp of the same scores, another summation order
# Logits, as max |diff| / max |logit| against the same model in fp32 on the CPU.
# fp32 on the card: only the summation order differs, over 12 layers.
TOL_F32_LOGITS_REL = 1e-3
# bf16 on the card: bf16 keeps 8 significant bits, so each GEMM output and
# residual add rounds at ~4e-3 relative, and 12 random-weight layers grow
# that to several percent (6.9e-2 measured on the H100); the same model in
# bf16 on the CPU, with no kernel, is printed beside it as the yardstick.
TOL_BF16_LOGITS_REL = 1e-1

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def environment_phase() -> str:
    smi = nvidia_smi()
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    # fp32 references run in full fp32 (cuDNN convolutions default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_phase(ptxas_verbose: bool = False) -> float:
    from peft_vit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(ptxas_verbose=ptxas_verbose)
    seconds = time.perf_counter() - t0
    for name, text in logs.items():
        print(f"built lib{name}.so")
        if ptxas_verbose and text.strip():
            print(text.strip())
    print(f"build seconds {seconds:.2f}")
    return seconds


def _device_ms(fn, reps: int, trials: int = 5) -> float:
    """Median over trials of one CUDA-graph replay of ``reps`` calls, per
    call: device time without the host's launch overhead."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _eager_ms(fn, reps: int, trials: int = 5) -> float:
    """Median per-call time of ``reps`` back-to-back eager calls (includes
    the wrapper's host time when that exceeds the kernel's)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def attention_bound(b: int, h: int, n: int, d: int, itemsize: int):
    """Least time for the function: q, k, v read once and o written once,
    against 4*B*H*N^2*D flops at the bf16 tensor-core peak."""
    bytes_moved = 4 * b * h * n * d * itemsize
    flops = 4 * b * h * n * n * d
    t_bytes, t_flops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_flops) * 1e3, ("bytes" if t_bytes >= t_flops else "operations")


def kernel_phase(timing: bool = True) -> dict:
    from peft_vit_tpu_torch.ops import attention as attn

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(shape, dtype, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    # (name, B, N, dtype, scale, q std, bias, lse, tolerance of o).  The
    # serving path calls the kernel at scale 1.0 with q already multiplied
    # by 1/sqrt(D) (post-scale-q), so that case draws q at std 1/8.
    cases = [
        ("bf16 scale=1.0 (post-scaled q)", 8, N_TOKENS, torch.bfloat16, 1.0, 0.125, False, False, TOL_BF16_OUT),
        ("bf16 scale=0.125", 8, N_TOKENS, torch.bfloat16, 0.125, 1.0, False, False, TOL_BF16_OUT),
        ("bf16 bias", 8, N_TOKENS, torch.bfloat16, 0.125, 1.0, True, False, TOL_BF16_OUT),
        ("bf16 lse", 8, N_TOKENS, torch.bfloat16, 0.125, 1.0, False, True, TOL_BF16_OUT),
        ("bf16 ragged N=50 bias lse", 2, 50, torch.bfloat16, 0.125, 1.0, True, True, TOL_BF16_OUT),
        ("bf16 ragged N=257 bias lse", 2, 257, torch.bfloat16, 0.125, 1.0, True, True, TOL_BF16_OUT),
        ("fp32 bias lse", 2, N_TOKENS, torch.float32, 0.125, 1.0, True, True, TOL_F32_OUT),
        ("fp32 ragged N=257", 2, 257, torch.float32, 0.125, 1.0, False, True, TOL_F32_OUT),
    ]
    main_err = None
    for name, b, n, dtype, scale, q_std, with_bias, with_lse, tol in cases:
        shape = (b, HEADS, n, HEAD_DIM)
        q, k, v = rand(shape, dtype, q_std), rand(shape, dtype), rand(shape, dtype)
        bias = rand((HEADS, n, n), torch.float32) if with_bias else None
        out = attn.flash_attention_fwd(q, k, v, bias, scale, return_lse=with_lse)
        ref = attn._flash_attention_plain(q, k, v, bias, scale, with_lse)
        torch.cuda.synchronize()
        if with_lse:
            (out, lse), (ref, ref_lse) = out, ref
            lse_err = (lse - ref_lse).abs().max().item()
            check(lse.shape == (b, HEADS, 1, n) and lse_err <= TOL_LSE,
                  f"kernel {name}: lse max abs err {lse_err:.3e} <= {TOL_LSE:g}")
        err = (out.float() - ref.float()).abs().max().item()
        check(out.shape == shape and bool(torch.isfinite(out).all()) and err <= tol,
              f"kernel {name} {tuple(shape)}: out max abs err {err:.3e} <= {tol:g}")
        if main_err is None:
            main_err = err

    result = {"max_abs_err": main_err, "per_batch": {}}
    if not timing:
        return result
    import torch.nn.functional as F

    for b in BUCKETS:
        shape = (b, HEADS, N_TOKENS, HEAD_DIM)
        q = rand(shape, torch.bfloat16, 0.125)
        k, v = rand(shape, torch.bfloat16), rand(shape, torch.bfloat16)
        reps = 200
        row = {
            "ms": _device_ms(lambda: attn.flash_attention_fwd(q, k, v, None, 1.0), reps),
            "plain_ms": _device_ms(lambda: attn._flash_attention_plain(q, k, v, None, 1.0, False), 50),
            "library_ms": _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), reps),
            "eager_ms": _eager_ms(lambda: attn.flash_attention_fwd(q, k, v, None, 1.0), reps),
        }
        row["bound_ms"], row["bound_by"] = attention_bound(b, HEADS, N_TOKENS, HEAD_DIM, 2)
        result["per_batch"][b] = row
        print(f"kernel timing B={b} {tuple(shape)} bf16: " + " ".join(
            f"{key}={val:.6f}" if isinstance(val, float) else f"{key}={val}"
            for key, val in row.items()), flush=True)
    return result


def jax_layout_tree(rng: np.random.RandomState) -> dict:
    """Random flagship weights in the JAX package's variable layout (the
    names a flax init produces; Dense kernels (in, out), conv HWIO)."""

    def normal(*shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    def dense(i, o):
        return {"kernel": normal(i, o, std=i**-0.5), "bias": normal(o, std=0.02)}

    def layer_norm():
        return {"scale": 1.0 + normal(WIDTH, std=0.1), "bias": normal(WIDTH, std=0.02)}

    g = IMAGE // PATCH
    backbone = {
        "conv1": {"kernel": normal(PATCH, PATCH, 3, WIDTH, std=(PATCH * PATCH * 3) ** -0.5)},
        "class_embedding": normal(WIDTH, std=WIDTH**-0.5),
        "positional_embedding": normal(g * g + 1, WIDTH, std=0.1),
        "ln_pre": layer_norm(),
        "ln_post": layer_norm(),
        "proj": normal(WIDTH, OUTPUT_DIM, std=WIDTH**-0.5),
    }
    for i in range(LAYERS):
        attn = {"in_proj": dense(WIDTH, 3 * WIDTH), "out_proj": dense(WIDTH, WIDTH)}
        for t in ("q", "v"):
            attn[f"{t}_adapter1"] = {"kernel": normal(WIDTH, LORA_RANK, std=0.02)}
            attn[f"{t}_adapter2"] = {"kernel": normal(LORA_RANK, WIDTH, std=0.02)}
        backbone[f"blocks_{i}"] = {
            "ln_1": layer_norm(),
            "attn": attn,
            "ln_2": layer_norm(),
            "mlp": {"c_fc": dense(WIDTH, 4 * WIDTH), "c_proj": dense(4 * WIDTH, WIDTH)},
        }
    return {
        "params": {"backbone": backbone, "classifier": {"head": dense(OUTPUT_DIM, NUM_CLASSES)}},
        "batch_stats": {"classifier": {"channel_bn": {
            "bn_mean": normal(OUTPUT_DIM, std=0.1),
            "bn_var": rng.uniform(0.5, 1.5, OUTPUT_DIM).astype(np.float32),
        }}},
    }


def prototype_head(tree: dict, feats: np.ndarray) -> None:
    """Make class c (c < len(feats)) the nearest-prototype class of image c:
    its head row is image c's BN-standardised feature, centred over the
    images and scaled so that the CPU fp32 logit of image c for class c is
    10, and its bias removes the shared centre.  Random weights give no
    decisive class; this makes top-1 a test of each image's identity."""
    stats = tree["batch_stats"]["classifier"]["channel_bn"]
    z = (feats - stats["bn_mean"]) / np.sqrt(stats["bn_var"] + 1e-5)
    centre = z.mean(axis=0)
    d = z - centre
    rows = 10.0 * d / (d * d).sum(axis=1, keepdims=True)
    head = tree["params"]["classifier"]["head"]
    head["kernel"][:, : len(feats)] = rows.T
    head["bias"][: len(feats)] = -(rows @ centre)
    spread = float(np.linalg.norm(d, axis=1).mean() / np.linalg.norm(z, axis=1).mean())
    print(f"slice: prototype head over {len(feats)} images, feature spread {spread:.4f} "
          "(mean |z - centre| / mean |z|)")


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def slice_phase(smi: str) -> dict:
    from peft_vit_tpu_torch.engine import ServingSession, make_infer_fn
    from peft_vit_tpu_torch.models import flagship, load_jax_variables, params_from_jax
    from peft_vit_tpu_torch.ops import attention as attn

    rng = np.random.RandomState(SEED)
    tree = jax_layout_tree(rng)
    requests = {n: rng.standard_normal((n, IMAGE, IMAGE, 3)).astype(np.float32) for n in REQUESTS}
    checked = requests[CHECKED_REQUEST]

    t0 = time.perf_counter()
    shape = dict(width=WIDTH, layers=LAYERS, heads=HEADS, image=IMAGE, patch=PATCH,
                 num_classes=NUM_CLASSES, use_bn=True)
    cpu_model = flagship(**shape, dtype=torch.float32, device="cpu").eval()
    load_jax_variables(cpu_model, tree)
    with torch.no_grad():
        feats = cpu_model.backbone(torch.from_numpy(checked)).numpy()
    prototype_head(tree, feats)
    load_jax_variables(cpu_model, tree)
    with torch.no_grad():
        cpu_logits = cpu_model(torch.from_numpy(checked)).numpy()
    print(f"slice: CPU fp32 reference of {CHECKED_REQUEST} images in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cpu_bf16 = load_jax_variables(
        flagship(**shape, dtype=torch.bfloat16, device="cpu"), tree).eval()
    with torch.no_grad():
        cpu_bf16_logits = cpu_bf16(torch.from_numpy(checked)).float().numpy()
    del cpu_bf16
    drift_cpu_bf16 = _rel(cpu_bf16_logits, cpu_logits)
    print(f"slice: bf16 on the CPU (no kernel) vs fp32 CPU: max |logit diff| / max |logit| = "
          f"{drift_cpu_bf16:.4e} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    session = ServingSession(flagship(**shape), params_from_jax(tree), IMAGE,
                             buckets=BUCKETS)
    print(f"slice: ServingSession ready in {time.perf_counter() - t0:.1f} s "
          f"(buckets {BUCKETS}, warm-up included)")

    # the main path: counts from 0 just before, read just after
    attn.flash_attention_fwd.launches = 0
    logits = {n: session.predict(x) for n, x in requests.items()}
    launches = attn.flash_attention_fwd.launches
    batches = sum(math.ceil(n / BUCKETS[-1]) for n in REQUESTS)

    for n, out in logits.items():
        check(out.shape == (n, NUM_CLASSES) and out.dtype == np.float32
              and bool(np.isfinite(out).all()),
              f"slice: request of {n} -> finite float32 logits {out.shape}")
    check(launches == LAYERS * batches and launches > 0,
          f"slice: flash_attn_fwd launches {launches} == {LAYERS} layers x {batches} batches")
    got = logits[CHECKED_REQUEST]
    rel = _rel(got, cpu_logits)
    top_gpu, top_cpu = got.argmax(axis=1), cpu_logits.argmax(axis=1)
    check(bool((top_gpu == top_cpu).all()),
          f"slice: top-1 bf16 card {top_gpu.tolist()} == fp32 CPU {top_cpu.tolist()}")
    check(rel <= TOL_BF16_LOGITS_REL,
          f"slice: bf16 card vs fp32 CPU: max |logit diff| / max |logit| = {rel:.4e} "
          f"<= {TOL_BF16_LOGITS_REL:g} (bf16 CPU: {drift_cpu_bf16:.4e})")

    # the port's arithmetic on the card with no bf16 rounding: fp32 throughout,
    # through the kernel's fp32 instantiation
    infer32 = make_infer_fn(flagship(**shape, dtype=torch.float32), params_from_jax(tree))
    card32 = infer32(torch.from_numpy(checked).cuda()).cpu().numpy()
    rel32 = _rel(card32, cpu_logits)
    check(rel32 <= TOL_F32_LOGITS_REL and bool((card32.argmax(1) == top_cpu).all()),
          f"slice: fp32 card vs fp32 CPU: max |logit diff| / max |logit| = {rel32:.4e} "
          f"<= {TOL_F32_LOGITS_REL:g}, top-1 equal")
    del infer32

    latency = {}
    for b in BUCKETS:
        x = rng.standard_normal((b, IMAGE, IMAGE, 3)).astype(np.float32)
        session.predict(x)
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            session.predict(x)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        latency[b] = ms
        print(f"slice latency bucket {b}: {ms:.3f} ms/request, {b / ms * 1e3:.1f} images/s "
              f"(median of 10, host clock, NHWC fp32 in -> fp32 logits out; {smi})")
        device_ms, top = _device_breakdown(lambda: session.predict(x), reps=3)
        if device_ms is None:
            print(f"slice profile bucket {b}: device time not measured (the profiler saw no "
                  "CUDA kernel)")
            continue
        print(f"slice profile bucket {b}: device busy {device_ms:.3f} ms/request, idle share "
              f"{max(0.0, 1.0 - device_ms / ms):.3f} of the {ms:.3f} ms request; top: "
              + "; ".join(f"{name} {t:.3f} ms" for name, t in top))
    return {"launches": launches, "batches": batches, "latency_ms": latency}


def _device_breakdown(fn, reps: int, top: int = 6):
    """Device time per call and the kernels that take most of it, from
    torch.profiler's CUDA activity (None when it records no kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        # kernels and copies only: a CPU op's row repeats its kernels' time,
        # and the activity-buffer row is the profiler's own
        if ev.device_type != DeviceType.CUDA or ev.key == "Activity Buffer Request":
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((ev.key[:48], t / 1e3 / reps))
    if not rows:
        return None, []
    rows.sort(key=lambda r: -r[1])
    return sum(t for _, t in rows), rows[:top]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = environment_phase()
    build_phase(ptxas_verbose=True)
    kern = kernel_phase()
    slc = slice_phase(smi)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed", file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    main_b = 8
    row = kern["per_batch"][main_b]
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "peft_vit_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "peft_vit_tpu/ops/attention.py:247",
        "launches": slc["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
