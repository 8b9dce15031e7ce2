"""Per-kernel device profile of a step (counterpart of
``peft_vit_tpu/utils/xprof.py``, which reads xprof's op profile of a TPU
trace).

Two layers, as there:

* ``capture_trace``: run a step a few times under ``torch.profiler`` with
  the card's activity and write the Chrome trace (``trace.json``);
  ``profile_window`` / ``device_events`` give a window's device events
  without the file.
* ``parse_op_profile`` / ``format_op_profile``: the trace's device events
  (kernels, copies, memsets) in categories, the top kernels, the busy time
  and the window's idle share, as rows and as a terminal table.

Categories: each kernel of ``csrc/`` by its symbol (K1-K7, ``KERNELS``);
GEMM (cuBLAS, CUTLASS); conv (cuDNN); elementwise; reduction; copy or
memset; NCCL; other.  Where the FLOPs and bytes of a category are known
(``op_costs``: ``utils.summary.CostMode``'s count of one eager run of the
step, the registered ops' FLOP formulas and ATen's for the GEMMs and
convolutions), the table gives the
achieved rate as a share of one H100's published peaks (NVIDIA's H100 SXM
data sheet, dense: 989 TFLOP/s bf16, 1,979 TOP/s int8, 3.35 TB/s), which
assume the card's full 700 W: ``format_op_profile`` prints the card's name
and power limit beside them.  A trace without device events (a CPU run)
gives the JAX reader's note that there is no device plane.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten

__all__ = [
    "KERNELS",
    "capture_trace",
    "device_events",
    "kernel_category",
    "op_costs",
    "parse_op_profile",
    "profile_window",
    "format_op_profile",
]

# one H100 SXM, NVIDIA's data sheet (dense tensor-core rates)
H100_BF16_FLOPS_PER_S = 989e12
H100_INT8_OPS_PER_S = 1979e12
H100_HBM_BYTES_PER_S = 3.35e12

# the kernels of csrc/ by the demangled symbols torch.profiler records
# (template arguments: attn_fwd_sm90_kernel<keys, stream, norm_first, bias, D>,
# attn_bwd_sm90_kernel<role, bias, D> with role 0 dq, 1 dk/dv, 2 fused)
KERNELS: Tuple[Tuple[str, str], ...] = (
    ("K4", r"attn_fwd_sm90_kernel<\d+, (true|false), true\b|short_fwd_f32_kernel"),
    ("K1", r"attn_fwd_sm90_kernel<|flash_fwd_f32_kernel"),
    ("K2", r"attn_bwd_sm90_kernel<0\b|flash_bwd_dq_f32_kernel"),
    ("K3", r"attn_bwd_sm90_kernel<1\b|flash_bwd_dkv_f32_kernel"),
    ("K5", r"attn_bwd_sm90_kernel<2\b|short_bwd_f32_kernel"),
    ("K6", r"int8_gemm_kernel|int8_row_absmax_kernel"),
    ("K7", r"bias_grad_(bf16|sum|f32)_kernel"),
)
_RULES = (
    ("NCCL", r"nccl"),
    ("copy or memset", r"[Mm]emcpy|[Mm]emset|copy_kernel|CatArrayBatchedCopy"),
    ("conv", r"cudnn|conv|fprop|dgrad|wgrad|implicit_gemm"),
    ("GEMM", r"gemm|cutlass|cublas|nvjet|xmma|gemv|splitKreduce|sm90_|sm80_|ampere_"),
    ("reduction", r"reduce|Reduce|[Ss]oft[Mm]ax|norm|_sum|sum_|argmax|scan|max_kernel"),
    ("elementwise", r"elementwise|foreach|index|scatter|gather|fill|where|_kernel_impl"),
)


def kernel_category(name: str, cat: str = "kernel") -> str:
    """The category of a device event: its name, and the profiler's ``cat``
    (``gpu_memcpy`` / ``gpu_memset`` are copies whatever their name)."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy or memset"
    for label, pattern in (*KERNELS, *_RULES):
        if re.search(pattern, name):
            return label
    return "other"


def _sync(out) -> Any:
    for t in tree_flatten(out)[0]:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            break
    return out


def profile_window(step: Callable[[], Any], steps: int = 1, host: bool = True):
    """Run ``step()`` ``steps`` times under ``torch.profiler`` (the card's
    activity and, with ``host``, the host's ops) and wait for the card;
    returns the finished profiler.  Without the host's ops a window of tens
    of thousands of launches traces seconds faster, and a launch or two may
    go unrecorded (a probe on one H100 lost 2 of 80,000), so it serves a
    long run's busy time, not a count that is checked."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = None
        for _ in range(steps):
            out = step()
        _sync(out)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return prof


def device_events(prof) -> List[Dict]:
    """The device events of a finished ``torch.profiler`` window in the
    Chrome trace's form (name, cat, ts and dur in µs): its kernels, copies
    and memsets, without the profiler's own buffer requests and user
    annotations."""
    from torch.autograd import DeviceType

    return [{"ph": "X", "name": e.name, "cat": "kernel", "ts": e.time_range.start,
             "dur": e.time_range.elapsed_us()}
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name != "Activity Buffer Request"
            and not getattr(e, "is_user_annotation", False)]


def capture_trace(step: Callable[[], Any], log_dir: str, steps: int = 3,
                  warmup: int = 1) -> Optional[str]:
    """Run ``step()`` ``warmup`` times, then ``steps`` times in a
    ``profile_window`` (the host's ops and, with CUDA, the card's), and
    write the Chrome trace to ``log_dir/trace.json``; returns its path."""
    for _ in range(warmup):
        _sync(step())
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    profile_window(step, steps).export_chrome_trace(path)
    return path


def _device_events(trace) -> List[Dict]:
    """The device events (name, cat, ts and dur in µs) of a Chrome trace:
    a path, its parsed dict, or a list of events."""
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and float(e.get("dur", 0)) > 0]


def _busy(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def parse_op_profile(trace, costs: Optional[Dict[str, Tuple[float, float]]] = None,
                     top: int = 15) -> Dict[str, Any]:
    """The device events of ``trace`` (a Chrome trace path, dict or event
    list) as ``{"categories": [...], "ops": [...], "busy_us", "window_us",
    "idle_share"}``.  A row: ``name``, ``category``, ``time_us``, ``count``,
    ``share`` (of the busy time: the union of the events' intervals) and,
    where ``costs`` (``{category: (flops, bytes)}`` over the same window)
    names the category, ``tflops``, ``flops_share`` (of the bf16 peak, K6's
    of the int8 one) and ``bytes_share`` (of the memory rate).  The window
    runs from the first event's start to the last one's end; ``idle_share``
    is the part of it in which no event ran.  ``ops``: the ``top`` kernels
    by time."""
    events = _device_events(trace)
    if not events:
        return {"categories": [], "ops": [], "busy_us": 0.0, "window_us": 0.0,
                "idle_share": None}
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events]
    busy = _busy(spans)
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    by_cat: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    by_op: Dict[str, List[Any]] = {}
    for e in events:
        cat = kernel_category(e["name"], e["cat"])
        by_cat[cat][0] += float(e["dur"])
        by_cat[cat][1] += 1
        row = by_op.setdefault(e["name"], [cat, 0.0, 0])
        row[1] += float(e["dur"])
        row[2] += 1

    def row(name, cat, t, n):
        r = {"name": name, "category": cat, "time_us": t, "count": n,
             "share": t / busy if busy else 0.0}
        if name == cat and costs and cat in costs:
            flops, nbytes = costs[cat]
            peak = H100_INT8_OPS_PER_S if cat == "K6" else H100_BF16_FLOPS_PER_S
            r["tflops"] = flops / (t * 1e-6) / 1e12
            r["flops_share"] = flops / (t * 1e-6) / peak
            r["bytes_share"] = nbytes / (t * 1e-6) / H100_HBM_BYTES_PER_S
        return r

    cats = sorted((row(c, c, t, n) for c, (t, n) in by_cat.items()), key=lambda r: -r["time_us"])
    ops = sorted((row(name, c, t, n) for name, (c, t, n) in by_op.items()),
                 key=lambda r: -r["time_us"])[:top]
    return {"categories": cats, "ops": ops, "busy_us": busy, "window_us": window,
            "idle_share": 1.0 - busy / window if window else 0.0}


def format_op_profile(profile: Dict[str, Any], top: int = 15, card: str = "") -> str:
    """Terminal table: the categories, then the top kernels; ``card``: the
    card's name and power limit (nvidia-smi), printed beside the peaks."""
    if not profile["categories"]:
        return ("trace contains no device-op metrics (op_profile needs a TPU/GPU device "
                "plane; CPU traces only carry host events)")
    lines = [f"device busy {profile['busy_us']:.1f} us of a {profile['window_us']:.1f} us window "
             f"(idle share {profile['idle_share']:.3f})"]
    if card:
        lines.append(f"card: {card}; peaks: H100 SXM data sheet, 989 TFLOP/s bf16, 1,979 TOP/s "
                     "int8, 3.35 TB/s at 700 W")
    hdr = f"{'':<48} {'us':>10} {'share':>6} {'n':>6} {'TFLOP/s':>8} {'peak':>6} {'HBM':>6}"

    def fmt(r):
        rate = (f" {r['tflops']:8.1f} {r['flops_share']:6.3f} {r['bytes_share']:6.3f}"
                if "tflops" in r else "")
        return (f"{r['name'][:48]:<48} {r['time_us']:10.1f} {r['share']:6.3f} {r['count']:6d}"
                + rate)

    lines.append("category" + hdr[len("category"):])
    lines.extend(fmt(r) for r in profile["categories"])
    if profile["ops"][:top]:
        lines.append("")
        lines.append("top kernels" + hdr[len("top kernels"):])
        lines.extend(fmt(r) for r in profile["ops"][:top])
    return "\n".join(lines)


def op_costs(fn: Callable, *args) -> Dict[str, Tuple[float, float]]:
    """``{category: (flops, bytes)}`` of one eager run of ``fn(*args)``
    (``utils.summary.costs_of``) for the categories whose device time
    ``parse_op_profile`` can set them against: the registered ops by their
    kernel (K1-K7), ATen's matrix products (GEMM) and convolutions (conv)."""
    from .summary import costs_of

    return {k: v for k, v in costs_of(fn, *args).items() if k != "other"}
