"""Multi-card scaling prediction from single-card measurements (counterpart
of ``peft_vit_tpu/utils/scaling.py``, with its formulas).

Count the bytes each parallelism strategy puts on the wire per optimizer
step, divide by the interconnect's rate, and compare with the measured
single-card step time.  Ring collectives: an all-reduce of S bytes moves
2 S (n - 1) / n per card, an all-gather or reduce-scatter S (n - 1) / n, a
pipeline send its payload once.  Weak scaling: the per-card batch, and so
the per-card compute time, stays fixed as cards are added; ``efficiency``
assumes the collectives overlap independent compute.

The numbers are PREDICTIONS: they say which strategy's collectives fit
under the compute time, not what a cluster will clock.  The default rate is
one H100's NVLink, 900 GB/s to the other cards of its host, 450 GB/s each
way (NVIDIA's H100 SXM data sheet); across hosts the network is slower.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

# NVIDIA H100 SXM data sheet: fourth-generation NVLink, 900 GB/s a card all
# to all within a host, 450 GB/s each way
H100_NVLINK_BYTES_PER_S = 450e9


@dataclass
class StepProfile:
    """What one optimizer step does on one card (measured or derived)."""

    step_time_s: float  # measured single-card step wall time
    per_chip_batch: int
    seq_len: int  # tokens after patchify (ViT-B/16 at 224 px: 197)
    width: int  # hidden size
    layers: int
    trainable_bytes: int  # gradient bytes all-reduced a step (fp32)
    grad_dtype_bytes: int = 4


def _ring_allreduce(size: float, n: int) -> float:
    return 2.0 * size * (n - 1) / n


def _ring_gather(size: float, n: int) -> float:
    return 1.0 * size * (n - 1) / n


def predict(prof: StepProfile, n_chips: int, strategy: str = "dp",
            link_bytes_per_s: float = H100_NVLINK_BYTES_PER_S,
            act_dtype_bytes: int = 2) -> Dict[str, float]:
    """Per-step wire bytes, time and predicted efficiency of ``strategy`` on
    ``n_chips`` cards over links of ``link_bytes_per_s`` each way.

    dp: replicated parameters, the gradients' all-reduce.  zero1: a
    reduce-scatter of the gradients and an all-gather of the updated
    parameters.  tp: Megatron blocks, 4 all-reduces of the (B, S, H)
    activation a block a step.  pp: GPipe over n stages, one boundary send a
    microbatch and direction, n microbatches."""
    n = int(n_chips)
    if n <= 1:
        return {"bytes": 0.0, "comm_s": 0.0, "efficiency": 1.0}
    act_bytes = prof.per_chip_batch * prof.seq_len * prof.width * act_dtype_bytes
    if strategy == "dp":
        wire = _ring_allreduce(prof.trainable_bytes, n)
    elif strategy == "zero1":
        wire = _ring_gather(prof.trainable_bytes, n) * 2.0
    elif strategy == "tp":
        wire = 4.0 * prof.layers * _ring_allreduce(act_bytes, n)
    elif strategy == "pp":
        wire = 2.0 * (n - 1) * n * (act_bytes / n)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    comm_s = wire / link_bytes_per_s
    # the slower of compute and the wire sets the step, with full overlap
    eff = prof.step_time_s / max(prof.step_time_s, comm_s)
    return {"bytes": wire, "comm_s": comm_s, "efficiency": eff}


def scaling_table(prof: StepProfile, chip_counts=(8, 64, 256),
                  strategies=("dp", "zero1", "tp", "pp"),
                  link_bytes_per_s: float = H100_NVLINK_BYTES_PER_S) -> str:
    """Markdown table of the predicted per-step wire traffic and efficiency."""
    img_s_chip = prof.per_chip_batch / prof.step_time_s
    lines = [
        f"single-chip: {prof.step_time_s * 1e3:.2f} ms/step, {img_s_chip:.0f} img/s/chip, "
        f"grads {prof.trainable_bytes / 1e6:.2f} MB",
        "",
        "| strategy | chips | wire MB/step | comm ms | predicted eff | img/s total |",
        "|---|---|---|---|---|---|",
    ]
    for s in strategies:
        for n in chip_counts:
            r = predict(prof, n, s, link_bytes_per_s)
            lines.append(f"| {s} | {n} | {r['bytes'] / 1e6:.2f} | {r['comm_s'] * 1e3:.3f} | "
                         f"{r['efficiency'] * 100:.1f}% | "
                         f"{img_s_chip * n * r['efficiency']:.0f} |")
    return "\n".join(lines)


def profile_from_params(params: Mapping[str, torch.Tensor], mask: Mapping[str, bool],
                        step_time_s: float, per_chip_batch: int, seq_len: int = 197,
                        width: Optional[int] = None, layers: int = 12) -> StepProfile:
    """A StepProfile from a model's named parameters and trainable mask; the
    width from the first block's ``ln_1`` (``norm1``) weight, else 768."""
    from ..peft.masks import count_trainable

    n_train = count_trainable(params, mask)
    if width is None:
        widths = [v.shape[-1] for k, v in params.items()
                  if k.endswith(("ln_1.weight", "norm1.weight"))]
        width = int(widths[0]) if widths else 768
    return StepProfile(step_time_s=step_time_s, per_chip_batch=per_chip_batch, seq_len=seq_len,
                       width=int(width), layers=layers,
                       trainable_bytes=int(n_train) * 4)  # fp32 gradients on the wire
