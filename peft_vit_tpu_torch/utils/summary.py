"""Model summary and FLOP accounting (counterpart of
``peft_vit_tpu/utils/summary.py``).

The JAX package counts with XLA's cost analysis of the whole compiled HLO,
elementwise work included.  The port counts what ``torch.utils.flop_counter``
counts: the products (2 m n k each) of every matrix product and convolution
that runs, and of every kernel launch through the FLOP formula of its
registered op (``ops._library``: K2 and K3 recompute the scores, so the
attention backward counts 7 products on the card's route).  Elementwise
work, reductions and normalisations count nothing, so the port's numbers
are below the JAX package's for the same program.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode


def param_summary(params: Mapping[str, torch.Tensor],
                  mask: Optional[Mapping[str, bool]] = None) -> str:
    """Per-leaf table (name, shape, count, train / frozen) and the totals,
    as the JAX package prints them; ``params`` name-keyed (a module's
    ``named_parameters``), ``mask`` ``{name: trainable}`` (None: all)."""
    lines = []
    total = trainable = 0
    mask = mask or {}
    for k in sorted(params):
        v = params[k]
        n = v.numel()
        total += n
        t = bool(mask.get(k, True))
        trainable += n if t else 0
        lines.append(f"{k:<70s} {str(tuple(v.shape)):<20s} {n:>12,d} "
                     f"{'train' if t else 'frozen'}")
    lines.append("-" * 110)
    lines.append(f"total params: {total / 1e6:.3f}M | trainable: {trainable / 1e6:.6f}M "
                 f"({100 * trainable / max(total, 1):.4f}%)")
    return "\n".join(lines)


def flops_of(fn: Callable, *args) -> float:
    """The products ``fn(*args)`` computes, run once under
    ``FlopCounterMode`` (see the module docstring for what counts)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


# the registered ops (ops._library) by the kernel each launches
OP_KERNEL = {
    "flash_attn_fwd": "K1", "flash_attn_bwd_dq": "K2", "flash_attn_bwd_dkv": "K3",
    "fused_short_attn_fwd": "K4", "fused_short_attn_bwd": "K5", "int8_gemm_dynamic": "K6",
    "int8_gemm_static": "K6", "int8_gemm_partial": "K6", "int8_row_absmax": "K6",
    "attn_bias_grad": "K7",
}
_GEMM_OPS = ("mm", "addmm", "bmm", "baddbmm", "_int_mm", "_scaled_mm")
_CONV_OPS = ("convolution", "convolution_backward")


def op_category(packet) -> str:
    """A dispatched op's category: its kernel (K1-K7) for a registered op,
    "GEMM" for ATen's matrix products, "conv" for its convolutions, "other"
    for everything else."""
    from ..ops._library import NAMESPACE

    ns, name = packet._qualified_op_name.split("::")
    if ns == NAMESPACE:
        return OP_KERNEL.get(name, "other")
    if name in _GEMM_OPS:
        return "GEMM"
    return "conv" if name in _CONV_OPS else "other"


class CostMode(TorchDispatchMode):
    """Every dispatched op's FLOPs (``FlopCounterMode``'s formulas: ATen's
    and the registered ops') and bytes (its tensor inputs read once, its
    outputs written once), summed by ``op_category`` into ``costs``:
    ``{category: [flops, bytes]}``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.costs: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        formula = self.registry.get(packet)
        cost = self.costs[op_category(packet)]
        cost[0] += formula(*args, **kwargs, out_val=out) if formula else 0
        cost[1] += sum(t.numel() * t.element_size() for t in tree_flatten((args, kwargs, out))[0]
                       if isinstance(t, torch.Tensor))
        return out


def costs_of(fn: Callable, *args) -> Dict[str, Tuple[float, float]]:
    """``{category: (flops, bytes)}`` of one eager run of ``fn(*args)``
    (``CostMode``)."""
    with CostMode() as mode:
        fn(*args)
    return {k: (v[0], v[1]) for k, v in mode.costs.items()}


def bytes_accessed_of(fn: Callable, *args) -> float:
    """The bytes ``fn(*args)`` moves: each dispatched op's tensor inputs read
    once and its outputs written once, a view and an in-place op as any
    other.  Nothing is fused, so an intermediate counts as written and read
    again, which XLA's count of a fused program does not."""
    return float(sum(b for _, b in costs_of(fn, *args).values()))
