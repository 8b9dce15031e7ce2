from typing import Dict

from . import attention as _attention
from . import int8 as _int8
from .attention import (
    attention_bias_grad,
    attention_reference,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    fused_short_attention,
    fused_short_attention_bwd,
    fused_short_attention_fwd,
    int8_attention,
    int8_attention_scores,
    multi_head_attention,
)
from .int8 import (
    INT8_TARGET_MODULES,
    activation_scales_from_stats,
    int8_column_parallel_dx,
    int8_gemm_dynamic,
    int8_gemm_partial,
    int8_gemm_static,
    int8_matmul,
    int8_matmul_bf16_bwd,
    int8_prequant_matmul,
    int8_prequant_matmul_i8bwd,
    int8_row_absmax,
    int8_row_parallel,
    int8_static_matmul,
    int8_static_matmul_i8bwd,
    quantize_cols,
    quantize_frozen_tree,
    quantize_rows,
    quantize_static,
)

#: the kernels' wrappers, each counting its launches in ``.launches``
KERNEL_WRAPPERS = (
    (_attention, "flash_attention_fwd"),
    (_attention, "flash_attention_bwd_dq"),
    (_attention, "flash_attention_bwd_dkv"),
    (_attention, "attention_bias_grad"),
    (_attention, "fused_short_attention_fwd"),
    (_attention, "fused_short_attention_bwd"),
    (_int8, "int8_gemm_dynamic"),
    (_int8, "int8_gemm_static"),
    (_int8, "int8_gemm_partial"),
    (_int8, "int8_row_absmax"),
)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count so far, by the wrapper's name (0
    for a wrapper swapped for something that does not count)."""
    return {name: getattr(getattr(module, name), "launches", 0)
            for module, name in KERNEL_WRAPPERS}


__all__ = [
    "INT8_TARGET_MODULES",
    "KERNEL_WRAPPERS",
    "activation_scales_from_stats",
    "attention_bias_grad",
    "attention_reference",
    "flash_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_fwd",
    "fused_short_attention",
    "fused_short_attention_bwd",
    "fused_short_attention_fwd",
    "int8_attention",
    "int8_attention_scores",
    "int8_column_parallel_dx",
    "int8_gemm_dynamic",
    "int8_gemm_partial",
    "int8_gemm_static",
    "int8_matmul",
    "int8_matmul_bf16_bwd",
    "int8_prequant_matmul",
    "int8_prequant_matmul_i8bwd",
    "int8_row_absmax",
    "int8_row_parallel",
    "int8_static_matmul",
    "int8_static_matmul_i8bwd",
    "launch_counts",
    "multi_head_attention",
    "quantize_cols",
    "quantize_frozen_tree",
    "quantize_rows",
    "quantize_static",
]
