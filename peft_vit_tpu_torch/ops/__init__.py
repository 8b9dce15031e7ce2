from .attention import (
    attention_reference,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    multi_head_attention,
)

__all__ = [
    "attention_reference",
    "flash_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_fwd",
    "multi_head_attention",
]
