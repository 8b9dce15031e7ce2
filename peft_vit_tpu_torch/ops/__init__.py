from .attention import (
    attention_reference,
    flash_attention_fwd,
    multi_head_attention,
)

__all__ = ["attention_reference", "flash_attention_fwd", "multi_head_attention"]
