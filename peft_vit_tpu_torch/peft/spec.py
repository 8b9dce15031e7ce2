"""PEFTSpec — the static description of the PEFT deltas injected into the ViT.

A field-for-field copy of ``peft_vit_tpu/peft/spec.py::PEFTSpec`` so that a
spec means the same thing in both packages.  The port implements the LoRA
q/k/v deltas (``attn_delta='lora'``, ``lora_rank``, ``lora_alpha``,
``lora_targets``, ``lora_post_scale_q``); the layers raise
``NotImplementedError`` for every other hook (``models.layers.require_ported``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PEFTSpec:
    """Static (hashable) description of the deltas injected into the ViT."""

    method: str = "none"

    # attention q/k/v deltas
    attn_delta: str = "none"  # 'none' | 'lora' | 'kron'
    lora_rank: int = 4
    lora_alpha: float = 128.0
    lora_targets: Tuple[str, ...] = ("q", "v")
    # CLIP LoRA parity: the q delta is added AFTER q is scaled by
    # 1/sqrt(head_dim), i.e. softmax((q/sqrt(d) + dq) k^T).
    lora_post_scale_q: bool = False
    # reference quirk: the seq-first delta reshaped flat into (B*H, N, hd)
    lora_ref_reshape: bool = False
    # LoRA-MoE gating over rank groups
    lora_moe: bool = False
    lora_moe_group: int = 2
    lora_moe_act: str = "linear"  # linear|sigmoid|tanh|relu
    lora_moe_softmax: bool = False
    lora_moe_lambda: float = 1.0
    # shared bottleneck adapter on per-head q/k/v
    attn_adapter: str = "none"  # 'none' | 'shared_qkv'
    phm_dim: int = 4
    phm_rank: int = 1

    # post-MLP bottleneck adapter
    adapter: str = "none"  # 'none' | 'houlsby' | 'compacter'
    adapter_dim: int = 64
    adapter_act: str = "relu"
    adapter_layers: Optional[Tuple[int, ...]] = None
    compacter_reduction: int = 12
    compacter_phm_dim_down: int = 32
    compacter_phm_dim_up: int = 4
    compacter_act: str = "gelu_new"

    # additive attention bias
    attn_bias: str = "none"  # 'none' | 'rpb'
    rpb_ndim: int = -1

    # locally-enhanced positional encoding (depthwise conv on v)
    lepe: bool = False
    lepe_ref_qkv: bool = False

    # visual prompt tokens
    prompt_tokens: int = 0
    prompt_deep: bool = False

    # extra trainable transformer block appended after the backbone
    extra_block: bool = False
