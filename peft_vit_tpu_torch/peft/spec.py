"""PEFTSpec — the static description of the PEFT deltas injected into the ViT.

A field-for-field copy of ``peft_vit_tpu/peft/spec.py::PEFTSpec``, with its
``canonical_method`` and ``spec_from_config``, so that a spec means the same
thing in both packages.  The port implements every hook but the relative
position bias (``attn_bias='rpb'``), for which the layers raise
``NotImplementedError`` (``models.layers.require_ported``).
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


_METHOD_ALIASES = {
    "none": "none",
    "zeroshot": "none",
    "linear": "linear",
    "linear_probe": "linear",
    "logistic": "linear",
    "full": "full",
    "finetune": "full",
    "bitfit": "bitfit",
    "bias": "bitfit",
    "layernorm": "layernorm",
    "norm": "layernorm",
    "attention": "attention",
    "attn": "attention",
    "lora": "lora",
    "lora_clip": "lora",
    "lora_fix_one": "lora_fix_one",
    "lora_moe": "lora_moe",
    "lora_adapter": "lora_adapter",
    "lora_compacter": "lora_compacter",
    "lora_drop_adapter": "lora_drop_adapter",
    "adapterdrop_lora": "lora_drop_adapter",
    "first_attention": "first_attention",
    "1st_attention": "first_attention",
    "first_mlp": "first_mlp",
    "1st_mlp": "first_mlp",
    "adapter": "adapter",
    "adapter_clip": "adapter",
    "adapterdrop": "adapterdrop",
    "adapter_drop": "adapterdrop",
    "compacter": "compacter",
    "compacter_clip": "compacter",
    "kadaptation": "kadaptation",
    "kronecker_adaptation": "kadaptation",
    "rpb": "rpb",
    "position_bias": "rpb",
    "lepe": "lepe",
    "cswin": "lepe",
    "transformer_probe": "transformer_probe",
    "finetune_contrast": "finetune_contrast",
    "contrast": "finetune_contrast",
    "linear_probe_contrast": "linear_probe_contrast",
    "vpt": "vpt",
    "prompt": "vpt",
    "intrinsic": "intrinsic",
    "intrinsic_dimension": "intrinsic",
}


def canonical_method(name: str) -> str:
    key = name.lower().strip()
    if key not in _METHOD_ALIASES:
        raise ValueError(
            f"Unknown PEFT method {name!r}; known: "
            f"{sorted(set(_METHOD_ALIASES.values()))}"
        )
    return _METHOD_ALIASES[key]


def spec_from_config(cfg) -> PEFTSpec:
    """Build a PEFTSpec from a ``config.PEFT`` group (config/default.py)."""
    p = cfg.PEFT
    method = canonical_method(p.METHOD)

    kw = dict(
        method=method,
        lora_rank=int(p.LORA_RANK),
        lora_alpha=float(p.LORA_ALPHA),
        lora_targets=tuple(p.LORA_TARGETS),
        lora_post_scale_q=bool(p.LORA_POST_SCALE_Q),
        lora_ref_reshape=bool(p.get("LORA_REF_RESHAPE", False)),
        phm_dim=int(p.PHM_DIM),
        phm_rank=int(p.PHM_RANK),
        adapter_dim=int(p.ADAPTER_DIM),
        adapter_act=str(p.ADAPTER_ACT),
        compacter_reduction=int(p.COMPACTER_REDUCTION),
        compacter_phm_dim_down=int(p.COMPACTER_PHM_DIM_DOWN),
        compacter_phm_dim_up=int(p.COMPACTER_PHM_DIM_UP),
        compacter_act=str(p.COMPACTER_ACT),
        rpb_ndim=int(p.RPB_NDIM),
        prompt_tokens=int(p.PROMPT_TOKENS),
        prompt_deep=bool(p.PROMPT_DEEP),
    )

    if method in (
        "lora",
        "lora_fix_one",
        "lora_moe",
        "lora_adapter",
        "lora_compacter",
        "lora_drop_adapter",
    ):
        kw["attn_delta"] = "lora"
        if method == "lora_moe":
            kw["lora_moe"] = True
    elif method == "kadaptation":
        kw["attn_delta"] = "kron"
    if method in ("adapter", "adapterdrop", "lora_drop_adapter"):
        kw["adapter"] = "houlsby"
        if method in ("adapterdrop", "lora_drop_adapter"):
            layers = tuple(p.ADAPTER_LAYERS) or (11,)
            kw["adapter_layers"] = layers
    elif method in ("compacter", "lora_compacter"):
        kw["adapter"] = "compacter"
    if method == "lora_adapter":
        # reference cls_vit_lora_adapter: shared head-dim adapter on q/k/v
        kw["attn_adapter"] = "shared_qkv"
    if method == "rpb":
        kw["attn_bias"] = "rpb"
    if method == "lepe":
        kw["lepe"] = True
    if method == "transformer_probe" or bool(p.EXTRA_BLOCK):
        kw["extra_block"] = True
    if method == "vpt":
        kw["prompt_tokens"] = int(p.PROMPT_TOKENS) or 10

    return PEFTSpec(**kw)
