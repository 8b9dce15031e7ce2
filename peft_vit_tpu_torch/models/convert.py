"""Weights carried across from the JAX package.

``params_from_jax`` maps a flax variables tree of the JAX package
(``{'params': ..., 'batch_stats': ...}``, numpy or JAX arrays, with exactly
the names a flax init produces) to this package's ``state_dict``:

* module path ``a/b/c`` -> ``a.b.c``; ``blocks_<i>`` -> ``blocks.<i>``;
* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
* Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW (LePE's depthwise
  ``get_v`` (3, 3, 1, d) -> (d, 1, 3, 3), ``groups=d``);
* LayerNorm ``scale`` -> ``weight``;
* everything else keeps its name and layout: biases, ``class_embedding``,
  ``positional_embedding``, ``proj``, ``bn_mean``, ``bn_var`` and the raw
  PEFT parameters (Compacter's ``W``, ``phm_rule`` and ``b``, KAdaptation's
  ``phm_rule``, ``phmb``, ``W_left{1,2}`` and ``W_right{1,2}``, VPT's
  ``prompt_embeddings`` and ``deep_prompt_embeddings``, RPB's
  ``relative_position_bias_table``).

Arrays arrive as fp32.  Loading copies each into the dtype the model
stores it in: fp32 for every trainable leaf (and for every leaf before
``layers.cast_frozen_``), so a master weight never passes through bf16.

``jax_path`` and ``params_to_jax`` are the inverse map, from this package's
names and layouts back to the JAX package's.

``load_torch_checkpoint``, ``infer_clip_shape``, ``clip_state_dict_to_tree``,
``visual_state_dict`` and ``text_state_dict`` load an OpenAI CLIP
checkpoint's visual and text towers (``MODEL.PRETRAINED``) through the JAX
package's names, so that there is one mapping (``is_clip_rn_state_dict``,
``infer_clip_rn_shape``, ``clip_rn_state_dict_to_tree`` and
``clip_rn_visual_state_dict`` the same for the ModifiedResNet towers, their
BatchNorms' running statistics included); ``timm_vit_state_dict_to_tree``
and ``timm_vit_state_dict`` do the same for a timm ViT (the supervised tower
of the full-shot trainer) with the full-shot PEFT variants' injections.  The text tower's leaves keep
their JAX names: ``token_embedding/embedding`` (the port's ``text.Embed``
names its table ``embedding`` too), ``positional_embedding``, ``blocks_<i>``,
``ln_final``, ``text_projection``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_COLLECTIONS = ("params", "batch_stats")
_BLOCK = re.compile(r"^blocks_(\d+)$")
_BATCH_STATS = ("bn_mean", "bn_var")
# a flax nn.BatchNorm's statistics; the channel-BN head names its own bn_mean / bn_var
_FLAX_BN_STATS = ("mean", "var")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def _torch_name_and_array(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *modules, name = path
    if name == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {arr.ndim}")
        name = "weight"
    elif name == "scale":
        name = "weight"
    parts = []
    for m in modules:
        block = _BLOCK.match(m)
        parts.extend(("blocks", block.group(1)) if block else (m,))
    return ".".join((*parts, name)), arr


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's variables tree -> this package's ``state_dict``.
    A flax ``nn.BatchNorm``'s ``batch_stats`` ``mean`` / ``var`` become the
    port's ``bn_mean`` / ``bn_var`` buffers; ``FrozenBatchNorm``'s ``mean``
    and ``var`` are parameters in both packages and keep their names."""
    unknown = set(variables) - set(_COLLECTIONS)
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    state = {}
    for collection in _COLLECTIONS:
        for path, leaf in _leaves(variables.get(collection, {})):
            if collection == "batch_stats" and path[-1] in _FLAX_BN_STATS:
                path = (*path[:-1], "bn_" + path[-1])
            name, arr = _torch_name_and_array(path, np.asarray(leaf, dtype=np.float32))
            if name in state:
                raise ValueError(f"two JAX leaves map to {name}")
            state[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load a JAX variables tree into ``model``; missing or unexpected keys
    and shape mismatches raise."""
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


def jax_path(name: str, ndim: int) -> str:
    """This package's parameter name -> the JAX package's ``/``-joined path:
    ``backbone.blocks.1.attn.q_adapter1.weight`` (2-D) ->
    ``backbone/blocks_1/attn/q_adapter1/kernel``.  A ``weight`` of rank 1 is
    a LayerNorm ``scale``, of rank 2 (Dense) or 4 (Conv) a ``kernel``; every
    other leaf is a raw flax parameter and keeps its name (``W``,
    ``phm_rule``, ``b``, ``phmb``, ``W_left1``, ``prompt_embeddings``, ...)."""
    *modules, leaf = name.split(".")
    if leaf == "weight":
        if ndim not in (1, 2, 4):
            raise ValueError(f"{name}: a weight of rank {ndim}")
        leaf = "scale" if ndim == 1 else "kernel"
    parts = []
    for m in modules:
        if m.isdigit() and parts and parts[-1] == "blocks":
            parts[-1] = f"blocks_{m}"
        else:
            parts.append(m)
    return "/".join((*parts, leaf))


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """A ``state_dict`` of this package -> the JAX package's variables tree
    (nested dicts of fp32 numpy arrays): the inverse of ``params_from_jax``."""
    variables: Dict[str, dict] = {}
    for name, tensor in state.items():
        arr = tensor.detach().to(torch.float32).cpu().numpy()
        *modules, leaf = jax_path(name, arr.ndim).split("/")
        if leaf == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        collection = "batch_stats" if leaf in _BATCH_STATS else "params"
        if collection == "batch_stats" and modules[-1] != "channel_bn":
            leaf = leaf[len("bn_"):]  # a flax nn.BatchNorm's mean / var
        node = variables.setdefault(collection, {})
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return variables


# ---------------------------------------------------------------------------
# OpenAI CLIP checkpoints (the visual half of peft_vit_tpu/models/convert.py)


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t)


def load_torch_checkpoint(path: str, allow_pickle: bool = False, model_key: str = "") -> dict:
    """``torch.load`` a .pt/.pth checkpoint to a CPU state dict, as the JAX
    package loads one: ``weights_only`` first, then a TorchScript archive
    (OpenAI CLIP ships those), then, with ``allow_pickle``, a full unpickle;
    ``model_key`` (``TEST.MODEL_KEY``) unwraps a nested checkpoint, and a
    ``state_dict`` or ``model`` entry is unwrapped too."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        try:
            obj = torch.jit.load(path, map_location="cpu").state_dict()
        except Exception:
            if not allow_pickle:
                raise
            obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if model_key and isinstance(obj, dict) and model_key in obj:
        obj = obj[model_key]
        if hasattr(obj, "state_dict"):
            obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return obj


def infer_clip_shape(sd: Mapping) -> Dict[str, int]:
    """The towers' shapes from an OpenAI CLIP state dict
    (adapter_model.py:553-576): width from conv1, layer count from the
    resblock keys, patch size from conv1's kernel, image size from the
    positional embedding, embed dim from ``text_projection`` (or, in a
    visual-only export, ``visual.proj``); the text tower's width from
    ``ln_final``, its depth from the resblock keys, vocabulary and context
    from its embeddings, heads width / 64 (all 0 without a text tower)."""
    conv1 = _np(sd["visual.conv1.weight"])
    layers = len({k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")})
    grid = int(round((_np(sd["visual.positional_embedding"]).shape[0] - 1) ** 0.5))
    has_text = "text_projection" in sd
    embed = _np(sd["text_projection"] if has_text else sd["visual.proj"]).shape[1]
    text = dict(vocab_size=0, context_length=0, text_width=0, text_layers=0)
    if has_text:
        text = dict(
            vocab_size=int(_np(sd["token_embedding.weight"]).shape[0]),
            context_length=int(_np(sd["positional_embedding"]).shape[0]),
            text_width=int(_np(sd["ln_final.weight"]).shape[0]),
            text_layers=len({k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}),
        )
    return dict(
        embed_dim=int(embed),
        image_size=int(grid * conv1.shape[-1]),
        patch_size=int(conv1.shape[-1]),
        vision_width=int(conv1.shape[0]),
        vision_layers=int(layers),
        vision_heads=max(int(conv1.shape[0] // 64), 1),
        **text,
        text_heads=max(text["text_width"] // 64, 1),
        has_text=has_text,
    )


def _convert_block(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    """One ResidualAttentionBlock -> the JAX package's Block names (the
    Houlsby adapter and the LoRA q/v pairs of a reference-trained checkpoint
    included)."""
    out = {
        "ln_1/scale": _np(sd[f"{prefix}.ln_1.weight"]),
        "ln_1/bias": _np(sd[f"{prefix}.ln_1.bias"]),
        "ln_2/scale": _np(sd[f"{prefix}.ln_2.weight"]),
        "ln_2/bias": _np(sd[f"{prefix}.ln_2.bias"]),
        "attn/in_proj/kernel": _np(sd[f"{prefix}.attn.in_proj_weight"]).T,
        "attn/in_proj/bias": _np(sd[f"{prefix}.attn.in_proj_bias"]),
        "attn/out_proj/kernel": _np(sd[f"{prefix}.attn.out_proj.weight"]).T,
        "attn/out_proj/bias": _np(sd[f"{prefix}.attn.out_proj.bias"]),
        "mlp/c_fc/kernel": _np(sd[f"{prefix}.mlp.c_fc.weight"]).T,
        "mlp/c_fc/bias": _np(sd[f"{prefix}.mlp.c_fc.bias"]),
        "mlp/c_proj/kernel": _np(sd[f"{prefix}.mlp.c_proj.weight"]).T,
        "mlp/c_proj/bias": _np(sd[f"{prefix}.mlp.c_proj.bias"]),
    }
    if f"{prefix}.adapter.adapter_down.1.weight" in sd:
        # a reference-trained Houlsby adapter (adapter_model.py:204-342):
        # adapter_norm_before, adapter_down = Sequential(LN, Linear, act), adapter_up
        a = f"{prefix}.adapter"
        out.update({
            "adapter/adapter_norm_before/scale": _np(sd[f"{a}.adapter_norm_before.weight"]),
            "adapter/adapter_norm_before/bias": _np(sd[f"{a}.adapter_norm_before.bias"]),
            "adapter/down/kernel": _np(sd[f"{a}.adapter_down.1.weight"]).T,
            "adapter/down/bias": _np(sd[f"{a}.adapter_down.1.bias"]),
            "adapter/up/kernel": _np(sd[f"{a}.adapter_up.weight"]).T,
            "adapter/up/bias": _np(sd[f"{a}.adapter_up.bias"]),
        })
    for t in ("q", "v"):
        if f"{prefix}.attn.{t}_proj_adapter1.weight" in sd:
            out[f"attn/{t}_adapter1/kernel"] = _np(sd[f"{prefix}.attn.{t}_proj_adapter1.weight"]).T
            out[f"attn/{t}_adapter2/kernel"] = _np(sd[f"{prefix}.attn.{t}_proj_adapter2.weight"]).T
    return out


def clip_state_dict_to_tree(sd: Mapping) -> Dict[str, np.ndarray]:
    """OpenAI CLIP state dict -> flat ``{path: array}`` in the JAX package's
    naming: ``visual/...``, ``text/...`` when the checkpoint has a text
    tower, and ``logit_scale`` when present."""
    info = infer_clip_shape(sd)
    flat = {
        "visual/conv1/kernel": _np(sd["visual.conv1.weight"]).transpose(2, 3, 1, 0),
        "visual/class_embedding": _np(sd["visual.class_embedding"]),
        "visual/positional_embedding": _np(sd["visual.positional_embedding"]),
        "visual/ln_pre/scale": _np(sd["visual.ln_pre.weight"]),
        "visual/ln_pre/bias": _np(sd["visual.ln_pre.bias"]),
    }
    for i in range(info["vision_layers"]):
        for k, v in _convert_block(sd, f"visual.transformer.resblocks.{i}").items():
            flat[f"visual/blocks_{i}/{k}"] = v
    flat["visual/ln_post/scale"] = _np(sd["visual.ln_post.weight"])
    flat["visual/ln_post/bias"] = _np(sd["visual.ln_post.bias"])
    flat["visual/proj"] = _np(sd["visual.proj"])
    if info["has_text"]:
        flat["text/token_embedding/embedding"] = _np(sd["token_embedding.weight"])
        flat["text/positional_embedding"] = _np(sd["positional_embedding"])
        for i in range(info["text_layers"]):
            for k, v in _convert_block(sd, f"transformer.resblocks.{i}").items():
                flat[f"text/blocks_{i}/{k}"] = v
        flat["text/ln_final/scale"] = _np(sd["ln_final.weight"])
        flat["text/ln_final/bias"] = _np(sd["ln_final.bias"])
        flat["text/text_projection"] = _np(sd["text_projection"])
    if "logit_scale" in sd:
        flat["logit_scale"] = _np(sd["logit_scale"]).reshape(())
    return flat


def is_clip_rn_state_dict(sd: Mapping) -> bool:
    """True for an OpenAI CLIP ModifiedResNet checkpoint (RN50 etc.): the
    ViT and RN towers both ship ``visual.conv1.weight``; only the RN tower
    has an attention pool."""
    return "visual.attnpool.positional_embedding" in sd


def infer_clip_rn_shape(sd: Mapping) -> Dict[str, object]:
    """The towers' shapes from a ModifiedResNet CLIP state dict (clip.py's
    ``build_model`` counting for the RN variants): the stem width is twice
    conv1's, the blocks a stage from the layer keys, the embed dim from the
    pool's ``c_proj``, the image size 32 x the pool's grid, heads width *
    32 // 64; the text tower's as in ``infer_clip_shape``."""
    width = _np(sd["visual.conv1.weight"]).shape[0] * 2
    layers = tuple(len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{s}.")})
                   for s in (1, 2, 3, 4))
    grid = int(round((_np(sd["visual.attnpool.positional_embedding"]).shape[0] - 1) ** 0.5))
    info = dict(
        embed_dim=int(_np(sd["visual.attnpool.c_proj.weight"]).shape[0]),
        image_size=int(grid * 32),
        vision_width=int(width),
        vision_layers=layers,
        vision_heads=int(width * 32 // 64),
        has_text="text_projection" in sd,
        text_width=0, text_layers=0, vocab_size=0, context_length=0, text_heads=1,
    )
    if info["has_text"]:
        info.update(
            text_width=int(_np(sd["ln_final.weight"]).shape[0]),
            text_layers=len({k.split(".")[2] for k in sd
                             if k.startswith("transformer.resblocks.")}),
            vocab_size=int(_np(sd["token_embedding.weight"]).shape[0]),
            context_length=int(_np(sd["positional_embedding"]).shape[0]),
        )
        info["text_heads"] = max(info["text_width"] // 64, 1)
    return info


def clip_rn_state_dict_to_tree(sd: Mapping) -> Tuple[Dict[str, np.ndarray],
                                                     Dict[str, np.ndarray]]:
    """An OpenAI CLIP RN state dict -> (flat params, flat batch_stats) in
    the JAX package's naming (JAX ``convert.py:254-304``): ``visual/conv<i>``,
    ``visual/bn<i>``, ``visual/layer<s>_<i>/{conv,bn}<c>``,
    ``downsample_conv`` / ``downsample_bn`` (the downsample Sequential's
    ``-1`` entry is its parameterless pool),
    ``visual/attnpool/...``, the text tower and ``logit_scale``.  Conv
    kernels OIHW -> HWIO, Linear weights transposed, as flax stores them."""
    info = infer_clip_rn_shape(sd)
    flat: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}

    def conv(src: str, dst: str) -> None:
        flat[dst + "/kernel"] = _np(sd[src]).transpose(2, 3, 1, 0)

    def bn(src: str, dst: str) -> None:
        flat[f"{dst}/scale"] = _np(sd[f"{src}.weight"])
        flat[f"{dst}/bias"] = _np(sd[f"{src}.bias"])
        stats[f"{dst}/mean"] = _np(sd[f"{src}.running_mean"])
        stats[f"{dst}/var"] = _np(sd[f"{src}.running_var"])

    for i in (1, 2, 3):
        conv(f"visual.conv{i}.weight", f"visual/conv{i}")
        bn(f"visual.bn{i}", f"visual/bn{i}")
    for s, blocks in enumerate(info["vision_layers"], start=1):
        for i in range(blocks):
            src, dst = f"visual.layer{s}.{i}", f"visual/layer{s}_{i}"
            for c in (1, 2, 3):
                conv(f"{src}.conv{c}.weight", f"{dst}/conv{c}")
                bn(f"{src}.bn{c}", f"{dst}/bn{c}")
            if f"{src}.downsample.0.weight" in sd:
                conv(f"{src}.downsample.0.weight", f"{dst}/downsample_conv")
                bn(f"{src}.downsample.1", f"{dst}/downsample_bn")
    flat["visual/attnpool/positional_embedding"] = _np(
        sd["visual.attnpool.positional_embedding"])
    for p in ("q_proj", "k_proj", "v_proj", "c_proj"):
        flat[f"visual/attnpool/{p}/kernel"] = _np(sd[f"visual.attnpool.{p}.weight"]).T
        flat[f"visual/attnpool/{p}/bias"] = _np(sd[f"visual.attnpool.{p}.bias"])
    if info["has_text"]:
        flat["text/token_embedding/embedding"] = _np(sd["token_embedding.weight"])
        flat["text/positional_embedding"] = _np(sd["positional_embedding"])
        for i in range(info["text_layers"]):
            for k, v in _convert_block(sd, f"transformer.resblocks.{i}").items():
                flat[f"text/blocks_{i}/{k}"] = v
        flat["text/ln_final/scale"] = _np(sd["ln_final.weight"])
        flat["text/ln_final/bias"] = _np(sd["ln_final.bias"])
        flat["text/text_projection"] = _np(sd["text_projection"])
    if "logit_scale" in sd:
        flat["logit_scale"] = _np(sd["logit_scale"]).reshape(())
    return flat, stats


def clip_rn_visual_state_dict(flat: Mapping[str, np.ndarray],
                              stats: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The ``visual/...`` leaves and statistics of
    ``clip_rn_state_dict_to_tree`` as this package's ``state_dict`` entries
    of the classifier's ``backbone`` (a ``clip_resnet.ModifiedResNet``): the
    BatchNorms' running statistics become ``bn_mean`` / ``bn_var``."""
    return _subtree_state_dict(flat, "visual", "backbone", stats)


def _timm_adapter(sd: Mapping, owner: str, target: str, flat: Dict[str, np.ndarray]) -> None:
    """A reference Houlsby adapter (``adapter_norm_before``, ``adapter_down``
    = Sequential(LN, Linear, act), ``adapter_up``) under ``owner`` -> the
    JAX package's ``Adapter`` names under ``target``; the LayerNorm inside
    ``adapter_down`` has no counterpart and is not read, as in the JAX
    converter."""
    if f"{owner}.adapter_down.1.weight" not in sd:
        return
    flat[f"{target}/adapter_norm_before/scale"] = _np(sd[f"{owner}.adapter_norm_before.weight"])
    flat[f"{target}/adapter_norm_before/bias"] = _np(sd[f"{owner}.adapter_norm_before.bias"])
    flat[f"{target}/down/kernel"] = _np(sd[f"{owner}.adapter_down.1.weight"]).T
    flat[f"{target}/down/bias"] = _np(sd[f"{owner}.adapter_down.1.bias"])
    flat[f"{target}/up/kernel"] = _np(sd[f"{owner}.adapter_up.weight"]).T
    flat[f"{target}/up/bias"] = _np(sd[f"{owner}.adapter_up.bias"])


def timm_vit_state_dict_to_tree(sd: Mapping) -> Dict[str, np.ndarray]:
    """A timm ``vit_base_patch16_224``-style state dict -> flat ``{path:
    array}`` in the JAX package's naming (JAX ``convert.py:357``), the
    full-shot PEFT variants' injections included: the q/v LoRA pairs, the
    post-MLP Houlsby adapter, the shared head-dim qkv adapter, the RPB table
    and LePE's ``get_v``.  ``cls_token`` is optional (a
    ``use_cls_token=False`` checkpoint has a (1, g*g, w) ``pos_embed``).
    Keys the JAX converter does not read (the head, a ``loraattn`` the
    reference never runs) are not read here either."""
    flat: Dict[str, np.ndarray] = {
        "conv1/kernel": _np(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
        "conv1/bias": _np(sd["patch_embed.proj.bias"]),
    }
    if "cls_token" in sd:
        flat["class_embedding"] = _np(sd["cls_token"]).reshape(-1)
    flat["positional_embedding"] = _np(sd["pos_embed"])[0]
    layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    for i in range(layers):
        p, o = f"blocks.{i}", f"blocks_{i}"
        flat[f"{o}/ln_1/scale"] = _np(sd[f"{p}.norm1.weight"])
        flat[f"{o}/ln_1/bias"] = _np(sd[f"{p}.norm1.bias"])
        flat[f"{o}/ln_2/scale"] = _np(sd[f"{p}.norm2.weight"])
        flat[f"{o}/ln_2/bias"] = _np(sd[f"{p}.norm2.bias"])
        flat[f"{o}/attn/in_proj/kernel"] = _np(sd[f"{p}.attn.qkv.weight"]).T
        if f"{p}.attn.qkv.bias" in sd:
            flat[f"{o}/attn/in_proj/bias"] = _np(sd[f"{p}.attn.qkv.bias"])
        flat[f"{o}/attn/out_proj/kernel"] = _np(sd[f"{p}.attn.proj.weight"]).T
        flat[f"{o}/attn/out_proj/bias"] = _np(sd[f"{p}.attn.proj.bias"])
        flat[f"{o}/mlp/c_fc/kernel"] = _np(sd[f"{p}.mlp.fc1.weight"]).T
        flat[f"{o}/mlp/c_fc/bias"] = _np(sd[f"{p}.mlp.fc1.bias"])
        flat[f"{o}/mlp/c_proj/kernel"] = _np(sd[f"{p}.mlp.fc2.weight"]).T
        flat[f"{o}/mlp/c_proj/bias"] = _np(sd[f"{p}.mlp.fc2.bias"])
        for t in ("q", "v"):
            if f"{p}.attn.{t}_proj_adapter1.weight" in sd:
                flat[f"{o}/attn/{t}_adapter1/kernel"] = _np(
                    sd[f"{p}.attn.{t}_proj_adapter1.weight"]).T
                flat[f"{o}/attn/{t}_adapter2/kernel"] = _np(
                    sd[f"{p}.attn.{t}_proj_adapter2.weight"]).T
        _timm_adapter(sd, f"{p}.adapter", f"{o}/adapter", flat)
        _timm_adapter(sd, f"{p}.attn.adapter", f"{o}/attn/qkv_adapter", flat)
        if f"{p}.attn.relative_position_bias_table" in sd:
            flat[f"{o}/attn/relative_position_bias_table"] = _np(
                sd[f"{p}.attn.relative_position_bias_table"])
        if f"{p}.attn.get_v.weight" in sd:
            flat[f"{o}/attn/get_v/kernel"] = _np(sd[f"{p}.attn.get_v.weight"]).transpose(
                2, 3, 1, 0)
            flat[f"{o}/attn/get_v/bias"] = _np(sd[f"{p}.attn.get_v.bias"])
    flat["ln_post/scale"] = _np(sd["norm.weight"])
    flat["ln_post/bias"] = _np(sd["norm.bias"])
    return flat


def _subtree(flat: Mapping[str, np.ndarray], source: str, target: str) -> dict:
    tree: dict = {}
    for path, arr in flat.items():
        if source and not path.startswith(source + "/"):
            continue
        rest = path[len(source):].lstrip("/")
        *modules, leaf = "/".join(p for p in (target, rest) if p).split("/")
        node = tree
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = arr
    return tree


def _subtree_state_dict(flat: Mapping[str, np.ndarray], source: str, target: str,
                        stats: Mapping[str, np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """The ``<source>/...`` leaves of a flat JAX-named dict ('': every leaf)
    under the module path ``target`` ('' for the root), and those of the
    flat ``batch_stats`` dict ``stats``, through ``params_from_jax``'s
    map."""
    variables = {"params": _subtree(flat, source, target)}
    if stats:
        variables["batch_stats"] = _subtree(stats, source, target)
    return params_from_jax(variables)


def visual_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The ``visual/...`` leaves of ``clip_state_dict_to_tree`` as this
    package's ``state_dict`` entries of the classifier's ``backbone``,
    through the same name map as ``params_from_jax``."""
    return _subtree_state_dict(flat, "visual", "backbone")


def text_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The ``text/...`` leaves of ``clip_state_dict_to_tree`` as the
    ``state_dict`` of a ``models.text.TextTransformer`` (the JAX builder's
    graft of the text tower)."""
    return _subtree_state_dict(flat, "text", "")


def timm_vit_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The leaves of ``timm_vit_state_dict_to_tree`` as this package's
    ``state_dict`` entries of the classifier's ``backbone``."""
    return _subtree_state_dict(flat, "", "backbone")


def clip_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Every leaf of ``clip_state_dict_to_tree`` as the ``state_dict`` of a
    ``models.clip.CLIP`` (``visual``, ``text``, ``logit_scale``)."""
    return _subtree_state_dict(flat, "", "")


# ---------------------------------------------------------------------------
# Swin and ConvViT checkpoints (JAX convert.py:445 and :621)


def swin_state_dict_to_tree(sd: Mapping) -> Dict[str, np.ndarray]:
    """An official Swin state dict (cls_swin.py / microsoft Swin naming, and
    ssl_swin.py's) -> flat ``{path: array}`` in the JAX package's
    ``SwinTransformer`` naming: the patch embedding and its norm, the
    absolute position embedding, each block's norms, qkv, proj, relative
    position table, q/v LoRA pairs and MLP, the patch mergings, the final
    norm.  The buffers ``relative_position_index`` and ``attn_mask`` are
    built by the model and not read; nor is the head."""
    flat: Dict[str, np.ndarray] = {
        "patch_embed/kernel": _np(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
        "patch_embed/bias": _np(sd["patch_embed.proj.bias"]),
    }
    if "patch_embed.norm.weight" in sd:
        flat["pos_norm/scale"] = _np(sd["patch_embed.norm.weight"])
        flat["pos_norm/bias"] = _np(sd["patch_embed.norm.bias"])
    if "absolute_pos_embed" in sd:
        flat["absolute_pos_embed"] = _np(sd["absolute_pos_embed"])[0]
    stages = sorted({int(k.split(".")[1]) for k in sd if k.startswith("layers.")})
    for s in stages:
        blocks = sorted({int(k.split(".")[3]) for k in sd if k.startswith(f"layers.{s}.blocks.")})
        for bi in blocks:
            p, o = f"layers.{s}.blocks.{bi}", f"stage{s}_block{bi}"
            flat[f"{o}/ln_1/scale"] = _np(sd[f"{p}.norm1.weight"])
            flat[f"{o}/ln_1/bias"] = _np(sd[f"{p}.norm1.bias"])
            flat[f"{o}/ln_2/scale"] = _np(sd[f"{p}.norm2.weight"])
            flat[f"{o}/ln_2/bias"] = _np(sd[f"{p}.norm2.bias"])
            flat[f"{o}/attn/in_proj/kernel"] = _np(sd[f"{p}.attn.qkv.weight"]).T
            flat[f"{o}/attn/in_proj/bias"] = _np(sd[f"{p}.attn.qkv.bias"])
            flat[f"{o}/attn/out_proj/kernel"] = _np(sd[f"{p}.attn.proj.weight"]).T
            flat[f"{o}/attn/out_proj/bias"] = _np(sd[f"{p}.attn.proj.bias"])
            flat[f"{o}/attn/relative_position_bias_table"] = _np(
                sd[f"{p}.attn.relative_position_bias_table"])
            for t in ("q", "v"):
                if f"{p}.attn.{t}_proj_adapter1.weight" in sd:
                    flat[f"{o}/attn/{t}_adapter1/kernel"] = _np(
                        sd[f"{p}.attn.{t}_proj_adapter1.weight"]).T
                    flat[f"{o}/attn/{t}_adapter2/kernel"] = _np(
                        sd[f"{p}.attn.{t}_proj_adapter2.weight"]).T
            flat[f"{o}/mlp_fc1/kernel"] = _np(sd[f"{p}.mlp.fc1.weight"]).T
            flat[f"{o}/mlp_fc1/bias"] = _np(sd[f"{p}.mlp.fc1.bias"])
            flat[f"{o}/mlp_fc2/kernel"] = _np(sd[f"{p}.mlp.fc2.weight"]).T
            flat[f"{o}/mlp_fc2/bias"] = _np(sd[f"{p}.mlp.fc2.bias"])
        if f"layers.{s}.downsample.reduction.weight" in sd:
            flat[f"downsample{s}/reduction/kernel"] = _np(
                sd[f"layers.{s}.downsample.reduction.weight"]).T
            flat[f"downsample{s}/norm/scale"] = _np(sd[f"layers.{s}.downsample.norm.weight"])
            flat[f"downsample{s}/norm/bias"] = _np(sd[f"layers.{s}.downsample.norm.bias"])
    flat["norm/scale"] = _np(sd["norm.weight"])
    flat["norm/bias"] = _np(sd["norm.bias"])
    return flat


def convvit_state_dict_to_tree(sd: Mapping) -> Tuple[Dict[str, np.ndarray],
                                                     Dict[str, np.ndarray]]:
    """A cls_vit_cswin.py / cls_vit_conv.py state dict -> ``(params,
    batch_stats)``, flat, in the JAX package's ``ConvViT`` naming
    (``blocks_<i>/{ln_1, attn/{qkv, out_proj, get_v}, ln_2, mlp/{c_fc,
    c_proj}, ln_3, conv/{pw1, dw, bn, pw2}}``, ``ln_post``): the conv
    mixer's BatchNorm brings its running statistics (``bn`` ``mean`` /
    ``var``)."""
    flat: Dict[str, np.ndarray] = {
        "patch_embed/kernel": _np(sd["patch_embed.proj.weight"]).transpose(2, 3, 1, 0),
        "patch_embed/bias": _np(sd["patch_embed.proj.bias"]),
    }
    stats: Dict[str, np.ndarray] = {}
    if "cls_token" in sd:
        flat["cls_token"] = _np(sd["cls_token"]).reshape(-1)
    flat["pos_embed"] = _np(sd["pos_embed"])[0]
    conv = lambda key: _np(sd[key]).transpose(2, 3, 1, 0)  # OIHW -> HWIO
    layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    for i in range(layers):
        p, o = f"blocks.{i}", f"blocks_{i}"
        flat[f"{o}/ln_1/scale"] = _np(sd[f"{p}.norm1.weight"])
        flat[f"{o}/ln_1/bias"] = _np(sd[f"{p}.norm1.bias"])
        flat[f"{o}/ln_2/scale"] = _np(sd[f"{p}.norm2.weight"])
        flat[f"{o}/ln_2/bias"] = _np(sd[f"{p}.norm2.bias"])
        flat[f"{o}/attn/qkv/kernel"] = _np(sd[f"{p}.attn.qkv.weight"]).T
        if f"{p}.attn.qkv.bias" in sd:
            flat[f"{o}/attn/qkv/bias"] = _np(sd[f"{p}.attn.qkv.bias"])
        flat[f"{o}/attn/out_proj/kernel"] = _np(sd[f"{p}.attn.proj.weight"]).T
        flat[f"{o}/attn/out_proj/bias"] = _np(sd[f"{p}.attn.proj.bias"])
        if f"{p}.attn.get_v.weight" in sd:
            flat[f"{o}/attn/get_v/kernel"] = conv(f"{p}.attn.get_v.weight")
            flat[f"{o}/attn/get_v/bias"] = _np(sd[f"{p}.attn.get_v.bias"])
        if f"{p}.mlp.fc1.weight" in sd:
            flat[f"{o}/mlp/c_fc/kernel"] = _np(sd[f"{p}.mlp.fc1.weight"]).T
            flat[f"{o}/mlp/c_fc/bias"] = _np(sd[f"{p}.mlp.fc1.bias"])
            flat[f"{o}/mlp/c_proj/kernel"] = _np(sd[f"{p}.mlp.fc2.weight"]).T
            flat[f"{o}/mlp/c_proj/bias"] = _np(sd[f"{p}.mlp.fc2.bias"])
        if f"{p}.conv.0.weight" in sd:  # pw-glu-dw-bn-swish-pw (cls_vit_conv.py:199-216)
            flat[f"{o}/ln_3/scale"] = _np(sd[f"{p}.norm3.weight"])
            flat[f"{o}/ln_3/bias"] = _np(sd[f"{p}.norm3.bias"])
            flat[f"{o}/conv/pw1/kernel"] = conv(f"{p}.conv.0.weight")
            flat[f"{o}/conv/dw/kernel"] = conv(f"{p}.conv.2.weight")
            flat[f"{o}/conv/bn/scale"] = _np(sd[f"{p}.conv.3.weight"])
            flat[f"{o}/conv/bn/bias"] = _np(sd[f"{p}.conv.3.bias"])
            stats[f"{o}/conv/bn/mean"] = _np(sd[f"{p}.conv.3.running_mean"])
            stats[f"{o}/conv/bn/var"] = _np(sd[f"{p}.conv.3.running_var"])
            flat[f"{o}/conv/pw2/kernel"] = conv(f"{p}.conv.5.weight")
    flat["ln_post/scale"] = _np(sd["norm.weight"])
    flat["ln_post/bias"] = _np(sd["norm.bias"])
    return flat, stats


def tower_state_dict(flat: Mapping[str, np.ndarray],
                     stats: Mapping[str, np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """The leaves (and BatchNorm statistics) of ``swin_state_dict_to_tree``
    or ``convvit_state_dict_to_tree`` as the ``state_dict`` of a
    ``swin.SwinTransformer`` or ``vit_conv.ConvViT``."""
    return _subtree_state_dict(flat, "", "", stats)


# ---------------------------------------------------------------------------
# The other CNNs of the backbone zoo: timm EfficientNet, cls_hrnet, the
# cls_hrnet_v2-v4 family and TTNet (JAX convert.py:305, :693, :814, :990).
# Each returns (flat params, flat batch_stats) in the JAX package's naming;
# ``tower_state_dict`` makes them a tower's state_dict.


def _conv_to(flat: Dict[str, np.ndarray], sd: Mapping, src: str, dst: str,
             bias: bool = False) -> None:
    """A conv's OIHW weight (dense or depthwise) -> flax's HWIO ``kernel``,
    and its ``bias`` when asked."""
    flat[dst + "/kernel"] = _np(sd[src + ".weight"]).transpose(2, 3, 1, 0)
    if bias:
        flat[dst + "/bias"] = _np(sd[src + ".bias"])


def _bn_to(flat: Dict[str, np.ndarray], stats: Dict[str, np.ndarray], sd: Mapping, src: str,
           dst: str) -> None:
    """A torch BatchNorm -> flax's ``scale`` / ``bias`` and its running
    statistics ``mean`` / ``var``."""
    flat[dst + "/scale"] = _np(sd[src + ".weight"])
    flat[dst + "/bias"] = _np(sd[src + ".bias"])
    stats[dst + "/mean"] = _np(sd[src + ".running_mean"])
    stats[dst + "/var"] = _np(sd[src + ".running_var"])


def timm_effnet_state_dict_to_tree(sd: Mapping) -> Tuple[Dict[str, np.ndarray],
                                                        Dict[str, np.ndarray]]:
    """A timm ``efficientnet_b0``-style state dict -> ``(params,
    batch_stats)`` in ``models/efficientnet.py``'s naming (``conv_stem``,
    ``bn1``, ``blocks_<s>_<i>/...``, ``conv_head``, ``bn2``); the classifier
    is dropped (the reference's EvalModel pools features only)."""
    flat: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    conv = lambda src, dst, bias=False: _conv_to(flat, sd, src, dst, bias)  # noqa: E731
    bn = lambda src, dst: _bn_to(flat, stats, sd, src, dst)  # noqa: E731
    conv("conv_stem", "conv_stem")
    bn("bn1", "bn1")
    s = 0
    while f"blocks.{s}.0.conv_dw.weight" in sd or f"blocks.{s}.0.conv_pw.weight" in sd:
        i = 0
        while f"blocks.{s}.{i}.conv_dw.weight" in sd:
            src, dst = f"blocks.{s}.{i}", f"blocks_{s}_{i}"
            if f"{src}.conv_pwl.weight" in sd:  # the inverted residual
                order = (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))
            else:  # the stage-0 depthwise-separable block
                order = (("conv_dw", "bn1"), ("conv_pw", "bn2"))
            for c, b in order:
                conv(f"{src}.{c}", f"{dst}/{c}")
                bn(f"{src}.{b}", f"{dst}/{b}")
            conv(f"{src}.se.conv_reduce", f"{dst}/se/conv_reduce", bias=True)
            conv(f"{src}.se.conv_expand", f"{dst}/se/conv_expand", bias=True)
            i += 1
        s += 1
    conv("conv_head", "conv_head")
    bn("bn2", "bn2")
    return flat, stats


def hrnet_state_dict_to_tree(sd: Mapping) -> Tuple[Dict[str, np.ndarray],
                                                  Dict[str, np.ndarray]]:
    """A cls_hrnet.py HighResolutionNet state dict -> ``(params,
    batch_stats)`` in ``models/hrnet.py``'s ``HRNet`` naming (its BatchNorms
    under ``<name>/bn``); the classifier Linear stays out."""
    flat: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    conv = lambda path, key, bias=False: _conv_to(flat, sd, key, path, bias)  # noqa: E731
    bn = lambda path, key: _bn_to(flat, stats, sd, key, path + "/bn")  # noqa: E731

    def bottleneck(path: str, key: str) -> None:
        for c in ("conv1", "conv2", "conv3"):
            conv(f"{path}/{c}", f"{key}.{c}")
        for b in ("bn1", "bn2", "bn3"):
            bn(f"{path}/{b}", f"{key}.{b}")
        if f"{key}.downsample.0.weight" in sd:
            conv(f"{path}/downsample", f"{key}.downsample.0")
            bn(f"{path}/bn_down", f"{key}.downsample.1")

    conv("stem_conv1", "conv1")
    bn("stem_bn1", "bn1")
    conv("stem_conv2", "conv2")
    bn("stem_bn2", "bn2")
    k = 0
    while f"layer1.{k}.conv1.weight" in sd:
        bottleneck(f"layer1_block{k}", f"layer1.{k}")
        k += 1
    # transition<si+1>.<bi> is Sequential(conv, bn, relu) for an existing
    # branch whose width changes, Sequential(Sequential(conv, bn, relu)) for
    # the new lowest branch
    si = 0
    while any(key.startswith(f"transition{si + 1}.") for key in sd):
        for bi in range(9):
            for key in (f"transition{si + 1}.{bi}", f"transition{si + 1}.{bi}.0"):
                if f"{key}.0.weight" in sd and f"{key}.1.running_mean" in sd:
                    conv(f"transition{si}_{bi}", f"{key}.0")
                    bn(f"transition{si}_bn{bi}", f"{key}.1")
                    break
        si += 1
    for s in (2, 3, 4):
        m = 0
        while any(key.startswith(f"stage{s}.{m}.") for key in sd):
            base, o = f"stage{s}.{m}", f"stage{s}_module{m}"
            b = 0
            while f"{base}.branches.{b}.0.conv1.weight" in sd:
                blk = 0
                while f"{base}.branches.{b}.{blk}.conv1.weight" in sd:
                    for c in ("conv1", "conv2"):
                        conv(f"{o}/branch{b}_block{blk}/{c}", f"{base}.branches.{b}.{blk}.{c}")
                    for c in ("bn1", "bn2"):
                        bn(f"{o}/branch{b}_block{blk}/{c}", f"{base}.branches.{b}.{blk}.{c}")
                    blk += 1
                b += 1
            for i in range(b):
                for j in range(b):
                    fl = f"{base}.fuse_layers.{i}.{j}"
                    if j > i:
                        conv(f"{o}/fuse/up_{j}_{i}", f"{fl}.0")
                        bn(f"{o}/fuse/up_bn_{j}_{i}", f"{fl}.1")
                    elif j < i:
                        for kk in range(i - j):
                            conv(f"{o}/fuse/down_{j}_{i}_{kk}", f"{fl}.{kk}.0")
                            bn(f"{o}/fuse/down_bn_{j}_{i}_{kk}", f"{fl}.{kk}.1")
            m += 1
    i = 0
    while f"incre_modules.{i}.0.conv1.weight" in sd:
        bottleneck(f"incre{i}", f"incre_modules.{i}.0")
        i += 1
    i = 0
    while f"downsamp_modules.{i}.0.weight" in sd:
        conv(f"down{i + 1}", f"downsamp_modules.{i}.0", bias=True)
        bn(f"down_bn{i + 1}", f"downsamp_modules.{i}.1")
        i += 1
    conv("final_conv", "proj_modules.0", bias=True)
    bn("final_bn", "proj_modules.1")
    return flat, stats


def hrnet_v_state_dict_to_tree(sd: Mapping, version: str, stem_spec: str = "", num_modules=(),
                               num_branches=(), num_blocks=(), num_channels=(), block=(),
                               head_block=(), head_proj: int = 2048
                               ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """A cls_hrnet_v2 / v2_share / v3 / v4 state dict -> ``(params,
    batch_stats)`` in ``HRNetV``'s naming, walked from the same arch spec
    the model is built from (``hrnet.hrnet_v_spec``'s fields); the
    classifier Linear stays out.  A conv whose bias is in the state dict
    brings it."""
    flat: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}

    def conv(path: str, key: str, bias: bool = False) -> None:
        _conv_to(flat, sd, key, path, bias or key + ".bias" in sd)

    def bn(path: str, key: str) -> None:
        _bn_to(flat, stats, sd, key, path + "/bn")

    def se(path: str, key: str) -> None:
        if key + ".fc.0.weight" in sd:
            flat[path + "/fc0/kernel"] = _np(sd[key + ".fc.0.weight"]).T
            flat[path + "/fc2/kernel"] = _np(sd[key + ".fc.2.weight"]).T

    def downsample(path: str, key: str) -> None:
        if key + ".0.weight" in sd and key + ".1.running_mean" in sd:  # Sequential(conv, BN)
            conv(path + "/downsample", key + ".0")
            bn(path + "/bn_down", key + ".1")
        elif key + ".1.weight" in sd:  # Sequential(AvgPool2d, Conv2d(norm=BN))
            conv(path + "/downsample", key + ".1")
            bn(path + "/bn_down", key + ".1.norm")

    def basic(path: str, key: str) -> None:
        for c in ("1", "2"):
            conv(f"{path}/conv{c}", f"{key}.conv{c}")
            bn(f"{path}/bn{c}", f"{key}.bn{c}")
        se(path + "/se", key + ".se")
        downsample(path, key + ".downsample")

    def bottleneck(path: str, key: str) -> None:
        for c in ("1", "2", "3"):
            conv(f"{path}/conv{c}", f"{key}.conv{c}")
            bn(f"{path}/bn{c}", f"{key}.bn{c}")
        se(path + "/se", key + ".se")
        downsample(path, key + ".downsample")

    def inverted(path: str, key: str) -> None:
        for c, b in (("conv_pw", "bn1"), ("conv_dw", "bn2")):
            conv(f"{path}/{c}", f"{key}.{c}", bias=True)
            bn(f"{path}/{b}", f"{key}.{b}")
        se(path + "/se", key + ".se")
        conv(path + "/conv_pwl", key + ".conv_pwl", bias=True)
        bn(path + "/bn3", key + ".bn3")
        downsample(path, key + ".downsample")

    blockmap = {"BASIC": basic, "BOTTLENECK": bottleneck, "INVERTED": inverted}

    def wrapper_conv_bn(path_conv: str, path_bn: str, key: str) -> None:
        # lib/layers/wrappers.py Conv2d(norm=get_norm('BN', ...))
        conv(path_conv, key)
        bn(path_bn, key + ".norm")

    if version in ("v2", "v2_share", "v3"):
        for c in ("1", "2"):
            conv(f"stem_conv{c}", f"conv{c}")
            bn(f"stem_bn{c}", f"bn{c}")
        stem_block = bottleneck if version != "v3" else inverted
        for k in range(4 if version != "v3" else 2):
            stem_block(f"layer1_block{k}", f"layer1.{k}")
    elif version == "v4":
        wrapper_conv_bn("stem_conv1", "stem_bn1", "stem.0")
        if stem_spec == "conv16s2conv24s2inv24e6x2":
            wrapper_conv_bn("stem_conv2", "stem_bn2", "stem.1")
            inverted("layer1_block0", "stem.2.0")
            inverted("layer1_block1", "stem.2.1")
        elif stem_spec == "conv32s2maxpools2inv32e6x1":
            inverted("layer1_block0", "stem.2.0")
        elif stem_spec == "conv32s2maxpools2inv32e2wosex1":
            # a raw InvertedResidual, not a _build_layer Sequential (cls_hrnet_v4.py:482)
            inverted("layer1_block0", "stem.2")
        elif stem_spec in ("conv32s2inv32e6s2x1", "conv24s2inv24e6s2x1"):
            inverted("layer1_block0", "stem.1.0")
        elif stem_spec != "conv32s2maxpools2":
            raise ValueError(f"unknown STEM_SPEC {stem_spec!r}")
    for i in range(len(num_modules)):
        nb = num_branches[i]
        for j in range(nb):
            t = f"transition{i + 1}.{j}"
            if f"{t}.0.weight" in sd:
                conv(f"transition{i + 1}_{j}", f"{t}.0")
                bn(f"transition{i + 1}_bn{j}", f"{t}.1")
            elif f"{t}.0.0.weight" in sd:
                k = 0
                while f"{t}.{k}.0.weight" in sd:
                    conv(f"transition{i + 1}_{j}_{k}", f"{t}.{k}.0")
                    bn(f"transition{i + 1}_bn{j}_{k}", f"{t}.{k}.1")
                    k += 1
        cvt = blockmap[block[i]]
        for m in range(num_modules[i]):
            base, o = f"stage{i + 2}.{m}", f"stage{i + 2}_m{m}"
            for b in range(nb):
                for blk in range(num_blocks[i][b]):
                    cvt(f"{o}/branch{b}_block{blk}", f"{base}.branches.{b}.{blk}")
            for f in range(nb - 1):
                wrapper_conv_bn(f"{o}/fuse_down{f}", f"{o}/fuse_down_bn{f}",
                                f"{base}.fuse_downsample_layers.{f}")
                wrapper_conv_bn(f"{o}/fuse_up{f}", f"{o}/fuse_up_bn{f}",
                                f"{base}.fuse_upsample_layers.{f}")
    for i, hb in enumerate(head_block):
        if (f"incre_modules.{i}.0.conv1.weight" in sd
                or f"incre_modules.{i}.0.conv_pw.weight" in sd):
            blockmap[hb](f"incre{i}", f"incre_modules.{i}.0")
    i = 0
    while f"downsample_modules.{i}.0.weight" in sd:
        conv(f"down{i + 1}", f"downsample_modules.{i}.0", bias=True)
        bn(f"down_bn{i + 1}", f"downsample_modules.{i}.1")
        i += 1
    if head_proj > 0 and "proj_modules.0.weight" in sd:
        conv("final_conv", "proj_modules.0", bias=True)
        bn("final_bn", "proj_modules.1")
    return flat, stats


def ttnet_state_dict_to_tree(sd: Mapping) -> Tuple[Dict[str, np.ndarray],
                                                  Dict[str, np.ndarray]]:
    """A cls_ttnet_v2.py MobileShuffleV2Net or cls_ttnet_v3.py TTNetV3 state
    dict -> ``(params, batch_stats)`` in ``models/ttnet.py``'s naming, the
    version told by the key prefix (``backbone.``: v2, ``stem.``: v3); the
    ``fc`` head comes along."""
    flat: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    conv = lambda path, key: _conv_to(flat, sd, key, path)  # noqa: E731
    bn = lambda path, key: _bn_to(flat, stats, sd, key, path)  # noqa: E731

    def block(path: str, key: str) -> None:
        # each branch a Sequential: 0 conv, 1 bn, 2 relu, 3 conv, 4 bn, 5 relu, 6 conv, 7 bn
        for br in ("branch1", "branch2"):
            if f"{key}.{br}.0.weight" not in sd:
                continue
            for n, (c, b) in enumerate((("0", "1"), ("3", "4"), ("6", "7")), start=1):
                conv(f"{path}/{br}/conv{n}", f"{key}.{br}.{c}")
                bn(f"{path}/{br}/bn{n}", f"{key}.{br}.{b}")

    if any(k.startswith("backbone.conv1.") for k in sd):  # v2
        conv("conv1_conv", "backbone.conv1.0")
        bn("conv1_bn", "backbone.conv1.1")
        block("block1", "backbone.block1")
        stage = lambda s: f"backbone.stage_{s}"  # noqa: E731
    else:  # v3
        conv("stem_conv", "stem.0.0")
        bn("stem_bn", "stem.0.1")
        block("stem_block", "stem.1")
        stage = lambda s: f"stages.{s - 1}"  # noqa: E731
    s = 1
    while f"{stage(s)}.0.branch1.0.weight" in sd:
        i = 0
        while f"{stage(s)}.{i}.branch1.0.weight" in sd:
            block(f"stage_{s}/block_{i}", f"{stage(s)}.{i}")
            i += 1
        s += 1
    if "conv1x1.0.weight" in sd:
        conv("final_conv", "conv1x1.0")
        bn("final_bn", "conv1x1.1")
    flat["fc/kernel"] = _np(sd["fc.weight"]).T
    flat["fc/bias"] = _np(sd["fc.bias"])
    return flat, stats
