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
