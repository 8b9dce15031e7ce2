"""The timm-style ViT of the port (``peft_vit_tpu_torch/models/vit.py``
``style="timm"``, the supervised tower of the full-shot trainer) against the
JAX module, the timm converter against the JAX converter, the factory's
routing, and the executed reference's supervised towers
(``tests/golden/refexec_cls_vit.npz``, ``refexec_vit_{lora,adapter,
adapterdrop_lora,rpb}.npz``).

Tolerances: forward and every gradient within 1e-5 relative plus 1e-6 of the
largest reference value (``test_torch_port_peft_hooks._compare``); the
goldens at the JAX tests' rtol 1e-4, atol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from peft_vit_tpu.config import get_default_config as jax_config
from peft_vit_tpu.models import convert as jax_convert
from peft_vit_tpu.models import factory as jax_factory
from peft_vit_tpu.models.vit import VisionTransformer as JaxViT
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu.peft import spec_from_config as jax_spec_from_config
from peft_vit_tpu_torch.config import get_default_config as port_config
from peft_vit_tpu_torch.models import convert as port_convert
from peft_vit_tpu_torch.models import factory as port_factory
from peft_vit_tpu_torch.models.classifier import ImageClassifier
from peft_vit_tpu_torch.models.convert import params_to_jax
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.peft import PEFTSpec
from peft_vit_tpu_torch.peft import spec_from_config as port_spec_from_config
from test_torch_port_peft_hooks import (  # noqa: F401 (_one_thread: an autouse fixture)
    GRID, HEADS, LORA, PATCH, WIDTH, _compare, _images, _one_thread)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

TIMM_CASES = {
    "plain": dict(),
    "lora": dict(LORA, lora_post_scale_q=False),
    "adapterdrop": dict(adapter="houlsby", adapter_dim=16, adapter_layers=(1,)),
    "lora_adapter": dict(LORA, attn_adapter="shared_qkv"),
    "rpb": dict(attn_bias="rpb", rpb_ndim=-1),
    "lepe": dict(lepe=True),
    "vpt": dict(prompt_tokens=2),
}
# the variants the reference builds without a class token (cls_vit.py
# use_cls_tocken=False: RPB's and LePE's grids have no class row)
NO_CLS_CASES = ("plain", "rpb", "lepe")
# Looser bound, with its reason: lora_adapter's LoRA alpha / r of 32 sharpens
# the softmax and the shared adapter's LayerNorm sums cancelling q, k and v
# rows (test_torch_port_peft_hooks.MHA_ATOL); through two blocks the LoRA
# and adapter leaves' gradients stood up to 3.8e-6 of their max apart
# (measured: block 1's q_adapter2; one block is tested now), bound 1e-5.
# adapterdrop: the class
# token's gradient sums every token through the adapter's LayerNorm; 1.06e-6
# of its max apart on one thread (measured), bound 3e-6.
TIMM_ATOL = {"lora_adapter": 1e-5, "adapterdrop": 3e-6}


def _pair(kw, use_cls=True, layers=1, patch_gemm=False):
    shape = dict(image_size=GRID * PATCH, patch_size=PATCH, width=WIDTH, layers=layers,
                 heads=HEADS)
    return (JaxViT(**shape, style="timm", use_cls_token=use_cls, spec=JaxSpec(**kw),
                   use_flash=False, patch_gemm=patch_gemm),
            VisionTransformer(**shape, style="timm", use_cls_token=use_cls,
                              spec=PEFTSpec(**kw), patch_gemm=patch_gemm, device="cpu"))


@pytest.mark.parametrize("case,use_cls", [(c, True) for c in sorted(TIMM_CASES)]
                         + [(c, False) for c in NO_CLS_CASES])
def test_timm_tower_matches_jax(case, use_cls):
    """Forward and the gradient of every parameter (the patch conv's bias
    included) and of the input, with and without the class token (the token
    mean pools then)."""
    # one block (the JAX compile sets this file's time); two where a hook
    # skips a block (AdapterDrop runs its adapter in block 1 only)
    jax_vit, port_vit = _pair(TIMM_CASES[case], use_cls, layers=2 if case == "adapterdrop" else 1)
    _compare(jax_vit, port_vit, _images(21), seed=22, atol=TIMM_ATOL.get(case, 1e-6))
    names = {n for n, _ in port_vit.named_parameters()}
    assert ("class_embedding" in names) == use_cls and "conv1.bias" in names
    assert "ln_pre.weight" not in names and "proj" not in names


def test_timm_patch_gemm_matches_jax():
    jax_vit, port_vit = _pair({}, patch_gemm=True)
    _compare(jax_vit, port_vit, _images(23), seed=24)


def test_timm_init_follows_the_jax_init():
    """A zero class token and a zero patch bias; the positional embedding's
    std 0.02 (CLIP style: 0.01), over the same number of rows."""
    vit = VisionTransformer(image_size=224, patch_size=16, width=768, layers=1, heads=12,
                            style="timm", device="cpu")
    assert torch.count_nonzero(vit.class_embedding) == 0
    assert torch.count_nonzero(vit.conv1.bias) == 0
    assert vit.positional_embedding.shape == (197, 768)
    assert abs(float(vit.positional_embedding.detach().std()) - 0.02) < 1e-3
    assert vit.num_features == 768 and vit.proj is None
    with pytest.raises(ValueError, match="style"):
        VisionTransformer(style="swin", device="cpu")


def test_patch_conv_bias_gradient_is_the_sum_of_the_cotangent():
    """The bias's gradient: one sum over batch and grid, in a fixed order."""
    vit = VisionTransformer(image_size=16, patch_size=8, width=8, layers=1, heads=1,
                            style="timm", device="cpu")
    x = torch.randn(3, 16, 16, 3)
    cot = torch.randn(3, 4, 8)
    (vit.conv1(x) * cot).sum().backward()
    torch.testing.assert_close(vit.conv1.bias.grad, cot.sum((0, 1)), rtol=1e-6, atol=1e-6)


def test_patch_conv_with_a_bias_gradchecks_and_batches_by_cell():
    """``_PatchConv`` with the timm bias: both gradients against float64
    finite differences, and its batching rule (a sweep round's per-cell
    weights and biases) equal to each cell alone."""
    from torch.func import vmap

    from peft_vit_tpu_torch.models.vit import _PatchConv

    x = torch.randn(2, 3, 16, 16, dtype=torch.float64, requires_grad=True)
    w = torch.randn(4, 3, 8, 8, dtype=torch.float64, requires_grad=True)
    b = torch.randn(4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, c, d: _PatchConv.apply(a, c, 8, d), (x, w, b))
    ws, bs = torch.randn(3, 4, 3, 8, 8), torch.randn(3, 4)
    xs = torch.randn(2, 3, 16, 16)
    got = vmap(lambda c, d: _PatchConv.apply(xs, c, 8, d))(ws, bs)
    for i in range(3):
        torch.testing.assert_close(got[i], _PatchConv.apply(xs, ws[i], 8, bs[i]),
                                   rtol=0, atol=0)


# -- the converter and the factory ------------------------------------------------


def _timm_sd(seed=0, width=32, layers=2, classes=5, cls=True, extra=()):
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32) * 0.1  # noqa: E731
    sd = {"patch_embed.proj.weight": r(width, 3, 8, 8), "patch_embed.proj.bias": r(width),
          "pos_embed": r(1, 16 + int(cls), width), "norm.weight": 1 + r(width),
          "norm.bias": r(width), "head.weight": r(classes, width), "head.bias": r(classes)}
    if cls:
        sd["cls_token"] = r(1, 1, width)
    for i in range(layers):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + r(width), f"{p}.norm1.bias": r(width),
                   f"{p}.norm2.weight": 1 + r(width), f"{p}.norm2.bias": r(width),
                   f"{p}.attn.qkv.weight": r(3 * width, width), f"{p}.attn.qkv.bias": r(3 * width),
                   f"{p}.attn.proj.weight": r(width, width), f"{p}.attn.proj.bias": r(width),
                   f"{p}.mlp.fc1.weight": r(4 * width, width), f"{p}.mlp.fc1.bias": r(4 * width),
                   f"{p}.mlp.fc2.weight": r(width, 4 * width), f"{p}.mlp.fc2.bias": r(width)})
        if "lora" in extra:
            for t in "qv":
                sd[f"{p}.attn.{t}_proj_adapter1.weight"] = r(4, width)
                sd[f"{p}.attn.{t}_proj_adapter2.weight"] = r(width, 4)
        for owner in (("adapter",) if "adapter" in extra else ()) + (
                ("attn.adapter",) if "qkv_adapter" in extra else ()):
            d = width if owner == "adapter" else width // 2
            hidden = 16 if owner == "adapter" else d // 2
            sd.update({f"{p}.{owner}.adapter_norm_before.weight": 1 + r(d),
                       f"{p}.{owner}.adapter_norm_before.bias": r(d),
                       f"{p}.{owner}.adapter_down.0.weight": r(d),
                       f"{p}.{owner}.adapter_down.1.weight": r(hidden, d),
                       f"{p}.{owner}.adapter_down.1.bias": r(hidden),
                       f"{p}.{owner}.adapter_up.weight": r(d, hidden),
                       f"{p}.{owner}.adapter_up.bias": r(d)})
        if "rpb" in extra:
            sd[f"{p}.attn.relative_position_bias_table"] = r(49, 2)
        if "lepe" in extra:
            sd[f"{p}.attn.get_v.weight"] = r(width, 1, 3, 3)
            sd[f"{p}.attn.get_v.bias"] = r(width)
    return sd


@pytest.mark.parametrize("extra,cls", [((), True), ((), False), (("lora", "adapter"), True),
                                       (("qkv_adapter", "rpb", "lepe"), False)])
def test_timm_converter_matches_the_jax_converter(extra, cls):
    sd = _timm_sd(extra=extra, cls=cls)
    want = jax_convert.timm_vit_state_dict_to_tree(sd)
    got = port_convert.timm_vit_state_dict_to_tree(sd)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    state = port_convert.timm_vit_state_dict(got)
    assert all(k.startswith("backbone.") for k in state)


def _cfg(factory, **over):
    cfg = factory()
    cfg.MODEL.NAME = "cls_vit_tiny"
    cfg.TRAIN.IMAGE_SIZE = [32, 32]
    v = cfg.MODEL.SPEC.VISION
    v.PATCH_SIZE, v.WIDTH, v.LAYERS, v.HEADS = 8, 32, 2, 2
    for key, value in over.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


@pytest.mark.parametrize("name,method", [("cls_vit_b16", "none"), ("deit_small", "lora")])
def test_factory_builds_the_timm_tower_with_the_jax_builders_leaves(name, method, tmp_path):
    """Any non-CLIP name outside the backbone zoo's families is the timm
    ViT, as in the JAX builder, with the same leaves; a timm checkpoint in
    ``MODEL.PRETRAINED`` is grafted (the PEFT leaves and the head stay
    fresh)."""
    sd = _timm_sd(seed=3)
    path = str(tmp_path / "timm.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    over = {"MODEL.NAME": name, "PEFT.METHOD": method, "MODEL.PRETRAINED": path}
    pcfg, jcfg = _cfg(port_config, **over), _cfg(jax_config, **over)
    model, params, encode_text = port_factory.build_image_classifier(
        pcfg, port_spec_from_config(pcfg), 5, device="cpu")
    assert encode_text is None and model.backbone.style == "timm"
    jax_model, variables, _ = jax_factory.build_image_classifier(
        jcfg, jax_spec_from_config(jcfg), 5)
    got = traverse_util.flatten_dict(params_to_jax(model.state_dict())["params"], sep="/")
    want = traverse_util.flatten_dict(variables["params"], sep="/")
    assert set(got) == set(want)
    for k in want:
        if "adapter" not in k and not k.startswith("classifier/"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("name,family", [("efficientnet_b3", "efficientnet"),
                                         ("rexnet_x1.5", "rexnet"), ("cls_hrnet_w18", "hrnet"),
                                         ("cls_ttnet_v3", "ttnet"),
                                         ("efficientnet_b0", "efficientnet"),
                                         ("rexnet", "rexnet"), ("cls_hrnet", "hrnet"),
                                         ("cls_ttnet_v2", "ttnet")])
def test_factory_refuses_the_other_families(name, family):
    cfg = _cfg(port_config, **{"MODEL.NAME": name})
    assert port_factory.zoo_family(cfg) == family
    with pytest.raises(NotImplementedError, match="ROADMAP §1, the backbone zoo"):
        port_factory.build_image_classifier(cfg, port_spec_from_config(cfg), 5, device="cpu")


@pytest.mark.parametrize("name,family,backbone", [
    ("swin_tiny", "swin", "SwinTransformer"), ("clip_swin_tiny", "swin", "SwinTransformer"),
    ("cls_vit_conv", "convvit", "ConvViT"), ("cls_cswin", "convvit", "ConvViT")])
def test_factory_builds_swin_and_convvit(name, family, backbone):
    """The families ported since: Swin (cls and CLIP) and ConvViT / CSwin
    build and run a forward."""
    swin = {"MODEL.SPEC.VISION.DEPTHS": [2, 2], "MODEL.SPEC.VISION.NUM_HEADS": [2, 4],
            "MODEL.SPEC.VISION.WINDOW_SIZE": 2, "MODEL.SPEC.EMBED_DIM": 16}
    cfg = _cfg(port_config, **{"MODEL.NAME": name, **(swin if family == "swin" else {})})
    assert port_factory.zoo_family(cfg) == family
    model, _, encode_text = port_factory.build_image_classifier(
        cfg, port_spec_from_config(cfg), 5, device="cpu")
    assert type(model.backbone).__name__ == backbone
    assert (encode_text is not None) == name.startswith("clip")
    with torch.no_grad():
        assert model(torch.zeros(2, 32, 32, 3)).shape == (2, 5)


# -- the executed reference ---------------------------------------------------------


def _golden_sd(g):
    return {k[len("sd__"):].replace("__", "."): np.asarray(v) for k, v in g.items()
            if k.startswith("sd__")}


GOLDENS = {
    "refexec_cls_vit.npz": PEFTSpec(),
    "refexec_vit_lora.npz": PEFTSpec(method="lora", attn_delta="lora", lora_rank=4,
                                     lora_alpha=128.0, lora_post_scale_q=False,
                                     lora_targets=("q", "v")),
    # the reference's cls_vit_adapter runs its adapter in block 0 only
    "refexec_vit_adapter.npz": PEFTSpec(method="adapter", adapter="houlsby", adapter_dim=64,
                                        adapter_act="relu", adapter_layers=(0,)),
    # and cls_vit_adapterdrop_lora never runs its LoRA attention
    "refexec_vit_adapterdrop_lora.npz": PEFTSpec(method="adapterdrop", adapter="houlsby",
                                                 adapter_dim=64, adapter_act="relu",
                                                 adapter_layers=(11,)),
    "refexec_vit_rpb.npz": PEFTSpec(method="rpb", attn_bias="rpb", rpb_ndim=-1),
}


@pytest.mark.parametrize("fname", sorted(GOLDENS))
def test_timm_tower_matches_the_executed_reference(fname):
    g = np.load(os.path.join(GOLDEN, fname))
    sd = _golden_sd(g)
    use_cls = bool(int(g["use_cls"])) if "use_cls" in g else True
    width = sd["pos_embed"].shape[-1]
    layers = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    patch = sd["patch_embed.proj.weight"].shape[-1]
    image = patch * int(np.sqrt(sd["pos_embed"].shape[1] - int(use_cls)))
    vit = VisionTransformer(image_size=image, patch_size=patch, width=width, layers=layers,
                            heads=int(g["heads"]), style="timm", use_cls_token=use_cls,
                            spec=GOLDENS[fname], device="cpu")
    model = ImageClassifier(vit, num_classes=sd["head.weight"].shape[0], device="cpu")
    missing, unexpected = model.load_state_dict(
        port_convert.timm_vit_state_dict(port_convert.timm_vit_state_dict_to_tree(sd)),
        strict=False)
    assert not unexpected and all(k.startswith("classifier.") for k in missing)
    with torch.no_grad():
        model.classifier.head.weight.copy_(torch.from_numpy(sd["head.weight"]))
        model.classifier.head.bias.copy_(torch.from_numpy(sd["head.bias"]))
        x = torch.from_numpy(np.ascontiguousarray(g["x"].transpose(0, 2, 3, 1)))
        feats = vit.eval()(x)
        logits = model.eval()(x)
    np.testing.assert_allclose(feats.numpy(), g["feats"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), g["logits"], rtol=1e-4, atol=1e-5)
