"""The port's stacked block layout (``TPU.SCAN_LAYERS``: the JAX ``nn.scan``
over the blocks) against its unrolled layout and the JAX package on the
CPU: the stacked tower equal to the unrolled one bit for bit (the JAX
``test_scan_layers.py``'s plain, LoRA and adapter specs), forward and
gradients; the stacked tower against JAX's scanned one from the same tree,
forward and LoRA gradients; the stack / unstack round trip and the
converter's stacked leaves; the per-layer specs falling back to the unrolled
layout; the masks on the stacked tree against JAX's ``build_mask``; no cached
prefix under the stacked layout; the builder's ``TPU.SCAN_LAYERS`` on a CLIP
and a timm config with a checkpoint grafted, against the JAX builder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from peft_vit_tpu import config as jax_config
from peft_vit_tpu.models import VisionTransformer as JaxViT
from peft_vit_tpu.models import factory as jax_factory
from peft_vit_tpu.models.convert import stack_flat_blocks as jax_stack
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu.peft import build_mask as jax_build_mask
from peft_vit_tpu.peft import spec_from_config as jax_spec_from_config
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.engine.cached import first_trainable_layer, maybe_cache_prefix
from peft_vit_tpu_torch.models import VisionTransformer, factory as port_factory
from peft_vit_tpu_torch.models import load_jax_variables, params_to_jax
from peft_vit_tpu_torch.models.convert import (jax_path, params_from_jax, stack_flat_blocks,
                                               unstack_flat_blocks)
from peft_vit_tpu_torch.peft import PEFTSpec, build_mask
from peft_vit_tpu_torch.peft import spec_from_config as port_spec_from_config
from test_torch_port_driver import _fake_clip_state_dict, tiny_cfg
from test_torch_port_model import randomize
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)
from test_torch_port_timm_vit import _cfg as timm_cfg
from test_torch_port_timm_vit import _timm_sd

LAYERS = 3
KW = dict(image_size=16, patch_size=8, width=32, layers=LAYERS, heads=2, style="clip",
          output_dim=32)
TOL_FWD = dict(rtol=1e-5, atol=1e-5)  # one fp32 forward in each framework
TOL_GRAD = dict(rtol=1e-4, atol=1e-5)  # fp32 LoRA gradients, another summation order
SPECS = {
    "plain": dict(),
    "lora": dict(method="lora", attn_delta="lora", lora_rank=2, lora_post_scale_q=True),
    "adapter": dict(method="adapter", adapter="houlsby", adapter_dim=8),
}
FALLBACK = {
    "adapterdrop": dict(method="adapterdrop", adapter="houlsby", adapter_layers=(1,)),
    "deep_vpt": dict(method="vpt", prompt_tokens=2, prompt_deep=True),
    "probe": dict(method="transformer_probe", extra_block=True),
}
METHODS = ("full", "bitfit", "layernorm", "attention", "lora", "lora_fix_one",
           "first_attention", "first_mlp", "adapter", "linear")


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_trees(kind: str, seed: int = 0):
    """The JAX unrolled tower's random tree of spec ``kind`` and its stack."""
    unrolled = JaxViT(spec=JaxSpec(**SPECS[kind]), use_flash=False, **KW)
    variables = randomize(unrolled.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))), seed)
    flat = _flat(variables["params"])
    return flat, stack_flat_blocks(flat, LAYERS)


def _port(kind: str, flat: dict, scan: bool):
    model = VisionTransformer(spec=PEFTSpec(**SPECS[kind]), scan_layers=scan, **KW)
    load_jax_variables(model, {"params": traverse_util.unflatten_dict(flat, sep="/")})
    return model


@pytest.mark.parametrize("kind", list(SPECS))
def test_stacked_equals_unrolled_bit_for_bit(kind):
    """The stacked tower on the stacked tree against the unrolled one on the
    tree it was stacked from: the features and every gradient (the stacked
    leaf's layer i equal to block i's) bit for bit."""
    flat, stacked = _jax_trees(kind)
    unrolled, scanned = _port(kind, flat, False), _port(kind, stacked, True)
    assert scanned.scan_layers and not unrolled.scan_layers
    x = torch.from_numpy(np.random.RandomState(1).standard_normal((2, 16, 16, 3))
                         .astype(np.float32))
    ya, yb = unrolled(x), scanned(x)
    torch.testing.assert_close(yb, ya, rtol=0, atol=0)
    ga = dict(zip([k for k, _ in unrolled.named_parameters()],
                  torch.autograd.grad(ya.square().sum(), list(unrolled.parameters()))))
    gb = dict(zip([k for k, _ in scanned.named_parameters()],
                  torch.autograd.grad(yb.square().sum(), list(scanned.parameters()))))
    for k, g in gb.items():
        if "blocks.block." in k:
            want = torch.stack([ga[k.replace("blocks.block.", f"blocks.{i}.")]
                                for i in range(LAYERS)])
        else:
            want = ga[k]
        torch.testing.assert_close(g, want, rtol=0, atol=0, msg=k)


def test_stacked_against_jax_scan_forward_and_lora_gradients():
    """The port's stacked tower against the JAX scanned tower on the same
    stacked tree: the features within ``TOL_FWD``, the stacked LoRA leaves'
    gradients of the features' sum of squares within ``TOL_GRAD``."""
    _, stacked = _jax_trees("lora", seed=2)
    scanned = JaxViT(spec=JaxSpec(**SPECS["lora"]), use_flash=False, scan_layers=True, **KW)
    params = traverse_util.unflatten_dict(stacked, sep="/")
    x = np.random.RandomState(3).standard_normal((2, 16, 16, 3)).astype(np.float32)
    mask = jax_build_mask(params, "lora", num_layers=LAYERS, train_head=False)
    lora = {k for k, m in traverse_util.flatten_dict(mask, sep="/").items() if m}
    assert lora and all(k.startswith("blocks/block/") for k in lora)

    def loss(p):
        return jnp.sum(scanned.apply({"params": p}, jnp.asarray(x)) ** 2)

    # compiled: the scan's eager gradient takes ~5x as long on the CPU
    want_y, want_g = jax.jit(lambda p: (scanned.apply({"params": p}, jnp.asarray(x)),
                                        jax.grad(loss)(p)))(params)
    want_y, want_g = np.asarray(want_y), _flat(want_g)
    model = _port("lora", stacked, True)
    y = model(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), want_y, **TOL_FWD)
    names = [k for k, _ in model.named_parameters() if "_adapter" in k]
    grads = torch.autograd.grad(y.square().sum(), [dict(model.named_parameters())[k]
                                                   for k in names])
    got = _flat(params_to_jax(dict(zip(names, grads)))["params"])
    assert set(got) == lora
    for k in lora:
        np.testing.assert_allclose(got[k], want_g[k], **TOL_GRAD, err_msg=k)


def test_stack_unstack_round_trip_and_the_converter():
    """``stack_flat_blocks`` / ``unstack_flat_blocks`` against the JAX
    functions and back; the stacked tree through ``params_from_jax`` (each
    layer's kernel transposed) and ``params_to_jax`` back, bit for bit."""
    flat, stacked = _jax_trees("lora")
    want = jax_stack(flat, LAYERS)
    assert set(stacked) == set(want)
    for k in want:
        np.testing.assert_array_equal(stacked[k], np.asarray(want[k]), err_msg=k)
    back = unstack_flat_blocks(stacked)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    state = params_from_jax({"params": traverse_util.unflatten_dict(stacked, sep="/")})
    w = state["blocks.block.attn.in_proj.weight"]
    assert tuple(w.shape) == (LAYERS, 96, 32)
    np.testing.assert_array_equal(w[1].numpy(), flat["blocks_1/attn/in_proj/kernel"].T)
    assert jax_path("blocks.block.attn.in_proj.weight", 3) == "blocks/block/attn/in_proj/kernel"
    assert jax_path("blocks.block.ln_1.weight", 2) == "blocks/block/ln_1/scale"
    again = _flat(params_to_jax(state)["params"])
    assert set(again) == set(stacked)
    for k in stacked:
        np.testing.assert_array_equal(again[k], stacked[k], err_msg=k)


@pytest.mark.parametrize("kind", list(FALLBACK))
def test_per_layer_specs_fall_back_to_the_unrolled_layout(kind):
    """AdapterDrop's layer subset, deep prompts and the probe's extra block
    (and drop path) keep the blocks layer-addressable, as the JAX
    ``_can_scan`` declines them."""
    model = VisionTransformer(spec=PEFTSpec(**FALLBACK[kind]), scan_layers=True, **KW)
    names = [k for k, _ in model.named_parameters()]
    assert not model.scan_layers and any(k.startswith("blocks.0.") for k in names)
    jax_model = JaxViT(spec=JaxSpec(**FALLBACK[kind]), use_flash=False, scan_layers=True, **KW)
    jax_names = _flat(jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"])
    assert set(jax_names) == {jax_path(k, p.dim()) for k, p in model.named_parameters()}
    dropped = VisionTransformer(spec=PEFTSpec(), scan_layers=True, drop_path_rate=0.1, **KW)
    assert not dropped.scan_layers


@pytest.mark.parametrize("method", METHODS)
def test_masks_on_the_stacked_tree_equal_jax(method):
    """Each method's mask on the stacked tree, leaf for leaf, against the JAX
    ``build_mask`` on the JAX stacked tree.  ``first_attention`` and
    ``first_mlp`` name ``blocks_1``, which no stacked leaf matches in either
    package."""
    kind = "adapter" if method == "adapter" else "lora"
    _, stacked = _jax_trees(kind)
    model = _port(kind, stacked, True)
    got = {jax_path(k, p.dim()): m for (k, p), m in zip(
        model.named_parameters(), build_mask(model, method, num_layers=LAYERS).values())}
    want = _flat(jax_build_mask(traverse_util.unflatten_dict(stacked, sep="/"), method,
                                num_layers=LAYERS))
    assert got == {k: bool(v) for k, v in want.items()}
    if method.startswith("first_"):
        assert not any(m for k, m in got.items() if k.startswith("blocks/"))


def test_no_cached_prefix_under_the_stacked_layout():
    """A mask that trains only the head would cut the unrolled tower after
    its last block; the stacked tower takes no cached prefix (the JAX
    ``maybe_cache_prefix``'s scan check)."""
    cfg = port_config.get_default_config()
    flat, stacked = _jax_trees("plain")
    for scan, tree in ((False, flat), (True, stacked)):
        model = torch.nn.Module()
        model.backbone = _port("plain", tree, scan)
        mask = {f"backbone.{k}": False for k, _ in model.backbone.named_parameters()}
        mask["classifier.head.weight"] = True
        if scan:
            assert maybe_cache_prefix(cfg, model, mask, LAYERS, splits=None) is None
        else:
            assert first_trainable_layer(mask, LAYERS) == LAYERS


def _clip_sd():
    """The driver test's fake CLIP checkpoint without its block-0-only LoRA
    leaves (a stacked leaf needs every layer's)."""
    return {k: v for k, v in _fake_clip_state_dict().items() if "_adapter" not in k}


@pytest.mark.parametrize("family", ["clip", "timm"])
def test_builder_scan_layers_grafts_as_the_jax_builder(family, tmp_path):
    """``TPU.SCAN_LAYERS`` through both builders with a checkpoint in
    ``MODEL.PRETRAINED`` (a CLIP ViT, a timm ViT): the same stacked leaves,
    every grafted one equal; and the stacked model equal to the one the port
    builds without the flag, bit for bit."""
    path = str(tmp_path / "ckpt.pt")
    if family == "clip":
        torch.save(_clip_sd(), path)
        over = {"MODEL.PRETRAINED": path, "MODEL.SPEC.VISION.HEADS": 2}
        make = tiny_cfg
    else:
        torch.save({k: torch.from_numpy(v) for k, v in _timm_sd(seed=3).items()}, path)
        over = {"MODEL.NAME": "cls_vit_b16", "PEFT.METHOD": "lora", "MODEL.PRETRAINED": path}

        def make(pkg, **kw):
            return timm_cfg(pkg.get_default_config, **kw)
    scan = {**over, "TPU.SCAN_LAYERS": True}
    pcfg, jcfg = make(port_config, **scan), make(jax_config, **scan)
    model, _, _ = port_factory.build_image_classifier(pcfg, port_spec_from_config(pcfg), 4,
                                                      device="cpu")
    assert model.backbone.scan_layers
    _, variables, _ = jax_factory.build_image_classifier(jcfg, jax_spec_from_config(jcfg), 4)
    got = _flat(params_to_jax(model.state_dict())["params"])
    want = _flat(variables["params"])
    assert set(got) == set(want) and "backbone/blocks/block/mlp/c_fc/kernel" in got
    for k in want:
        if "adapter" not in k and not k.startswith("classifier/"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ucfg = make(port_config, **over)
    unrolled, _, _ = port_factory.build_image_classifier(ucfg, port_spec_from_config(ucfg), 4,
                                                         device="cpu")
    x = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (2, *pcfg.TRAIN.IMAGE_SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(model.eval()(x), unrolled.eval()(x), rtol=0, atol=0)
