"""The port's trainable masks (peft_vit_tpu_torch.peft.masks) against the JAX
package's, on the tiny flagship tree: for every method name the predicates
know, the port's ``{name: bool}`` equals the JAX ``build_mask`` under the
name map ``models.convert.jax_path``, and ``count_trainable`` is equal.
Masks are booleans and counts are integers: equality is exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.peft import masks as jax_masks
from peft_vit_tpu_torch.models import flagship, jax_path, params_from_jax, params_to_jax
from peft_vit_tpu_torch.peft import masks as port_masks
from test_torch_port_model import TINY, _jax_flagship, randomize

METHODS = [
    "none", "linear", "full", "bitfit", "layernorm", "attention", "lora", "lora_fix_one",
    "lora_moe", "lora_adapter", "lora_drop_adapter", "lora_compacter", "first_attention",
    "first_mlp", "adapter", "adapterdrop", "compacter", "kadaptation", "rpb", "lepe",
    "transformer_probe", "vpt", "finetune_contrast", "linear_probe_contrast", "intrinsic",
]


@pytest.fixture(scope="module")
def trees():
    model = _jax_flagship(use_bn=True)
    x = jnp.zeros((1, TINY["image"], TINY["image"], 3), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x)["params"]
    port = flagship(**TINY, dtype=torch.float32, use_bn=True, device="cpu")
    return params, port


def _jax_flat(params, **kw):
    return traverse_util.flatten_dict(jax_masks.build_mask(params, **kw), sep="/")


def _port_by_path(port, mask):
    named = dict(port.named_parameters())
    return {jax_path(name, named[name].dim()): m for name, m in mask.items()}


def test_every_method_the_jax_predicates_know_is_listed():
    """METHODS is the JAX ``_method_predicate``'s whole vocabulary: each name
    is accepted by both packages, and an unknown one by neither."""
    for method in METHODS:
        jax_masks._method_predicate(method, 12)
        port_masks._method_predicate(method, 12)
    for module in (jax_masks, port_masks):
        with pytest.raises(ValueError):
            module._method_predicate("no_such_method", 12)


@pytest.mark.parametrize("method", METHODS)
def test_mask_and_count_equal_jax(trees, method):
    params, port = trees
    kw = dict(method=method, num_layers=TINY["layers"])
    if method == "adapterdrop":
        kw["adapter_layers"] = (1,)
    want = _jax_flat(params, **kw)
    mask = port_masks.build_mask(port, **kw)
    assert set(mask) == set(dict(port.named_parameters()))
    assert _port_by_path(port, mask) == want
    assert port_masks.count_trainable(port, mask) == jax_masks.count_trainable(
        params, jax_masks.build_mask(params, **kw))


@pytest.mark.parametrize(
    "kw",
    [dict(method="lora", train_head=False),
     dict(method="none", extra_regex=r"blocks_1/mlp/c_fc|ln_post"),
     dict(method="lora", train_head=False, extra_regex=r"positional_embedding$")],
    ids=["train_head_false", "extra_regex", "both"],
)
def test_train_head_and_extra_regex_equal_jax(trees, kw):
    params, port = trees
    want = _jax_flat(params, **kw)
    mask = port_masks.build_mask(port, **kw)
    assert _port_by_path(port, mask) == want
    assert any(want.values())


def test_full_width_lora_count():
    """12 layers x 2 targets x 2 x 768 x 4 LoRA weights, plus the 512 x 100
    head and its bias."""
    port = flagship(dtype=torch.bfloat16, device="meta")
    mask = port_masks.build_mask(port, "lora")
    assert port_masks.count_trainable(port, mask) == 12 * 2 * 2 * 768 * 4 + 512 * 100 + 100 == 198756


def test_split_merge_describe(trees):
    _, port = trees
    port = flagship(**TINY, dtype=torch.float32, use_bn=True, device="cpu")
    mask = port_masks.build_mask(port, "lora", num_layers=TINY["layers"])
    trainable, frozen = port_masks.split_params(port, mask)
    named = dict(port.named_parameters())
    assert set(trainable) | set(frozen) == set(named) and not set(trainable) & set(frozen)
    for name, p in named.items():
        assert p.requires_grad == mask[name] == (name in trainable)
        assert (trainable.get(name, frozen.get(name))) is p
    merged = port_masks.merge_params(trainable, frozen)
    assert set(merged) == set(named) and all(merged[k] is named[k] for k in named)
    text = port_masks.describe_mask(port, mask)
    assert "backbone.blocks.1.attn.q_adapter1.weight  (4, 64)" in text
    total = port_masks.count_trainable(port, mask)
    assert text.endswith(f"Number of trainable params: {total / 1e6}M.")
    with pytest.raises(ValueError):
        port_masks.split_params(port, {k: v for k, v in mask.items() if "head" not in k})


def test_params_to_jax_inverts_params_from_jax(trees):
    params, _ = trees
    model = _jax_flagship(use_bn=True)
    x = jnp.zeros((1, TINY["image"], TINY["image"], 3), jnp.float32)
    variables = randomize(model.init(jax.random.PRNGKey(0), x), seed=3)
    back = params_to_jax(params_from_jax(variables))
    want = traverse_util.flatten_dict(variables, sep="/")
    got = traverse_util.flatten_dict(back, sep="/")
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
