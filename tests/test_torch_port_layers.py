"""The port's layers (peft_vit_tpu_torch.models.layers) against the JAX
package's flax modules: each JAX module is initialised in flax, its
weights are replaced by numpy draws from a seed (LoRA ``adapter2``
non-zero), the same tree is carried into the port with
``load_jax_variables``, and both run the same input in fp32 on the CPU.
Tolerance atol = rtol = 1e-5 (fp32; XLA and torch sum in other orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.models import layers as jax_layers
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu_torch.models import layers as port_layers
from peft_vit_tpu_torch.models.convert import load_jax_variables
from peft_vit_tpu_torch.peft import PEFTSpec
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
WIDTH, HEADS = 64, 4
LORA = dict(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
            lora_post_scale_q=True)


def randomize(variables, seed):
    """Every leaf of a flax variables tree redrawn from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in traverse_util.flatten_dict(dict(variables)).items():
        shape, name = np.shape(leaf), path[-1]
        if name == "bn_var":
            x = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "kernel" and "adapter" in path[-2]:
            x = 0.02 * rng.standard_normal(shape)
        elif name in ("kernel", "proj"):
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:
            x = 0.1 * rng.standard_normal(shape)
        out[path] = x.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def _compare(jax_module, port_module, x, seed):
    variables = randomize(jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed)
    want = np.asarray(jax_module.apply(variables, jnp.asarray(x)))
    load_jax_variables(port_module, variables).eval()
    with torch.no_grad():
        got = port_module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _tokens(seed, b=2, n=17):
    return np.random.RandomState(seed).standard_normal((b, n, WIDTH)).astype(np.float32)


@pytest.mark.parametrize("compute_fp32", [True, False])
def test_layernorm(compute_fp32):
    _compare(
        jax_layers.LayerNorm(compute_fp32=compute_fp32),
        port_layers.LayerNorm(WIDTH, compute_fp32=compute_fp32),
        3.0 + 2.0 * _tokens(0), seed=1,
    )


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp(act):
    _compare(
        jax_layers.Mlp(WIDTH, 4 * WIDTH, act=act),
        port_layers.Mlp(WIDTH, 4 * WIDTH, act=act),
        _tokens(2), seed=3,
    )


@pytest.mark.parametrize("act", sorted(port_layers.ACT2FN))
def test_activations(act):
    x = np.linspace(-6.0, 6.0, 101, dtype=np.float32)
    want = np.asarray(jax_layers.ACT2FN[act](jnp.asarray(x)))
    got = port_layers.ACT2FN[act](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "spec_kw",
    [LORA, dict(LORA, lora_post_scale_q=False, lora_targets=("q", "k", "v")), {},
     dict(LORA, lora_ref_reshape=True),
     dict(LORA, lora_post_scale_q=False, lora_targets=("q", "k", "v"), lora_ref_reshape=True)],
    ids=["lora_post_scale_q", "lora_qkv_pre_scale", "no_peft", "lora_ref_reshape",
         "lora_qkv_ref_reshape"],
)
def test_multi_head_attention(spec_kw):
    _compare(
        jax_layers.MultiHeadAttention(WIDTH, HEADS, spec=JaxSpec(**spec_kw), use_flash=False),
        port_layers.MultiHeadAttention(WIDTH, HEADS, spec=PEFTSpec(**spec_kw)),
        _tokens(4, b=4), seed=5,
    )


def test_block():
    _compare(
        jax_layers.Block(WIDTH, HEADS, act="quick_gelu", spec=JaxSpec(**LORA), use_flash=False),
        port_layers.Block(WIDTH, HEADS, act="quick_gelu", spec=PEFTSpec(**LORA)),
        _tokens(6), seed=7,
    )


def test_spec_copy_has_the_same_fields():
    import dataclasses

    assert dataclasses.asdict(PEFTSpec(**LORA)) == dataclasses.asdict(JaxSpec(**LORA))


# The hooks the port once refused, each now held against the JAX package on a
# tiny ViT (2 blocks, a 4 x 4 patch grid) under the LoRA spec; the id names
# the hook as the refusal test named it.  lepe_ref_qkv acts only with lepe.
PORTED_HOOKS = {
    "attn_delta=kron": dict(attn_delta="kron", phm_dim=4),
    "adapter=houlsby": dict(adapter="houlsby", adapter_dim=16),
    "adapter=compacter": dict(adapter="compacter", compacter_reduction=4),
    "lepe=True": dict(lepe=True),
    "lepe_ref_qkv=True": dict(lepe=True, lepe_ref_qkv=True),
    "attn_adapter=shared_qkv": dict(attn_adapter="shared_qkv"),
    "prompt_tokens=10": dict(prompt_tokens=10, prompt_deep=True),
    "lora_moe=True": dict(lora_moe=True),
    "extra_block=True": dict(extra_block=True),
    "attn_bias=rpb": dict(attn_bias="rpb"),
}


@pytest.mark.parametrize("hook", sorted(PORTED_HOOKS))
def test_ported_hook_matches_jax(hook):
    from peft_vit_tpu.models.vit import VisionTransformer as JaxViT
    from peft_vit_tpu_torch.models.vit import VisionTransformer

    kw = {**LORA, **PORTED_HOOKS[hook]}
    shape = dict(image_size=32, patch_size=8, width=WIDTH, layers=2, heads=HEADS, output_dim=32)
    x = np.random.RandomState(8).standard_normal((2, 32, 32, 3)).astype(np.float32)
    _compare(JaxViT(**shape, style="clip", spec=JaxSpec(**kw), use_flash=False),
             VisionTransformer(**shape, spec=PEFTSpec(**kw), device="cpu"), x, seed=9)


@pytest.mark.parametrize("hook", [dict(int8_attn=True), dict(int8_attn_pv=True)],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_hooks_raise(hook):
    """Int8 attention, once refused, now builds on a block and on the tower
    (``test_torch_port_int8_attention.py`` holds its numbers against JAX):
    the flags reach every block's attention, which holds no scales until a
    calibration gives them."""
    from peft_vit_tpu_torch.models.vit import VisionTransformer

    spec = PEFTSpec(**LORA)
    block = port_layers.Block(WIDTH, HEADS, spec=spec, **hook)
    vit = VisionTransformer(image_size=32, patch_size=8, width=WIDTH, layers=1, heads=HEADS,
                            spec=spec, **hook)
    for attn in (block.attn, vit.blocks[0].attn):
        assert (attn.int8_attn, attn.int8_attn_pv) == (hook.get("int8_attn", False),
                                                       hook.get("int8_attn_pv", False))
        assert attn.s_q is None and "s_q" not in attn.state_dict()


@pytest.mark.parametrize("flag", ["int8_attn", "int8_attn_pv"])
def test_int8_attention_flags_raise(flag):
    """The flags, once refused, build; without scales the attention is the
    plain one (the JAX module's ``has_variable("qscale", "s_q")`` test),
    equal to the same module without the flag."""
    x = torch.from_numpy(_tokens(31))
    plain = port_layers.MultiHeadAttention(WIDTH, HEADS, spec=PEFTSpec(**LORA))
    flagged = port_layers.MultiHeadAttention(WIDTH, HEADS, spec=PEFTSpec(**LORA), **{flag: True})
    flagged.load_state_dict(plain.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(flagged(x), plain(x), rtol=0, atol=0)
