"""The port's PEFT hooks against the JAX package's, on the CPU in fp32: the
PHM ops, the Houlsby and Compacter adapters, the KAdaptation, LoRA-MoE,
shared-qkv and LePE attention hooks, the post-MLP adapter hook with
AdapterDrop, VPT prompts (shallow and deep) and the transformer probe's
extra block.  Each JAX module is initialised in flax, every leaf is redrawn
from a numpy seed (none of them zero), the same tree goes into the port
through ``params_from_jax``, and both run the same input: the forward, the
gradient of every parameter and the gradient of the input, for one
cotangent drawn from a seed.

Tolerance (``_close``): rtol 1e-5 and atol 1e-6 x max |reference| of each
tensor (fp32: the same arithmetic, summed in other orders by XLA and
torch).  The executed reference's fixtures are held at the JAX tests' own
tolerances (``tests/test_golden_quirks.py``).  Plus the converter's round
trip for every new leaf and the driver's fresh initialisers."""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import peft_vit_tpu_torch.commands.run as port_run
from peft_vit_tpu.models import layers as jax_layers
from peft_vit_tpu.models.vit import VisionTransformer as JaxViT
from peft_vit_tpu.ops import phm as jax_phm
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu_torch.models import layers as port_layers
from peft_vit_tpu_torch.models.convert import jax_path, params_from_jax, params_to_jax
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.ops import phm as port_phm
from peft_vit_tpu_torch.peft import PEFTSpec

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
WIDTH, HEADS, GRID, PATCH = 64, 4, 4, 8
N = GRID * GRID + 1
LORA = dict(attn_delta="lora", lora_rank=4, lora_alpha=128.0, lora_post_scale_q=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny tensors: as fast alone, and it
    does not contend with the other test processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randomize(variables, seed):
    """Every leaf of a flax variables tree redrawn from RandomState(seed),
    none of them zero: kernels at 1 / sqrt(fan in) (LoRA's and the MoE
    gates' at 0.02, as LoRA's alpha / rank of 32 scales them), LayerNorm
    scales near 1, PHM rules and KAdaptation factors large enough that each
    delta moves the output."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, leaf in traverse_util.flatten_dict(dict(variables)).items():
        shape, name = np.shape(leaf), path[-1]
        if name == "bn_var":
            x = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            x = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "kernel" and "adapter" in path[-2]:  # LoRA (scaled by alpha/r) and MoE
            x = 0.02 * rng.standard_normal(shape)
        elif name in ("kernel", "proj", "W"):
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "phm_rule":
            x = 0.5 * rng.standard_normal(shape)
        elif name.startswith(("W_left", "W_right")):
            x = 0.1 * rng.standard_normal(shape)
        else:
            x = 0.1 * rng.standard_normal(shape)
        out[path] = x.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def _close(got, want, what="", atol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=atol * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _compare(jax_module, port_module, x, seed, atol=1e-6, **apply_kw):
    """Forward and gradients (every parameter, the input) of ``jax_module``
    and ``port_module`` on the same weights and input ``x``, each within
    ``_close`` (``atol`` x max |reference|)."""
    variables = randomize(jax_module.init(jax.random.PRNGKey(0), jnp.asarray(x), **apply_kw),
                          seed)
    params = variables["params"]

    @jax.jit
    def run(p, xx, cot):
        out, vjp = jax.vjp(lambda p_, x_: jax_module.apply({"params": p_}, x_, **apply_kw), p, xx)
        return out, vjp(cot)

    rng = np.random.RandomState(seed + 1)
    want_out = np.asarray(jax.eval_shape(
        lambda: jax_module.apply({"params": params}, jnp.asarray(x), **apply_kw)).shape)
    cot = rng.standard_normal(tuple(want_out)).astype(np.float32)
    out, (g_params, g_x) = run(params, jnp.asarray(x), jnp.asarray(cot))

    port_module.load_state_dict(params_from_jax({"params": params}), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    got = port_module(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach(), out, "forward", atol)
    _close(xt.grad, g_x, "input gradient", atol)
    want_grads = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, g_params)})
    for name, p in port_module.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _close(g, want_grads[name].numpy(), name, atol)


def _tokens(seed, b=2, n=N, d=WIDTH):
    return np.random.RandomState(seed).standard_normal((b, n, d)).astype(np.float32)


def _images(seed, b=2):
    return np.random.RandomState(seed).standard_normal(
        (b, GRID * PATCH, GRID * PATCH, 3)).astype(np.float32)


# ---------------------------------------------------------------- the PHM ops


@pytest.mark.parametrize("n,p,q,r,s", [(4, 16, 1, 16, 1), (2, 3, 5, 4, 2), (8, 8, 8, 8, 8)])
def test_phm_ops_match_jax(n, p, q, r, s):
    rng = np.random.RandomState(n + p)
    a, b = (rng.standard_normal(shape).astype(np.float32) for shape in ((n, p, q), (n, r, s)))
    _close(port_phm.kronecker_product_batched(torch.from_numpy(a), torch.from_numpy(b)),
           jax_phm.kronecker_product_batched(jnp.asarray(a), jnp.asarray(b)))
    rule = rng.standard_normal((n, n, n)).astype(np.float32)
    w = rng.standard_normal((n, p, r)).astype(np.float32)
    _close(port_phm.phm_weight(torch.from_numpy(rule), torch.from_numpy(w)),
           jax_phm.phm_weight(jnp.asarray(rule), jnp.asarray(w)))
    x = rng.standard_normal((3, 5, n * p)).astype(np.float32)
    bias = rng.standard_normal(n * r).astype(np.float32)
    for bb in (None, bias):
        _close(port_phm.phm_linear(torch.from_numpy(x), torch.from_numpy(rule),
                                   torch.from_numpy(w),
                                   None if bb is None else torch.from_numpy(bb)),
               jax_phm.phm_linear(jnp.asarray(x), jnp.asarray(rule), jnp.asarray(w),
                                  None if bb is None else jnp.asarray(bb)))
    wl = rng.standard_normal((n, p, 2)).astype(np.float32)
    wr = rng.standard_normal((n, 2, r)).astype(np.float32)
    _close(port_phm.factorized_phm_weight(*(torch.from_numpy(t) for t in (rule, wl, wr))),
           jax_phm.factorized_phm_weight(*(jnp.asarray(t) for t in (rule, wl, wr))))


def test_phm_linear_adds_the_bias_after_rounding_the_product():
    """In bf16 the product is rounded first, then the bias added: not
    ``F.linear``'s bias inside the GEMM.  Equal, bit for bit, to the JAX
    package's bf16 ``phm_linear``."""
    rng = np.random.RandomState(3)
    x = rng.standard_normal((4, 7, 32)).astype(np.float32)
    rule = rng.standard_normal((4, 4, 4)).astype(np.float32)
    w = (rng.standard_normal((4, 8, 4)) / 6).astype(np.float32)
    b = (100.0 + rng.standard_normal(16)).astype(np.float32)
    got = port_phm.phm_linear(*(torch.from_numpy(t).bfloat16() for t in (x, rule, w, b)))
    want = jax_phm.phm_linear(*(jnp.asarray(t, jnp.bfloat16) for t in (x, rule, w, b)))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    h = port_phm.phm_weight(torch.from_numpy(rule).bfloat16(), torch.from_numpy(w).bfloat16())
    inside = torch.nn.functional.linear(torch.from_numpy(x).bfloat16(), h.t(),
                                        torch.from_numpy(b).bfloat16())
    assert not torch.equal(got, inside)


# ---------------------------------------------------------------- adapters


@pytest.mark.parametrize("act", ["relu", "gelu_new"])
def test_adapter_matches_jax(act):
    _compare(jax_layers.Adapter(WIDTH, 16, act=act), port_layers.Adapter(WIDTH, 16, act=act),
             _tokens(1), seed=2)


def test_phm_dense_matches_jax():
    _compare(jax_layers.PHMDense(WIDTH, 16, 4), port_layers.PHMDense(WIDTH, 16, 4),
             _tokens(3), seed=4)


@pytest.mark.parametrize("width,reduction", [(64, 4), (48, 12), (768, 12)])
def test_compacter_adapter_matches_jax(width, reduction):
    """At 768 the reference's shape: phm_dim 32 down to 64, 4 up; narrower
    towers shrink each phm_dim to a common divisor."""
    _compare(jax_layers.CompacterAdapter(width, reduction=reduction),
             port_layers.CompacterAdapter(width, reduction=reduction),
             _tokens(5, n=5, d=width), seed=6)


def test_fit_phm_dim_matches_jax():
    for req, feats in ((32, (768, 64)), (4, (64, 768)), (32, (64, 16)), (32, (48, 4)), (7, (10,))):
        assert port_layers._fit_phm_dim(req, *feats) == jax_layers._fit_phm_dim(req, *feats)


# ---------------------------------------------------------------- attention hooks

MHA_CASES = {
    "kron": dict(attn_delta="kron", phm_dim=4, phm_rank=1),
    "kron_rank2_post_scale_q": dict(attn_delta="kron", phm_dim=8, phm_rank=2,
                                    lora_post_scale_q=True),
    "kron_phm_dim_is_width": dict(attn_delta="kron", phm_dim=WIDTH, phm_rank=1),
    "lora_moe": dict(LORA, lora_moe=True),
    "lora_moe_sigmoid": dict(LORA, lora_moe=True, lora_moe_act="sigmoid", lora_moe_lambda=2.0),
    "lora_moe_tanh_softmax": dict(LORA, lora_moe=True, lora_moe_act="tanh",
                                  lora_moe_softmax=True, lora_targets=("q", "k", "v")),
    "lora_moe_relu_ref_reshape": dict(LORA, lora_moe=True, lora_moe_act="relu",
                                      lora_ref_reshape=True),
    "shared_qkv": dict(attn_adapter="shared_qkv"),
    "lora_shared_qkv": dict(LORA, attn_adapter="shared_qkv"),
    "lepe": dict(lepe=True),
    "lepe_ref_qkv": dict(lepe=True, lepe_ref_qkv=True),
    "lepe_kron": dict(lepe=True, attn_delta="kron", phm_dim=4, phm_rank=1),
    "kron_ignores_lora_ref_reshape": dict(attn_delta="kron", phm_dim=4, lora_ref_reshape=True),
}


# Looser bounds, each with its reason.  lora_shared_qkv: LoRA's alpha / r of
# 32 sharpens the softmax, and the shared adapter's LayerNorm bias sums its
# gradient over q, k and v of every head and token (3 x 4 x 17 x 3 rows) to
# values that cancel: 1.2e-6 of the max apart measured, bound 3e-6.
MHA_ATOL = {"lora_shared_qkv": 3e-6}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_attention_hook_matches_jax(case):
    kw = MHA_CASES[case]
    _compare(
        jax_layers.MultiHeadAttention(WIDTH, HEADS, spec=JaxSpec(**kw), grid_size=GRID,
                                      n_prefix=1, use_flash=False),
        port_layers.MultiHeadAttention(WIDTH, HEADS, spec=PEFTSpec(**kw), grid_size=GRID,
                                       n_prefix=1),
        _tokens(7, b=3), seed=8, atol=MHA_ATOL.get(case, 1e-6),
    )


def test_lepe_with_prompts_reads_the_grid_after_the_prefix():
    kw = dict(lepe=True)
    _compare(
        jax_layers.MultiHeadAttention(WIDTH, HEADS, spec=JaxSpec(**kw), grid_size=GRID,
                                      n_prefix=3, use_flash=False),
        port_layers.MultiHeadAttention(WIDTH, HEADS, spec=PEFTSpec(**kw), grid_size=GRID,
                                       n_prefix=3),
        _tokens(9, n=GRID * GRID + 3), seed=10,
    )


# ---------------------------------------------------------------- the post-MLP adapter hook

BLOCK_CASES = {
    "houlsby": dict(adapter="houlsby", adapter_dim=16),
    "houlsby_dropped": dict(adapter="houlsby", adapter_dim=16, adapter_layers=(3,)),
    "houlsby_kept": dict(adapter="houlsby", adapter_dim=16, adapter_layers=(0, 3)),
    "compacter": dict(adapter="compacter", compacter_reduction=4),
    "lora_compacter": dict(LORA, adapter="compacter", compacter_reduction=4),
    "lora_drop_adapter": dict(LORA, adapter="houlsby", adapter_dim=16, adapter_layers=(1,)),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_adapter_hook_matches_jax(case):
    """Block 0: a dropped adapter's leaves exist and get no gradient, and the
    block is the plain block."""
    kw = BLOCK_CASES[case]
    _compare(
        jax_layers.Block(WIDTH, HEADS, act="quick_gelu", spec=JaxSpec(**kw), layer_idx=0,
                         use_flash=False),
        port_layers.Block(WIDTH, HEADS, act="quick_gelu", spec=PEFTSpec(**kw), layer_idx=0),
        _tokens(11), seed=12,
    )


# ---------------------------------------------------------------- the ViT: prompts and probe

VIT_CASES = {
    "vpt": dict(prompt_tokens=3),
    "vpt_deep": dict(prompt_tokens=3, prompt_deep=True),
    "vpt_deep_lepe": dict(prompt_tokens=2, prompt_deep=True, lepe=True),
    "extra_block": dict(extra_block=True),
    "extra_block_adapterdrop": dict(extra_block=True, adapter="houlsby", adapter_dim=16,
                                    adapter_layers=(2,)),
    "kadaptation": dict(attn_delta="kron", phm_dim=4),
}


def _vits(kw, layers=3):
    shape = dict(image_size=GRID * PATCH, patch_size=PATCH, width=WIDTH, layers=layers,
                 heads=HEADS, output_dim=32)
    return (JaxViT(**shape, style="clip", spec=JaxSpec(**kw), use_flash=False),
            VisionTransformer(**shape, spec=PEFTSpec(**kw), device="cpu"))


@pytest.mark.parametrize("case", sorted(VIT_CASES))
def test_vision_transformer_hook_matches_jax(case):
    """3 blocks (the extra block a 4th): prompts between the class token and
    the patches, without a positional embedding, deep prompts over blocks 1
    and 2 only, the probe block's leaves under ``blocks.3``."""
    jax_vit, port_vit = _vits(VIT_CASES[case])
    _compare(jax_vit, port_vit, _images(13), seed=14)
    if VIT_CASES[case].get("extra_block"):
        assert port_vit.layers == 3 and len(port_vit.blocks) == 4


# ---------------------------------------------------------------- the converter

ROUND_TRIP = {
    "kadaptation": dict(attn_delta="kron", phm_dim=4, phm_rank=2),
    "lora_moe": dict(LORA, lora_moe=True),
    "lora_adapter": dict(LORA, attn_adapter="shared_qkv"),
    "adapter": dict(adapter="houlsby", adapter_dim=16),
    "compacter": dict(adapter="compacter", compacter_reduction=4),
    "lepe": dict(lepe=True),
    "vpt_deep": dict(prompt_tokens=3, prompt_deep=True),
    "transformer_probe": dict(extra_block=True),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIP))
def test_params_round_trip_through_the_jax_layout(case):
    """``params_from_jax`` loads every leaf of the JAX tree strictly and
    ``params_to_jax`` gives back the same tree, bit for bit; every new leaf's
    JAX path is the one the masks read."""
    jax_vit, port_vit = _vits(ROUND_TRIP[case], layers=2)
    variables = randomize(jax_vit.init(jax.random.PRNGKey(0), jnp.asarray(_images(0, 1))), 15)
    port_vit.load_state_dict(params_from_jax(variables), strict=True)
    back = traverse_util.flatten_dict(params_to_jax(port_vit.state_dict())["params"], sep="/")
    want = traverse_util.flatten_dict(variables["params"], sep="/")
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    named = dict(port_vit.named_parameters())
    assert {jax_path(k, p.dim()) for k, p in named.items()} == set(want)


def test_jax_path_refuses_a_weight_of_another_rank():
    with pytest.raises(ValueError, match="rank 3"):
        jax_path("backbone.blocks.0.attn.x.weight", 3)


# ---------------------------------------------------------------- fresh leaves

FRESH = [
    # (name, shape, (mean, std) or None, bound or None): flax's inits
    ("backbone.blocks.0.attn.q_moe_adapter1.weight", (2, 768), 0.02, None),
    ("backbone.blocks.0.adapter.down.weight", (64, 768), 0.02, None),
    ("backbone.blocks.0.attn.qkv_adapter.up.weight", (64, 32), 0.02, None),
    ("backbone.prompt_embeddings", (10, 768), 0.02, None),
    ("backbone.deep_prompt_embeddings", (11, 10, 768), 0.02, None),
    ("backbone.blocks.0.attn.phm_rule", (4, 4, 4), 0.01, None),
    ("backbone.blocks.0.attn.W_left1", (4, 192, 1), 0.01, None),
    ("backbone.blocks.0.attn.W_right2", (4, 1, 192), 0.01, None),
    ("backbone.blocks.0.compacter.down_phm.phm_rule", (32, 32, 32), 0.01, None),
    # variance_scaling(2, fan_avg, uniform): fans 768 and 64
    ("backbone.blocks.0.compacter.down_phm.W", (32, 24, 2), math.sqrt(2 / 416),
     math.sqrt(6 / 416)),
    ("backbone.blocks.0.compacter.up_phm.W", (4, 16, 192), math.sqrt(2 / 416),
     math.sqrt(6 / 416)),
    # lecun normal, truncated at 2 std: fan in 9
    ("backbone.blocks.0.attn.get_v.weight", (768, 1, 3, 3), math.sqrt(1 / 9),
     2 * math.sqrt(1 / 9) / 0.87962566103423978),
    # the probe block: xavier uniform in_proj, lecun normal elsewhere
    ("backbone.blocks.12.attn.in_proj.weight", (2304, 768), math.sqrt(2 / 3072),
     math.sqrt(6 / 3072)),
    ("backbone.blocks.12.mlp.c_fc.weight", (3072, 768), math.sqrt(1 / 768),
     2 * math.sqrt(1 / 768) / 0.87962566103423978),
    ("backbone.blocks.12.mlp.c_proj.weight", (768, 3072), math.sqrt(1 / 3072),
     2 * math.sqrt(1 / 3072) / 0.87962566103423978),
]
ZEROS = ["backbone.blocks.0.adapter.up.bias", "backbone.blocks.0.compacter.up_phm.b",
         "backbone.blocks.0.attn.phmb", "backbone.blocks.0.attn.get_v.bias",
         "backbone.blocks.12.ln_1.bias", "backbone.blocks.12.mlp.c_fc.bias"]
ONES = ["backbone.blocks.0.adapter.adapter_norm_before.weight", "backbone.blocks.12.ln_2.weight"]


@pytest.mark.parametrize("name,shape,std,bound", FRESH, ids=[f[0].split(".", 3)[-1]
                                                             for f in FRESH])
def test_fresh_leaf_follows_the_flax_init(name, shape, std, bound):
    """Mean near 0 and the standard deviation within 5 % (at least 2,048
    draws, except the (4, 4, 4) rule: 15 %), every draw within its bound."""
    t = port_run._fresh_leaf(name, shape, torch.Generator().manual_seed(0))
    assert t.shape == shape and t.dtype == torch.float32
    rel = 0.15 if t.numel() < 2048 else 0.05
    assert float(t.std()) == pytest.approx(std, rel=rel)
    assert abs(float(t.mean())) < 4 * std / math.sqrt(t.numel())
    if bound is not None:
        assert float(t.abs().max()) <= bound


def test_fresh_leaf_zeros_and_ones():
    gen = torch.Generator().manual_seed(0)
    for name in ZEROS:
        assert not port_run._fresh_leaf(name, (64,), gen).any(), name
    for name in ONES:
        assert bool((port_run._fresh_leaf(name, (64,), gen) == 1).all()), name


def test_every_leaf_of_every_method_has_a_fresh_initialiser():
    """The trainable leaves of each ported method whose cells draw them
    fresh, at a small width.  The methods that train the pretrained tower
    draw only the head and start the tower's leaves from their grafted
    values (``tests/test_torch_port_tower_methods.py``); the contrastive
    methods likewise draw only their logit scale, 1
    (``tests/test_torch_port_zeroshot.py``)."""
    from peft_vit_tpu_torch.config import get_default_config
    from peft_vit_tpu_torch.peft import build_mask, spec_from_config

    gen = torch.Generator().manual_seed(0)
    assert port_run._fresh_leaf("logit_scale", (), gen).item() == 1.0
    for method in port_run.PORTED_METHODS:
        if method in port_run.TOWER_METHODS + port_run.CONTRASTIVE_METHODS:
            continue
        cfg = get_default_config()
        cfg.PEFT.METHOD = method
        cfg.PEFT.COMPACTER_REDUCTION = 4
        cfg.PEFT.PHM_DIM = 4
        spec = spec_from_config(cfg)
        vit = VisionTransformer(image_size=16, patch_size=8, width=WIDTH, layers=2, heads=HEADS,
                                spec=spec, device="cpu")
        mask = build_mask(vit, method if method != "none" else "linear", num_layers=2,
                          train_head=False, adapter_layers=spec.adapter_layers)
        gen = torch.Generator().manual_seed(0)
        for name, p in vit.named_parameters():
            if mask[name]:
                assert port_run._fresh_leaf(name, p.shape, gen).shape == p.shape, (method, name)


# ---------------------------------------------------------------- the executed reference's fixtures


def _golden(name):
    return np.load(os.path.join(GOLDEN, name))


def _load_fixture(module, mapping, absent=()):
    """The fixture's tensors, under the JAX package's paths (as the JAX
    tests set them), into ``module`` through the converter; the leaves the
    fixture does not set (``absent``) keep the module's own."""
    tree = traverse_util.unflatten_dict({k: np.asarray(v, np.float32)
                                         for k, v in mapping.items()}, sep="/")
    missing, unexpected = module.load_state_dict(params_from_jax({"params": tree}), strict=False)
    assert not unexpected and set(missing) == set(absent), (missing, unexpected)
    return module.eval()


def _attn_mapping(g):
    return {"in_proj/kernel": g["w_qkv"].T, "in_proj/bias": g["b_qkv"],
            "out_proj/kernel": g["w_out"].T, "out_proj/bias": g["b_out"]}


def _run(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(np.asarray(x, np.float32))).numpy()


@pytest.mark.parametrize("fname", ["adapter_double_mlp.npz", "refexec_adapter_double_mlp.npz"])
def test_adapter_double_mlp_fixture(fname):
    g = _golden(fname)
    d = g["x"].shape[-1]
    spec = PEFTSpec(method="adapter", adapter="houlsby", adapter_dim=int(g["adapter_dim"]),
                    adapter_act="relu")
    m = _load_fixture(port_layers.Block(d, int(g["heads"]), act="quick_gelu", spec=spec), {
        "ln_1/scale": g["ln1_w"], "ln_1/bias": g["ln1_b"],
        **{f"attn/{k}": v for k, v in _attn_mapping(g).items()},
        "ln_2/scale": g["ln2_w"], "ln_2/bias": g["ln2_b"],
        "mlp/c_fc/kernel": g["w_fc"].T, "mlp/c_fc/bias": g["b_fc"],
        "mlp/c_proj/kernel": g["w_proj"].T, "mlp/c_proj/bias": g["b_proj"],
        "adapter/adapter_norm_before/scale": g["lna_w"],
        "adapter/adapter_norm_before/bias": g["lna_b"],
        "adapter/down/kernel": g["w_down"].T, "adapter/down/bias": g["b_down"],
        "adapter/up/kernel": g["w_up"].T, "adapter/up/bias": g["b_up"]})
    # the JAX test's scale-aware bound (the refexec fixture's O(30) activations)
    np.testing.assert_allclose(_run(m, g["x"]), g["out"], rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(g["out"]).max())))


@pytest.mark.parametrize("fname", ["compacter_phm_adapter.npz",
                                   "refexec_compacter_phm_adapter.npz"])
def test_compacter_phm_adapter_fixture(fname):
    g = _golden(fname)
    m = _load_fixture(port_layers.CompacterAdapter(
        g["x"].shape[-1], reduction=int(g["reduction"]), phm_dim_down=int(g["phm_dim_down"]),
        phm_dim_up=int(g["phm_dim_up"])), {
        "adapter_norm_before/scale": g["ln_w"], "adapter_norm_before/bias": g["ln_b"],
        "down_phm/W": g["w_dn"], "down_phm/phm_rule": g["rule_dn"], "down_phm/b": g["b_dn"],
        "up_phm/W": g["w_up"], "up_phm/phm_rule": g["rule_up"], "up_phm/b": g["b_up"]})
    np.testing.assert_allclose(_run(m, g["x"]), g["out"], atol=1e-5, rtol=1e-4)


def _kadaptation(t, heads, phm_dim, phm_rank):
    d = t["x"].shape[-1]
    spec = PEFTSpec(method="kadaptation", attn_delta="kron", phm_dim=phm_dim,
                    phm_rank=phm_rank, lora_post_scale_q=False)
    m = port_layers.MultiHeadAttention(d, heads, spec=spec)
    return _load_fixture(m, {**_attn_mapping(t), "phm_rule": t["rule"], "W_left1": t["l1"],
                             "W_right1": t["r1"], "W_left2": t["l2"], "W_right2": t["r2"]},
                         absent=("phmb",))


def test_kadaptation_kron_attn_fixture():
    g = _golden("kadaptation_kron_attn.npz")
    m = _kadaptation(g, int(g["heads"]), int(g["phm_dim"]), int(g["phm_rank"]))
    np.testing.assert_allclose(_run(m, g["x"]), g["out"], rtol=1e-4, atol=1e-5)


@pytest.mark.skipif(
    os.environ.get("PVT_RUN_BIG_GOLDEN", "") != "1",
    reason="regenerates the reference's hardcoded (768,768,768) phm_rule (~1.7 GB of "
    "temporaries); set PVT_RUN_BIG_GOLDEN=1, as for the JAX package's test",
)
def test_kadaptation_kron_attn_refexec_fixture():
    """Full width at the reference's phm_dim 768 (the JAX test's gate)."""
    import sys

    sys.path.insert(0, GOLDEN)
    try:
        from generate_from_reference import kadaptation_tensors
    finally:
        sys.path.pop(0)
    g = _golden("refexec_kadaptation_kron_attn.npz")
    t = {k: (v.numpy() if hasattr(v, "numpy") else v)
         for k, v in kadaptation_tensors(seed=int(g["seed"])).items()}
    m = _kadaptation(t, int(g["heads"]), int(g["phm_dim"]), int(g["phm_rank"]))
    np.testing.assert_allclose(_run(m, t["x"]), g["out"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fname", ["lepe_attention.npz", "refexec_lepe_attention.npz"])
def test_lepe_attention_fixture(fname):
    """A pure grid (n_prefix 0); the refexec fixture with the reference's
    q/k/v scramble (``lepe_ref_qkv``)."""
    g = _golden(fname)
    spec = PEFTSpec(method="lepe", lepe=True, lepe_ref_qkv=fname.startswith("refexec_"))
    m = port_layers.MultiHeadAttention(g["x"].shape[-1], int(g["heads"]), spec=spec,
                                       grid_size=int(g["grid"]), n_prefix=0)
    m = _load_fixture(m, {**_attn_mapping(g),
                          "get_v/kernel": np.transpose(g["w_v"], (2, 3, 1, 0)),
                          "get_v/bias": g["bias_v"]})
    np.testing.assert_allclose(_run(m, g["x"]), g["out"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fname", ["shared_qkv_adapter.npz", "refexec_shared_qkv_adapter.npz"])
def test_shared_qkv_adapter_fixture(fname):
    g = _golden(fname)
    spec = PEFTSpec(method="adapter", attn_adapter="shared_qkv")
    m = _load_fixture(port_layers.MultiHeadAttention(g["x"].shape[-1], int(g["heads"]),
                                                     spec=spec), {
        **_attn_mapping(g),
        "qkv_adapter/adapter_norm_before/scale": g["ln_w"],
        "qkv_adapter/adapter_norm_before/bias": g["ln_b"],
        "qkv_adapter/down/kernel": g["w_down"].T, "qkv_adapter/down/bias": g["b_down"],
        "qkv_adapter/up/kernel": g["w_up"].T, "qkv_adapter/up/bias": g["b_up"]})
    np.testing.assert_allclose(_run(m, g["x"]), g["out"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fname", ["lora_moe_gate.npz", "refexec_lora_moe_gate.npz"])
def test_lora_moe_gate_fixture(fname):
    g = _golden(fname)
    spec = PEFTSpec(method="lora_moe", attn_delta="lora", lora_rank=int(g["rank"]),
                    lora_alpha=float(g["alpha"]), lora_post_scale_q=True,
                    lora_targets=("q", "v"), lora_moe=True, lora_moe_group=int(g["group"]),
                    lora_moe_act="sigmoid", lora_moe_lambda=float(g["lam"]),
                    lora_moe_softmax=False)
    m = _load_fixture(port_layers.MultiHeadAttention(g["x"].shape[-1], int(g["heads"]),
                                                     spec=spec), {
        **_attn_mapping(g),
        "q_adapter1/kernel": g["a_q"].T, "q_adapter2/kernel": g["b_q"].T,
        "q_moe_adapter1/kernel": g["g_q"].T,
        "v_adapter1/kernel": g["a_v"].T, "v_adapter2/kernel": g["b_v"].T,
        "v_moe_adapter1/kernel": g["g_v"].T})
    np.testing.assert_allclose(_run(m, g["x"]), g["out"], rtol=1e-5, atol=1e-5)


def test_clip_checkpoint_houlsby_adapter_converts_as_jax():
    """A reference-trained adapter CLIP checkpoint (``adapter_norm_before``,
    ``adapter_down.1``, ``adapter_up`` in every block): the port's converter
    gives the JAX converter's tree, bit for bit, and the port's adapter model
    loads its visual tower strictly."""
    from peft_vit_tpu.models import convert as jax_convert
    from peft_vit_tpu_torch.models.convert import clip_state_dict_to_tree, visual_state_dict
    from test_torch_port_driver import _fake_clip_state_dict

    sd = _fake_clip_state_dict()
    rng = np.random.RandomState(16)
    for i in range(2):
        a = f"visual.transformer.resblocks.{i}.adapter"
        for key, shape in (("adapter_norm_before.weight", (32,)),
                           ("adapter_norm_before.bias", (32,)),
                           ("adapter_down.1.weight", (8, 32)), ("adapter_down.1.bias", (8,)),
                           ("adapter_up.weight", (32, 8)), ("adapter_up.bias", (32,))):
            sd[f"{a}.{key}"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got, want = clip_state_dict_to_tree(sd), jax_convert.clip_state_dict_to_tree(sd)
    assert set(got) == set(want) and any("/adapter/" in k for k in got)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    spec = PEFTSpec(method="lora", adapter="houlsby", adapter_dim=8, **LORA)
    vit = VisionTransformer(image_size=16, patch_size=8, width=32, layers=2, heads=1,
                            output_dim=24, spec=spec, device="cpu")
    state = {k[len("backbone."):]: v for k, v in visual_state_dict(got).items()}
    missing, unexpected = vit.load_state_dict(state, strict=False)
    assert not unexpected
    assert set(missing) == {f"blocks.1.attn.{t}_adapter{i}.weight" for t in "qv" for i in (1, 2)}
