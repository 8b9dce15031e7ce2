"""The port's Swin family (``peft_vit_tpu_torch/models/swin.py``,
``ssl_swin.py``) against the JAX modules (``peft_vit_tpu/models/swin.py``,
``ssl_swin.py``), and against the executed reference's towers
(``tests/golden/refexec_swin.npz``, ``refexec_ssl_swin.npz``) loaded through
the port's converter.

Tiny towers (32 px, patch 4, embed 16, window 4 or 2, depths (2, 2)) from
one weight tree redrawn from a numpy seed.  Tolerances: the fp32 forward and
the gradient of every parameter (the relative position tables through the
window fold included) and of the input, each within 1e-4 of the largest
reference value; the goldens at the JAX tests' own rtol 1e-4, atol 1e-5; the
window ops, the shift mask and the masks exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from peft_vit_tpu.models import ssl_swin as jax_ssl
from peft_vit_tpu.models import swin as jax_swin
from peft_vit_tpu.peft.spec import PEFTSpec as JaxSpec
from peft_vit_tpu_torch.models import ssl_swin as port_ssl
from peft_vit_tpu_torch.models import swin as port_swin
from peft_vit_tpu_torch.models.convert import (params_from_jax, params_to_jax,
                                               swin_state_dict_to_tree, tower_state_dict)
from peft_vit_tpu_torch.ops import attention as port_attn
from peft_vit_tpu_torch.peft.spec import PEFTSpec as PortSpec
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TOL = 1e-4  # of the largest reference value
LORA = dict(method="lora", attn_delta="lora", lora_rank=2, lora_alpha=8.0,
            lora_targets=("q", "v"))


def _randomize(variables, seed):
    """Every leaf redrawn from RandomState(seed): kernels at 1 / sqrt(fan
    in), LayerNorm scales in [0.5, 1.5], the relative position tables at
    0.5 (so that the bias moves the softmax), every other leaf at 0.1."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(variables["params"], sep="/")
    new = {}
    for k, v in flat.items():
        leaf, shape = k.rsplit("/", 1)[-1], np.shape(v)
        if leaf == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(int(np.prod(shape[:-1])))
        elif leaf == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "relative_position_bias_table":
            a = 0.5 * rng.standard_normal(shape)
        else:
            a = 0.1 * rng.standard_normal(shape)
        new[k] = jnp.asarray(a, jnp.float32)
    return {"params": traverse_util.unflatten_dict(new, sep="/")}


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err:.3g} > {tol} x {scale:.3g}"


def _hold(jm, port, args_np, jax_call, port_call, seed=7):
    """The JAX module's output and VJP (parameters and the first argument)
    against the port module's forward and autograd on the same weights and
    cotangent."""
    x = jnp.asarray(args_np)
    variables = _randomize(dict(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                               *jax_call(x)))), seed)
    out_shape = jax.eval_shape(lambda: jm.apply(variables, *jax_call(x))).shape
    cot = np.random.RandomState(3).standard_normal(out_shape).astype(np.float32)

    @jax.jit
    def run(p, xx):
        out, vjp = jax.vjp(lambda p_, x_: jm.apply({"params": p_}, *jax_call(x_)), p, xx)
        return out, vjp(jnp.asarray(cot))

    out, (gp, gx) = run(variables["params"], x)
    port.load_state_dict(params_from_jax(variables), strict=True)
    xt = torch.tensor(np.asarray(args_np)).requires_grad_()
    got = port_call(port, xt)
    _close(got, out, "forward")
    got.backward(torch.tensor(cot))
    _close(xt.grad, gx, "d input")
    grads = traverse_util.flatten_dict(
        params_to_jax({k: p.grad for k, p in port.named_parameters()})["params"], sep="/")
    want = traverse_util.flatten_dict(gp, sep="/")
    assert set(grads) == set(want)
    for k in want:
        _close(grads[k], want[k], f"d {k}")


def test_window_ops_and_shift_mask():
    x = np.random.RandomState(0).standard_normal((2, 8, 8, 3)).astype(np.float32)
    for ws in (2, 4):
        got = port_swin.window_partition(torch.tensor(x), ws)
        want = np.asarray(jax_swin.window_partition(jnp.asarray(x), ws))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(port_swin.window_merge(got, ws, 8, 8).numpy(), x)
    for h, ws, shift in ((8, 4, 2), (8, 2, 1), (14, 7, 3), (56, 7, 3)):
        np.testing.assert_array_equal(port_swin._shift_attn_mask(h, h, ws, shift),
                                      jax_swin._shift_attn_mask(h, h, ws, shift))


@pytest.mark.parametrize("shifted,lora", [(False, False), (True, False), (True, True)])
def test_window_attention(shifted, lora):
    """Both kinds of block (the JAX module folds them two ways, the port one
    way) and the LoRA deltas: the output, the table's gradient through the
    fold, every other gradient."""
    dim, heads, ws, res = 16, 2, 4, 8
    nw = (res // ws) ** 2
    mask = jax_swin._shift_attn_mask(res, res, ws, ws // 2) if shifted else None
    spec = (JaxSpec(**LORA), PortSpec(**LORA)) if lora else (JaxSpec(), PortSpec())
    jm = jax_swin.WindowAttention(dim, heads, ws, spec=spec[0], use_flash=False)
    port = port_swin.WindowAttention(dim, heads, ws, spec=spec[1])
    x = np.random.RandomState(1).standard_normal((2 * nw, ws * ws, dim)).astype(np.float32)
    mt = None if mask is None else torch.tensor(mask)
    _hold(jm, port, x, lambda xx: (xx, mask), lambda m, xx: m(xx, nw, mt))
    # the kernels take a contiguous bias, also where one window covers the map
    assert port.folded_bias(mt, nw).is_contiguous() and port.folded_bias(None, 1).is_contiguous()


def test_patch_merging():
    jm = jax_swin.PatchMerging((8, 8), 16)
    port = port_swin.PatchMerging((8, 8), 16)
    x = np.random.RandomState(2).standard_normal((2, 64, 16)).astype(np.float32)
    _hold(jm, port, x, lambda xx: (xx,), lambda m, xx: m(xx))


TOWERS = {
    "cls_w4": dict(),
    "cls_w2_lora": dict(window_size=2, lora=True),
    "clip_ape_no_patch_norm": dict(output_dim=12, ape=True, patch_norm=False),
}


@pytest.mark.parametrize("case", sorted(TOWERS))
def test_swin_transformer(case):
    kw = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
              window_size=4)
    kw.update(TOWERS[case])
    lora = kw.pop("lora", False)
    jm = jax_swin.SwinTransformer(**kw, spec=JaxSpec(**LORA) if lora else JaxSpec(),
                                  use_flash=False)
    port = port_swin.SwinTransformer(**kw, spec=PortSpec(**LORA) if lora else PortSpec())
    x = np.random.RandomState(4).standard_normal((2, 32, 32, 3)).astype(np.float32)
    _hold(jm, port, x, lambda xx: (xx,), lambda m, xx: m(xx))


def test_n_last_blocks():
    kw = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
              window_size=4, ape=True)
    jm = jax_swin.SwinTransformer(**kw, use_flash=False)
    port = port_swin.SwinTransformer(**kw)
    x = np.random.RandomState(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    _hold(jm, port, x, lambda xx: (xx, True, 3), lambda m, xx: m(xx, n_last_blocks=3))


def test_uniform_fold_dbias():
    """The table's gradient through the port's one fold (batch b, nW h heads,
    the plain bias-gradient kernel summed over the windows) against the JAX
    module's two folds under jax.vjp: an unshifted block (batch b nW, h
    heads, an (h, N, N) bias) and a shifted one (batch b, nW h heads, mask +
    table)."""
    from peft_vit_tpu.ops.attention import attention_reference

    rng = np.random.RandomState(6)
    b, nw, h, n, d = 2, 4, 3, 16, 32
    q, k, v, do = (rng.standard_normal((b * nw, h, n, d)).astype(np.float32) for _ in range(4))
    table = rng.standard_normal((h, n, n)).astype(np.float32)
    mask = jax_swin._shift_attn_mask(8, 8, 4, 2)
    for shifted in (False, True):
        scale = d ** -0.5
        if shifted:
            def f(t):
                bias = (jnp.asarray(mask)[:, None] + t[None]).reshape(nw * h, n, n)
                fold = lambda a: jnp.asarray(a).reshape(b, nw * h, n, d)
                return attention_reference(fold(q), fold(k), fold(v), bias, scale)
            cot = jnp.asarray(do).reshape(b, nw * h, n, d)
        else:
            def f(t):
                return attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), t,
                                           scale)
            cot = jnp.asarray(do)
        _, vjp = jax.vjp(f, jnp.asarray(table))
        (want,) = vjp(cot)
        fold = lambda a: torch.tensor(a).reshape(b, nw * h, n, d)
        bias = torch.tensor(table)[None].expand(nw, h, n, n)
        if shifted:
            bias = bias + torch.tensor(mask)[:, None]
        bias = bias.reshape(nw * h, n, n).contiguous()
        qt, kt, vt, dot = (fold(a) for a in (q, k, v, do))
        o, lse = port_attn.flash_attention_fwd(qt, kt, vt, bias, scale, return_lse=True)
        dbias = port_attn.attention_bias_grad(qt, kt, vt, dot, lse, scale, bias, o=o)
        _close(dbias.reshape(nw, h, n, n).sum(0), want, f"dbias shifted={shifted}")


def _golden_tower(name, **kw):
    g = np.load(os.path.join(GOLDEN, name))
    sd = {k[len("sd__"):].replace("__", "."): np.asarray(v) for k, v in g.items()
          if k.startswith("sd__")}
    port = port_swin.SwinTransformer(
        image_size=32, patch_size=sd["patch_embed.proj.weight"].shape[-1],
        embed_dim=sd["patch_embed.proj.weight"].shape[0],
        depths=tuple(int(v) for v in g["depths"]), num_heads=tuple(int(v) for v in g["heads"]),
        window_size=int(g["window"]), **kw)
    port.load_state_dict(tower_state_dict(swin_state_dict_to_tree(sd)), strict=True)
    return g, sd, port.eval(), torch.tensor(g["x"]).permute(0, 2, 3, 1)


def test_refexec_swin():
    """Official Swin executed whole (refexec_swin.npz): the shifted windows
    at resolution 8 with window 4, the tables, patch merging, the final norm
    and the token mean, through the port's converter."""
    g, sd, port, x = _golden_tower("refexec_swin.npz")
    with torch.no_grad():
        feats = port(x).numpy()
    np.testing.assert_allclose(feats, g["feats"], rtol=1e-4, atol=1e-5)
    logits = feats @ sd["head.weight"].T + sd["head.bias"]
    np.testing.assert_allclose(logits, g["logits"], rtol=1e-4, atol=1e-5)


def test_refexec_ssl_swin():
    """ssl_swin.py executed (refexec_ssl_swin.npz): the absolute position
    embedding and the linear-eval features of the last n blocks."""
    g, _, port, x = _golden_tower("refexec_ssl_swin.npz", ape=True)
    np.testing.assert_allclose(port_ssl.extract_n_last_blocks(port, x, int(g["n_last"])).numpy(),
                               g["nlast"], rtol=1e-4, atol=1e-5)


def test_multi_crop_and_ssl_builder():
    """multi_crop_forward groups runs of one resolution, as the JAX helper;
    build_ssl_swin reads USE_APE, PATCH_NORM and DROP_PATH_RATE, the teacher
    without drop path."""
    from peft_vit_tpu_torch.config import get_default_config

    calls = []

    def apply_fn(x):
        calls.append(tuple(x.shape))
        return x.mean(dim=(1, 2, 3))[:, None]

    crops = [torch.full((2, s, s, 3), float(i)) for i, s in enumerate((8, 8, 4, 4, 4, 8))]
    out = port_ssl.multi_crop_forward(apply_fn, crops)
    want = jax_ssl.multi_crop_forward(lambda p, x, det: x.mean(axis=(1, 2, 3))[:, None], None,
                                      [jnp.asarray(c.numpy()) for c in crops])
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert calls == [(4, 8, 8, 3), (6, 4, 4, 3), (2, 8, 8, 3)]
    cfg = get_default_config()
    cfg.TRAIN.IMAGE_SIZE = [32, 32]
    for key, value in (("PATCH_SIZE", 4), ("EMBED_DIM", 16), ("DEPTHS", [2, 2]),
                       ("NUM_HEADS", [1, 2]),
                       ("WINDOW_SIZE", 4), ("USE_APE", True), ("PATCH_NORM", False),
                       ("DROP_PATH_RATE", 0.2)):
        cfg.MODEL.SPEC.VISION[key] = value
    student = port_ssl.build_ssl_swin(cfg, device="cpu")
    teacher = port_ssl.build_ssl_swin(cfg, is_teacher=True, device="cpu")
    assert student.ape and not student.patch_norm and student.drop_path_rate == 0.2
    assert teacher.drop_path_rate == 0.0
    assert student.stage1_block1.drop_path == pytest.approx(0.2)
    with pytest.raises(ValueError, match="Generator"):
        student.train()(torch.zeros(1, 32, 32, 3))
    gen = torch.Generator().manual_seed(0)
    assert torch.isfinite(student.train()(torch.zeros(2, 32, 32, 3), generator=gen)).all()


MASK_METHODS = ("rpb", "lora", "linear", "full", "bitfit", "layernorm", "attention")


@pytest.mark.parametrize("model_yaml", ["swin_tiny", "clip_swin_tiny"])
def test_masks_on_swin_leaves(model_yaml):
    """Each method's mask over the Swin classifier's leaves equals the JAX
    package's over the same tree (the port's names through ``jax_path``)."""
    from peft_vit_tpu.config import get_default_config as jax_config
    from peft_vit_tpu.models.factory import build_image_classifier as jax_build
    from peft_vit_tpu.peft import masks as jax_masks
    from peft_vit_tpu.peft.spec import spec_from_config as jax_spec_from
    from peft_vit_tpu_torch.config import get_default_config
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.models.convert import jax_path
    from peft_vit_tpu_torch.peft import build_mask, spec_from_config

    yaml = f"peft_vit_tpu/resources/model/{model_yaml}.yaml"
    tiny = {"TRAIN.IMAGE_SIZE": [32, 32], "MODEL.SPEC.VISION.EMBED_DIM": 16,
            "MODEL.SPEC.VISION.DEPTHS": [2, 2], "MODEL.SPEC.VISION.NUM_HEADS": [1, 2],
            "MODEL.SPEC.VISION.WINDOW_SIZE": 4, "MODEL.SPEC.EMBED_DIM": 16,
            "MODEL.SPEC.TEXT.WIDTH": 16, "MODEL.SPEC.TEXT.LAYERS": 1,
            "MODEL.SPEC.TEXT.HEADS": 2, "PEFT.LORA_RANK": 2}
    # the towers' leaves differ only with LoRA's: two builds a package
    for methods in (("lora",), tuple(m for m in MASK_METHODS if m != "lora")):
        cfgs = []
        for make in (jax_config, get_default_config):
            cfg = make()
            cfg.merge_from_file(yaml)
            cfg.merge_from_list([x for kv in tiny.items() for x in kv]
                                + ["PEFT.METHOD", methods[0]])
            cfgs.append(cfg)
        _, variables, _ = jax_build(cfgs[0], jax_spec_from(cfgs[0]), 5)
        port, _, _ = build_image_classifier(cfgs[1], spec_from_config(cfgs[1]), 5, device="cpu")
        paths = {k: jax_path(k, p.dim()) for k, p in port.named_parameters()}
        for method in methods:
            want = traverse_util.flatten_dict(
                jax_masks.build_mask(variables["params"], method), sep="/")
            got = {paths[k]: m for k, m in build_mask(port, method).items()}
            assert got == {k: bool(v) for k, v in want.items()}, method
