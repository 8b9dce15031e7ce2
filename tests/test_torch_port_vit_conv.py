"""The port's ConvViT / CSwin tower (``peft_vit_tpu_torch/models/vit_conv.py``)
against the JAX module (``peft_vit_tpu/models/vit_conv.py``), and against the
executed reference's towers (``tests/golden/refexec_vit_conv.npz``,
``refexec_vit_cswin.npz``) loaded through the port's converter.

Tiny towers (32 px, patch 8, width 16, 2 blocks of 2 heads) from one weight
tree redrawn from a numpy seed: the conv mixer with ``res_score`` and
``ADD_CLS``; LePE with ``ref_qkv_scramble`` and ``res_score`` (the CSwin
config); no class token with ``norm_embed`` and a mixer of ratio 2.
Tolerances: the fp32 forward in eval and train mode, the train-mode BN
statistics (flax's momentum 0.9) and the gradient of every parameter and of
the input, each within 1e-4 of the largest reference value; the goldens at
the JAX tests' own rtol 1e-4, atol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from peft_vit_tpu.models import vit_conv as jax_vc
from peft_vit_tpu_torch.models import vit_conv as port_vc
from peft_vit_tpu_torch.models.convert import (convvit_state_dict_to_tree, params_from_jax,
                                               params_to_jax, tower_state_dict)
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TOL = 1e-4  # of the largest reference value
TINY = dict(image_size=32, patch_size=8, width=16, layers=2, heads=2)
CASES = {
    "conv_res_score_add_cls": dict(has_conv=True, res_score=True, add_cls=True),
    "cswin_lepe_scramble": dict(lepe=True, ref_qkv_scramble=True, res_score=True),
    "no_cls_norm_embed_ratio2": dict(use_cls_token=False, norm_embed=True, has_conv=True,
                                     conv_ratio=2.0),
}


def _randomize(variables, seed):
    """Every leaf redrawn from RandomState(seed): kernels at 1 / sqrt(fan
    in), norm scales and BN variances in [0.5, 1.5], every other leaf (BN
    means included) at 0.1."""
    rng = np.random.RandomState(seed)
    out = {}
    for col, tree in variables.items():
        new = {}
        for k, v in traverse_util.flatten_dict(tree, sep="/").items():
            leaf, shape = k.rsplit("/", 1)[-1], np.shape(v)
            if leaf == "kernel":
                a = rng.standard_normal(shape) / np.sqrt(int(np.prod(shape[:-1])))
            elif leaf in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, shape)
            else:
                a = 0.1 * rng.standard_normal(shape)
            new[k] = jnp.asarray(a, jnp.float32)
        out[col] = traverse_util.unflatten_dict(new, sep="/")
    return out


def _close(got, want, what, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_convvit_against_jax(case):
    """Eval forward; train-mode forward, its new BN statistics and the
    gradient of every parameter and of the input."""
    kw = dict(TINY, **CASES[case])
    jm = jax_vc.ConvViT(**kw)
    port = port_vc.ConvViT(**kw)
    x = np.random.RandomState(1).standard_normal((4, 32, 32, 3)).astype(np.float32)
    variables = _randomize(dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                               jnp.asarray(x))), 7)
    stats = variables.get("batch_stats", {})
    cot = np.random.RandomState(3).standard_normal((4, 16)).astype(np.float32)

    @jax.jit
    def run(p, xx):
        def f(p_, x_):
            v = {"params": p_, **({"batch_stats": stats} if stats else {})}
            if stats:
                return jm.apply(v, x_, False, mutable=["batch_stats"])
            return jm.apply(v, x_, False), {}

        out, vjp, new = jax.vjp(f, p, xx, has_aux=True)
        return jm.apply({"params": p, **({"batch_stats": stats} if stats else {})}, xx, True), \
            out, new, vjp(jnp.asarray(cot))

    eval_out, out, new, (gp, gx) = run(variables["params"], jnp.asarray(x))
    port.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        _close(port.eval()(torch.tensor(x)), eval_out, "eval forward")
    xt = torch.tensor(x).requires_grad_()
    got = port.train()(xt)
    _close(got, out, "train forward")
    got.backward(torch.tensor(cot))
    _close(xt.grad, gx, "d input")
    want_stats = traverse_util.flatten_dict(new.get("batch_stats", {}), sep="/")
    for k, v in want_stats.items():
        *mods, leaf = k.split("/")
        buf = dict(port.named_buffers())[".".join(
            ("blocks." + m[len("blocks_"):] if m.startswith("blocks_") else m) for m in mods)
            + f".bn_{leaf}"]
        _close(buf, v, f"new {k}")
    assert len(want_stats) == (4 if CASES[case].get("has_conv") else 0)
    grads = traverse_util.flatten_dict(
        params_to_jax({k: p.grad for k, p in port.named_parameters()})["params"], sep="/")
    want = traverse_util.flatten_dict(gp, sep="/")
    assert set(grads) == set(want)
    for k in want:
        _close(grads[k], want[k], f"d {k}")


def _golden(name, **kw):
    g = np.load(os.path.join(GOLDEN, name))
    sd = {k[len("sd__"):].replace("__", "."): np.asarray(v) for k, v in g.items()
          if k.startswith("sd__")}
    use_cls = bool(int(g["use_cls"])) if "use_cls" in g.files else True
    patch = sd["patch_embed.proj.weight"].shape[-1]
    n_tok = sd["pos_embed"].shape[1] - (1 if use_cls else 0)
    port = port_vc.ConvViT(
        image_size=patch * int(np.sqrt(n_tok)), patch_size=patch,
        width=sd["pos_embed"].shape[-1],
        layers=len({k.split(".")[1] for k in sd if k.startswith("blocks.")}),
        heads=int(g["heads"]), use_cls_token=use_cls, **kw)
    flat, stats = convvit_state_dict_to_tree(sd)
    port.load_state_dict(tower_state_dict(flat, stats), strict=True)
    with torch.no_grad():
        feats = port.eval()(torch.tensor(g["x"]).permute(0, 2, 3, 1)).numpy()
    np.testing.assert_allclose(feats, g["feats"], rtol=1e-4, atol=1e-5)
    logits = feats @ sd["head.weight"].T + sd["head.bias"]
    np.testing.assert_allclose(logits, g["logits"], rtol=1e-4, atol=1e-5)


def test_refexec_vit_conv():
    """cls_vit_conv.py executed: attention, MLP and the conv mixer with
    ADD_CLS, the BN running statistics through the converter."""
    _golden("refexec_vit_conv.npz", has_conv=True, add_cls=True, conv_ratio=1.0)


def test_refexec_vit_cswin():
    """cls_vit_cswin.py executed: LePE's get_v on the executed reference's
    scrambled q, k, v."""
    _golden("refexec_vit_cswin.npz", lepe=True, ref_qkv_scramble=True)


def test_factory_builds_convvit():
    """The port's factory reads what the JAX one reads for cls_vit_conv and
    cls_vit_cswin: the same leaves, a cswin name turns on LePE and off the
    mixer, and each method's mask selects the same leaves."""
    from peft_vit_tpu.config import get_default_config as jax_config
    from peft_vit_tpu.models.factory import build_image_classifier as jax_build
    from peft_vit_tpu.peft import build_mask as jax_build_mask
    from peft_vit_tpu.peft.spec import spec_from_config as jax_spec_from
    from peft_vit_tpu_torch.config import get_default_config
    from peft_vit_tpu_torch.models import build_image_classifier
    from peft_vit_tpu_torch.models.convert import jax_path
    from peft_vit_tpu_torch.peft import build_mask, spec_from_config

    over = ["TRAIN.IMAGE_SIZE", [32, 32], "MODEL.SPEC.VISION.PATCH_SIZE", 8,
            "MODEL.SPEC.VISION.WIDTH", 16, "MODEL.SPEC.VISION.LAYERS", 2,
            "MODEL.SPEC.VISION.HEADS", 2]
    for name, extra in (("cls_vit_conv", ["MODEL.SPEC.VISION.RES_SCORE", True,
                                          "MODEL.SPEC.VISION.ADD_CLS", True]),
                        ("cls_vit_cswin", [])):
        cfgs = []
        for make in (jax_config, get_default_config):
            cfg = make()
            cfg.merge_from_list(["MODEL.NAME", name, *over, *extra])
            cfgs.append(cfg)
        _, variables, _ = jax_build(cfgs[0], jax_spec_from(cfgs[0]), 5)
        port, _, enc = build_image_classifier(cfgs[1], spec_from_config(cfgs[1]), 5,
                                              device="cpu")
        assert enc is None and isinstance(port.backbone, port_vc.ConvViT)
        want = set(traverse_util.flatten_dict(variables["params"], sep="/"))
        assert {jax_path(k, p.dim()) for k, p in port.named_parameters()} == want, name
        stats = set(traverse_util.flatten_dict(variables.get("batch_stats", {}), sep="/"))
        got = {k for k, _ in port.named_buffers() if k.rsplit(".", 1)[-1] in ("bn_mean", "bn_var")}
        assert len(got) == len(stats), name
        assert (name == "cls_vit_cswin") == port.backbone.blocks[0].attn.lepe
        # each method's mask selects the JAX package's leaves
        paths = {k: jax_path(k, p.dim()) for k, p in port.named_parameters()}
        for method in ("rpb", "lora", "linear", "full", "bitfit", "layernorm", "attention",
                       "lepe"):
            want = traverse_util.flatten_dict(
                jax_build_mask(variables["params"], method, num_layers=2), sep="/")
            got = {paths[k]: m for k, m in build_mask(port, method, num_layers=2).items()}
            assert got == {k: bool(v) for k, v in want.items()}, (name, method)
