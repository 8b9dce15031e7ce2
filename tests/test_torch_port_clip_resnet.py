"""CLIP's ModifiedResNet tower through the port (``models/clip_resnet.py``,
the RN loaders of ``models/convert.py``, the factory's RN branch and the
registry) against the JAX package, and ``zeroshot_main`` and the logistic
probe on the RN tower through both packages on the same weights (the
few-shot driver's drives are in ``test_torch_port_rn_drivers.py``).

Tolerances: the tower and its pool, fp32, forward and every gradient within
1e-4 of the largest reference value (train mode: the new BN statistics too);
the goldens at the JAX tests' own bounds (``refexec_clip_rn.npz`` rtol 2e-4,
atol 1e-4; ``clip_rn_tower.npz`` rtol 2e-4, atol 1e-3); the commands' scores
within 1e-4 and the same C.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import peft_vit_tpu.commands.linear_probe as jax_lp
import peft_vit_tpu.commands.run as jax_run
import peft_vit_tpu.commands.zeroshot_eval as jax_zs
import peft_vit_tpu_torch.commands.linear_probe as port_lp
import peft_vit_tpu_torch.commands.zeroshot_eval as port_zs
from peft_vit_tpu import config as jax_config
from peft_vit_tpu.models import clip_resnet as jax_clip_resnet
from peft_vit_tpu.models import convert as jax_convert
from peft_vit_tpu.models import factory as jax_factory
from peft_vit_tpu.models import registry as jax_registry
from peft_vit_tpu.peft import build_mask as jax_build_mask
from peft_vit_tpu.peft import spec as jax_spec
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.models import clip_resnet as port_clip_resnet
from peft_vit_tpu_torch.models import convert as port_convert
from peft_vit_tpu_torch.models import factory as port_factory
from peft_vit_tpu_torch.models import registry as port_registry
from peft_vit_tpu_torch.models.convert import load_jax_variables, params_from_jax
from peft_vit_tpu_torch.peft import build_mask as port_build_mask
from peft_vit_tpu_torch.peft import spec as port_spec
from test_torch_port_driver import jax_text_variables, tiny_cfg
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)
from test_torch_port_resnet import _close, _images, _randomize
from test_torch_port_zeroshot import _synthetic_prompts  # noqa: F401 (an autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# the JAX test's rn_tiny_cfg (tests/test_clip_resnet.py:84-97), as overrides of tiny_cfg
RN_TINY = {"TRAIN.IMAGE_SIZE": [32, 32], "MODEL.NAME": "RN50", "MODEL.SPEC.EMBED_DIM": 16,
           "MODEL.SPEC.VISION.MODEL": "resnet", "MODEL.SPEC.VISION.WIDTH": 8,
           "MODEL.SPEC.VISION.LAYERS": [1, 1, 1, 1], "MODEL.SPEC.VISION.HEADS": 4,
           "MODEL.SPEC.TEXT.WIDTH": 16, "MODEL.SPEC.TEXT.HEADS": 2,
           "MODEL.SPEC.TEXT.LAYERS": 1}


@pytest.fixture(scope="module")
def tower():
    """The JAX tower's eval and train forwards, new statistics and gradients
    (one program) at width 8, 64 px (a 2 x 2 grid: the pool reads 5
    tokens), and the port's tower on the same weights."""
    kw = dict(layers=(1, 1, 1, 1), output_dim=16, heads=4, image_size=64, width=8)
    jm = jax_clip_resnet.ModifiedResNet(**kw)
    x = _images(2, b=4, size=64)
    variables = _randomize(dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                               jnp.asarray(x))), 11)
    cot = np.random.RandomState(3).standard_normal((4, 16)).astype(np.float32)
    stats = variables["batch_stats"]

    @jax.jit
    def run(p, xx, c):
        res = {}
        for train in (False, True):
            def f(p_, x_):
                v = {"params": p_, "batch_stats": stats}
                if train:
                    return jm.apply(v, x_, False, mutable=["batch_stats"])
                return jm.apply(v, x_, True), {}

            out, vjp, new = jax.vjp(f, p, xx, has_aux=True)
            res[train] = (out, new, vjp(c))
        return res

    want = jax.tree_util.tree_map(np.asarray, run(variables["params"], jnp.asarray(x),
                                                  jnp.asarray(cot)))
    pm = port_clip_resnet.ModifiedResNet(**kw, device="cpu")
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return pm, x, cot, want, variables


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_modified_resnet_matches_jax(tower, train):
    pm, x, cot, want, _ = tower
    out, new, (g_p, g_x) = want[train]
    buffers = {k: v.clone() for k, v in pm.named_buffers()}
    xt = torch.from_numpy(x).requires_grad_()
    pm.zero_grad(set_to_none=True)
    pm.train(train)
    got = torch.func.functional_call(pm, buffers, (xt,))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, out, "forward")
    _close(xt.grad, g_x, "input gradient")
    grads = params_from_jax({"params": g_p})
    floor = 1e-2 * max(float(g.abs().max()) for g in grads.values())  # as in the ResNet test
    for name, p in pm.named_parameters():
        _close(p.grad, grads[name].numpy(), f"{name} gradient", floor=floor)
    if train:
        stats = params_from_jax({"batch_stats": new["batch_stats"]})
        for name, t in buffers.items():
            _close(t, stats[name].numpy(), name)


def test_attention_pool_matches_jax(tower):
    """The pool alone on a (B, 2, 2, C) grid: the mean token's query row,
    fp32 scores, the plain softmax."""
    pm, *_, variables = tower
    rng = np.random.RandomState(4)
    grid = rng.standard_normal((3, 2, 2, 256)).astype(np.float32)
    jpool = jax_clip_resnet.AttentionPool2d(embed_dim=256, num_heads=4, output_dim=16)
    p = {"params": variables["params"]["attnpool"]}
    want = jpool.apply(p, jnp.asarray(grid))
    got = pm.attnpool(torch.from_numpy(grid).permute(0, 3, 1, 2))
    _close(got, want, "pool")


def _strip(state, prefix="backbone."):
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


@pytest.mark.parametrize("golden,rtol,atol", [("refexec_clip_rn", 2e-4, 1e-4),
                                              ("clip_rn_tower", 2e-4, 1e-3)])
def test_goldens_through_the_port_loader(golden, rtol, atol):
    """The OpenAI-format state dicts through ``clip_rn_state_dict_to_tree``
    and ``clip_rn_visual_state_dict``: every leaf loaded (strict), the eval
    forward at the JAX tests' bounds; the shape inference as the JAX one's."""
    g = np.load(os.path.join(GOLDEN, f"{golden}.npz"))
    if golden == "refexec_clip_rn":
        sd = {k[len("sd__"):].replace("__", "."): g[k] for k in g.files if k.startswith("sd__")}
    else:
        sd = {k.replace("__", "."): g[k] for k in g.files if k.startswith("visual")}
    assert port_convert.is_clip_rn_state_dict(sd)
    info = port_convert.infer_clip_rn_shape(sd)
    assert info == jax_convert.infer_clip_rn_shape(sd)
    flat, stats = port_convert.clip_rn_state_dict_to_tree(sd)
    jflat, jstats = jax_convert.clip_rn_state_dict_to_tree(sd)
    assert set(flat) == set(jflat) and set(stats) == set(jstats)
    m = port_clip_resnet.ModifiedResNet(layers=info["vision_layers"],
                                        output_dim=info["embed_dim"],
                                        image_size=info["image_size"],
                                        width=info["vision_width"], device="cpu")
    m.load_state_dict(_strip(port_convert.clip_rn_visual_state_dict(flat, stats)), strict=True)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(g["x"].transpose(0, 2, 3, 1).copy())).numpy()
    np.testing.assert_allclose(out, g["out"], rtol=rtol, atol=atol)


_JAX_BUILDS = {}


@contextlib.contextmanager
def _jit_init():
    """Within, flax's ``Module.init`` is compiled once per call instead of
    run op by op (the JAX builder's init of the RN tower takes ~33 s eagerly
    on one core, ~10 s compiled): the same function of the same key.  Only
    around a build: a compile per call would cost a sweep's cells more."""
    import flax.linen as fnn

    eager = fnn.Module.init

    def init(self, rngs, *args, **kwargs):
        if kwargs:
            return eager(self, rngs, *args, **kwargs)
        return jax.jit(lambda r, *a: eager(self, r, *a))(rngs, *args)

    fnn.Module.init = init
    try:
        yield
    finally:
        fnn.Module.init = eager


@pytest.fixture
def jax_build_once(monkeypatch):
    """The JAX builder's RN build (its init compiled, ``_jit_init``), made
    once per (num_classes, use_bn) for this module's drives: the tiny RN
    config's build does not depend on the PEFT method (the RN tower has no
    PEFT hooks) and draws from PRNGKey(0) every time."""
    real = jax_factory.build_image_classifier

    def build(cfg, spec, num_classes, rng=None, use_bn=False):
        key = (int(num_classes), bool(use_bn))
        if key not in _JAX_BUILDS:
            with _jit_init():
                _JAX_BUILDS[key] = real(cfg, spec, num_classes, rng, use_bn)
        return _JAX_BUILDS[key]

    for module in (jax_run, jax_zs, jax_lp):
        monkeypatch.setattr(module, "build_image_classifier", build)


def _built(pkg_factory, pkg_config, pkg_spec, **kw):
    cfg = tiny_cfg(pkg_config, **RN_TINY)
    return cfg, pkg_factory.build_image_classifier(cfg, pkg_spec.spec_from_config(cfg), 4, **kw)


def test_factory_builds_the_rn_tower_as_jax_does(jax_build_once):
    """rn_tiny_cfg through both builders: the same parameter tree, the text
    tower, the JAX weights loaded into the port give its logits (eval) and
    its train-mode statistics; ``backbone_eval_variables`` carries the
    statistics; bitfit selects the same leaves."""
    assert port_factory.is_clip_rn_cfg(tiny_cfg(port_config, **RN_TINY))
    _, (jm, variables, jenc) = _built(jax_run, jax_config, jax_spec)
    _, (pm, params, penc) = _built(port_factory, port_config, port_spec, device="cpu")
    assert jenc is not None and penc is not None
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    load_jax_variables(pm, variables)
    assert set(params) == {k for k, _ in pm.named_parameters()}
    x = _images(6, b=4, size=32)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        _close(pm.eval()(torch.from_numpy(x)), want, "eval logits")
    _, mut = jax.jit(lambda v, xx: jm.apply(v, xx, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    buffers = {k: v.clone() for k, v in pm.named_buffers()}
    with torch.no_grad():
        torch.func.functional_call(pm.train(), buffers, (torch.from_numpy(x),))
    stats = params_from_jax({"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                    mut["batch_stats"])})
    assert set(stats) == set(buffers)
    for k, t in buffers.items():
        _close(t, stats[k].numpy(), k)
    ev = port_factory.backbone_eval_variables(pm)
    assert any(k.endswith("bn_mean") for k in ev)
    assert set(jax_factory.backbone_eval_variables(variables)) == {"params", "batch_stats"}
    jmask = traverse_util.flatten_dict(jax_build_mask(variables["params"], "bitfit",
                                                      num_layers=4), sep="/")
    pmask = port_build_mask(pm, "bitfit", num_layers=4)
    assert sorted(port_convert.jax_path(k, dict(pm.named_parameters())[k].dim())
                  for k, v in pmask.items() if v) == sorted(k for k, v in jmask.items() if v)


def test_factory_loads_an_rn_checkpoint(tmp_path):
    """``MODEL.PRETRAINED`` naming an RN checkpoint (the clip_rn_tower
    golden's visual-only state dict): the architecture from the checkpoint,
    every tower leaf loaded, the statistics too, no text tower."""
    g = np.load(os.path.join(GOLDEN, "clip_rn_tower.npz"))
    sd = {k.replace("__", "."): torch.from_numpy(np.array(g[k]))
          for k in g.files if k.startswith("visual")}
    path = tmp_path / "rn.pt"
    torch.save(sd, path)
    cfg = tiny_cfg(port_config, **{**RN_TINY, "MODEL.PRETRAINED": str(path)})
    model, _, enc = port_factory.build_image_classifier(cfg, port_spec.spec_from_config(cfg),
                                                        5, device="cpu")
    assert enc is None
    with torch.no_grad():
        out = model.backbone.eval()(torch.from_numpy(g["x"].transpose(0, 2, 3, 1).copy()))
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=2e-4, atol=1e-3)


def _capture(monkeypatch, module):
    built = {}
    real = module.build_image_classifier

    def build(*a, **kw):
        built["out"] = real(*a, **kw)
        return built["out"]

    monkeypatch.setattr(module, "build_image_classifier", build)
    return built


def test_zeroshot_and_logistic_probe_on_the_rn_tower_match_jax(jax_build_once, monkeypatch,
                                                              tmp_path):
    """``zeroshot_main`` (the text tower beside the RN tower, eval-mode BN)
    and ``logistic_main`` (RN features): the same scores, the same C."""
    over = {**RN_TINY, "TEST.BATCH_SIZE_PER_GPU": 128, "TRAIN.SEARCH_WD_LOG_LOWER": -3,
            "TRAIN.SEARCH_WD_LOG_UPPER": 3}
    built = _capture(monkeypatch, jax_zs)
    want = jax_zs.zeroshot_main(tiny_cfg(jax_config, **over))
    variables = jax.tree_util.tree_map(np.asarray, dict(built["out"][1]))
    text = jax_text_variables(built["out"][2], {"PEFT.METHOD": "finetune_contrast"})
    got = port_zs.zeroshot_main(tiny_cfg(port_config, **over), device="cpu",
                                variables=variables, text_variables=text)
    assert got == pytest.approx(want, abs=1e-4)

    built = _capture(monkeypatch, jax_lp)
    sweeps = {}
    for name, module in (("jax", jax_lp), ("port", port_lp)):
        real = module.logistic_probe_sweep
        monkeypatch.setattr(module, "logistic_probe_sweep", lambda *a, _n=name, _r=real, **kw:
                            sweeps.setdefault(_n, _r(*a, **kw)))
    want = jax_lp.logistic_main(tiny_cfg(jax_config, **over), str(tmp_path / "jax"))
    variables = jax.tree_util.tree_map(np.asarray, dict(built["out"][1]))
    got = port_lp.logistic_main(tiny_cfg(port_config, **over), str(tmp_path / "port"),
                                device="cpu", variables=variables)
    assert got == pytest.approx(want, abs=1e-9)
    assert sweeps["port"][1] == sweeps["jax"][1]


@pytest.fixture
def registered():
    names = ("tiny_custom_rn",)
    yield names
    for n in names:
        port_registry._BUILDERS.pop(n, None)
        jax_registry._BUILDERS.pop(n, None)


def test_registry_in_both_packages(registered):
    """A builder registered by name owns the build in both packages, a
    ``module:function`` path resolves without registration, and an
    unregistered name falls through to the built-in families."""
    calls = []

    @port_registry.register_model("tiny_custom_rn")
    def port_builder(cfg, spec, num_classes, device, seed):
        calls.append(("port", num_classes, str(device), seed))
        model = torch.nn.Linear(3, num_classes)
        return model, dict(model.named_parameters()), None

    @jax_registry.register_model("tiny_custom_rn")
    def jax_builder(cfg, spec, num_classes, rng):
        calls.append(("jax", num_classes))
        return "model", {"params": {}}, None

    for pkg_factory, pkg_config, pkg_spec, kw in (
            (port_factory, port_config, port_spec, dict(device="cpu", seed=3)),
            (jax_factory, jax_config, jax_spec, {})):
        cfg = tiny_cfg(pkg_config, **{"MODEL.NAME": "tiny_custom_rn"})
        out = pkg_factory.build_image_classifier(cfg, pkg_spec.spec_from_config(cfg), 7, **kw)
        assert out[2] is None
    assert calls == [("port", 7, "cpu", 3), ("jax", 7)]
    path = "peft_vit_tpu_torch.models.resnet:resnet50"
    assert port_registry.get_custom_builder(path).__name__ == "resnet50"
    assert jax_registry.get_custom_builder("peft_vit_tpu.models.resnet:resnet50").__name__ == \
        "resnet50"
    port_registry._BUILDERS.pop("tiny_custom_rn")
    jax_registry._BUILDERS.pop("tiny_custom_rn")
    assert port_registry.get_custom_builder("tiny_custom_rn") is None
    assert jax_registry.get_custom_builder("tiny_custom_rn") is None
