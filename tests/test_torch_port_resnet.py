"""The port's ResNet family (``peft_vit_tpu_torch/models/resnet.py``) against
the JAX module (``peft_vit_tpu/models/resnet.py``), and against the executed
reference's towers (``tests/golden/refexec_resnet.npz``,
``refexec_resnet_d.npz``) loaded as the port's state dicts.

Each variant (v1, v2 BiT with GroupNorm and weight-standardized convs, the
'd' stems with DyReLU and avg_down, SE on chosen stages, ResNeXt, frozen BN,
the resnetP projection without the post-residual ReLU) is built tiny (width
8, one block a stage, 40 px, so that the later stages' maps are odd and
flax's SAME average pool pads) from one weight tree.  Tolerances: fp32
forward, the train-mode BN statistics (flax's biased variance, momentum 0.9)
and the gradient of every parameter and of the input, each within 1e-4 of
the largest reference value; the goldens at the JAX tests' own rtol 1e-4,
atol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from peft_vit_tpu.models import resnet as jax_resnet
from peft_vit_tpu_torch.models import resnet as port_resnet
from peft_vit_tpu_torch.models.convert import params_from_jax, params_to_jax
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
IMAGE, BATCH = 40, 4
TOL = 1e-4  # of the largest reference value
TINY = dict(layers=(1, 1, 1, 1), width=8)
CASES = {
    "v1": dict(),
    # with the deep stem, the SAME-padded avg_down shortcut, SE on stages 2 and
    # 4, ResNeXt groups
    "v1_deep_se_resnext": dict(deep_stem=True, avg_down=True, se_ratio=0.25,
                               se_stages=(False, True, False, True), cardinality=2,
                               base_width=32),
    "v2_bit": dict(version="v2", norm="gn", weight_standardization=True),
    "d_deep_dyrelu": dict(version="d", deep_stem=True, avg_down=True, dy_relu=("spec",)),
    "d_kernel3_se": dict(version="d", stem_kernel=3, se_ratio=0.25),
    "d_kernel7": dict(version="d"),
    "frozen_bn_proj_no_relu": dict(frozen_bn=True, proj_dims=(16, 12), with_relu=False),
}


def _kw(case, package):
    kw = dict(TINY, **CASES[case])
    if "dy_relu" in kw:
        kw["dy_relu"] = package.DyReLUSpec()
    return kw


def _randomize(variables, seed):
    """Every leaf redrawn from RandomState(seed): kernels at 1 / sqrt(fan
    in), norm scales in [0.5, 1.5], biases and means at 0.1, variances in
    [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    out = {}
    for col, tree in variables.items():
        flat = traverse_util.flatten_dict(tree, sep="/")
        new = {}
        for k, v in flat.items():
            leaf, shape = k.rsplit("/", 1)[-1], np.shape(v)
            if leaf == "kernel":
                fan_in = int(np.prod(shape[:-1]))
                a = rng.standard_normal(shape) / np.sqrt(fan_in)
            elif leaf in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, shape)
            else:
                a = 0.1 * rng.standard_normal(shape)
            new[k] = jnp.asarray(a, jnp.float32)
        out[col] = traverse_util.unflatten_dict(new, sep="/")
    return out


def _close(got, want, what, tol=TOL, floor=1e-30):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err:.3g} > {tol} x {scale:.3g}"


def _images(seed, b=BATCH, size=IMAGE):
    return np.random.RandomState(seed).standard_normal((b, size, size, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """The JAX module's eval and train forwards, new statistics and
    gradients (one compiled program), and the port's module on the same
    weights."""
    case = request.param
    jm = jax_resnet.ResNet(**_kw(case, jax_resnet))
    x = _images(1)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _randomize(dict(shapes), 7)
    stats = variables.get("batch_stats", {})
    out_shape = jax.eval_shape(lambda: jm.apply(variables, jnp.asarray(x), True)).shape
    cot = np.random.RandomState(3).standard_normal(out_shape).astype(np.float32)

    @jax.jit
    def run(p, xx, c):
        res = {}
        for train in (False, True):
            def f(p_, x_):
                v = {"params": p_, **({"batch_stats": stats} if stats else {})}
                if train and stats:
                    return jm.apply(v, x_, False, mutable=["batch_stats"])
                return jm.apply(v, x_, not train), {}

            out, vjp, new = jax.vjp(f, p, xx, has_aux=True)
            res[train] = (out, new, vjp(c))
        return res

    want = jax.tree_util.tree_map(np.asarray, run(variables["params"], jnp.asarray(x),
                                                  jnp.asarray(cot)))
    pm = port_resnet.ResNet(**_kw(case, port_resnet), device="cpu")
    pm.load_state_dict(params_from_jax(variables), strict=True)
    return case, pm, x, cot, want


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_matches_jax(pair, train):
    """The forward, in train mode the new BN statistics, and every gradient."""
    case, pm, x, cot, want = pair
    out, new, (g_p, g_x) = want[train]
    buffers = {k: v.clone() for k, v in pm.named_buffers()}
    xt = torch.from_numpy(x).requires_grad_()
    pm.zero_grad(set_to_none=True)
    pm.train(train)
    got = torch.func.functional_call(pm, buffers, (xt,))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, out, f"{case} forward")
    _close(xt.grad, g_x, f"{case} input gradient")
    grads = params_from_jax({"params": g_p})
    # a bias just before a train-mode BN (the 'd' block's bn_down, under bn3)
    # has an analytically zero gradient that both compute as rounding noise:
    # a leaf's scale is at least 1e-2 of the largest gradient of any leaf
    floor = 1e-2 * max(float(g.abs().max()) for g in grads.values())
    for name, p in pm.named_parameters():
        _close(torch.zeros_like(p) if p.grad is None else p.grad, grads[name].numpy(),
               f"{case} {name} gradient", floor=floor)
    if train and buffers:
        want_stats = params_from_jax({"batch_stats": new["batch_stats"]})
        assert set(want_stats) == set(buffers)
        for name, t in buffers.items():
            _close(t, want_stats[name].numpy(), f"{case} {name}")
    else:
        for name, t in buffers.items():  # eval reads the statistics, writes none
            assert torch.equal(t, dict(pm.named_buffers())[name]), name


def test_round_trip_names():
    """``params_to_jax`` inverts ``params_from_jax`` on a BN tower: the flax
    ``batch_stats`` ``mean`` / ``var`` and FrozenBatchNorm's ``mean`` /
    ``var`` parameters."""
    for case in ("v1", "frozen_bn_proj_no_relu"):
        jm = jax_resnet.ResNet(**_kw(case, jax_resnet))
        variables = _randomize(dict(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 32, 32, 3)))), 0)
        back = params_to_jax(params_from_jax(variables))
        flat = lambda t: traverse_util.flatten_dict(t, sep="/")  # noqa: E731
        assert set(back) == set(variables)
        for col in variables:
            assert set(flat(back[col])) == set(flat(variables[col])), col


def _sd(g, prefix="sd__"):
    return {k[len(prefix):].replace("__", "."): np.asarray(v)
            for k, v in g.items() if k.startswith(prefix)}


def _reference_to_port(sd):
    """The executed reference's cls_resnet / cls_resnetD state dict in the
    port's names: ``layer<s>.<i>`` -> ``layer<s>_block<i>``, the avg_down
    Sequential's conv and BN -> ``downsample`` / ``bn_down``, SE's and
    DyReLU's ``fc.0`` / ``fc.2`` -> ``fc1`` / ``fc2``, the running
    statistics -> ``bn_mean`` / ``bn_var``; ``fc`` (the head) left out."""
    out = {}
    for k, v in sd.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        k = k.replace("running_mean", "bn_mean").replace("running_var", "bn_var")
        k = k.replace(".fc.0.", ".fc1.").replace(".fc.2.", ".fc2.")
        k = k.replace(".downsample.1.", ".downsample.").replace(".downsample.2.", ".bn_down.")
        for s in (1, 2, 3, 4):
            k = k.replace(f"layer{s}.0.", f"layer{s}_block0.")
        out[k] = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    return out


def test_refexec_resnet():
    """cls_resnet.py executed: post-act bottlenecks, SE on stage 2, the
    avg_down shortcut, width 16."""
    g = np.load(os.path.join(GOLDEN, "refexec_resnet.npz"))
    sd = _sd(g)
    pm = port_resnet.ResNet(layers=(1, 1), width=16, se_ratio=1.0 / 16.0,
                            se_stages=(False, True), avg_down=True, device="cpu")
    pm.load_state_dict(_reference_to_port(sd), strict=True)
    with torch.no_grad():
        feats = pm.eval()(torch.from_numpy(g["x"].transpose(0, 2, 3, 1).copy())).numpy()
    np.testing.assert_allclose(feats @ sd["fc.weight"].T + sd["fc.bias"], g["logits"],
                               rtol=1e-4, atol=1e-5)


def test_refexec_resnet_d():
    """cls_resnetD.py executed: the deep stem without maxpool, PreActBottleneck
    (bn3 after the add), DyReLU at every activation with the final one, SE on
    stage 2, avg_down."""
    g = np.load(os.path.join(GOLDEN, "refexec_resnet_d.npz"))
    sd = {}
    for k, v in _sd(g).items():
        for i in (1, 2, 3):  # the stem's names
            if k.startswith((f"conv{i}.", f"bn{i}.")):
                k = "stem_" + k
        if k.startswith(("act1.", "act2.")):
            k = "stem_" + k
        k = k.replace("final.0.", "final_act.")
        sd[k] = v
    pm = port_resnet.ResNet(layers=(1, 1), width=64, version="d", deep_stem=True, avg_down=True,
                            se_ratio=1.0 / 16.0, se_stages=(False, True),
                            dy_relu=port_resnet.DyReLUSpec(), device="cpu")
    pm.load_state_dict(_reference_to_port(sd), strict=True)
    with torch.no_grad():
        feats = pm.eval()(torch.from_numpy(g["x"].transpose(0, 2, 3, 1).copy())).numpy()
    np.testing.assert_allclose(feats @ sd["fc.weight"].T + sd["fc.bias"], g["logits"],
                               rtol=1e-4, atol=1e-5)


def test_avg_pool_same_matches_flax():
    """flax's SAME average pool on odd maps, with and without the padded
    zeros counted (the v1 and 'd' shortcuts), exactly in fp32 up to the
    division's rounding."""
    import flax.linen as fnn

    x = _images(5, b=2, size=7)
    for count in (True, False):
        want = fnn.avg_pool(jnp.asarray(x), (2, 2), strides=(2, 2), padding="SAME",
                            count_include_pad=count)
        got = port_resnet.avg_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 2, count)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)


def test_constructors():
    """The named constructors build the JAX module's geometry: the same
    parameter names and shapes (at width 8; the ResNeXts at 16, where their
    32 groups divide the channels)."""
    for name in ("resnet50", "resnet101", "resnext50_32x4d", "bit_resnet50",
                 "se_resnext50_32x4d"):
        kw = dict(width=16 if "resnext" in name else 8)
        jm = getattr(jax_resnet, name)(**kw)
        pm = getattr(port_resnet, name)(**kw, device="cpu")
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
        want = {k: tuple(v.shape) for k, v in params_from_jax(_randomize(dict(shapes), 0)).items()}
        got = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
        assert got == want, name


YAMLS = ("resnet50", "resnet101", "r50_s3", "rn50_CLIP", "rn101_CLIP", "rn50x4_CLIP",
         "rn50x16_CLIP")
# configs no yaml ships: a resnetD with DYReLU (cls_resnetD.py's deep stem and
# avg_down) and the BiT name
EXTRA = {
    "cls_resnetd_dyrelu": {"MODEL.NAME": "cls_resnetd50", "MODEL.SPEC.VISION.MODEL": "resnet",
                           "MODEL.SPEC.VISION.DEEP_STEM": True, "MODEL.SPEC.VISION.AVG_DOWN": True,
                           "MODEL.SPEC.VISION.DY_RELU": {"ENABLE": True, "REDUCTION": 4}},
    "bit_resnet50": {"MODEL.NAME": "bit_resnet50", "MODEL.SPEC.VISION.MODEL": "resnet"},
}


def _set(cfg, over):
    for key, value in over.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


@pytest.mark.parametrize("name", YAMLS + tuple(EXTRA))
def test_configs_build_and_run_through_the_port(name):
    """Every shipped ResNet-family config (the CLIP RN towers at their
    widths, depth cut to one block a stage, 64 px; the text tower built on
    first use) through ``build_image_classifier``: finite logits in eval and
    train mode, the train-mode forward moving the BN statistics; the CLIP
    towers with a text tower; the Swin family still refused."""
    from peft_vit_tpu_torch.config import get_default_config
    from peft_vit_tpu_torch.models import factory
    from peft_vit_tpu_torch.models.clip_resnet import ModifiedResNet
    from peft_vit_tpu_torch.peft import spec_from_config

    cfg = get_default_config()
    if name in YAMLS:
        cfg.merge_from_file(os.path.join(os.path.dirname(GOLDEN), "..", "peft_vit_tpu",
                                         "resources", "model", f"{name}.yaml"))
    _set(cfg, EXTRA.get(name, {}))
    clip = factory.is_clip_model(cfg)
    v = cfg.MODEL.SPEC.VISION
    v["LAYERS" if clip else "LAYERS_PER_STAGE"] = [1, 1, 1, 1]
    cfg.TRAIN.IMAGE_SIZE = [64, 64]
    model, params, enc = factory.build_image_classifier(cfg, spec_from_config(cfg), 5,
                                                        device="cpu")
    assert isinstance(model.backbone, ModifiedResNet if clip else port_resnet.ResNet)
    assert (enc is not None) == clip
    x = torch.from_numpy(_images(9, b=2, size=64))
    with torch.no_grad():
        assert torch.isfinite(model.eval()(x)).all()
        before = {k: t.clone() for k, t in model.named_buffers()}
        assert model.train()(x).shape == (2, 5)
    assert any(not torch.equal(t, before[k]) for k, t in model.named_buffers())
    if name == "cls_resnetd_dyrelu":
        assert model.backbone.version == "d" and hasattr(model.backbone, "stem_act1")


def test_fullshot_commands_train_a_resnet(monkeypatch, tmp_path):
    """``train`` (DropBlock on stages 3 and 4 in the step), ``swa_finetune``
    (the SWA average's BN statistics refreshed by ``update_bn`` on the CNN)
    and ``bit_finetune`` (the HyperRule, its 500 steps cut to 16) on
    r50_s3.yaml's ResNet cut to one block a stage, width 8, 32 px: each runs
    to its end on the CPU with a finite top-1."""
    from peft_vit_tpu_torch.commands import bit_finetune, swa_finetune, train

    yaml = os.path.join(os.path.dirname(GOLDEN), "..", "peft_vit_tpu", "resources", "model",
                        "r50_s3.yaml")
    tiny = ["DATASET.DATASET", "synthetic", "DATASET.NUM_CLASSES", "4", "MODEL.NUM_CLASSES", "4",
            "TRAIN.IMAGE_SIZE", "[32, 32]", "MODEL.SPEC.VISION.LAYERS_PER_STAGE", "[1, 1, 1, 1]",
            "MODEL.SPEC.VISION.STEM_WIDTH", "8", "TRAIN.BATCH_SIZE_PER_GPU", "8",
            "TEST.BATCH_SIZE_PER_GPU", "16", "TRAIN.END_EPOCH", "2", "TRAIN.LR", "0.01",
            "AUG.DROPBLOCK_KEEP_PROB", "0.9", "AUG.DROPBLOCK_BLOCK_SIZE", "3"]
    score = train.main(["--cfg", yaml, *tiny, "OUTPUT_DIR", str(tmp_path / "train")],
                       device="cpu")
    assert 0.0 <= score <= 100.0
    swa = swa_finetune.main(["--cfg", yaml, *tiny, "SWA.BEGIN_EPOCH", "1", "SWA.ANNEAL_EPOCHS",
                             "1", "OUTPUT_DIR", str(tmp_path / "swa")], device="cpu")
    assert 0.0 <= swa <= 100.0
    monkeypatch.setattr(bit_finetune, "bit_hyperrule", lambda n: (16, (8, 12, 14)))
    from peft_vit_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list([*tiny, "OUTPUT_DIR", str(tmp_path / "bit")])
    bit = bit_finetune.bit_main(cfg, device="cpu")
    spe = 16 // int(cfg.TRAIN.END_EPOCH)  # the HyperRule's 16 steps over whole epochs
    assert 0.0 <= bit <= 100.0 and cfg.TRAIN.LR_SCHEDULER.METHOD == "step"
    assert list(cfg.TRAIN.SCHEDULE) == [b // spe for b in (8, 12, 14)]
