"""The port's export (``engine.serving.export_classifier`` / ``load_exported``,
``commands.export_model``) against the JAX package's, and every kernel
launch as a registered op of ``peft_vit_tpu_torch::``.

The tiny flagship of ``test_torch_port_model`` (width 64, 2 layers, 4 heads,
image 32, patch 16) from one numpy-drawn weight tree in both packages; fp32
on the CPU.  The artifact's logits are held to JAX's ``model.apply`` and to
JAX's own ``load_exported(export_classifier(...))`` at max |err| <= 1e-4,
the JAX test's bound (fp32 through the whole tower, sums in other orders).
The ops: each CPU implementation equals its plain version bit for bit (it
is the plain version), and each fake implementation gives the kernel's
shapes and dtypes.
"""

import io
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peft_vit_tpu.engine.serving import export_classifier as jax_export
from peft_vit_tpu.engine.serving import load_exported as jax_load
from peft_vit_tpu_torch import ops
from peft_vit_tpu_torch.config import get_default_config
from peft_vit_tpu_torch.engine.serving import export_classifier, load_exported, make_infer_fn
from peft_vit_tpu_torch.models import flagship, load_jax_variables
from peft_vit_tpu_torch.ops import attention as attn
from peft_vit_tpu_torch.ops import int8 as i8
from test_torch_port_model import TINY, _jax_flagship, randomize
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-4  # the JAX export test's bound
BATCHES = (1, 3, 7)  # one artifact, several batch sizes


def _images(n, seed):
    return np.random.RandomState(seed).standard_normal(
        (n, TINY["image"], TINY["image"], 3)).astype(np.float32)


@pytest.fixture(scope="module")
def both():
    """(JAX model, its variables, the port model with the same weights)."""
    model = _jax_flagship(use_bn=True)
    # the init compiled: op by op it takes three times as long
    variables = randomize(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(_images(1, 0))),
                          5)
    port = flagship(**TINY, dtype=torch.float32, use_bn=True, device="cpu")
    return model, variables, load_jax_variables(port, variables)


@pytest.fixture(scope="module")
def artifact(both, tmp_path_factory):
    """The port's artifact: (bytes, path)."""
    path = str(tmp_path_factory.mktemp("export") / "m.pt2")
    data = export_classifier(both[2], None, TINY["image"], path=path)
    return data, path


def test_artifact_matches_jax_apply_and_jax_artifact(both, artifact):
    model, variables, _ = both
    data, path = artifact
    jax_served = jax_load(jax_export(model, variables, TINY["image"]))

    def apply(x):  # eager: one JAX compile a file (the export's) is enough
        return model.apply(variables, x, False)

    for source in (path, data):
        served = load_exported(source, device="cpu")
        for n in BATCHES:
            x = _images(n, seed=10 + n)
            got = served(x)
            assert got.dtype == torch.float32 and got.shape == (n, TINY["num_classes"])
            np.testing.assert_allclose(got.numpy(), np.asarray(apply(jnp.asarray(x))), atol=TOL,
                                       rtol=0)
            np.testing.assert_allclose(got.numpy(), np.asarray(jax_served(jnp.asarray(x))),
                                       atol=TOL, rtol=0)


def test_graph_names_the_kernels_ops(both):
    """A CPU export traces the card's route (``card_route``: the CPU takes
    ``flash_attention`` as the card does), so the graph holds K1's op and
    no softmax of the plain attention, and the int8 tower's K6's; the CPU
    artifact still matches JAX."""
    model, variables, port = both
    data = export_classifier(port, None, TINY["image"], platforms=("cpu",))
    graph = str(torch.export.load(io.BytesIO(data)).graph)
    assert "peft_vit_tpu_torch.flash_attn_fwd" in graph
    assert graph.count("peft_vit_tpu_torch.flash_attn_fwd") == TINY["layers"]
    assert "softmax" not in graph
    x = _images(3, seed=4)
    np.testing.assert_allclose(load_exported(data, device="cpu")(x).numpy(),
                               np.asarray(model.apply(variables, jnp.asarray(x), False)),
                               atol=TOL, rtol=0)
    int8 = load_jax_variables(flagship(**TINY, dtype=torch.float32, use_bn=True, int8=True,
                                       device="cpu"), variables)
    graph8 = str(torch.export.load(io.BytesIO(
        export_classifier(int8, None, TINY["image"]))).graph)
    assert set(re.findall(r"peft_vit_tpu_torch\.(\w+)", graph8)) == {"flash_attn_fwd",
                                                                    "int8_gemm_dynamic"}
    assert graph8.count("peft_vit_tpu_torch.int8_gemm_dynamic") == 4 * TINY["layers"]


def test_int8_artifact_equals_the_live_int8_model(both):
    _, variables, _ = both
    model = load_jax_variables(flagship(**TINY, dtype=torch.float32, use_bn=True, int8=True,
                                        device="cpu"), variables)
    served = load_exported(export_classifier(model, None, TINY["image"]), device="cpu")
    live = make_infer_fn(model)
    for n in BATCHES:
        x = torch.from_numpy(_images(n, seed=20 + n))
        assert torch.equal(served(x), live(x))


def test_an_artifact_takes_the_images_in_its_traced_dtype(both):
    """An artifact traced on bfloat16 images casts what it is given to
    bfloat16: it serves fp32 numpy images as the live model serves their
    bfloat16 rounding."""
    port = both[2]
    served = load_exported(export_classifier(port, None, TINY["image"], dtype=torch.bfloat16),
                           device="cpu")
    x = _images(3, seed=6)
    want = make_infer_fn(port)(torch.from_numpy(x).to(torch.bfloat16)).float()
    assert torch.equal(served(x), want)


def test_platforms_refuse_tpu_and_two_devices(both):
    port = both[2]
    with pytest.raises(ValueError, match="tpu"):
        export_classifier(port, None, TINY["image"], platforms=("tpu",))
    with pytest.raises(ValueError, match="one device"):
        export_classifier(port, None, TINY["image"], platforms=("cpu", "cuda"))
    with pytest.raises(ValueError, match="unknown"):
        export_classifier(port, None, TINY["image"], platforms=("rocm",))


# ---------------------------------------------------------------- the command

_CMD = {"DATASET.NUM_CLASSES": 5, "TRAIN.IMAGE_SIZE": [16, 16], "MODEL.NAME": "clip_tiny",
        "MODEL.SPEC.EMBED_DIM": 32, "MODEL.SPEC.VISION.PATCH_SIZE": 8,
        "MODEL.SPEC.VISION.WIDTH": 32, "MODEL.SPEC.VISION.LAYERS": 2,
        "MODEL.SPEC.VISION.HEADS": 2, "MODEL.SPEC.TEXT.WIDTH": 32,
        "MODEL.SPEC.TEXT.LAYERS": 1, "MODEL.SPEC.TEXT.HEADS": 2, "PEFT.METHOD": "lora"}


def _cmd_cfg():
    cfg = get_default_config()
    cfg.merge_from_list([x for k, v in _CMD.items() for x in (k, str(v))])
    cfg.freeze()
    return cfg


def test_export_main_grafts_a_checkpoint_of_one_lora_step(tmp_path):
    """One SGD step of the LoRA leaves through ``engine.train``, saved by
    ``engine.checkpoint``; ``export_main(check=True)`` grafts it, and the
    artifact is the trained model's, not the fresh one's."""
    from peft_vit_tpu_torch.commands.export_model import export_main
    from peft_vit_tpu_torch.engine.checkpoint import save_checkpoint
    from peft_vit_tpu_torch.engine.train import (ce_per_example, init_cell_state,
                                                 make_apply_fn, make_train_step)
    from peft_vit_tpu_torch.models.factory import build_image_classifier
    from peft_vit_tpu_torch.peft import build_mask, spec_from_config, split_params

    cfg = _cmd_cfg()
    model, _, _ = build_image_classifier(cfg, spec_from_config(cfg), 5, device="cpu")
    trainable, frozen = split_params(model, build_mask(model, "lora", num_layers=2))
    step = make_train_step(make_apply_fn(model), ce_per_example)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((4, 16, 16, 3)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 5, 4))
    state, _ = step(init_cell_state(trainable), frozen, x, y, None, 0.5, 0.0)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, 1, {"trainable": state.trainable})

    out = str(tmp_path / "lora.pt2")
    assert len(export_main(cfg, "lora", out, checkpoint=ckpt, check=True, device="cpu")) > 0
    served = load_exported(out, device="cpu")
    with torch.no_grad():
        for k, v in state.trainable.items():
            dict(model.named_parameters())[k].copy_(v)
    trained = make_infer_fn(model)(x)
    fresh = make_infer_fn(build_image_classifier(cfg, spec_from_config(cfg), 5,
                                                 device="cpu")[0])(x)
    got = served(x)
    np.testing.assert_allclose(got.numpy(), trained.numpy(), atol=TOL, rtol=0)
    assert not np.allclose(got.numpy(), fresh.numpy(), atol=1e-5)


def test_export_main_without_a_checkpoint_raises(tmp_path):
    from peft_vit_tpu_torch.commands.export_model import export_main

    with pytest.raises(FileNotFoundError):
        export_main(_cmd_cfg(), "full", str(tmp_path / "x.pt2"),
                    checkpoint=str(tmp_path / "nope"), device="cpu")


def test_export_main_from_the_command_line(tmp_path):
    from peft_vit_tpu_torch.commands import export_model

    out = str(tmp_path / "cli.pt2")
    data = export_model.main(["--output", out, "--check", "--platforms", "cpu",
                              *[x for k, v in _CMD.items() for x in (k, str(v))]],
                             device="cpu")
    assert open(out, "rb").read() == data


# ---------------------------------------------------------------- the ops

def _attn_operands(b=2, h=2, n=9, d=32, seed=0, cells=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, n, d), generator=g) for _ in range(4))
    bias = torch.randn(((cells,) if cells else ()) + (h, n, n), generator=g)
    return q, k, v, do, bias


OPS = ["flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "attn_bias_grad",
       "fused_short_attn_fwd", "fused_short_attn_bwd", "int8_gemm_dynamic", "int8_gemm_static",
       "int8_gemm_partial", "int8_row_absmax"]


def _op_case(name):
    """(the op's arguments, its plain version's results) on CPU tensors."""
    q, k, v, do, bias = _attn_operands()
    scale = 0.3
    o, lse = attn._flash_attention_plain(q, k, v, bias, scale, True)
    delta = attn._row_dot(do, o)
    x = torch.randn(3, 5, 128)
    w_i8, s_w = i8.quantize_cols(torch.randn(64, 128))
    s_x = torch.tensor(0.05)
    if name == "flash_attn_fwd":
        return (q, k, v, bias, scale, True), (o, lse)
    if name == "flash_attn_bwd_dq":
        return (q, k, v, do, lse, o, bias, scale), attn._bwd_dq_plain(q, k, v, do, lse, o, scale,
                                                                      bias)
    if name == "flash_attn_bwd_dkv":
        return (q, k, v, do, lse, delta, bias, scale), attn._bwd_dkv_plain(
            q, k, v, do, lse, delta, scale, bias)
    if name == "attn_bias_grad":
        return (q, k, v, do, lse, bias, delta, None, scale), (attn._bias_grad_plain(
            q, k, v, do, lse, scale, bias, delta),)
    if name == "fused_short_attn_fwd":
        return (q, k, v, scale, True), attn._fused_short_fwd_plain(q, k, v, scale, True)
    if name == "fused_short_attn_bwd":
        fo, flse = attn._fused_short_fwd_plain(q, k, v, scale, True)
        return (q, k, v, fo, flse, do, scale), attn._fused_short_bwd_plain(q, k, v, fo, flse,
                                                                           do, scale)
    if name == "int8_gemm_dynamic":
        return (x, w_i8, s_w), (i8._prequant_forward(x, w_i8, s_w),)
    if name == "int8_gemm_static":
        return (x, w_i8, s_w, s_x), (i8._static_forward(x, w_i8, s_w, s_x),)
    if name == "int8_gemm_partial":
        s_rows = i8.row_scales(i8._row_absmax_plain(x))
        return (x, w_i8, s_rows, None), (i8._partial_plain(x, w_i8, s_rows, None),)
    return (x,), (i8._row_absmax_plain(x),)


@pytest.mark.parametrize("name", OPS)
def test_op_cpu_is_the_plain_version_and_fake_gives_the_shapes(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = getattr(torch.ops.peft_vit_tpu_torch, name)
    args, want = _op_case(name)
    got = op(*args)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    before = ops.launch_counts()
    with FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args])
    fake = fake if isinstance(fake, tuple) else (fake,)
    for f, w in zip(fake, want):
        assert f.shape == w.shape and f.dtype == w.dtype
    assert ops.launch_counts() == before  # neither counts: no kernel launched


def test_every_launch_is_a_registered_op_with_a_flop_formula():
    from torch.utils.flop_counter import flop_registry

    for name in OPS:
        assert getattr(torch.ops.peft_vit_tpu_torch, name) in flop_registry
    # an int8 wrapper reaches its op for a meta tensor (its fake implementation:
    # the launch's checks run on the card only)
    x = torch.zeros(4, 128, device="meta")
    w_i8 = torch.zeros(64, 128, dtype=torch.int8, device="meta")
    assert i8.int8_gemm_dynamic(x, w_i8, torch.zeros(64, device="meta")).shape == (4, 64)
