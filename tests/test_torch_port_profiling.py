"""The port's summary, scaling, profiling and trace reader
(``utils.{summary,scaling,profiling,xprof}``, ``commands.{model_summary,
profile}``) against the JAX package's, on the CPU.

FLOPs: the port counts the products (2 m n k) of every matrix product,
convolution and kernel op; XLA's cost analysis of the JAX program counts its
elementwise work too, so on the tiny flagship the JAX count stands above the
port's by a ratio measured here (``JAX_FLOPS_RATIO``).  The port's forward
equals the analytic count of the tower's products exactly.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.peft import build_mask as jax_build_mask
from peft_vit_tpu.utils import scaling as jax_scaling
from peft_vit_tpu.utils.summary import flops_of as jax_flops_of
from peft_vit_tpu.utils.summary import param_summary as jax_param_summary
from peft_vit_tpu_torch.models import flagship, load_jax_variables
from peft_vit_tpu_torch.peft import build_mask
from peft_vit_tpu_torch.utils import scaling
from peft_vit_tpu_torch.utils.profiling import MetricsWriter, StepTimer, enable_anomaly_detection
from peft_vit_tpu_torch.utils.summary import bytes_accessed_of, flops_of, param_summary
from peft_vit_tpu_torch.utils.xprof import (format_op_profile, kernel_category,
                                            parse_op_profile)
from test_torch_port_model import TINY, _jax_flagship, randomize
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

# XLA's count of the tiny flagship's forward over the port's products:
# measured 1.0313 on the CPU (the softmax, the LayerNorms, quick-GELU, the
# scalings and the residual adds are the rest); held within 1 %
JAX_FLOPS_RATIO = 1.0313


def vit_forward_products(width, layers, heads, image, patch, rank, targets, out_dim, classes):
    """The CLIP ViT's forward products at B = 1: patch embedding, a block's
    four GEMMs (24 N W^2), attention (q k^T, p v: 4 N^2 W), the LoRA
    adapters (4 N W r a target), proj on the class token, the head."""
    n = (image // patch) ** 2 + 1
    return (2 * 3 * patch * patch * width * (n - 1) + 2 * width * out_dim + 2 * out_dim * classes
            + layers * (24 * n * width ** 2 + 4 * n * n * width + 4 * targets * n * width * rank))


@pytest.fixture(scope="module")
def both():
    model = _jax_flagship(use_bn=False)
    x = np.zeros((1, TINY["image"], TINY["image"], 3), np.float32)
    # the init compiled: op by op it takes three times as long
    variables = randomize(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    port = load_jax_variables(flagship(**TINY, dtype=torch.float32, device="cpu"), variables)
    return model, variables, port


def test_flops_of_a_matmul_is_2mkn():
    m, k, n = 32, 64, 16
    assert flops_of(lambda a, b: a @ b, torch.zeros(m, k), torch.zeros(k, n)) == 2 * m * k * n


def test_gradient_costs_more_than_the_forward():
    w, x = torch.zeros(64, 64, requires_grad=True), torch.zeros(32, 64)

    def fwd(w, x):
        return ((x @ w) ** 2).sum()

    def grad(w, x):
        return torch.autograd.grad(fwd(w, x), w)

    assert flops_of(grad, w, x) > 1.8 * flops_of(fwd, w, x)


def test_bytes_accessed_reads_and_writes():
    a = torch.zeros(128, 128)
    assert bytes_accessed_of(lambda x: x * 2.0, a) >= 2 * a.numel() * 4


def test_forward_flops_are_the_analytic_count_and_near_jax(both):
    model, variables, port = both
    x = np.zeros((1, TINY["image"], TINY["image"], 3), np.float32)
    with torch.no_grad():
        got = flops_of(port, torch.from_numpy(x))
    want = vit_forward_products(TINY["width"], TINY["layers"], TINY["heads"], TINY["image"],
                                TINY["patch"], rank=4, targets=2, out_dim=512,
                                classes=TINY["num_classes"])
    assert got == want
    jax_flops = jax_flops_of(lambda v, xx: model.apply(v, xx, False), variables, jnp.asarray(x))
    assert jax_flops / got == pytest.approx(JAX_FLOPS_RATIO, rel=1e-2)


def test_param_summary_counts_as_jax(both):
    model, variables, port = both
    params = variables["params"]
    jmask = jax_build_mask(params, "lora", num_layers=TINY["layers"])
    want = jax_param_summary(params, jmask).splitlines()[-1]
    mask = build_mask(port, "lora", num_layers=TINY["layers"])
    got = param_summary(dict(port.named_parameters()), mask).splitlines()[-1]
    assert got == want
    assert len(traverse_util.flatten_dict(params)) == len(mask)


@pytest.mark.parametrize("strategy", ["dp", "zero1", "tp", "pp"])
@pytest.mark.parametrize("n", [1, 8, 256])
def test_predict_and_the_table_equal_jax(strategy, n):
    rate = 450e9
    kw = dict(step_time_s=8.9e-3, per_chip_batch=16, seq_len=197, width=768, layers=12,
              trainable_bytes=4 * 51300)
    got = scaling.predict(scaling.StepProfile(**kw), n, strategy, rate)
    want = jax_scaling.predict(jax_scaling.StepProfile(**kw), n, strategy, rate)
    assert got == pytest.approx(want, rel=1e-12)
    assert scaling.scaling_table(scaling.StepProfile(**kw), link_bytes_per_s=rate) == \
        jax_scaling.scaling_table(jax_scaling.StepProfile(**kw), ici_bytes_per_s=rate)


def test_profile_from_params_as_jax(both):
    model, variables, port = both
    params = variables["params"]
    jmask = jax_build_mask(params, "lora", num_layers=TINY["layers"])
    want = jax_scaling.profile_from_params(params, jmask, 8.9e-3, 16, layers=TINY["layers"])
    got = scaling.profile_from_params(dict(port.named_parameters()),
                                      build_mask(port, "lora", num_layers=TINY["layers"]),
                                      8.9e-3, 16, layers=TINY["layers"])
    assert vars(got) == vars(want)
    assert scaling.H100_NVLINK_BYTES_PER_S == 450e9


class TestStepTimer:
    def test_counts_and_sync(self):
        t = StepTimer()
        for _ in range(5):
            t.step(8, sync_value=torch.ones(2))
        assert t._samples == 40 and t._steps == 5
        assert t.samples_per_sec > 0 and t.ms_per_step > 0

    def test_reset(self):
        t = StepTimer()
        t.step(4)
        t.reset()
        assert t._samples == 0 and t._steps == 0


def test_metrics_writer_jsonl_rows_and_tensorboard(tmp_path, monkeypatch):
    """The JSONL rows, and each scalar handed to ``utils.tb``'s writer (a
    stand-in here: TensorBoard's import takes tens of seconds)."""
    from peft_vit_tpu_torch.utils import tb

    seen = []

    class Writer:
        def scalar(self, tag, value, step):
            seen.append((tag, value, step))

        def close(self):
            seen.append("closed")

    monkeypatch.setattr(tb, "create_scalar_writer", lambda log_dir: Writer())
    w = MetricsWriter(str(tmp_path))
    w.write(0, {"loss": 1.5, "acc": 0.25})
    w.write(10, {"loss": 0.5})
    w.close()
    rows = [json.loads(line) for line in open(os.path.join(str(tmp_path), "metrics.jsonl"))]
    assert rows[0] == {"step": 0, "loss": 1.5, "acc": 0.25}
    assert rows[1]["step"] == 10
    assert seen == [("loss", 1.5, 0), ("acc", 0.25, 0), ("loss", 0.5, 10), "closed"]


def test_anomaly_detection_checks_nans():
    enable_anomaly_detection(True)
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        enable_anomaly_detection(False)
    assert not torch.is_anomaly_enabled()


# ---------------------------------------------------------------- the trace reader

_SYMBOLS = [
    ("void attn_fwd_sm90_kernel<256, false, false, false, 64>(CUtensorMap, CUtensorMap, "
     "CUtensorMap, FwdArgs)", "K1"),
    ("void attn_fwd_sm90_kernel<256, false, true, false, 64>(CUtensorMap, CUtensorMap, "
     "CUtensorMap, FwdArgs)", "K4"),
    ("void attn_bwd_sm90_kernel<0, false, 64>(CUtensorMap, CUtensorMap, CUtensorMap, "
     "CUtensorMap, BwdArgs)", "K2"),
    ("void attn_bwd_sm90_kernel<1, true, 32>(CUtensorMap, CUtensorMap, CUtensorMap, "
     "CUtensorMap, BwdArgs)", "K3"),
    ("void attn_bwd_sm90_kernel<2, false, 64>(CUtensorMap, CUtensorMap, CUtensorMap, "
     "CUtensorMap, BwdArgs)", "K5"),
    ("void int8_gemm_kernel<__nv_bfloat16, false, false, false>(CUtensorMap, ...)", "K6"),
    ("void bias_grad_sum_kernel(float const*, float*, unsigned long, int)", "K7"),
    ("nvjet_tst_128x192_64x4_1x2_h_bz_coopA_NNT", "GEMM"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "GEMM"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", "conv"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reduction"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", "reduction"),
    ("Memcpy DtoD (Device -> Device)", "copy or memset"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "NCCL"),
    ("some_other_kernel", "other"),
]


@pytest.mark.parametrize("symbol,category", _SYMBOLS)
def test_kernel_categories(symbol, category):
    assert kernel_category(symbol) == category


def test_a_synthetic_trace_by_category_busy_and_idle():
    events = [
        {"ph": "X", "cat": "kernel", "name": _SYMBOLS[0][0], "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": _SYMBOLS[2][0], "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": _SYMBOLS[7][0], "ts": 40.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 70.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": _SYMBOLS[0][0], "ts": 90.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 500.0},
    ]
    prof = parse_op_profile({"traceEvents": events}, costs={"K1": (2e9, 1e6)})
    cats = {r["name"]: r for r in prof["categories"]}
    assert prof["busy_us"] == 80.0 and prof["window_us"] == 100.0
    assert prof["idle_share"] == pytest.approx(0.2)
    assert (cats["K1"]["time_us"], cats["K1"]["count"]) == (20.0, 2)
    assert cats["GEMM"]["share"] == pytest.approx(30 / 80)
    assert sum(r["time_us"] for r in prof["categories"]) == prof["busy_us"]
    assert cats["K1"]["tflops"] == pytest.approx(2e9 / 20e-6 / 1e12)
    assert cats["K1"]["flops_share"] == pytest.approx(2e9 / 20e-6 / 989e12)
    text = format_op_profile(prof, card="NVIDIA H100 80GB HBM3, 700.00 W")
    assert "K1" in text and "700.00 W" in text and "idle share 0.200" in text


def test_device_events_of_a_profiler_window():
    """``device_events`` keeps a window's kernels and copies, not its host
    ops, the profiler's buffer requests or user annotations."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from peft_vit_tpu_torch.utils.xprof import device_events

    def event(name, device, start, end, annotation=False):
        span = SimpleNamespace(start=start, elapsed_us=lambda: end - start)
        return SimpleNamespace(name=name, device_type=device, time_range=span,
                               is_user_annotation=annotation)

    window = SimpleNamespace(events=lambda: [
        event(_SYMBOLS[0][0], DeviceType.CUDA, 0.0, 10.0),
        event("aten::mm", DeviceType.CPU, 0.0, 50.0),
        event("Activity Buffer Request", DeviceType.CUDA, 0.0, 5.0),
        event("ProfilerStep#1", DeviceType.CUDA, 0.0, 40.0, annotation=True),
        event("Memcpy DtoD (Device -> Device)", DeviceType.CUDA, 20.0, 30.0),
    ])
    events = device_events(window)
    assert [(e["name"], e["ts"], e["dur"]) for e in events] == [
        (_SYMBOLS[0][0], 0.0, 10.0), ("Memcpy DtoD (Device -> Device)", 20.0, 10.0)]
    prof = parse_op_profile(events)
    assert {r["name"]: r["count"] for r in prof["categories"]} == {"K1": 1, "copy or memset": 1}
    assert prof["busy_us"] == 20.0 and prof["idle_share"] == pytest.approx(1 / 3)


def test_one_count_of_costs_by_category():
    """``CostMode`` counts FLOPs and bytes by category once: a GEMM, a
    registered op (K1 at 2 products) and the elementwise rest; ``op_costs``
    keeps the categories a trace can time, ``bytes_accessed_of`` sums all."""
    from peft_vit_tpu_torch.ops import attention as attn
    from peft_vit_tpu_torch.ops._library import attention_products
    from peft_vit_tpu_torch.utils.summary import costs_of
    from peft_vit_tpu_torch.utils.xprof import op_costs

    a, b = torch.ones(4, 8), torch.ones(8, 16)
    q = torch.randn(1, 2, 8, 64)

    def fn():
        (a @ b) * 2.0
        attn.flash_attention_fwd(q, q, q, None, 0.125)

    costs = costs_of(fn)
    assert costs["GEMM"] == (2 * 4 * 8 * 16, (4 * 8 + 8 * 16 + 4 * 16) * 4)
    assert costs["K1"][0] == attention_products(q.shape, 2)
    assert costs["other"][0] == 0 and costs["other"][1] >= 2 * 4 * 16 * 4
    assert op_costs(fn) == {k: v for k, v in costs.items() if k != "other"}
    assert bytes_accessed_of(fn) == sum(v[1] for v in costs.values())


def test_a_cpu_trace_has_no_device_plane(tmp_path):
    from peft_vit_tpu_torch.utils.xprof import capture_trace

    path = capture_trace(lambda: torch.ones(64, 64) @ torch.ones(64, 64), str(tmp_path), steps=2)
    prof = parse_op_profile(path)
    assert prof["categories"] == [] and "no device" in format_op_profile(prof)


# ---------------------------------------------------------------- the commands

_TINY_CFG = ["MODEL.NAME", "clip_tiny", "DATASET.NUM_CLASSES", "5", "MODEL.NUM_CLASSES", "5",
             "TRAIN.IMAGE_SIZE", "[16, 16]", "MODEL.SPEC.EMBED_DIM", "32",
             "MODEL.SPEC.VISION.PATCH_SIZE", "8", "MODEL.SPEC.VISION.WIDTH", "32",
             "MODEL.SPEC.VISION.LAYERS", "2", "MODEL.SPEC.VISION.HEADS", "2",
             "MODEL.SPEC.TEXT.WIDTH", "32", "MODEL.SPEC.TEXT.LAYERS", "1",
             "MODEL.SPEC.TEXT.HEADS", "2"]


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_profile_main_runs_on_the_cpu(mode, tmp_path, capsys):
    from peft_vit_tpu_torch.commands import profile

    prof = profile.main(["--mode", mode, "--method", "lora", "--batch", "4", "--k-chain", "2",
                         "--steps", "1", "--logdir", str(tmp_path), *_TINY_CFG], device="cpu")
    assert prof["categories"] == []
    assert "no device" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "trace.json")


def vit_step_products(width, layers, heads, image, patch, rank, targets, out_dim, classes):
    """The train step's gradient products at B = 1 on the card's route: the
    forward, then dx of every frozen GEMM whose input needs one (not block
    0's in_proj or adapters' input), dW and dx of the adapters and the head,
    dx of proj, and K2 + K3 (3 + 4 products: both recompute the scores)."""
    n, w, r = (image // patch) ** 2 + 1, width, rank
    return (vit_forward_products(width, layers, heads, image, patch, rank, targets, out_dim,
                                 classes)
            + 4 * out_dim * classes + 2 * w * out_dim + layers * 14 * n * n * w
            + 18 * n * w * w + 6 * targets * n * w * r
            + (layers - 1) * (24 * n * w * w + 8 * targets * n * w * r))


def test_model_summary_counts_the_cards_products(capsys):
    """The summary counts the card's program on the CPU (``card_route``: K2
    and K3 recompute the scores), forward and train step equal to the
    analytic count; its command line prints the table and the scaling."""
    from peft_vit_tpu_torch.commands import model_summary
    from peft_vit_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg.merge_from_list(["PEFT.METHOD", "lora", *_TINY_CFG])
    cfg.freeze()
    _, params, _, layers, flops = model_summary.summarize(cfg, "lora", device="cpu")
    dims = dict(width=32, layers=layers, heads=2, image=16, patch=8,
                rank=params["backbone.blocks.0.attn.q_adapter1.weight"].shape[0], targets=2,
                out_dim=32, classes=5)
    assert (flops["forward"], flops["grad"]) == (vit_forward_products(**dims),
                                                vit_step_products(**dims))
    out = model_summary.main(["--method", "lora", "--scaling", "8.9", "--batch", "8",
                              *_TINY_CFG], device="cpu")
    assert "total params:" in out and "trainable:" in out and "frozen" in out
    assert "forward FLOPs" in out and "grad FLOPs" in out and "| dp | 8 |" in out
    assert out == capsys.readouterr().out.rstrip("\n")
