"""A sweep round's cells trained together, on the CPU: the batching rules of
the kernels' autograd Functions against a Python loop over the cells, a
round of the tiny flagship against the same cells trained one by one, a
round with a diverging cell, and int8 serving quantized once at load.

The kernels' plain versions run here, so a rule is held by what its
wrappers are given: one call for the whole round, the cell axis folded into
the batch or the rows.  Weights and data are drawn from numpy seeds; every
tensor is fp32.  Each tolerance is stated where it is used."""

import numpy as np
import pytest
import torch
from torch.func import vmap
from torch.utils._pytree import tree_leaves, tree_map

from peft_vit_tpu_torch.config import get_default_config
from peft_vit_tpu_torch.engine import (
    ServingSession,
    SweepEngine,
    ce_per_example,
    init_cell_state,
    make_apply_fn,
    make_array_task,
    make_epoch_fn,
    make_eval_fn,
    step_decay_lr,
)
from peft_vit_tpu_torch.engine import serving as serving_engine
from peft_vit_tpu_torch.engine import train as train_engine
from peft_vit_tpu_torch.engine.sweep import CellKey
from peft_vit_tpu_torch.models import cast_frozen_, flagship
from peft_vit_tpu_torch.models import layers as port_layers
from peft_vit_tpu_torch.ops import attention as attn
from peft_vit_tpu_torch.ops import int8 as i8
from peft_vit_tpu_torch.ops import launch_counts
from peft_vit_tpu_torch.peft import build_mask, split_params
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

CELLS, B, H, N, D = 3, 2, 2, 9, 8
TINY = dict(width=64, layers=2, heads=4, image=32, patch=16, num_classes=10)
# A folded launch computes each cell's rows as the loop does, but PyTorch's
# CPU matmuls may block a batch of k*B matrices otherwise than one of B:
# fp32 sums of the same products in another order, a few ulps.
F32 = dict(rtol=1e-5, atol=1e-6)
# A round against its cells trained one by one, per leaf after 2 epochs:
# ||round - alone|| <= RTOL_LEAF ||alone|| (2-norms).  In fp32 PyTorch's CPU
# matmuls (the plain attention's among them) sum a batch of 3 x 8 matrices in
# other blocks than one of 8, and 4 steps carry that into the gradients;
# measured on the CPU: 4e-7 for the trainables and the BN statistics, 6e-6
# for the momentum (the head's gradient, through train-mode BN over 8 rows).
# Element by element the momentum misses 1e-5 on elements near 0.
RTOL_LEAF = 1e-5


def _rand(seed, *shape):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(shape).astype(np.float32))


class _Spy:
    """Records the leading shape of every call of a wrapper, then calls it."""

    def __init__(self, monkeypatch, module, name):
        self.shapes, real = [], getattr(module, name)

        def spy(x, *args, **kwargs):
            self.shapes.append(tuple(x.shape))
            return real(x, *args, **kwargs)

        monkeypatch.setattr(module, name, spy)


def _loop_and_vmap(fn, batched, shared, cotangent, n_grad=None):
    """``fn`` over the cells through ``vmap`` (``batched`` on axis 0,
    ``shared`` unbatched) and through a loop: (outputs, gradients of the
    first ``n_grad`` batched operands) of each."""
    n_grad = len(batched) if n_grad is None else n_grad

    def leaves():
        return [t.clone().requires_grad_(i < n_grad) for i, t in enumerate(batched)]

    xs = leaves()
    got = vmap(lambda *b: fn(*b, *shared))(*xs)
    got_g = torch.autograd.grad(got, xs[:n_grad], cotangent)
    ys = leaves()
    want = torch.stack([fn(*(t[i] for t in ys), *shared) for i in range(CELLS)])
    want_g = torch.autograd.grad(want, ys[:n_grad], cotangent)
    return (got, got_g), (want, want_g)


@pytest.mark.parametrize("which", ["flash", "fused"])
@pytest.mark.parametrize("k_shared", [False, True])
def test_attention_rule_folds_the_cells_into_the_batch(monkeypatch, which, k_shared):
    """q and v batched over the cells, k batched or shared (block 0: the
    LoRA deltas touch q and v only): one forward and one backward call at
    batch CELLS x B, outputs and dq, dk, dv as the loop's (fp32, ``F32``)."""
    q, k, v = (_rand(s, CELLS, B, H, N, D) for s in (1, 2, 3))
    do = _rand(4, CELLS, B, H, N, D)
    if which == "flash":
        fn = lambda q_, k_, v_: attn.flash_attention(q_, k_, v_, scale=0.3)
        fwd = _Spy(monkeypatch, attn, "flash_attention_fwd")
        bwd = _Spy(monkeypatch, attn, "flash_attention_bwd_dq")
    else:
        fn = lambda q_, k_, v_: attn.fused_short_attention(q_, k_, v_, scale=0.3)
        fwd = _Spy(monkeypatch, attn, "fused_short_attention_fwd")
        bwd = _Spy(monkeypatch, attn, "fused_short_attention_bwd")
    if k_shared:
        k = k[0]
        f = lambda q_, v_, k_: fn(q_, k_, v_)
        (got, got_g), (want, want_g) = _loop_and_vmap(f, (q, v), (k,), do)
    else:
        (got, got_g), (want, want_g) = _loop_and_vmap(fn, (q, k, v), (), do)
    torch.testing.assert_close(got, want, **F32)
    for g, w in zip(got_g, want_g):
        torch.testing.assert_close(g, w, **F32)
    folded = (CELLS * B, H, N, D)
    assert fwd.shapes[0] == folded and bwd.shapes[0] == folded  # the round's one call each
    assert len(fwd.shapes) == len(bwd.shapes) == 1 + CELLS  # and the loop's calls


def test_attention_rule_without_a_gradient():
    """The eval path: no lse, nothing saved, the loop's output exactly."""
    q, k, v = (_rand(s, CELLS, B, H, N, D) for s in (5, 6, 7))
    with torch.no_grad():
        got = vmap(lambda a, b, c: attn.flash_attention(a, b, c))(q, k, v)
        want = torch.stack([attn.flash_attention(q[i], k[i], v[i]) for i in range(CELLS)])
    torch.testing.assert_close(got, want, **F32)


def _int8_operands(seed, k=64, n=64):
    x = _rand(seed, CELLS, B, 5, k)
    w = _rand(seed + 1, n, k) * 0.05
    w_i8, s_w = i8.quantize_cols(w)
    wt_i8, s_wt = i8.quantize_cols(w.t())
    return x, w, w_i8, s_w, wt_i8, s_wt


@pytest.mark.parametrize("op", ["dynamic", "dx", "static"])
def test_int8_rule_folds_the_cells_into_the_rows(monkeypatch, op):
    """The int8 ops (their plain versions here) over a batched activation:
    outputs and dx EQUAL to the loop's (the arithmetic is exact and row by
    row).  The dynamic forward and the int8 dx take every cell's rows in one
    call; a per-cell static scale takes one call per cell, since the kernel
    reads one scale a launch."""
    x, w, w_i8, s_w, wt_i8, s_wt = _int8_operands(8)
    g = _rand(10, CELLS, B, 5, 64)
    s_x = torch.tensor([0.02, 0.03, 0.05])
    dyn = _Spy(monkeypatch, i8, "int8_gemm_dynamic")
    static = _Spy(monkeypatch, i8, "int8_gemm_static")
    if op == "dynamic":
        (got, got_g), (want, want_g) = _loop_and_vmap(
            lambda x_: i8.int8_prequant_matmul(x_, w, w_i8, s_w), (x,), (), g)
        calls = {"dynamic": [(CELLS, B, 5, 64)], "static": []}
    elif op == "dx":
        (got, got_g), (want, want_g) = _loop_and_vmap(
            lambda x_: i8.int8_prequant_matmul_i8bwd(x_, w, w_i8, s_w, wt_i8, s_wt), (x,), (), g)
        calls = {"dynamic": [(CELLS, B, 5, 64)] * 2, "static": []}
    else:
        (got, got_g), (want, want_g) = _loop_and_vmap(
            lambda x_, s_: i8.int8_static_matmul(x_, w, w_i8, s_w, s_), (x, s_x), (), g, 1)
        calls = {"dynamic": [], "static": [(B, 5, 64)] * CELLS}
    assert torch.equal(got, want)
    assert torch.equal(got_g[0], want_g[0])
    n_loop = CELLS * (2 if op == "dx" else 1)
    assert dyn.shapes[:len(dyn.shapes) - (0 if op == "static" else n_loop)] == calls["dynamic"]
    assert static.shapes[:len(static.shapes) - (n_loop if op == "static" else 0)] == \
        calls["static"]


def test_int8_rule_shared_activation_with_per_cell_scales():
    """Block 0's in_proj under the static recipe: the input is the same for
    every cell, the scale is each cell's own."""
    x, w, w_i8, s_w, _, _ = _int8_operands(12)
    x = x[0]
    s_x = torch.tensor([0.01, 0.04, 0.2])
    got = vmap(lambda s: i8.int8_static_matmul(x, w, w_i8, s_w, s), in_dims=0)(s_x)
    want = torch.stack([i8.int8_static_matmul(x, w, w_i8, s_w, s) for s in s_x])
    assert torch.equal(got, want)


@pytest.mark.parametrize("x_batched", [True, False])
def test_int8_rule_launches_a_batched_weight_once_per_cell(monkeypatch, x_batched):
    """The transformer probe's extra block under the int8 training recipe: its
    weights are trainable, each cell's own, and quantized per call
    (``int8_matmul_bf16_bwd``).  The rule launches the dynamic kernel once
    per cell on that cell's rows (or on the shared rows) and its weight:
    outputs and the gradients of the weights and the activation EQUAL to the
    loop's.  Batched codes or weight scales still raise."""
    x, w, w_i8, s_w = _int8_operands(14)[:4]
    ws = torch.stack([w, 2 * w, -w])
    g = _rand(15, CELLS, B, 5, 64)
    dyn = _Spy(monkeypatch, i8, "int8_gemm_dynamic")
    if x_batched:
        (got, got_g), (want, want_g) = _loop_and_vmap(i8.int8_matmul_bf16_bwd, (x, ws), (), g)
    else:
        f = lambda w_, x_: i8.int8_matmul_bf16_bwd(x_, w_)
        (got, got_g), (want, want_g) = _loop_and_vmap(f, (ws,), (x[0],), g)
    assert torch.equal(got, want)
    assert all(torch.equal(a, c) for a, c in zip(got_g, want_g))
    rows = (B, 5, 64)
    assert dyn.shapes == [rows] * (2 * CELLS)  # the round's calls, then the loop's
    with pytest.raises(NotImplementedError, match="batched codes or weight scales"):
        vmap(lambda c: i8.int8_matmul(x[0], w, c, s_w))(torch.stack([w_i8] * CELLS))


def test_linear_rule_adds_the_bias_inside_the_gemm_as_for_one_cell():
    """A biased frozen ``Dense`` over a round's rows: EQUAL to the loop in
    bf16 (the bias added inside the GEMM for the round as for one cell), its
    gradients too; a batched weight runs one cell at a time, also equal; the
    Function's fp64 gradients pass ``gradcheck``."""
    x = _rand(20, CELLS, B, 5, 64).bfloat16()
    w, b = (_rand(21, 96, 64) * 0.1).bfloat16(), _rand(22, 96).bfloat16()
    g = _rand(23, CELLS, B, 5, 96).bfloat16()
    linear = port_layers._Linear.apply
    (got, got_g), (want, want_g) = _loop_and_vmap(lambda x_: linear(x_, w, b), (x,), (), g)
    assert torch.equal(got, want) and torch.equal(got_g[0], want_g[0])
    ws, bs = torch.stack([w, w * 2, -w]), torch.stack([b, b, -b])
    (got, got_g), (want, want_g) = _loop_and_vmap(linear, (x, ws, bs), (), g)
    assert torch.equal(got, want) and all(torch.equal(a, c) for a, c in zip(got_g, want_g))
    args = (_rand(24, 3, 4, 8).double().requires_grad_(), _rand(25, 5, 8).double().requires_grad_(),
            _rand(26, 5).double().requires_grad_())
    assert torch.autograd.gradcheck(linear, args)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_one_cell_round_forward_is_the_plain_forward(dtype):
    """The tiny flagship in train mode (channel BN, LayerNorm in the compute
    dtype) under ``vmap`` over one cell: logits EQUAL to the plain forward's,
    so a round changes no cell's forward arithmetic."""
    torch.manual_seed(0)
    model = flagship(**TINY, dtype=dtype, use_bn=True, ln_fp32=False, device="cpu")
    trainable, _ = split_params(model, build_mask(model, "lora", num_layers=TINY["layers"]))
    cast_frozen_(model)
    apply_fn = make_apply_fn(model)
    x = torch.from_numpy(_data(27, 16)[0])
    leaves = {k: v.detach() + 0.01 * _rand(28, *v.shape) for k, v in trainable.items()}
    bn = {k: v.clone() for k, v in model.named_buffers()}
    want = apply_fn({**leaves, **{k: v.clone() for k, v in bn.items()}}, x, True)
    got = vmap(lambda t, s: apply_fn({**t, **s}, x, True))(
        {k: v[None] for k, v in leaves.items()}, {k: v[None].clone() for k, v in bn.items()})
    assert torch.equal(got[0], want)


# ---------------------------------------------------------------- a round of the tiny flagship


def _tiny(seed=0, **kw):
    """The tiny flagship in fp32 with channel BN, every weight redrawn from
    ``seed``, LoRA mask applied: (model, initial trainables of each of the
    round's cells, BN template)."""
    torch.manual_seed(seed)
    model = flagship(**TINY, dtype=torch.float32, use_bn=True, device="cpu", **kw)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
    trainable, _ = split_params(model, build_mask(model, "lora", num_layers=TINY["layers"]))
    cast_frozen_(model)
    draws = [{k: torch.from_numpy(0.02 * np.random.RandomState(100 + i).standard_normal(
        v.shape).astype(np.float32)) for k, v in trainable.items()} for i in range(CELLS)]
    bn = {k: v.clone() for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    return model, draws, bn


def _data(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, TINY["image"], TINY["image"], 3)).astype(np.float32)
    return x, rng.randint(0, TINY["num_classes"], n)


LRS, WDS, EPOCHS, BATCH = (1e-3, 3e-3, 1e-2), (1e-4, 1e-2, 1.0), 2, 8


def test_round_trains_as_its_cells_one_by_one():
    """3 cells, 2 epochs of 2 batches, channel BN: every cell's losses and
    eval logits (``F32``) and its trainables, momentum and BN statistics
    (``RTOL_LEAF``) as the same cell trained alone."""
    model, draws, bn0 = _tiny()
    apply_fn = make_apply_fn(model)
    x, y = _data(1, 14)
    task = make_array_task(x, y, x[:6], y[:6], BATCH, device="cpu")
    perms = [np.random.RandomState(2 + e).permutation(task.x_train.shape[0])
             for e in range(EPOCHS)]
    one = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True)
    cells = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True, cells=True)
    eval_one = make_eval_fn(apply_fn, BATCH, has_bn=True)
    eval_cells = make_eval_fn(apply_fn, BATCH, has_bn=True, cells=True)

    state = init_cell_state({k: torch.stack([d[k] for d in draws]) for k in draws[0]},
                            {k: v.expand(CELLS, *v.shape) for k, v in bn0.items()})
    args = (task.x_train, task.y_train, task.valid_train)
    for e, perm in enumerate(perms):
        state, losses = cells(state, {}, *args, perm, step_decay_lr(LRS, e, ()),
                              torch.tensor(WDS))
    assert losses.shape == (CELLS,) and state.step == EPOCHS * 2
    logits = eval_cells(state.trainable, {}, task.x_val, state.bn)
    assert logits.shape == (CELLS, task.x_val.shape[0], TINY["num_classes"])
    for i in range(CELLS):
        alone = init_cell_state(draws[i], bn0)
        for e, perm in enumerate(perms):
            alone, loss = one(alone, {}, *args, perm, step_decay_lr(LRS[i], e, ()), WDS[i])
        torch.testing.assert_close(losses[i], loss, **F32)
        for part in ("trainable", "momentum", "bn"):
            for k, v in getattr(alone, part).items():
                diff = torch.linalg.vector_norm(getattr(state, part)[k][i] - v)
                assert diff <= RTOL_LEAF * torch.linalg.vector_norm(v), (part, k, i)
        torch.testing.assert_close(logits[i], eval_one(alone.trainable, {}, task.x_val,
                                                       alone.bn), **F32)


def _engine(metric="accuracy", **over):
    model, draws, bn0 = _tiny()
    cfg = get_default_config()
    cfg.TRAIN.BATCH_SIZE_PER_GPU = BATCH
    cfg.TRAIN.SCHEDULE = [1]
    for key, value in over.items():
        cfg.TRAIN[key] = value
    # a cell's draw depends on its key alone, as CellKey.generator's does
    init = lambda key: draws[key.index if key.round_size else 0]
    engine = SweepEngine(cfg, make_apply_fn(model), init, {}, ce_per_example, metric=metric,
                         bn_template=bn0)
    x, y = _data(3, 14)
    return engine, make_array_task(x, y, x[:6], y[:6], BATCH, device="cpu")


@pytest.mark.parametrize("last", [False, True])
def test_round_scores_as_its_cells_one_by_one(last):
    """``train_cells`` of a round of 3 against each cell of it trained alone
    by the one-cell path (``_train``, the final run's): equal val scores,
    best or last epoch."""
    engine, task = _engine(SEARCH_RESULT_ON_LAST_EPOCH=last)
    got = engine.train_cells(LRS, WDS, task, EPOCHS)
    perms = engine._perms(task.x_train.shape[0], EPOCHS, 0)
    for i in range(CELLS):
        scores = [s for _, s in engine._train(CellKey(0, CELLS, i), LRS[i], WDS[i], task, perms)]
        assert got[i] == np.float32(scores[-1] if last else max(scores))


def test_a_diverging_cell_touches_no_other():
    """Cell 1 at lr 1e30 goes non-finite within the first step.  Cells 0 and
    2 end EQUAL to the same round with cell 1 at a sane lr (every row and
    leaf of a cell is its own), and so do their scores, while the diverged
    cell scores 0 under a host metric (its logits are not finite); top-1 of
    NaN logits is scored as the JAX engine scores it, so the test takes
    mean-per-class."""
    model, draws, bn0 = _tiny()
    apply_fn = make_apply_fn(model)
    x, y = _data(4, 16)
    task = make_array_task(x, y, x[:8], y[:8], BATCH, device="cpu")
    cells = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True, cells=True)
    perm = np.random.RandomState(5).permutation(16)
    ends = {}
    for bad_lr in (1e-3, 1e30):
        state = init_cell_state({k: torch.stack([d[k] for d in draws]) for k in draws[0]},
                                {k: v.expand(CELLS, *v.shape) for k, v in bn0.items()})
        ends[bad_lr], _ = cells(state, {}, task.x_train, task.y_train, task.valid_train, perm,
                                torch.tensor([1e-3, bad_lr, 1e-3]), torch.tensor(WDS))
    sane, wild = ends[1e-3], ends[1e30]
    assert not all(bool(v[1].isfinite().all()) for v in wild.trainable.values())
    for part in ("trainable", "momentum", "bn"):
        for k, v in getattr(wild, part).items():
            for i in (0, 2):
                assert torch.equal(v[i], getattr(sane, part)[k][i]), (part, k, i)

    engine, task = _engine(metric="mean-per-class", SCHEDULE=[])
    sane, wild = (engine.train_cells([1e-3, lr, 1e-3], list(WDS), task, 1) for lr in (1e-3, 1e30))
    assert wild[1] == 0.0 and wild[[0, 2]].tolist() == sane[[0, 2]].tolist()


# ---------------------------------------------------------------- int8 serving


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_serving_quantizes_once_at_load(monkeypatch, dtype):
    """An int8 ServingSession quantizes the tower's 8 weights at load; a
    request then quantizes no weight, and its logits EQUAL those of the same
    model quantizing every weight per call (the codes of the same cast
    weights)."""
    state = _tiny(int8=True)[0].state_dict()
    count = {"n": 0}
    real = i8.quantize_cols

    def counted(w):
        count["n"] += 1
        return real(w)

    monkeypatch.setattr(i8, "quantize_cols", counted)
    images = _data(6, 5)[0]
    build = lambda: flagship(**TINY, dtype=dtype, use_bn=True, int8=True, device="cpu")
    session = ServingSession(build(), state, TINY["image"], buckets=(1, 8), device="cpu")
    assert count["n"] == 4 * TINY["layers"]  # at load
    count["n"] = 0
    got = session.predict(images)
    assert count["n"] == 0

    per_call = build()
    per_call.load_state_dict(state)
    cast_frozen_(per_call.requires_grad_(False)).eval()
    with torch.no_grad():
        want = per_call(torch.from_numpy(images)).float().numpy()
    assert count["n"] == 4 * TINY["layers"]  # per call
    np.testing.assert_array_equal(got, want)


def test_static_int8_round_calibrates_each_cell(monkeypatch):
    """The static int8 recipe (pre-quantized tree, int8 dx, scales
    calibrated on each epoch's first batch) in a round of 3: each cell's
    scales are its own (one calibration forward per cell, EQUAL to the scales
    of the cell alone), the static kernel runs once per cell and GEMM, and
    each cell trains as it does alone (``RTOL_LEAF``)."""
    model, draws, bn0 = _tiny(int8_train=True)
    frozen = {k: v for k, v in model.named_parameters() if not v.requires_grad}
    tree = i8.quantize_frozen_tree({k: v.float() for k, v in frozen.items()}, bwd_dx=True)
    apply_fn = make_apply_fn(model)
    x, y = _data(7, 16)
    task = make_array_task(x, y, x[:8], y[:8], BATCH, device="cpu")
    perm = np.random.RandomState(8).permutation(16)
    scales = []
    real = i8.activation_scales_from_stats
    monkeypatch.setattr("peft_vit_tpu_torch.engine.train.activation_scales_from_stats",
                        lambda *a: scales.append(real(*a)) or scales[-1])
    static = _Spy(monkeypatch, i8, "int8_gemm_static")
    cells = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True, calibrate_model=model,
                          cells=True)
    state = init_cell_state({k: torch.stack([d[k] for d in draws]) for k in draws[0]},
                            {k: v.expand(CELLS, *v.shape) for k, v in bn0.items()})
    state, _ = cells(state, tree, task.x_train, task.y_train, task.valid_train, perm,
                     torch.tensor(LRS), torch.tensor(WDS))
    gemms = 4 * TINY["layers"]
    assert len(scales) == CELLS and len(static.shapes) == 2 * CELLS * gemms  # 2 steps
    round_scales = scales[:]
    one = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True, calibrate_model=model)
    for i in range(CELLS):
        alone, _ = one(init_cell_state(draws[i], bn0), tree, task.x_train, task.y_train,
                       task.valid_train, perm, LRS[i], WDS[i])
        assert scales[-1].keys() == round_scales[i].keys()
        assert all(torch.equal(scales[-1][k], round_scales[i][k]) for k in scales[-1])
        for part in ("trainable", "momentum", "bn"):
            for k, v in getattr(alone, part).items():
                diff = torch.linalg.vector_norm(getattr(state, part)[k][i] - v)
                assert diff <= RTOL_LEAF * torch.linalg.vector_norm(v), (part, k, i)


# ---------------------------------------------------------------- the captured path's own code


class _Rerun(train_engine.StepGraph):
    """A stand-in for the CUDA graph on the CPU: the 'capture' runs ``fn``
    once, a 'replay' runs it again on the static buffers and copies its
    results into the captured outputs, as a replay overwrites them.  It
    runs the engine's captured path (static buffers, copies in, state
    written back, clones out, graphs kept by shape) where no card is."""

    def __init__(self, fn, inputs, keep=(), generators=()):
        self.keep, self.fn, self.replays = tuple(keep), fn, 0
        self.inputs = tree_map(lambda t: t.detach().clone(), inputs)
        states = [g.get_state() for g in generators]
        before = launch_counts()
        self.outputs = fn(self.inputs)
        self.launches = {k: n - before[k] for k, n in launch_counts().items()}
        for g, state in zip(generators, states):  # as the capture puts them back
            g.set_state(state)

    def _replay(self):
        with torch.enable_grad():
            outputs = self.fn(self.inputs)
        for out, new in zip(tree_leaves(self.outputs), tree_leaves(outputs)):
            with torch.inference_mode(out.is_inference()), torch.no_grad():
                out.copy_(new)


def _captured(monkeypatch, on: bool):
    """The engine's work on the CPU as 'replays' (``on``) or eagerly."""
    for module in (train_engine, serving_engine):
        monkeypatch.setattr(module, "runs_captured", lambda t: on)


@pytest.fixture
def rerun(monkeypatch):
    for module in (train_engine, serving_engine):
        monkeypatch.setattr(module, "StepGraph", _Rerun)
    _captured(monkeypatch, True)


def test_step_graph_captures_with_the_cyclic_collector_off(monkeypatch):
    """``StepGraph`` keeps Python's cyclic garbage collector off for the
    capture and only there: a dead graph in a reference cycle collected
    during a capture is destroyed while the stream captures, which CUDA
    refuses, and the capture fails (seen on the card).  The CUDA graph API
    is faked here, so the CPU runs the class's capture path."""
    import contextlib
    import gc

    class Fake:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

        def replay(self):
            pass

    seen = []
    capturing = {"on": False}

    @contextlib.contextmanager
    def fake_graph(graph):
        capturing["on"] = True
        yield
        capturing["on"] = False

    for name, value in (("Stream", Fake), ("CUDAGraph", Fake), ("graph", fake_graph),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("current_stream", lambda *a: Fake())):
        monkeypatch.setattr(torch.cuda, name, value)

    def fn(inputs):
        seen.append((capturing["on"], gc.isenabled()))
        return inputs["x"] * 2

    assert gc.isenabled()
    graph = train_engine.StepGraph(fn, {"x": torch.ones(2)})
    assert seen == [(False, True)] * train_engine.StepGraph.WARMUP + [(True, False)]
    assert gc.isenabled() and torch.equal(graph.outputs, torch.full((2,), 2.0))


def test_captured_epochs_and_evals_equal_the_eager_ones(rerun, monkeypatch):
    """The captured path against the eager one, a round and one cell, 2
    epochs of 2 steps: EQUAL states, losses and eval logits; the caller's
    state is not written; one graph per (kind, round size, batch), reused by
    the second epoch, replayed once a batch."""
    model, draws, bn0 = _tiny()
    apply_fn = make_apply_fn(model)
    x, y = _data(9, 16)
    task = make_array_task(x, y, x[:8], y[:8], BATCH, device="cpu")
    perms = [np.random.RandomState(10 + e).permutation(16) for e in range(EPOCHS)]
    graphs = {}
    for cells in (True, False):
        start = init_cell_state(
            {k: torch.stack([d[k] for d in draws]) for k in draws[0]} if cells else draws[0],
            {k: v.expand(CELLS, *v.shape) for k, v in bn0.items()} if cells else bn0)
        lr, wd = (torch.tensor(LRS), torch.tensor(WDS)) if cells else (LRS[0], WDS[0])
        copy = {k: v.clone() for k, v in start.trainable.items()}
        ends = {}
        for capture in (False, True):
            _captured(monkeypatch, capture)
            epoch = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True, cells=cells,
                                  graphs=graphs)
            evaluate = make_eval_fn(apply_fn, BATCH, has_bn=True, cells=cells, graphs=graphs)
            state, out = start, []
            for perm in perms:
                state, loss = epoch(state, {}, task.x_train, task.y_train, task.valid_train,
                                    perm, lr, wd)
                out.append((loss, evaluate(state.trainable, {}, task.x_val, state.bn)))
            ends[capture] = state, out
        (eager, eager_out), (captured, captured_out) = ends[False], ends[True]
        for part in ("trainable", "momentum", "bn"):
            for k, v in getattr(eager, part).items():
                assert torch.equal(getattr(captured, part)[k], v), (cells, part, k)
        for (l0, e0), (l1, e1) in zip(eager_out, captured_out):
            assert torch.equal(l0, l1) and torch.equal(e0, e1)
        assert captured.step == eager.step == EPOCHS * 2
        assert all(torch.equal(v, copy[k]) for k, v in start.trainable.items())
        key = CELLS if cells else None
        assert graphs[("step", key, BATCH)].replays == EPOCHS * 2
        assert graphs[("eval", key, BATCH)].replays == EPOCHS * 1
    assert len(graphs) == 4


def test_captured_serving_buckets_equal_the_eager_ones(rerun, monkeypatch):
    model, _, _ = _tiny(int8=True)
    state = model.state_dict()
    sessions = []
    for capture in (False, True):
        _captured(monkeypatch, capture)
        sessions.append(ServingSession(flagship(**TINY, dtype=torch.float32, use_bn=True,
                                                int8=True, device="cpu"), state,
                                       TINY["image"], buckets=(1, 8), device="cpu"))
    eager, captured = sessions
    assert not eager._graphs and sorted(captured._graphs) == [1, 8]
    for n in (1, 5, 11):
        images = _data(20 + n, n)[0]
        np.testing.assert_array_equal(captured.predict(images), eager.predict(images))
    assert [captured._graphs[b].replays for b in (1, 8)] == [1, 3]
