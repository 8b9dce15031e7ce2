"""RPB and the six methods that train a subset of the pretrained tower
(``full``, ``bitfit``, ``layernorm``, ``attention``, ``first_attention``,
``first_mlp``) through the port, against the JAX package on the CPU:

* each method's trainable mask against the JAX ``build_mask`` on a tree with
  the RPB table (booleans and counts: exact);
* a sweep round of 3 cells against the same cells trained one by one, as
  ``tests/test_torch_port_peft_rounds.py`` holds the injected methods (the
  same tiny ViT and bounds: losses within ``F32``, trainables and BN
  statistics within ``RTOL_LEAF``, momentum within ``RTOL_MOMENTUM``, eval
  logits within rtol 1e-5 and ``EVAL_ATOL`` of the largest), and a one-cell
  round's forward equal to the plain forward;
* ``finetune_main`` of both packages on the tiny config of
  ``test_torch_port_driver`` for ``rpb``, ``bitfit`` and ``full``, as
  ``test_torch_port_peft_driver`` holds the injected methods (the same
  rounds of cells, per-cell scores within 1e-4, the same choice and score);
  the other four through the port's driver alone (first_attention and
  first_mlp train block 1, so with ``TRAIN.CACHE_FROZEN_PREFIX`` False in
  both drivers);
* the driver's per-cell reset: every cell of a tower method starts from the
  grafted fp32 values, as the JAX driver's cells do, and draws only its head;
* the int8 tower: the trainable GEMMs are not in the quantized tree (the
  JAX package's holes), and a round runs each once a cell."""

import numpy as np
import pytest
import torch
from torch.func import vmap

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.models import ImageClassifier as JaxImageClassifier
from peft_vit_tpu.models import VisionTransformer as JaxViT
from peft_vit_tpu.ops import int8 as jax_int8
from peft_vit_tpu.peft import masks as jax_masks
from peft_vit_tpu.peft import spec as jax_spec
from peft_vit_tpu import config as jax_config
import peft_vit_tpu_torch.commands.run as port_run
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.engine import (
    ce_per_example,
    init_cell_state,
    make_apply_fn,
    make_array_task,
    make_epoch_fn,
    make_eval_fn,
    step_decay_lr,
)
from peft_vit_tpu_torch.engine import sweep as port_sweep
from peft_vit_tpu_torch.models import (ImageClassifier, cast_frozen_, jax_path, params_from_jax,
                                       params_to_jax)
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.ops import int8 as port_int8
from peft_vit_tpu_torch.peft import build_mask, spec_from_config, split_params
from test_torch_port_cells import EPOCHS, F32, RTOL_LEAF, WDS
from test_torch_port_driver import _run_both, tiny_cfg
from test_torch_port_peft_rounds import (
    BATCH,
    CELLS,
    EVAL_ATOL,
    LRS,
    NUM_CLASSES,
    RTOL_MOMENTUM,
    TINY,
    _cell_draw,
    _data,
    _draw,
    _stacked,
)

TOWER = ("full", "bitfit", "layernorm", "attention", "first_attention", "first_mlp")
METHODS = ("rpb", *TOWER)
# Leaves whose gradient is zero in exact arithmetic: train-mode channel BN
# subtracts the batch mean of the features, and ln_post's bias only shifts
# them (through proj) by the same vector in every row.  Their momentum is
# rounding alone (a norm of 9e-4 where the cell's largest is O(1)), and a
# round sums it in another order than a cell: held to RTOL_MOMENTUM of the
# cell's largest momentum norm instead of their own (measured 8e-7 apart).
ZERO_GRAD = ("backbone.ln_post.bias",)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny tensors: as fast alone, and it
    does not contend with the other test processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(pkg, method, **over):
    cfg = pkg.get_default_config()
    for key, value in {"PEFT.METHOD": method, **over}.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    return cfg


def _port_model(method, int8_train=False):
    """The tiny classifier with the RPB table in every block (so that each
    mask also meets it), every weight redrawn from a seed."""
    spec = spec_from_config(_cfg(port_config, "rpb"))
    model = ImageClassifier(VisionTransformer(**TINY, spec=spec, int8_train=int8_train,
                                              device="cpu"),
                            num_classes=NUM_CLASSES, use_bn=True, device="cpu")
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(_draw(rng, p.shape, name).astype(np.float32)))
    return model


def _tower_draws(trainable, mask_fresh):
    """Each cell's initial trainables: an injected leaf (the table, the
    head) as the driver draws it, nonzero (``_cell_draw``); a pretrained
    leaf its grafted value times 1 + N(0, 0.1^2), so that the cells differ."""
    draws = []
    for i in range(CELLS):
        rng = np.random.RandomState(200 + i)
        draws.append({k: _cell_draw(k, v.shape, i) if mask_fresh(k) else v.detach() * (
            1.0 + 0.1 * torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32)))
            for k, v in trainable.items()})
    return draws


def _round_model(method):
    model = _port_model(method)
    mask = build_mask(model, method, num_layers=TINY["layers"])
    trainable, _ = split_params(model, mask)
    cast_frozen_(model)
    fresh = (lambda k: True) if method == "rpb" else (lambda k: k.startswith("classifier."))
    draws = _tower_draws(trainable, fresh)
    bn = {k: v.clone() for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    return model, draws, bn


@pytest.mark.parametrize("method", METHODS)
def test_mask_and_count_equal_jax(method):
    model = _port_model(method)
    jax_model = JaxImageClassifier(
        backbone=JaxViT(image_size=TINY["image_size"], patch_size=TINY["patch_size"],
                        width=TINY["width"], layers=TINY["layers"], heads=TINY["heads"],
                        style="clip", output_dim=TINY["output_dim"],
                        spec=jax_spec.spec_from_config(_cfg(jax_config, "rpb")),
                        use_flash=False),
        num_classes=NUM_CLASSES, use_bn=True)
    x = jnp.zeros((1, TINY["image_size"], TINY["image_size"], 3), jnp.float32)
    params = jax_model.init(jax.random.PRNGKey(0), x)["params"]
    want = traverse_util.flatten_dict(
        jax_masks.build_mask(params, method, num_layers=TINY["layers"]), sep="/")
    mask = build_mask(model, method, num_layers=TINY["layers"])
    named = dict(model.named_parameters())
    assert {jax_path(k, named[k].dim()): m for k, m in mask.items()} == want
    assert port_run.count_trainable(model, mask) == jax_masks.count_trainable(
        params, jax_masks.build_mask(params, method, num_layers=TINY["layers"]))
    if method == "first_attention":  # blocks_1, the second block (the reference's blocks.1)
        assert {k for k, m in mask.items() if m and k.startswith("backbone.")} == {
            k for k in named if k.startswith("backbone.blocks.1.attn.")}


def test_patch_conv_gradients_and_its_round():
    """The patch embedding's convolution with its fixed-order weight
    gradient (``vit._PatchConv``): gradcheck of both gradients in float64,
    and a round's per-cell weights (``full``) under ``torch.func.vmap``
    against ``F.conv2d`` a cell at a time, forward and weight gradient."""
    from peft_vit_tpu_torch.models.vit import _PatchConv

    rng = np.random.RandomState(11)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 16))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((5, 3, 8, 8))).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, b: _PatchConv.apply(a, b, 8), (x, w))
    ws = torch.from_numpy(rng.standard_normal((3, 5, 3, 8, 8))).requires_grad_()
    got = vmap(lambda c: _PatchConv.apply(x.detach(), c, 8))(ws)
    want = torch.stack([torch.nn.functional.conv2d(x.detach(), ws[i], None, 8)
                        for i in range(3)])
    g = torch.from_numpy(rng.standard_normal(tuple(got.shape)))
    torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(torch.autograd.grad(got, ws, g)[0],
                               torch.autograd.grad(want, ws, g)[0], atol=1e-12, rtol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_one_cell_round_forward_is_the_plain_forward(method):
    model, draws, bn = _round_model(method)
    apply_fn = make_apply_fn(model)
    x = torch.from_numpy(_data(1, 16)[0])
    want = apply_fn({**draws[0], **{k: v.clone() for k, v in bn.items()}}, x, True)
    got = vmap(lambda t, s: apply_fn({**t, **s}, x, True))(
        {k: v[None] for k, v in draws[0].items()}, {k: v[None].clone() for k, v in bn.items()})
    assert torch.equal(got[0], want)


def _round_against_cells(model, draws, bn0, frozen=None, calls=None):
    frozen = frozen or {}
    apply_fn = make_apply_fn(model)
    x, y = _data(2, 14)
    task = make_array_task(x, y, x[:6], y[:6], BATCH, device="cpu")
    perms = [np.random.RandomState(3 + e).permutation(task.x_train.shape[0])
             for e in range(EPOCHS)]
    one = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True)
    cells = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True, cells=True)
    args = (task.x_train, task.y_train, task.valid_train)
    state = _stacked(draws, bn0)
    for e, perm in enumerate(perms):
        state, losses = cells(state, frozen, *args, perm, step_decay_lr(LRS, e, ()),
                              torch.tensor(WDS))
    launched = None if calls is None else len(calls)
    logits = make_eval_fn(apply_fn, BATCH, has_bn=True, cells=True)(state.trainable, frozen,
                                                                     task.x_val, state.bn)
    eval_one = make_eval_fn(apply_fn, BATCH, has_bn=True)
    for i in range(CELLS):
        alone = init_cell_state(draws[i], bn0)
        for e, perm in enumerate(perms):
            alone, loss = one(alone, frozen, *args, perm, step_decay_lr(LRS[i], e, ()), WDS[i])
        torch.testing.assert_close(losses[i], loss, **F32)
        largest = max(torch.linalg.vector_norm(v) for v in alone.momentum.values())
        for part in ("trainable", "momentum", "bn"):
            rtol = RTOL_MOMENTUM if part == "momentum" else RTOL_LEAF
            for k, v in getattr(alone, part).items():
                diff = torch.linalg.vector_norm(getattr(state, part)[k][i] - v)
                scale = largest if part == "momentum" and k in ZERO_GRAD else (
                    torch.linalg.vector_norm(v))
                assert diff <= rtol * scale, (part, k, i)
        want = eval_one(alone.trainable, frozen, task.x_val, alone.bn)
        torch.testing.assert_close(logits[i], want, rtol=1e-5,
                                   atol=EVAL_ATOL * float(want.abs().max()))
        moved = [k for k, v in alone.trainable.items() if not torch.equal(v, draws[i][k])]
        assert len(moved) == len(draws[i]), sorted(set(draws[i]) - set(moved))
    return launched


@pytest.mark.parametrize("method", METHODS)
def test_round_trains_as_its_cells_one_by_one(method):
    """``full`` batches every leaf of the tower over the cells: the patch
    embedding, the class and positional embeddings, each LayerNorm and
    ``Dense`` and the projection run a cell at a time under the vmap."""
    _round_against_cells(*_round_model(method))


def test_int8_tower_skips_the_trainable_gemms_and_a_round_runs_them_once_a_cell(monkeypatch):
    """``attention`` under ``INT8_FWD_TRAIN`` + ``INT8_BWD_DX``: the quantized
    tree holds the MLP's GEMMs and none of the trainable attention ones, as
    the JAX tree leaves them out; in a round the frozen GEMMs run once for
    the round's rows and the trainable ones (quantized per call) once a
    cell, and the round trains as its cells."""
    model = _port_model("attention", int8_train=True)
    mask = build_mask(model, "attention", num_layers=TINY["layers"])
    trainable, frozen = split_params(model, mask)
    qtree = port_int8.quantize_frozen_tree(frozen, bwd_dx=True)
    jtree = params_to_jax({k: v for k, v in frozen.items()})["params"]
    jq = traverse_util.flatten_dict(jax_int8.quantize_frozen_tree(jtree, bwd_dx=True), sep="/")
    assert {jax_path(k, 0) for k in qtree} == {f"{k}" for k in jq}
    assert not any(".attn." in k for k in qtree) and any(".mlp.c_fc." in k for k in qtree)
    for k, v in qtree.items():  # the codes transposed, the scales (1, N) in JAX
        ref = np.asarray(jq[jax_path(k, 0)])
        np.testing.assert_array_equal(v.numpy(), ref.T if v.dim() == 2 else ref.reshape(v.shape))
    cast_frozen_(model)
    draws = _tower_draws(trainable, lambda k: k.startswith("classifier."))
    bn0 = {k: v.clone() for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    calls = []
    real = port_int8.int8_gemm_dynamic
    monkeypatch.setattr(port_int8, "int8_gemm_dynamic",
                        lambda x, *a: calls.append(x.shape) or real(x, *a))
    launched = _round_against_cells(model, draws, bn0, qtree, calls)
    # a round's step: per block in_proj and out_proj once a cell, c_fc and c_proj
    # once, and their int8 dx once; 2 steps an epoch
    per_step = TINY["layers"] * (2 * CELLS + 2 + 2)
    assert launched == EPOCHS * 2 * per_step


# ---------------------------------------------------------------- the drivers


@pytest.mark.parametrize("method", ["rpb", "bitfit", "full"])
def test_driver_sweeps_and_chooses_as_jax(monkeypatch, tmp_path, method):
    """As ``test_torch_port_peft_driver``: one block, a 2-lr grid over a
    5-point wd grid (2 coarse points), 2 epochs a cell; accuracy on 8
    images (a step is 12.5 %), fp32 logits ~1e-6 apart, so the per-cell
    scores are held at 1e-4, the choice and the score exactly."""
    over = {"TRAIN.NO_TUNING": False, "TRAIN.END_EPOCH": 2, "TRAIN.SEARCH_WD_POINTS": 5,
            "TRAIN.SEARCH_WD_INIT_POINTS": 2, "MODEL.SPEC.VISION.LAYERS": 1,
            "PEFT.METHOD": method}
    want, got = _run_both(monkeypatch, tmp_path, lr_grid=[1e-3, 3e-2], **over)
    assert [c[:2] for c in got["cells"]] == [c[:2] for c in want["cells"]]
    for g, w in zip(got["cells"], want["cells"]):
        np.testing.assert_allclose(g[2], w[2], atol=1e-4)
    assert (got["record"]["lr"], got["record"]["wd"]) == (want["record"]["lr"],
                                                          want["record"]["wd"])
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert got["record"]["trainable_params"] == want["record"]["trainable_params"]


@pytest.mark.parametrize("method", ["layernorm", "attention", "first_attention", "first_mlp"])
def test_finetune_main_runs_the_other_tower_methods_on_the_cpu(tmp_path, method):
    """Through the port's driver alone (``NO_TUNING``, 2 epochs): a finite
    score written to results.jsonl with the method's trainable count."""
    import json

    cfg = tiny_cfg(port_config, **{"PEFT.METHOD": method, "TRAIN.END_EPOCH": 2,
                                   "TRAIN.LR": 1e-3, "TRAIN.CACHE_FROZEN_PREFIX": False})
    score = port_run.finetune_main(cfg, str(tmp_path), device="cpu")
    record = json.loads((tmp_path / "results.jsonl").read_text().splitlines()[-1])
    assert 0.0 <= score <= 100.0 and record["score"] == score and record["method"] == method
    assert record["trainable_params"] > 0


@pytest.mark.parametrize("method", ["bitfit", "full"])
def test_each_cell_starts_from_the_grafted_fp32_values(monkeypatch, method):
    """The driver's cells (bf16 compute, the weights handed in as a JAX
    tree): every trainable tower leaf starts at its grafted fp32 value in
    every cell, bit for bit and in fp32 (not the bf16 the frozen tower is
    cast to), as the JAX driver's ``init_trainable`` gives them; only the
    head is drawn, anew for each cell."""
    seen = {}

    class Spy(port_sweep.SweepEngine):
        def __init__(self, cfg, apply_fn, init_trainable, *a, **kw):
            super().__init__(cfg, apply_fn, init_trainable, *a, **kw)
            seen["init"] = init_trainable

    monkeypatch.setattr(port_run, "SweepEngine", Spy)
    cfg = tiny_cfg(port_config, **{"PEFT.METHOD": method, "TRAIN.END_EPOCH": 1,
                                   "MODEL.SPEC.VISION.LAYERS": 1,
                                   "TPU.COMPUTE_DTYPE": "bfloat16"})
    model = port_run.build_image_classifier(cfg, spec_from_config(cfg), 4, use_bn=True,
                                            device="cpu")[0]
    rng = np.random.RandomState(9)
    tree = params_to_jax({k: torch.from_numpy(_draw(rng, tuple(v.shape), k).astype(np.float32))
                          for k, v in model.state_dict().items()})
    port_run.finetune_main(cfg, device="cpu", variables=tree)
    grafted = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
               params_from_jax(tree).items()}
    keys = (port_sweep.CellKey(0, 3, 0), port_sweep.CellKey(0, 3, 2),
            port_sweep.CellKey(0, None))
    cells = [seen["init"](key) for key in keys]
    tower = [k for k in cells[0] if not k.startswith("classifier.")]
    assert tower and all(c[k].dtype == torch.float32 and torch.equal(c[k], grafted[k])
                         for c in cells for k in tower)
    head = "classifier.head.weight"
    assert not torch.equal(cells[0][head], cells[1][head])
    assert not torch.equal(cells[0][head], grafted[head])
