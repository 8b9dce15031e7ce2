"""Every PEFT method of the port in a sweep round, on the CPU: a round of 3
cells trained together (``make_epoch_fn(cells=True)``, the forward under
``torch.func.vmap``) against the same cells trained one by one, as
``tests/test_torch_port_cells.py`` holds LoRA.  The model is a tiny CLIP ViT
(width 64, 2 blocks, 4 heads, 32 px, patch 16, channel BN, 10 classes) with
the method's hooks, built from ``spec_from_config``; every weight is drawn
from a numpy seed, and every cell's initial trainables as the driver draws
them, none of them zero.

Bounds, as in the cells tests: a one-cell round's forward EQUAL to the plain
forward; after 2 epochs of 2 batches every cell's losses within ``F32``,
its eval logits within rtol 1e-5 and ``EVAL_ATOL`` x the largest, its trainables and BN statistics within ``RTOL_LEAF`` and
its momentum within ``RTOL_MOMENTUM`` of the cell trained alone.  And the leaves a method trains
but never reads (the adapters of the blocks that ``lora_drop_adapter``
skips) move by weight decay alone, as in the JAX package's vmapped epoch,
within one fp32 ulp."""

import numpy as np
import pytest
import torch
from torch.func import vmap

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.engine import train as jax_train
from peft_vit_tpu.models import ImageClassifier as JaxImageClassifier
from peft_vit_tpu.models import VisionTransformer as JaxViT
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
from peft_vit_tpu_torch.engine.sweep import CellKey
from peft_vit_tpu_torch.models import ImageClassifier, cast_frozen_, jax_path, params_to_jax
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.peft import build_mask, spec_from_config, split_params
from test_torch_port_cells import EPOCHS, F32, RTOL_LEAF, WDS

CELLS, BATCH = 3, 8
# The cells' lrs, a tenth of the LoRA cells test's: the methods that add LoRA
# (alpha / r = 32) to an adapter or a gate on this model, whose frozen weights
# are at 1 / sqrt(fan in) where the LoRA test's are at 0.05, move their LoRA
# leaves by more than their size a step at lr 1e-2.  The round's first step
# equals its cells' forward bit for bit and their gradients within 3e-6
# (GEMMs over 3 x 8 rows blocked otherwise than over 8); at lr 1e-2 four
# steps carry that to 6.6e-5 of the trainables and 1.6e-4 of the logits
# (measured on the CPU), at these lrs within the bounds below.
LRS = (1e-4, 3e-4, 1e-3)
# The momentum holds the raw gradients, which sum their rows in other orders
# in a round and cancel within some leaves (Compacter's biases, LayerNorm
# biases): after 4 steps 1.9e-5 of a leaf's 2-norm measured (lora_compacter),
# where the trainables and BN statistics stand within 4e-7 (RTOL_LEAF).
RTOL_MOMENTUM = 5e-5
# Eval logits after the 4 steps: 1.3e-6 of the largest logit apart measured
# (lora_drop_adapter, vpt_deep), where ``F32``'s atol of 1e-6 is absolute.
EVAL_ATOL = 3e-6
TINY = dict(image_size=32, patch_size=16, width=64, layers=2, heads=4, output_dim=32)
NUM_CLASSES = 10
# each method at the tiny width: phm_dim 4, Compacter's reduction 4 (16 wide),
# the adapter dropped from every block but the last, 3 prompts
PEFT = {"PEFT.PHM_DIM": 4, "PEFT.COMPACTER_REDUCTION": 4, "PEFT.ADAPTER_LAYERS": [1],
        "PEFT.ADAPTER_DIM": 16}
METHODS = {
    "kadaptation": {}, "adapter": {}, "adapterdrop": {}, "compacter": {}, "lora_fix_one": {},
    "lora_moe": {}, "lora_adapter": {}, "lora_compacter": {}, "lora_drop_adapter": {},
    "lepe": {}, "vpt": {"PEFT.PROMPT_TOKENS": 3},
    "vpt_deep": {"PEFT.PROMPT_TOKENS": 3, "PEFT.PROMPT_DEEP": True}, "transformer_probe": {},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny tensors: as fast alone, and it
    does not contend with the other test processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(pkg, method):
    cfg = pkg.get_default_config()
    for key, value in {**PEFT, **METHODS[method], "PEFT.METHOD": method.replace("_deep", "")
                       }.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    return cfg


def _draw(rng, shape, name):
    if name.endswith(("bn_var",)):
        return rng.uniform(0.5, 1.5, shape)
    if name.endswith(("ln_1.weight", "ln_2.weight", "norm_before.weight", "ln_pre.weight",
                      "ln_post.weight")):
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if "adapter1" in name or "adapter2" in name:
        return 0.02 * rng.standard_normal(shape)
    fan = int(np.prod(shape[1:])) if len(shape) > 1 else 10
    return rng.standard_normal(shape) / np.sqrt(fan)


def _cell_draw(name, shape, i):
    """Cell ``i``'s initial leaf: the driver's fresh draw (the flax init), with
    N(0, 0.02^2) added where that is all zeros or ones (LoRA's B, biases,
    LayerNorm scales), so that no leaf starts at zero."""
    t = port_run._fresh_leaf(name, shape, CellKey(0, CELLS, i).generator())
    if bool((t == 0).all()) or bool((t == 1).all()):
        t = t + torch.from_numpy(0.02 * np.random.RandomState(100 + i).standard_normal(
            tuple(shape)).astype(np.float32))
    return t


def _model(method, seed=0):
    """The tiny classifier of ``method``, every weight redrawn from
    ``seed``: (model, its mask, each cell's initial trainables, the BN
    statistics)."""
    cfg = _cfg(port_config, method)
    spec = spec_from_config(cfg)
    model = ImageClassifier(VisionTransformer(**TINY, spec=spec, device="cpu"),
                            num_classes=NUM_CLASSES, use_bn=True, device="cpu")
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(_draw(rng, p.shape, name).astype(np.float32)))
    mask = build_mask(model, spec.method, num_layers=TINY["layers"],
                      adapter_layers=spec.adapter_layers)
    trainable, _ = split_params(model, mask)
    cast_frozen_(model)
    draws = [{k: _cell_draw(k, v.shape, i) for k, v in trainable.items()} for i in range(CELLS)]
    bn = {k: v.clone() for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    return model, mask, draws, bn


def _data(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, TINY["image_size"], TINY["image_size"], 3)).astype(np.float32)
    return x, rng.randint(0, NUM_CLASSES, n)


def _stacked(draws, bn):
    return init_cell_state({k: torch.stack([d[k] for d in draws]) for k in draws[0]},
                           {k: v.expand(CELLS, *v.shape) for k, v in bn.items()})


@pytest.mark.parametrize("method", sorted(METHODS))
def test_one_cell_round_forward_is_the_plain_forward(method):
    model, _, draws, bn = _model(method)
    apply_fn = make_apply_fn(model)
    x = torch.from_numpy(_data(1, 16)[0])
    want = apply_fn({**draws[0], **{k: v.clone() for k, v in bn.items()}}, x, True)
    got = vmap(lambda t, s: apply_fn({**t, **s}, x, True))(
        {k: v[None] for k, v in draws[0].items()}, {k: v[None].clone() for k, v in bn.items()})
    assert torch.equal(got[0], want)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_round_trains_as_its_cells_one_by_one(method):
    model, _, draws, bn0 = _model(method)
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
        state, losses = cells(state, {}, *args, perm, step_decay_lr(LRS, e, ()), torch.tensor(WDS))
    logits = make_eval_fn(apply_fn, BATCH, has_bn=True, cells=True)(state.trainable, {},
                                                                     task.x_val, state.bn)
    eval_one = make_eval_fn(apply_fn, BATCH, has_bn=True)
    for i in range(CELLS):
        alone = init_cell_state(draws[i], bn0)
        for e, perm in enumerate(perms):
            alone, loss = one(alone, {}, *args, perm, step_decay_lr(LRS[i], e, ()), WDS[i])
        torch.testing.assert_close(losses[i], loss, **F32)
        for part in ("trainable", "momentum", "bn"):
            rtol = RTOL_MOMENTUM if part == "momentum" else RTOL_LEAF
            for k, v in getattr(alone, part).items():
                diff = torch.linalg.vector_norm(getattr(state, part)[k][i] - v)
                assert diff <= rtol * torch.linalg.vector_norm(v), (part, k, i)
        want = eval_one(alone.trainable, {}, task.x_val, alone.bn)
        torch.testing.assert_close(logits[i], want, rtol=1e-5,
                                   atol=EVAL_ATOL * float(want.abs().max()))
        moved = [k for k, v in alone.trainable.items() if not torch.equal(v, draws[i][k])]
        assert len(moved) == len(draws[i]), sorted(set(draws[i]) - set(moved))


def test_lora_drop_adapter_unused_leaves_move_as_the_jax_step_moves_them():
    """lora_drop_adapter trains every block's adapter but runs only block 1's:
    block 0's adapter leaves get no gradient, and weight decay alone moves
    them, in the port's round of 3 as in the JAX package's epoch vmapped over
    the same 3 cells (one epoch of 2 steps), within one fp32 ulp."""
    model, mask, draws, bn0 = _model("lora_drop_adapter")
    unused = [k for k in draws[0] if ".blocks.0.adapter." in k]
    assert len(unused) == 6 and all(mask[k] for k in unused)
    x, y = _data(4, 16)
    perm = np.random.RandomState(5).permutation(16)
    apply_fn = make_apply_fn(model)
    cells = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True, cells=True)
    # weight decay large enough to move every cell's leaves by more than an ulp
    lrs, wds = (1e-2, 1e-2, 1e-2), (1e-2, 1e-1, 1.0)
    lr, wd = torch.tensor(lrs), torch.tensor(wds)
    got, _ = cells(_stacked(draws, bn0), {}, torch.from_numpy(x), torch.from_numpy(y),
                   torch.ones(16, dtype=torch.bool), perm, lr, wd)

    cfg = _cfg(jax_config, "lora_drop_adapter")
    spec = jax_spec.spec_from_config(cfg)
    jax_model = JaxImageClassifier(
        backbone=JaxViT(image_size=TINY["image_size"], patch_size=TINY["patch_size"],
                        width=TINY["width"], layers=TINY["layers"], heads=TINY["heads"],
                        style="clip", output_dim=TINY["output_dim"], spec=spec,
                        use_flash=False),
        num_classes=NUM_CLASSES, use_bn=True)
    tree = params_to_jax({k: v for k, v in model.state_dict().items()})
    params, bn = tree["params"], tree["batch_stats"]
    jmask = jax_masks.build_mask(params, "lora_drop_adapter", num_layers=TINY["layers"],
                                 adapter_layers=spec.adapter_layers)
    _, frozen = jax_masks.split_params(params, jmask)
    flat = traverse_util.flatten_dict(params, sep="/")
    starts = []
    for d in draws:
        cell = {**flat, **traverse_util.flatten_dict(params_to_jax(d)["params"], sep="/")}
        starts.append(jax_masks.split_params(traverse_util.unflatten_dict(cell, sep="/"),
                                             jmask)[0])
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *starts)
    apply = lambda v, xx, train, **kw: jax_model.apply(v, xx, train, **kw)
    epoch = jax.vmap(jax_train.make_epoch_fn(apply, jax_train.ce_per_example, BATCH, has_bn=True),
                     in_axes=(0, None, None, None, None, None, 0, 0))
    state = jax_train.init_cell_state(
        stacked, jax.tree_util.tree_map(lambda v: jnp.stack([v] * CELLS), bn))
    state = state._replace(step=jnp.zeros(CELLS, jnp.int32))
    want, _ = jax.jit(epoch)(state, frozen, jnp.asarray(x), jnp.asarray(y), jnp.ones(16, bool),
                             jnp.asarray(perm), jnp.asarray(lrs, jnp.float32),
                             jnp.asarray(wds, jnp.float32))
    want = traverse_util.flatten_dict(want.trainable, sep="/")
    for i in range(CELLS):
        got_tree = traverse_util.flatten_dict(
            params_to_jax({k: got.trainable[k][i] for k in unused})["params"], sep="/")
        start = traverse_util.flatten_dict(starts[i], sep="/")
        for k in unused:
            path = jax_path(k, draws[0][k].dim())
            ref = np.asarray(want[path][i])
            # XLA contracts the update into fused multiply-adds here and there
            np.testing.assert_array_max_ulp(got_tree[path], ref, maxulp=1)
            assert not np.array_equal(ref, start[path]), path


def test_int8_round_of_the_probe_launches_its_weights_once_a_cell(monkeypatch):
    """The transformer probe under ``INT8_FWD_TRAIN``: the frozen tower's
    GEMMs run once for the round (its rows are every cell's), the probe
    block's trainable weights (quantized per call) once a cell; the round
    trains as its cells one by one (``RTOL_LEAF``, momentum
    ``RTOL_MOMENTUM``)."""
    from peft_vit_tpu_torch.ops import int8 as i8

    cfg = _cfg(port_config, "transformer_probe")
    cfg.TPU.INT8_FWD_TRAIN = True
    spec = spec_from_config(cfg)
    model = ImageClassifier(VisionTransformer(**TINY, spec=spec, int8_train=True,
                                              device="cpu"),
                            num_classes=NUM_CLASSES, use_bn=True, device="cpu")
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(_draw(rng, p.shape, name).astype(np.float32)))
    trainable, frozen = split_params(model, build_mask(model, "transformer_probe",
                                                       num_layers=TINY["layers"]))
    qtree = i8.quantize_frozen_tree(frozen)
    cast_frozen_(model)
    draws = [{k: _cell_draw(k, v.shape, i) for k, v in trainable.items()} for i in range(CELLS)]
    bn0 = {k: v.clone() for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    calls = []
    real = i8.int8_gemm_dynamic
    monkeypatch.setattr(i8, "int8_gemm_dynamic", lambda x, *a: calls.append(x.shape) or real(x, *a))
    apply_fn = make_apply_fn(model)
    x, y = _data(6, 8)
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.ones(8, dtype=torch.bool),
            np.arange(8))
    cells = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True, cells=True)
    state, losses = cells(_stacked(draws, bn0), qtree, *args, torch.tensor(LRS),
                          torch.tensor(WDS))
    frozen_gemms, probe_gemms = 4 * TINY["layers"], 4
    # before the probe every cell's rows are the same rows: one call a GEMM
    assert len(calls) == frozen_gemms + CELLS * probe_gemms
    assert all(c[0] == BATCH for c in calls)
    one = make_epoch_fn(apply_fn, ce_per_example, BATCH, has_bn=True)
    for i in range(CELLS):
        alone, loss = one(init_cell_state(draws[i], bn0), qtree, *args, LRS[i], WDS[i])
        torch.testing.assert_close(losses[i], loss, **F32)
        for part in ("trainable", "momentum", "bn"):
            rtol = RTOL_MOMENTUM if part == "momentum" else RTOL_LEAF
            for k, v in getattr(alone, part).items():
                diff = torch.linalg.vector_norm(getattr(state, part)[k][i] - v)
                assert diff <= rtol * torch.linalg.vector_norm(v), (part, k, i)
