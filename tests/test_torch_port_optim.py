"""The port's optimizers and schedules (``peft_vit_tpu_torch/engine/optim.py``,
``ema.py``) against the JAX package's optax chains on the same trees, and
against the executed reference's schedules, LARC and EMA
(``tests/golden/refexec_engine.npz``).

Tolerances: every optimizer and schedule within 1e-6 relative of optax
(fp32 on both sides: the chains do the same operations in the same order;
a norm or a power may round its last bit differently), with an absolute
floor of 1e-9 for rates and 1e-7 for leaves near zero; the golden keys at
the JAX tests' own tolerances.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from peft_vit_tpu.config import get_default_config as jax_config
from peft_vit_tpu.engine import optim as jax_optim
from peft_vit_tpu_torch.config import get_default_config as port_config
from peft_vit_tpu_torch.engine import ema as port_ema
from peft_vit_tpu_torch.engine import optim as port_optim
from peft_vit_tpu_torch.models.convert import params_from_jax

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
sys.path.insert(0, GOLDEN)
from generate_engine_from_reference import ema_inputs, larc_inputs  # noqa: E402

sys.path.pop(0)
G = np.load(os.path.join(GOLDEN, "refexec_engine.npz"))
RTOL = 1e-6


def _cfg(factory, **over):
    cfg = factory()
    cfg.TRAIN.LR = 0.1
    cfg.TRAIN.END_EPOCH = 6
    for key, value in over.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    return cfg


SCHEDULES = [
    {"TRAIN.LR_SCHEDULER.METHOD": "step", "TRAIN.SCHEDULE": [2, 4]},
    {"TRAIN.LR_SCHEDULER.METHOD": "multistep", "TRAIN.SCHEDULE": [1, 3, 5]},
    {"TRAIN.LR_SCHEDULER.METHOD": "multistep", "TRAIN.SCHEDULE": []},
    {"TRAIN.LR_SCHEDULER.METHOD": "cosine"},
    {"TRAIN.LR_SCHEDULER.METHOD": "warmupcosine", "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 2},
    {"TRAIN.LR_SCHEDULER.METHOD": "warmup_cosine", "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 0.5,
     "TRAIN.LR_SCHEDULER.WARMUP_FACTOR": 0.01},
    {"TRAIN.LR_SCHEDULER.METHOD": "constant"},
    {"TRAIN.LR_SCHEDULER.METHOD": "cyclic", "TRAIN.LR_SCHEDULER.STEP_SIZE_UP": 5},
    {"TRAIN.LR_SCHEDULER.METHOD": "cycliclr", "TRAIN.LR_SCHEDULER.STEP_SIZE_UP": 4,
     "TRAIN.LR_SCHEDULER.STEP_SIZE_DOWN": 7, "TRAIN.LR_SCHEDULER.CYCLIC_MODE": "triangular2"},
    {"TRAIN.LR_SCHEDULER.METHOD": "cyclic", "TRAIN.LR_SCHEDULER.STEP_SIZE_UP": 6,
     "TRAIN.LR_SCHEDULER.CYCLIC_MODE": "exp_range", "TRAIN.LR_SCHEDULER.CYCLIC_GAMMA": 0.97},
    {"TRAIN.LR_SCHEDULER.METHOD": "swalr", "SWA.BEGIN_EPOCH": 2, "SWA.ANNEAL_EPOCHS": 2},
    {"TRAIN.LR_SCHEDULER.METHOD": "swa", "SWA.BEGIN_EPOCH": 1, "SWA.ANNEAL_EPOCHS": 3,
     "SWA.ANNEAL_STRATEGY": "linear", "SWA.LR_RATIO": 0.2},
]


@pytest.mark.parametrize("over", SCHEDULES, ids=lambda o: "-".join(
    str(v) for v in o.values()).replace(" ", ""))
def test_schedule_matches_the_jax_schedule_at_every_step(over):
    spe = 5
    want = jax_optim.build_lr_schedule(_cfg(jax_config, **over), spe)
    got = port_optim.build_lr_schedule(_cfg(port_config, **over), spe)
    steps = range(6 * spe + 3)
    w = np.asarray([float(want(jnp.asarray(t, jnp.int32))) for t in steps])
    g = np.asarray([float(got(torch.tensor(t, dtype=torch.int32))) for t in steps])
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-9)
    # a Python int and a tensor count give the same rate
    assert float(got(7)) == float(got(torch.tensor(7, dtype=torch.int32)))


def _tree(seed: int = 0) -> dict:
    """A JAX-layout tree whose paths exercise the weight-decay and TWO_LR
    masks: kernels, biases, a LayerNorm, an embedding, a depthwise conv and
    the head."""
    rng = np.random.RandomState(seed)
    shapes = {
        "backbone/conv1/kernel": (2, 2, 3, 4), "backbone/conv1/bias": (4,),
        "backbone/class_embedding": (4,),
        "backbone/blocks_0/ln_1/scale": (4,), "backbone/blocks_0/ln_1/bias": (4,),
        "backbone/blocks_0/attn/in_proj/kernel": (4, 12),
        "backbone/blocks_0/attn/in_proj/bias": (12,),
        "backbone/blocks_0/attn/get_v/kernel": (3, 3, 1, 4),
        "classifier/head/kernel": (4, 3), "classifier/head/bias": (3,),
    }
    flat = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    return traverse_util.unflatten_dict(flat, sep="/")


OPTIMIZERS = [
    {"TRAIN.OPTIMIZER": "sgd", "TRAIN.MOMENTUM": 0.9, "TRAIN.NESTEROV": True, "TRAIN.WD": 1e-2},
    {"TRAIN.OPTIMIZER": "sgd", "TRAIN.MOMENTUM": 0.9, "TRAIN.NESTEROV": False, "TRAIN.WD": 1e-2,
     "TRAIN.CLIP_GRAD_NORM": 0.5},
    {"TRAIN.OPTIMIZER": "sgd", "TRAIN.MOMENTUM": 0.0, "TRAIN.WD": 0.0},
    {"TRAIN.OPTIMIZER": "sgd", "TRAIN.MOMENTUM": 0.9, "TRAIN.LARC": True, "TRAIN.WD": 0.0},
    {"TRAIN.OPTIMIZER": "sgd", "TRAIN.MOMENTUM": 0.9, "TRAIN.NESTEROV": True, "TRAIN.LARC": True,
     "TRAIN.WD": 5e-2, "TRAIN.WITHOUT_WD_LIST": ["bias", "depthwise"]},
    {"TRAIN.OPTIMIZER": "adam", "TRAIN.WD": 0.0},
    {"TRAIN.OPTIMIZER": "adam", "TRAIN.WD": 1e-2, "TRAIN.CLIP_GRAD_NORM": 1.0},
    {"TRAIN.OPTIMIZER": "adamW", "TRAIN.WD": 5e-2, "TRAIN.TWO_LR": True},
    {"TRAIN.OPTIMIZER": "timm", "TRAIN.WD": 5e-2, "TRAIN.WITHOUT_WD_LIST": ["norm"]},
    {"TRAIN.OPTIMIZER": "rmsprop", "TRAIN.MOMENTUM": 0.0, "TRAIN.WD": 1e-3,
     "TRAIN.GAMMA1": 0.95},
    {"TRAIN.OPTIMIZER": "rmsprop", "TRAIN.MOMENTUM": 0.9, "TRAIN.WD": 0.0,
     "TRAIN.TWO_LR": True, "TRAIN.CLIP_GRAD_NORM": 2.0},
]


@pytest.mark.parametrize("over", OPTIMIZERS, ids=lambda o: "-".join(
    f"{k.split('.')[-1]}={v}" for k, v in o.items()).replace(" ", ""))
def test_optimizer_matches_the_optax_chain(over):
    """Five updates of every optimizer and flag combination (under the
    warmup-cosine schedule) from the same tree and gradients: the port's
    leaves against optax's within 1e-6 relative."""
    over = {"TRAIN.LR_SCHEDULER.METHOD": "warmupcosine", "TRAIN.LR_SCHEDULER.WARMUP_EPOCH": 1,
            **over}
    spe = 3
    tree = _tree()
    jcfg, pcfg = _cfg(jax_config, **over), _cfg(port_config, **over)
    tx = jax_optim.build_optimizer(jcfg, tree, spe)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    port = {k: v.clone() for k, v in params_from_jax({"params": tree}).items()}
    opt = port_optim.build_optimizer(pcfg, port, spe)
    pstate = opt.init(port)
    rng = np.random.RandomState(1)
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.randn(*a.shape) * 3.0).astype(np.float32), tree)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        lr = opt.step(port, params_from_jax({"params": grads}), pstate,
                      torch.tensor(step, dtype=torch.int32))
        assert float(lr) == pytest.approx(float(jax_optim.build_lr_schedule(jcfg, spe)(step)),
                                          rel=RTOL)
    want = params_from_jax({"params": jax.device_get(params)})
    for k, v in port.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("wd_list", [[], ["bias", "depthwise"], ["norm", "class_embedding"]])
def test_weight_decay_and_two_lr_masks_match_the_jax_masks(wd_list):
    tree = _tree()
    want = traverse_util.flatten_dict(jax_optim.no_weight_decay_mask(tree, wd_list), sep="/")
    port = params_from_jax({"params": tree})
    got = port_optim.no_weight_decay_mask(port, wd_list)
    by_path = {k: want[k] for k in want}
    from peft_vit_tpu_torch.models.convert import jax_path

    assert {jax_path(k, v.dim()): got[k] for k, v in port.items()} == by_path
    want_bb = traverse_util.flatten_dict(jax_optim.backbone_lr_mask(tree), sep="/")
    got_bb = port_optim.backbone_lr_mask(port)
    assert {jax_path(k, v.dim()): got_bb[k] for k, v in port.items()} == want_bb


# -- the executed reference (refexec_engine.npz) --------------------------------


@pytest.mark.parametrize("key,build,steps,tol", [
    ("wc_lrs", lambda: port_optim.warmup_cosine_schedule(0.1, 60, 10, 0.001), 60,
     dict(rtol=1e-5, atol=1e-8)),
    ("ms_lrs", lambda: port_optim.step_decay_schedule(0.1, [3, 6], 1), 10, dict(rtol=1e-6)),
    ("stepdecay_lrs", lambda: port_optim.step_decay_schedule(1e-3, [3, 6], 1), 10,
     dict(rtol=1e-6)),
    ("cyc_tri", lambda: port_optim.cyclic_schedule(1e-4, 1e-2, 8, mode="triangular"), 40,
     dict(rtol=1e-4, atol=1e-9)),
    ("cyc_tri2", lambda: port_optim.cyclic_schedule(1e-4, 1e-2, 8, mode="triangular2"), 40,
     dict(rtol=1e-4, atol=1e-9)),
    ("cyc_exp", lambda: port_optim.cyclic_schedule(1e-4, 1e-2, 8, mode="exp_range",
                                                   gamma=0.98), 40, dict(rtol=1e-4, atol=1e-9)),
    ("swalr_lrs", lambda: port_ema.swalr_schedule(0.1, 0.05, 0, 5, "cos"), 10,
     dict(rtol=1e-5)),
])
def test_schedules_match_the_executed_reference(key, build, steps, tol):
    s = build()
    np.testing.assert_allclose([float(s(t)) for t in range(steps)], G[key], **tol)


@pytest.mark.parametrize("wd,tag", [(0.0, "wd0"), (0.01, "wd1")])
def test_larc_sgd_momentum_matches_the_executed_reference(wd, tag):
    """LARC (trust 0.02, clip), trace 0.9, lr 0.1 for three steps."""
    params, grads = larc_inputs()
    port = {f"p{i}": p.clone() for i, p in enumerate(params)}
    opt = port_optim.Optimizer("sgd", list(port), port_optim.constant_schedule(0.1), wd=wd,
                               momentum=0.9, use_larc=True, larc_lr=0.1)
    state = opt.init(port)
    for step, g in enumerate(grads):
        opt.step(port, {f"p{i}": t for i, t in enumerate(g)}, state, torch.tensor(step))
    for i in range(len(params)):
        np.testing.assert_allclose(port[f"p{i}"].numpy(), G[f"larc_{tag}_p{i}"], rtol=1e-5,
                                   atol=1e-6)


def test_ema_matches_the_executed_reference_and_the_jax_blend():
    from peft_vit_tpu.engine import ema as jax_ema

    init, steps = ema_inputs()
    state = port_ema.ema_init({"a": init[0], "b": init[1]}, 0.9)
    jstate = jax_ema.ema_init([jnp.asarray(p.numpy()) for p in init], 0.9)
    for sa, sb in steps:
        port_ema.ema_update_(state.shadow, {"a": sa, "b": sb}, state.decay)
        jstate = jax_ema.ema_update(jstate, [jnp.asarray(sa.numpy()), jnp.asarray(sb.numpy())])
    for i, k in enumerate("ab"):
        np.testing.assert_allclose(state.shadow[k].numpy(), G[f"ema_shadow_{k}"], rtol=1e-6)
        np.testing.assert_array_equal(state.shadow[k].numpy(), np.asarray(jstate.shadow[i]))


def test_swa_average_matches_the_jax_average():
    from peft_vit_tpu.engine import ema as jax_ema

    rng = np.random.RandomState(3)
    leaves = [rng.randn(4, 3).astype(np.float32) for _ in range(5)]
    state = port_ema.swa_init({"w": torch.from_numpy(leaves[0])})
    jstate = jax_ema.swa_init([jnp.asarray(leaves[0])])
    for i, leaf in enumerate(leaves[1:]):
        # the device flag off at the third: nothing moves
        port_ema.swa_update_(state, {"w": torch.from_numpy(leaf)}, torch.tensor(i != 2))
        if i == 2:
            continue
        jstate = jax_ema.swa_update(jstate, [jnp.asarray(leaf)])
    assert int(state.count) == int(jstate.count) == 3
    np.testing.assert_allclose(state.average["w"].numpy(), np.asarray(jstate.average[0]),
                               rtol=RTOL, atol=1e-7)
