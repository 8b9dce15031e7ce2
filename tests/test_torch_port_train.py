"""The port's training slice against the JAX package on the CPU: the engine's
pieces (criteria, schedule, padding, accuracy, the SGD update), training-mode
drop-path, ``ln_fp32``, the fp32 master weights, and the slice as a whole:
two epochs of the tiny flagship (width 64, 2 layers, 4 heads, 32 px, channel
BN) through both packages' ``make_epoch_fn`` from the same numpy weights,
data, ``perm``, lr and wd.  Each tolerance is stated where it is used."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from peft_vit_tpu.engine import train as jax_train
from peft_vit_tpu.models import layers as jax_layers
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu.peft import masks as jax_masks
from peft_vit_tpu_torch.engine import train as port_train
from peft_vit_tpu_torch.models import (
    cast_frozen_,
    flagship,
    layers as port_layers,
    load_jax_variables,
    params_to_jax,
)
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.peft import PEFTSpec, build_mask, split_params
from test_torch_port_layers import LORA, _tokens
from test_torch_port_model import REPO, TINY, _images, _jax_flagship, randomize
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

F32 = dict(atol=1e-6, rtol=1e-5)  # the same fp32 formula in both frameworks


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()
            if v is not None}


# ---------------------------------------------------------------- engine pieces


def test_ce_per_example_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    hard = np.array([0, 4, -1, 2, 2, -3])
    soft = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    for target in (hard, soft):
        want = np.asarray(jax_train.ce_per_example(jnp.asarray(logits), jnp.asarray(target)))
        got = port_train.ce_per_example(torch.from_numpy(logits), torch.from_numpy(target)).numpy()
        np.testing.assert_allclose(got, want, **F32)
    got = port_train.ce_per_example(torch.from_numpy(logits), torch.from_numpy(hard)).numpy()
    assert np.isposinf(got[[2, 5]]).all() and np.isfinite(got[[0, 1, 3, 4]]).all()


def test_bce_per_example_matches_jax():
    rng = np.random.RandomState(1)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 4
    target = (rng.uniform(size=(6, 5)) < 0.4)
    want = np.asarray(jax_train.bce_per_example(jnp.asarray(logits), jnp.asarray(target)))
    got = port_train.bce_per_example(torch.from_numpy(logits), torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("schedule", [(), (3, 6), (2, 2, 5)])
def test_step_decay_lr_matches_jax(schedule):
    for epoch in range(8):
        want = np.asarray(jax_train.step_decay_lr(0.03, epoch, schedule))
        got = port_train.step_decay_lr(0.03, epoch, schedule)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,batch", [(10, 4), (8, 4), (3, 8), (1, 1)])
def test_pad_dataset_equals_jax(n, batch):
    rng = np.random.RandomState(n)
    x, y = rng.standard_normal((n, 2, 3)).astype(np.float32), rng.randint(0, 5, n)
    for got, want in zip(port_train.pad_dataset(x, y, batch), jax_train.pad_dataset(x, y, batch)):
        np.testing.assert_array_equal(got, want)


def test_make_array_task_pads_and_needs_cuda_unless_asked_for_cpu(monkeypatch):
    rng = np.random.RandomState(2)
    x, y = rng.standard_normal((10, 4)).astype(np.float32), rng.randint(0, 3, 10)
    task = port_train.make_array_task(x, y, x[:3], y[:3], 4, device="cpu")
    want = jax_train.make_array_task(x, y, x[:3], y[:3], 4)
    for got, ref in zip(task, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert task.x_train.shape == (12, 4) and task.valid_val.tolist() == [True] * 3 + [False]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.make_array_task(x, y, x, y, 4)


def test_masked_accuracy_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.standard_normal((12, 5)).astype(np.float32)
    y = rng.randint(0, 5, 12)
    y[:6] = logits[:6].argmax(1)
    valid = np.arange(12) < 10
    for v in (valid, np.zeros(12, bool)):
        want = float(jax_train.masked_accuracy(jnp.asarray(logits), jnp.asarray(y), jnp.asarray(v)))
        got = float(port_train.masked_accuracy(*(torch.from_numpy(a) for a in (logits, y, v))))
        assert got == pytest.approx(want, abs=1e-5)


@pytest.mark.parametrize("with_lr_scale", [False, True])
@pytest.mark.parametrize("nesterov", [True, False])
def test_sgd_update_matches_jax_and_torch_optim(nesterov, with_lr_scale):
    """Three steps of the same gradients through the JAX ``sgd_update``, the
    port's, and ``torch.optim.SGD`` (one parameter group per leaf for the
    per-leaf lr): fp32, the same formula, 1e-6."""
    rng = np.random.RandomState(4)
    shapes = {"a.weight": (3, 4), "b.bias": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lr, wd, mu = 0.1, 0.01, 0.9
    scale = {"a.weight": 0.1, "b.bias": 1.0} if with_lr_scale else None

    jstate = jax_train.init_cell_state({k: jnp.asarray(v) for k, v in p0.items()})
    state = port_train.init_cell_state({k: torch.from_numpy(v) for k, v in p0.items()})
    leaves = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = torch.optim.SGD(
        [{"params": [leaves[k]], "lr": lr * (scale[k] if scale else 1.0)} for k in leaves],
        lr=lr, momentum=mu, nesterov=nesterov, weight_decay=wd)
    for g in grads:
        jstate = jax_train.sgd_update({k: jnp.asarray(v) for k, v in g.items()}, jstate, lr, wd,
                                      mu, nesterov, scale)
        before = {k: v.clone() for k, v in state.trainable.items()}
        new = port_train.sgd_update({k: torch.from_numpy(v) for k, v in g.items()}, state, lr,
                                    wd, mu, nesterov, scale)
        for k in before:  # functional: the old state is untouched
            torch.testing.assert_close(state.trainable[k], before[k], rtol=0, atol=0)
        state = new
        for k, v in g.items():
            leaves[k].grad = torch.from_numpy(v.copy())
        opt.step()
    assert state.step == 3 == int(jstate.step)
    for k in shapes:
        np.testing.assert_allclose(state.trainable[k].numpy(), np.asarray(jstate.trainable[k]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(state.momentum[k].numpy(), np.asarray(jstate.opt.momentum[k]),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(state.trainable[k].numpy(), leaves[k].detach().numpy(),
                                   atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- the slice as a whole

BATCH, N_REAL, EPOCHS = 4, 10, 2
# LoRA at alpha/rank = 32 on random weights gives gradients of up to ~30 per
# element and steps that amplify a rounding difference about tenfold each at
# lr 1e-3; at 1e-4 the six steps stay in the regime where two frameworks'
# fp32 runs can be held together.
LR, WD = 1e-4, 1e-3


def _task(seed, batch=BATCH, n_real=N_REAL):
    rng = np.random.RandomState(seed)
    x = _images(n_real, seed)
    y = rng.randint(0, TINY["num_classes"], n_real)
    x, y, valid = port_train.pad_dataset(x, y, batch)
    perms = [rng.permutation(len(x)) for _ in range(EPOCHS)]
    return x, y, valid, perms


def _jax_epochs(dtype, variables, x, y, valid, perms, lr=LR, wd=WD, batch=BATCH):
    model = _jax_flagship(use_bn=True, dtype=dtype)
    params, bn = variables["params"], variables["batch_stats"]
    mask = jax_masks.build_mask(params, "lora", num_layers=TINY["layers"])
    trainable, frozen = jax_masks.split_params(params, mask)
    apply_fn = lambda v, xx, train, **kw: model.apply(v, xx, train, **kw)
    epoch_fn = jax.jit(jax_train.make_epoch_fn(apply_fn, jax_train.ce_per_example, batch,
                                               has_bn=True))
    eval_fn = jax.jit(jax_train.make_eval_fn(apply_fn, batch, has_bn=True))
    state = jax_train.init_cell_state(
        jax.tree_util.tree_map(jnp.asarray, trainable), jax.tree_util.tree_map(jnp.asarray, bn))
    frozen = jax.tree_util.tree_map(jnp.asarray, frozen)
    losses = []
    for perm in perms:
        state, loss = epoch_fn(state, frozen, jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid),
                               jnp.asarray(perm), lr, wd)
        losses.append(float(loss))
    logits = eval_fn(state.trainable, frozen, jnp.asarray(x), state.bn)
    return losses, state, np.asarray(logits, np.float32)


def _port_epochs(dtype, variables, x, y, valid, perms, lr=LR, wd=WD, batch=BATCH):
    model = load_jax_variables(
        flagship(**TINY, dtype=dtype, use_bn=True, device="cpu"), variables)
    trainable, frozen = split_params(model, build_mask(model, "lora", num_layers=TINY["layers"]))
    cast_frozen_(model)
    frozen_start = {k: v.detach().clone() for k, v in frozen.items()}
    bn = {k: v for k, v in model.named_buffers()}
    apply_fn = port_train.make_apply_fn(model)
    epoch_fn = port_train.make_epoch_fn(apply_fn, port_train.ce_per_example, batch, has_bn=True)
    eval_fn = port_train.make_eval_fn(apply_fn, batch, has_bn=True)
    state = port_train.init_cell_state(trainable, bn)
    tx, ty, tv = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(valid)
    losses = []
    for perm in perms:
        state, loss = epoch_fn(state, {}, tx, ty, tv, perm, lr, wd)
        losses.append(float(loss))
    logits = eval_fn(state.trainable, frozen, tx, state.bn).float().numpy()  # frozen named
    return losses, state, logits, model, frozen_start


def _close(got, want, rel, what):
    """max |got - want| <= rel * max(1, max |want|)."""
    err, ref = np.abs(np.asarray(got) - np.asarray(want)).max(), np.abs(want).max()
    assert err <= rel * max(1.0, ref), f"{what}: {err:.3e} > {rel:g} * max(1, {ref:.3e})"


def _check_against_jax(port_out, jax_out):
    """Losses, updated leaves and BN statistics at 1e-5: fp32 throughout, the
    same arithmetic with sums in another order (XLA against torch), through
    two layers forward and backward and six SGD steps.  Momentum at 3e-4 of
    its largest element: it holds the raw gradients (up to ~30 here, on
    leaves of ~0.02), which answer to the 3e-7 differences the leaves have
    picked up by the last step at a slope of about 1e3.  Eval logits at the
    serving tests' 1e-4."""
    losses, state, logits, model, frozen_start = port_out
    jlosses, jstate, jlogits = jax_out
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, **tol)
    want = _flat(jstate.trainable)
    got = _flat(params_to_jax(state.trainable)["params"])
    assert set(got) == set(want) and len(got) == 2 * 2 * 2 + 2  # LoRA a1/a2 on q, v; head
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)
    got_mom = _flat(params_to_jax(state.momentum)["params"])
    for path, ref in _flat(jstate.opt.momentum).items():
        _close(got_mom[path], ref, 3e-4, "momentum " + path)
    got_bn = _flat(params_to_jax(state.bn)["batch_stats"])
    for path, ref in _flat(jstate.bn).items():
        np.testing.assert_allclose(got_bn[path], ref, err_msg="bn " + path, **tol)
    assert state.step == EPOCHS * 3 == int(jstate.step)
    # the frozen leaves and the module's own trainable leaves and statistics are untouched
    for name, p in model.named_parameters():
        if name in frozen_start:
            assert torch.equal(p, frozen_start[name]), name
    for t in (*state.trainable.values(), *state.momentum.values(), *state.bn.values()):
        assert t.dtype == torch.float32
    np.testing.assert_allclose(logits, jlogits, atol=1e-4, rtol=1e-4)


def test_two_epochs_match_jax_fp32():
    """fp32 throughout; tolerances in ``_check_against_jax``."""
    variables = randomize(_jax_flagship(True).init(jax.random.PRNGKey(0),
                                                   jnp.asarray(_images(1, 0))), seed=5)
    task = _task(seed=6)
    jax_out = _jax_epochs(jnp.float32, variables, *task)
    port_out = _port_epochs(torch.float32, variables, *task)
    _check_against_jax(port_out, jax_out)
    # the steps did something: every trainable leaf moved
    start = _lora_start(variables)
    got = _flat(params_to_jax(port_out[1].trainable)["params"])
    for path in got:
        assert np.abs(got[path] - start[path]).max() > 1e-5, path


def _cos(a, b):
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


# The bf16 cases run at the flagship's batch of 16 (40 images, 3 batches an
# epoch).  At a batch of 4, train-mode BN divides by the spread of 4 rows and
# carries a bf16 rounding difference into a leaf's update tenfold: there two
# bf16 runs of the JAX package itself (bf16 against fp32) stand 0.1-0.8 of
# the largest element apart, and no bound set from that holds a port to much.
BF16_BATCH, BF16_N_REAL = 16, 40


def _hold_bf16_updates(got, want, start, what):
    """The port's bf16-compute update of every leaf against a JAX run's.  Both
    round every matmul output and residual add to bf16 (2^-9 relative), the
    JAX package through XLA's CPU compiler, which drops some of the roundings
    inside a fused chain, so the two do not agree bit for bit.  Measured at
    batch 16 over four seeds, one and six steps: the port stands at most
    0.045 of a leaf's largest update from JAX's bf16 run and 0.088 from its
    fp32 run, at cosines of at least 0.9990 and 0.9979; JAX's bf16 run stands
    up to 0.090 from its own fp32 run.  Held at 0.15 and 0.995."""
    for path in want:
        du, dw = got[path] - start[path], want[path] - start[path]
        assert np.abs(du - dw).max() <= 0.15 * np.abs(dw).max(), (what, path)
        assert _cos(du, dw) >= 0.995, (what, path)


def _lora_start(variables):
    return _flat(jax_masks.split_params(
        variables["params"], jax_masks.build_mask(variables["params"], "lora", 2))[0])


def test_two_epochs_match_jax_bf16_compute_fp32_params():
    """bf16 compute, fp32 parameters, gradients and momentum, held to the JAX
    package's run in the same setting (``dtype=bfloat16``, fp32
    ``param_dtype``) and, as a second witness, to its fp32 run: losses at 5e-3
    relative (1.9e-3 measured), updates as ``_hold_bf16_updates`` states, eval
    logits at 0.03 of the largest logit (0.015 measured)."""
    variables = randomize(_jax_flagship(True).init(jax.random.PRNGKey(0),
                                                   jnp.asarray(_images(1, 0))), seed=7)
    task = _task(seed=8, batch=BF16_BATCH, n_real=BF16_N_REAL)
    losses, state, logits, model, frozen_start = _port_epochs(
        torch.bfloat16, variables, *task, batch=BF16_BATCH)
    got, start = _flat(params_to_jax(state.trainable)["params"]), _lora_start(variables)
    for what, jdtype in (("JAX bf16", jnp.bfloat16), ("JAX fp32", jnp.float32)):
        jlosses, jstate, jlogits = _jax_epochs(jdtype, variables, *task, batch=BF16_BATCH)
        assert all(v.dtype == jnp.float32 for v in jax.tree_util.tree_leaves(
            (jstate.trainable, jstate.opt.momentum)))
        np.testing.assert_allclose(losses, jlosses, rtol=5e-3, err_msg=what)
        _hold_bf16_updates(got, _flat(jstate.trainable), start, what)
        assert np.abs(logits - jlogits).max() <= 0.03 * np.abs(jlogits).max(), what
    assert state.step == EPOCHS * 3
    for t in (*state.trainable.values(), *state.momentum.values()):
        assert t.dtype == torch.float32
    frozen_dtypes = {p.dtype for n, p in model.named_parameters() if n in frozen_start}
    assert frozen_dtypes == {torch.bfloat16, torch.float32}  # LayerNorm leaves stay fp32
    for name, p in model.named_parameters():
        if name in frozen_start:
            assert torch.equal(p, frozen_start[name]), name


def test_two_epochs_through_the_flash_attention_function(monkeypatch):
    """The port's attention routed through the ``flash_attention`` Function
    (on the CPU: the kernels' plain forward and backward) takes the same
    steps as the JAX package."""
    from peft_vit_tpu_torch.ops.attention import flash_attention

    calls = []

    def through_function(q, k, v, bias=None, scale=None, **kw):
        calls.append(q.requires_grad)
        return flash_attention(q, k, v, bias, scale)

    monkeypatch.setattr(port_layers, "multi_head_attention", through_function)
    variables = randomize(_jax_flagship(True).init(jax.random.PRNGKey(0),
                                                   jnp.asarray(_images(1, 0))), seed=5)
    task = _task(seed=6)
    port_out = _port_epochs(torch.float32, variables, *task)
    assert calls and any(calls)
    jax_out = _jax_epochs(jnp.float32, variables, *task)
    _check_against_jax(port_out, jax_out)


# ---------------------------------------------------------------- fp32 master weights


def test_bf16_model_trains_fp32_masters_where_a_bf16_weight_would_not_move():
    """One SGD step at lr 1e-5 on the bf16 tiny flagship.  The update of each
    head weight is far below a bf16 step of the weight, so a weight stored in
    bf16 (what the port did before it kept fp32 masters) stays where it was;
    the fp32 master moves, and by what the JAX step with fp32 parameters
    (bf16 compute) moves it, with its fp32 step as a second witness (tolerance
    of ``_hold_bf16_updates``)."""
    variables = randomize(_jax_flagship(True).init(jax.random.PRNGKey(0),
                                                   jnp.asarray(_images(1, 0))), seed=9)
    x, y, valid, _ = _task(seed=10, batch=BF16_BATCH, n_real=BF16_N_REAL)
    task = x[:BF16_BATCH], y[:BF16_BATCH], valid[:BF16_BATCH], [np.arange(BF16_BATCH)]
    kw = dict(lr=1e-5, wd=0.0, batch=BF16_BATCH)
    _, state, _, model, _ = _port_epochs(torch.bfloat16, variables, *task, **kw)

    name = "classifier.head.weight"
    old = torch.from_numpy(variables["params"]["classifier"]["head"]["kernel"].T.copy())
    new = state.trainable[name]
    assert new.dtype == state.momentum[name].dtype == torch.float32
    assert model.get_parameter(name).dtype == torch.float32
    update = new - old
    moved = (update != 0).float().mean().item()
    assert moved > 0.99, moved
    # the same update applied to a bf16-stored weight is lost to rounding
    stored = old.to(torch.bfloat16)
    lost = ((stored.float() + update).to(torch.bfloat16) == stored).float().mean().item()
    assert lost > 0.95, lost
    assert update.abs().max() < 0.5 * 2.0**-8 * old.abs().median()
    got, start = _flat(params_to_jax(state.trainable)["params"]), _lora_start(variables)
    for what, jdtype in (("JAX bf16", jnp.bfloat16), ("JAX fp32", jnp.float32)):
        _, jstate, _ = _jax_epochs(jdtype, variables, *task, **kw)
        _hold_bf16_updates(got, _flat(jstate.trainable), start, what)


def test_dense_casts_at_use_and_cast_frozen_keeps_trainable_fp32():
    dense = port_layers.Dense(8, 4, dtype=torch.bfloat16)
    assert dense.weight.dtype == dense.bias.dtype == torch.float32
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    y = dense(x)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(
        y, torch.nn.functional.linear(x.bfloat16(), dense.weight.bfloat16(), dense.bias.bfloat16()),
        rtol=0, atol=0)
    (g,) = torch.autograd.grad(y.float().sum(), dense.weight)
    assert g.dtype == torch.float32
    dense.bias.requires_grad_(False)
    cast_frozen_(dense)
    assert dense.weight.dtype == torch.float32 and dense.bias.dtype == torch.bfloat16
    torch.testing.assert_close(dense(x), y, rtol=0, atol=0)


# ---------------------------------------------------------------- drop_path, ln_fp32


def _block(rate, seed=None):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return port_layers.Block(64, 4, act="quick_gelu", spec=PEFTSpec(**LORA), drop_path=rate,
                             generator=gen)


def test_drop_path_is_the_identity_at_rate_0_and_in_eval():
    x = torch.from_numpy(_tokens(0, b=8))
    block = _block(0.5, seed=1)
    reference = _block(0.0)
    reference.load_state_dict(block.state_dict())
    with torch.no_grad():
        want = reference.eval()(x)
        torch.testing.assert_close(block.eval()(x), want, rtol=0, atol=0)
        torch.testing.assert_close(reference.train()(x), want, rtol=0, atol=0)


def test_drop_path_keeps_or_drops_whole_samples_and_follows_the_generator():
    x = torch.from_numpy(_tokens(1, b=64))
    block = _block(0.5, seed=2).train()
    branch = torch.ones(64, 5, 64)
    out = block._drop_path(branch)
    per_sample = out.reshape(64, -1)
    kept = per_sample[:, 0] != 0
    assert 8 < int(kept.sum()) < 56  # Bernoulli(0.5) over 64 samples
    torch.testing.assert_close(per_sample[kept], torch.full_like(per_sample[kept], 2.0))
    assert (per_sample[~kept] == 0).all()
    block.generator.manual_seed(2)
    torch.testing.assert_close(block._drop_path(branch), out, rtol=0, atol=0)
    # whole forward: the same seed gives the same output, another seed another
    with torch.no_grad():
        block.generator.manual_seed(3)
        a = block(x)
        block.generator.manual_seed(3)
        b = block(x)
        block.generator.manual_seed(4)
        c = block(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        _block(0.5).train()(x)


def test_vision_transformer_drop_path_schedule():
    vit = VisionTransformer(image_size=32, patch_size=16, width=64, layers=4, heads=4,
                            drop_path_rate=0.3, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose([b.drop_path for b in vit.blocks], np.linspace(0.0, 0.3, 4))
    assert all(b.drop_path == 0.0 for b in VisionTransformer(
        image_size=32, patch_size=16, width=64, layers=2, heads=4).blocks)


@pytest.mark.parametrize("ln_fp32", [True, False])
def test_block_ln_fp32_matches_jax_in_bf16(ln_fp32):
    """bf16 activations: with ``ln_fp32=False`` the LayerNorms normalize in
    bf16.  Both sides round every matmul and the LayerNorm result to bf16:
    3e-2 of the output's largest value."""
    x = _tokens(11)
    jblock = jax_layers.Block(64, 4, act="quick_gelu", spec=JaxSpec(**LORA), use_flash=False,
                              ln_fp32=ln_fp32, dtype=jnp.bfloat16)
    variables = randomize(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=12)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x, jnp.bfloat16)), np.float32)
    block = port_layers.Block(64, 4, act="quick_gelu", spec=PEFTSpec(**LORA), ln_fp32=ln_fp32,
                              dtype=torch.bfloat16)
    assert block.ln_1.compute_fp32 == block.ln_2.compute_fp32 == ln_fp32
    load_jax_variables(block, variables).eval()
    with torch.no_grad():
        got = block(torch.from_numpy(x).bfloat16()).float().numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_flagship_threads_ln_fp32():
    model = flagship(**TINY, ln_fp32=False, device="cpu")
    norms = [m for m in model.modules() if isinstance(m, port_layers.LayerNorm)]
    assert len(norms) == 2 * TINY["layers"] + 2 and not any(m.compute_fp32 for m in norms)


# ---------------------------------------------------------------- bench_torch guards


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300, **kw)


def test_bench_torch_on_the_cpu_prints_one_json_line_and_imports_nothing_of_jax():
    code = (
        "import sys, bench_torch\n"
        "rc = bench_torch.main(['--device', 'cpu', '--tiny', '--batch', '2', '--k-chain', '2',"
        " '--windows', '2', '--warmup', '1'])\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0].startswith('jax')"
        " or n.split('.')[0] in ('flax', 'optax') or n.split('.')[0] == 'peft_vit_tpu')\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline"}
    assert out["vs_baseline"] is None and out["value"] > 0
    assert "vitb16" not in out["metric"] and "cpu" in out["unit"]  # a rehearsal says so


def test_bench_torch_needs_cuda_unless_asked_for_cpu_and_has_no_int8_yet(monkeypatch):
    import bench_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.main(["--tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.main(["--tiny", "--int8"])
    # the int8 cases are ported: their flags are arguments, and --int8 gates the others
    for flag in ("--bwd-dx", "--static-act"):
        with pytest.raises(SystemExit):
            bench_torch.main(["--device", "cpu", "--tiny", flag])


@pytest.mark.parametrize("flags", [("--int8",), ("--int8", "--bwd-dx"),
                                   ("--int8", "--bwd-dx", "--static-act", "--patch-gemm")],
                         ids=lambda f: "".join(f))
def test_bench_torch_int8_cases_run_on_the_cpu(flags, capsys):
    """The int8 cases of the benchmark at the tiny size: one JSON line with the
    benchmark's keys, named as a rehearsal."""
    import bench_torch

    rc = bench_torch.main(["--device", "cpu", "--tiny", "--batch", "2", "--k-chain", "2",
                           "--windows", "1", "--warmup", "1", *flags])
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline"} and out["value"] > 0
    assert "vitb16" not in out["metric"] and "cpu" in out["unit"]
    assert f"int8=True dx={'--bwd-dx' in flags} static={'--static-act' in flags}" in captured.err
