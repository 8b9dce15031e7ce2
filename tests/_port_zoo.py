"""What the port's tests of the zoo's other CNNs (EfficientNet, ReXNet,
HRNet, TTNet) share: a tower held against its JAX module on the same
numpy-drawn variables (forward, new BatchNorm statistics, every gradient),
a round of 3 cells against its cells one at a time, the full-shot Trainer's
epochs against the JAX Trainer, and the JAX builders' flax init traced and
drawn from a seed (``traced_init``).

Tolerances: the module's outputs, statistics and gradients within ``TOL``
of the largest reference value in fp32 (the same arithmetic summed in other
orders; ``test_torch_port_resnet``'s bound), ``TOL_F64`` in float64; the
trainer's epoch losses within 1e-4 relative, its leaves within 1e-4
relative + 1e-5, its BN statistics within 1e-4 of the largest of their kind
(mean or variance) over the tower; a float64 round against its cells within
``RTOL_F64``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_port_resnet import _close, _randomize

TOL = 1e-4  # of the largest reference value
TOL_F64 = 1e-8  # the same in float64 (flax's one-pass variance against the port's two)
RTOL_F64 = 1e-9  # a float64 round against its cells, of each state part's largest value


def jax_reference(jm, x: np.ndarray, seed: int = 7, float64: bool = False):
    """The JAX module ``jm``'s variables drawn from ``RandomState(seed)``
    (``test_torch_port_resnet._randomize``) and, in one compiled program,
    its eval and train forwards, the train forward's new ``batch_stats``
    and the gradients of ``sum(out * cot)`` for the parameters and the
    input; ``float64`` (``jm`` built with a float64 dtype) runs it all in
    float64 under ``jax.enable_x64``.  Returns ``(variables,
    cot, {train: (out, new, (g_params, g_x))})``, float64 with ``float64``."""
    dt = np.float64 if float64 else np.float32
    with jax.enable_x64(float64):
        x = x.astype(dt)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                           _randomize(dict(shapes), seed))
        stats = variables.get("batch_stats", {})
        out_shape = jax.eval_shape(lambda: jm.apply(variables, jnp.asarray(x), True)).shape
        cot = np.random.RandomState(3).standard_normal(out_shape).astype(dt)

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
        return jax.tree_util.tree_map(np.asarray, variables), cot, want


def _state(tree, dtype, collection: str = "params"):
    """``params_from_jax`` of one collection, keeping float64 leaves float64
    (``params_from_jax`` gives fp32, as the port stores its weights)."""
    from peft_vit_tpu_torch.models.convert import _leaves, _torch_name_and_array

    out = {}
    for path, leaf in _leaves(tree):
        if collection == "batch_stats" and path[-1] in ("mean", "var"):
            path = (*path[:-1], "bn_" + path[-1])
        name, arr = _torch_name_and_array(path, np.asarray(leaf, dtype=dtype))
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def hold_against_jax(pm, variables, x, cot, want, train: bool, what: str,
                     tol: float = TOL) -> None:
    """The port's tower ``pm`` (its weights loaded from ``variables``) on
    ``x``: the forward, every gradient and, in train mode, the new BN
    statistics against ``jax_reference``'s, within ``tol`` of the largest
    reference value; in eval mode no statistic moves.  With a float64
    reference, ``pm`` computes in float64 (``_as_float64``)."""
    if x.dtype == np.float64:
        pm = _as_float64(pm)
    pm.load_state_dict({**_state(variables["params"], x.dtype),
                        **_state(variables.get("batch_stats", {}), x.dtype, "batch_stats")},
                       strict=True)
    out, new, (g_p, g_x) = want[train]
    buffers = {k: v.clone() for k, v in pm.named_buffers()}
    xt = torch.from_numpy(x).requires_grad_()
    pm.zero_grad(set_to_none=True)
    pm.train(train)
    got = torch.func.functional_call(pm, buffers, (xt,))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, out, f"{what} forward", tol)
    _close(xt.grad, g_x, f"{what} input gradient", tol)
    grads = _state(g_p, x.dtype)
    # a bias just before a train-mode BN has an analytically zero gradient
    # that both compute as rounding noise: a leaf's scale is at least 1e-2
    # of the largest gradient of any leaf
    floor = 1e-2 * max(float(g.abs().max()) for g in grads.values())
    assert set(grads) == {k for k, _ in pm.named_parameters()}
    for name, p in pm.named_parameters():
        _close(torch.zeros_like(p) if p.grad is None else p.grad, grads[name].numpy(),
               f"{what} {name} gradient", tol, floor=floor)
    if train:
        want_stats = _state(new["batch_stats"], x.dtype, "batch_stats")
        assert set(want_stats) == set(buffers) and buffers
        for name, t in buffers.items():
            _close(t, want_stats[name].numpy(), f"{what} {name}", tol)
    else:
        for name, t in buffers.items():
            assert torch.equal(t, dict(pm.named_buffers())[name]), name


@contextlib.contextmanager
def traced_init():
    """Within, flax's ``Module.init`` is traced, not run: every leaf of the
    tree it would return drawn by ``test_torch_port_resnet._randomize`` from
    a seed of the key it is given (0 for a key under a trace).  The JAX
    builders and the JAX driver's cells' fresh trainables (each a
    whole-model init, which takes tens of seconds op by op on these towers
    and as long compiled) then cost a trace; the port is given the same
    tree, so the two packages start equal."""
    import flax.linen as fnn

    eager = fnn.Module.init

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(lambda r, *a: eager(self, r, *a, **kwargs), rngs, *args)
        key = rngs["params"] if isinstance(rngs, dict) else rngs
        if isinstance(key, jax.core.Tracer):  # the JAX driver's jitted fresh trainables
            seed = 0
        else:
            seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1]) % (2 ** 31)
        return _randomize(dict(shapes), seed)

    fnn.Module.init = init
    try:
        yield
    finally:
        fnn.Module.init = eager


@pytest.fixture
def jax_traced_init():
    """``traced_init`` through the test."""
    with traced_init():
        yield


def _as_float64(model):
    """``model`` computing in float64 (``chip_smoke._as_float64``): every
    module's compute dtype, its parameters and its statistics."""
    for m in model.modules():
        for attr in ("compute_dtype", "dtype"):
            if isinstance(getattr(m, attr, None), torch.dtype):
                setattr(m, attr, torch.float64)
    return model.double()


def round_against_cells(model, method: str, image: int, classes: int = 5, batch: int = 8):
    """A round of 3 cells of ``method`` on ``model`` (its BN in train mode,
    the statistics per cell; a per-cell conv weight a grouped conv of the
    cells' channels) against the same cells trained one by one, in float64:
    at random weights the BN biases' gradients are rounding noise, which
    fp32 trains chaotically, so the round is held in float64, each state
    part (trainables, momentum, statistics) and the eval logits within
    ``RTOL_F64`` of the part's largest value."""
    from peft_vit_tpu_torch.engine import (ce_per_example, init_cell_state, make_apply_fn,
                                           make_array_task, make_epoch_fn, make_eval_fn,
                                           step_decay_lr)
    from peft_vit_tpu_torch.peft import build_mask, split_params
    from test_torch_port_cells import EPOCHS, WDS
    from test_torch_port_peft_rounds import LRS

    cells = 3
    rng = np.random.RandomState(0)
    model = _as_float64(model)
    mask = build_mask(model, method, num_layers=12)
    trainable, _ = split_params(model, mask)
    draws = [{k: v.detach() + torch.from_numpy(0.02 * np.random.RandomState(10 + i)
                                               .standard_normal(v.shape))
              for k, v in trainable.items()} for i in range(cells)]
    bn0 = {k: v.clone() for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    assert bn0
    apply_fn = make_apply_fn(model)
    x = rng.standard_normal((14, image, image, 3)).astype(np.float32)
    y = rng.randint(0, classes, 14)
    task = make_array_task(x, y, x[:6], y[:6], batch, device="cpu")
    perms = [np.random.RandomState(3 + e).permutation(task.x_train.shape[0])
             for e in range(EPOCHS)]
    one = make_epoch_fn(apply_fn, ce_per_example, batch, has_bn=True)
    many = make_epoch_fn(apply_fn, ce_per_example, batch, has_bn=True, cells=True)
    args = (task.x_train, task.y_train, task.valid_train)
    state = init_cell_state({k: torch.stack([d[k] for d in draws]) for k in draws[0]},
                            {k: v.expand(cells, *v.shape) for k, v in bn0.items()})
    for e, perm in enumerate(perms):
        state, losses = many(state, {}, *args, perm, step_decay_lr(LRS, e, ()),
                             torch.tensor(WDS))
    logits = make_eval_fn(apply_fn, batch, has_bn=True, cells=True)(state.trainable, {},
                                                                     task.x_val, state.bn)
    eval_one = make_eval_fn(apply_fn, batch, has_bn=True)
    for i in range(cells):
        alone = init_cell_state(draws[i], bn0)
        for e, perm in enumerate(perms):
            alone, loss = one(alone, {}, *args, perm, step_decay_lr(LRS[i], e, ()), WDS[i])
        torch.testing.assert_close(losses[i].double(), loss.double(), rtol=RTOL_F64, atol=0)
        for part in ("trainable", "momentum", "bn"):
            leaves = getattr(alone, part)
            scale = max(float(v.abs().max()) for v in leaves.values())
            for k, v in leaves.items():
                diff = float((getattr(state, part)[k][i] - v).abs().max())
                assert diff <= RTOL_F64 * scale, (part, k, i, diff, scale)
        want = eval_one(alone.trainable, {}, task.x_val, alone.bn)
        torch.testing.assert_close(logits[i], want, rtol=0,
                                   atol=RTOL_F64 * float(want.abs().max()))


def trainer_against_jax(over: dict, image: int, epochs: int = 1, method: str = "full",
                        update_bn: bool = False) -> None:
    """The full-shot Trainer on the config ``over`` through both packages'
    builders (the JAX weights loaded into the port): ``epochs`` epochs (SGD,
    warmup-cosine, every BN in train mode, the statistics carried) against
    the JAX Trainer, the eval top-1, the statistics, and with ``update_bn``
    (the JAX one runs eagerly: seconds) ``update_bn``."""
    from peft_vit_tpu import config as jax_config
    from peft_vit_tpu.engine.trainer import Trainer as JaxTrainer
    from peft_vit_tpu.engine.trainer import batch_iterator as jax_batches
    from peft_vit_tpu.models.factory import build_image_classifier as jax_build
    from peft_vit_tpu.peft import build_mask as jax_mask
    from peft_vit_tpu.peft.spec import spec_from_config as jax_spec_from
    from peft_vit_tpu_torch.engine.trainer import Trainer, batch_iterator
    from peft_vit_tpu_torch.models import build_image_classifier, load_jax_variables
    from peft_vit_tpu_torch.peft import build_mask, spec_from_config
    from test_torch_port_trainer import _data, _flat, _port_flat, make_cfg

    over = {"TRAIN.IMAGE_SIZE": [image, image], "TRAIN.LR": 1e-4, "TRAIN.MOMENTUM": 0.9,
            **over}
    x, y = _data(n_per_class=8)
    rep = image // x.shape[1]
    x = np.repeat(np.repeat(x, rep, axis=1), rep, axis=2)
    jcfg, pcfg = make_cfg(jax_config.get_default_config, **over), make_cfg(**over)
    with traced_init():
        jmodel, variables, _ = jax_build(jcfg, jax_spec_from(jcfg), 4)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    stats = variables["batch_stats"]
    jt = JaxTrainer(jcfg, jmodel, variables["params"],
                    jax_mask(variables["params"], method, num_layers=12), steps_per_epoch=4,
                    batch_stats=stats)
    model, _, _ = build_image_classifier(pcfg, spec_from_config(pcfg), 4, device="cpu")
    load_jax_variables(model, variables)
    pt = Trainer(pcfg, model, build_mask(model, method, num_layers=12), 4)
    assert pt.has_bn
    for e in range(epochs):
        want = jt.train_one_epoch(jax_batches(x, y, 8, seed=e), epoch=e)["loss"]
        got = pt.train_one_epoch(batch_iterator(x, y, 8, seed=e), epoch=e)["loss"]
        assert got == pytest.approx(want, rel=1e-4)
    want = _flat(jt.state.trainable)
    for k, v in _port_flat(pt.state.trainable).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    kw = dict(shuffle=False, drop_last=False)
    assert pt.evaluate(batch_iterator(x, y, 8, **kw)) == jt.evaluate(jax_batches(x, y, 8, **kw))

    def hold(got, want):
        # each statistic within 1e-4 of the largest of its kind over the
        # tower: a mean after a BN and a bias-free conv is the conv of the
        # BN's bias, near zero at these steps, and rounding-dominated
        want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(want, sep="/").items()}
        got = _port_flat(got, "batch_stats")
        assert set(got) == set(want)
        scale = {kind: max(np.abs(v).max() for k, v in want.items() if k.endswith(kind))
                 for kind in ("mean", "var")}
        for k, v in got.items():
            np.testing.assert_allclose(v, want[k], rtol=0,
                                       atol=1e-4 * scale[k.rsplit("/", 1)[-1]], err_msg=k)

    hold(pt.state.batch_stats, jt.state.batch_stats)
    if update_bn:
        batches = list(batch_iterator(x, y, 8, shuffle=False))
        hold(pt.update_bn(iter(batches)), jt.update_bn(iter(batches)))
