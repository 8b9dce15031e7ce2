"""The port's data parallelism against the JAX package on the CPU: the mesh
and its refusals, the tensor-parallel and ZeRO-1 rules against the JAX
specs; then, in 2 spawned gloo processes (``_port_dist``), against JAX on a
mesh of the same data degree (2 of the 8 virtual CPU devices): two sharded
SGD steps of the tiny LoRA flagship, replicated and ZeRO-1, the eval step,
``gather_features``' forward and gradient (JAX's test_gather_features_grad),
the mean reductions and the host gathers, ragged shards included."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util
from jax.sharding import NamedSharding

from peft_vit_tpu.engine import ce_per_example as jax_ce, init_cell_state as jax_init_state
from peft_vit_tpu.models import ImageClassifier as JaxImageClassifier
from peft_vit_tpu.models import VisionTransformer as JaxVisionTransformer
from peft_vit_tpu.parallel import make_mesh as jax_make_mesh
from peft_vit_tpu.parallel import make_sharded_eval_step as jax_eval_step
from peft_vit_tpu.parallel import make_sharded_train_step as jax_train_step
from peft_vit_tpu.parallel import mesh as jax_mesh
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu.peft import build_mask as jax_build_mask
from peft_vit_tpu.peft import split_params as jax_split
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch import parallel
from peft_vit_tpu_torch.models import flagship, params_to_jax
from peft_vit_tpu_torch.models.convert import jax_path
from peft_vit_tpu_torch.parallel import mesh as port_mesh
from peft_vit_tpu_torch.utils import dist as port_dist

import _port_dist
from test_torch_port_model import randomize

# two fp32 runs of the same SGD steps, the gradients summed in another order
# (a 2-way all-reduce against GSPMD's): the JAX ZeRO-1 test's own bound
TOL_STEP = dict(rtol=1e-5, atol=1e-6)
TOL_LOGITS = dict(rtol=1e-5, atol=1e-5)  # one fp32 forward in each framework
WORLD = 2
BATCH = 16
LR, WD, STEPS = 1e-2, 1e-4, 2


def _jax_model():
    spec = JaxSpec(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
                   lora_post_scale_q=True)
    t = _port_dist.TINY_DP
    vit = JaxVisionTransformer(image_size=t["image"], patch_size=t["patch"], width=t["width"],
                               layers=t["layers"], heads=t["heads"], style="clip",
                               output_dim=512, spec=spec, use_flash=False)
    return JaxImageClassifier(backbone=vit, num_classes=t["num_classes"])


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    t = _port_dist.TINY_DP
    x = rng.standard_normal((BATCH, t["image"], t["image"], 3)).astype(np.float32)
    y = (np.arange(BATCH) % t["num_classes"]).astype(np.int64)
    model = _jax_model()
    variables = randomize(model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1])), 3)
    return model, variables, x, y


@pytest.fixture(scope="module")
def spawned(data, tmp_path_factory):
    _, variables, x, y = data
    np_vars = jax.tree_util.tree_map(np.asarray, variables)
    return _port_dist.spawn(_port_dist.sharded_steps, WORLD, tmp_path_factory.mktemp("dp"),
                            np_vars, x, y, LR, WD, STEPS)


@pytest.fixture(scope="module")
def jax_runs(data):
    model, variables, x, y = data
    mesh = jax_make_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])
    params = variables["params"]
    mask = jax_build_mask(params, "lora", num_layers=_port_dist.TINY_DP["layers"])
    trainable, frozen = jax_split(params, mask)
    apply_fn = lambda v, xx, t: model.apply(v, xx, t)  # noqa: E731
    out = {}
    for zero1 in (False, True):
        step, place = jax_train_step(apply_fn, jax_ce, mesh, zero1=zero1, donate=False)
        state, frozen_p = place(jax_init_state(trainable), frozen)
        if zero1:
            out["sharded"] = {
                "/".join(p): ("data" in str(b.sharding.spec))
                for p, b in traverse_util.flatten_dict(state.opt.momentum).items()
                if b is not None and isinstance(b.sharding, NamedSharding)}
        losses = []
        for _ in range(STEPS):
            state, loss = step(state, frozen_p, jnp.asarray(x), jnp.asarray(y),
                               jnp.float32(LR), jnp.float32(WD))
            losses.append(float(loss))
        out[zero1] = ({k: np.asarray(v) for k, v in traverse_util.flatten_dict(
            state.trainable, sep="/").items() if v is not None}, losses)
    out["logits"] = np.asarray(jax_eval_step(apply_fn, mesh)(trainable, frozen, jnp.asarray(x)))
    return out


def test_mesh_over_one_process_and_refusals():
    assert not port_dist.group_initialized()
    assert port_dist.init_distributed() == (0, 1)
    assert (port_dist.rank(), port_dist.world_size(), port_dist.is_main_process()) == (0, 1, True)
    port_dist.barrier()
    mesh = parallel.make_mesh()
    assert tuple(mesh) == (1, 1, 1, 0) and mesh.shape == {"data": 1, "model": 1}
    assert parallel.batch_rows(mesh, 8) == slice(0, 8)
    # a model or pipe degree builds where the group has the ranks for it
    # (tests/test_torch_port_tensor_parallel.py, test_torch_port_pipeline.py);
    # sequence parallelism changes no axis, as in the JAX mesh_from_config
    with pytest.raises(ValueError, match="mesh of 0 x 2 x 1 over 1"):
        parallel.make_mesh(model=2)
    with pytest.raises(ValueError, match="mesh of 0 x 1 x 2 over 1"):
        parallel.make_mesh(pipe=2)
    cfg = port_config.get_default_config()
    cfg.TPU.SEQUENCE_PARALLEL = True
    mesh = parallel.mesh_from_config(cfg)
    assert tuple(mesh) == (1, 1, 1, 0) and (mesh.model_rank, mesh.pipe_rank) == (0, 0)
    assert mesh.model_group is None and mesh.pipe_group is None
    with pytest.raises(ValueError, match="mesh of 2"):
        parallel.make_mesh(data=2)
    with pytest.raises(ValueError, match="rendezvous"):
        port_dist.init_distributed(num_processes=2)
    # the batch split of rank 1 of 2: rows [8, 16), the JAX batch_sharding's order
    two = port_mesh.Mesh(2, rank=1)
    x = torch.arange(16)
    assert torch.equal(parallel.shard_batch(two, x), x[8:])
    with pytest.raises(ValueError, match="does not split"):
        parallel.batch_rows(two, 15)


def test_partition_and_zero_rules_match_the_jax_specs(data):
    """Every leaf of the tiny LoRA flagship (and a few shapes that do not
    split): the tensor-parallel spec, in the port's layout, is the JAX
    kernel's spec transposed; the ZeRO-1 dim of a shape is the JAX one's."""
    _, variables, _, _ = data
    model = flagship(**_port_dist.TINY_DP, dtype=torch.float32, device="cpu")
    jax_mesh8 = jax_make_mesh(data=8, model=1)
    state = model.state_dict()
    seen = set()
    for name, t in state.items():
        shape = tuple(t.shape)
        path = jax_path(name, t.dim())
        kernel = name.endswith(".weight") and t.dim() == 2  # (out, in): the kernel's transpose
        want = tuple(jax_mesh.param_partition_spec(path, shape[::-1] if kernel else shape))
        got = parallel.param_partition_spec(name, shape)
        assert (got[::-1] if kernel else got) == want, name
        seen.add(want)
    assert ((None, "model") in seen) and (("model", None) in seen) and (() in seen)
    for shape in [(64,), (5,), (5, 3), (4, 6, 6), (7, 8), (8, 8), (1,), (3, 16, 5)]:
        for ndata, mesh in ((2, jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])),
                            (8, jax_mesh8)):
            want = tuple(jax_mesh._zero_leaf_sharding(mesh, np.zeros(shape)).spec)
            want = want + (None,) * (len(shape) - len(want)) if want else ()
            assert parallel.zero_partition_spec(shape, ndata) == want, (shape, ndata)
    assert parallel.zero_dim((4, 6, 6), 2) == 1 and parallel.zero_dim((5, 3), 2) is None


@pytest.mark.parametrize("zero1", [False, True])
def test_sharded_steps_match_jax(spawned, jax_runs, zero1):
    """Two SGD steps on 2 processes against the JAX step on a 2-device mesh:
    every trainable leaf and each step's loss (the group's mean), on both
    ranks; under ZeRO-1 each rank holds half of every momentum buffer whose
    JAX sharding splits it, and the whole of the others."""
    want_leaves, want_losses = jax_runs[zero1]
    for rank, out in enumerate(spawned):
        assert out["mesh"] == (WORLD, 1, 1, rank)
        np.testing.assert_allclose(out[f"losses_{zero1}"], want_losses, **TOL_STEP)
        got = params_to_jax({k: torch.from_numpy(v) for k, v in out[f"trainable_{zero1}"].items()})
        got = traverse_util.flatten_dict(got["params"], sep="/")
        assert set(got) == set(want_leaves)
        for k, v in want_leaves.items():
            np.testing.assert_allclose(got[k], v, **TOL_STEP, err_msg=k)
        if zero1:
            shapes = out["momentum_shapes_True"]
            full = {k: tuple(v.shape) for k, v in out["trainable_False"].items()}
            for name, shape in shapes.items():
                split = jax_runs["sharded"][jax_path(name, len(shape))]
                assert (np.prod(shape) * (WORLD if split else 1)) == np.prod(full[name]), name
            assert any(jax_runs["sharded"].values()) and not all(jax_runs["sharded"].values())


def test_replicated_and_zero1_runs_agree(spawned):
    """ZeRO-1 is numerically the replicated step (the JAX
    test_zero1_optimizer_sharding_matches, in the port)."""
    for out in spawned:
        np.testing.assert_allclose(out["losses_True"], out["losses_False"], **TOL_STEP)
        for k, v in out["trainable_False"].items():
            np.testing.assert_allclose(out["trainable_True"][k], v, **TOL_STEP, err_msg=k)


def test_sharded_eval_step_matches_jax(spawned, jax_runs):
    for out in spawned:
        np.testing.assert_allclose(out["logits"], jax_runs["logits"], **TOL_LOGITS)


CLIP_FEATS = 8, 6  # rows (4 a rank) and width of the gathered CLIP loss's features
CLIP_SCALE = 2.0  # its log logit scale


def _clip_feats():
    rng = np.random.RandomState(7)
    return tuple(rng.standard_normal(CLIP_FEATS).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def spawned_collectives(tmp_path_factory):
    feats = np.arange(16.0, dtype=np.float32).reshape(16, 1)
    return _port_dist.spawn(_port_dist.collectives, WORLD, tmp_path_factory.mktemp("coll"),
                            feats, [3, 1], *_clip_feats(), CLIP_SCALE)


def test_gather_features_forward_and_gradient_match_jax(spawned_collectives):
    """JAX's test_gather_features_grad: the gathered rows are the whole
    batch in rank order on every rank, and the gradient of the global loss
    (16 sum x^2, each rank's 8 rows carrying sum x^2) is 32 x on each rank's
    rows, as jax.grad through shard_map gives."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from peft_vit_tpu.parallel.collectives import gather_features as jax_gather

    mesh = jax_make_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])
    x = jnp.arange(16.0).reshape(16, 1)

    @partial(jax.shard_map, mesh=mesh, in_specs=P("data"), out_specs=P("data"))
    def f(xs):
        g = jax_gather(xs, "data")
        return jnp.sum(g ** 2) * jnp.ones_like(xs)

    want = np.asarray(jax.grad(lambda x: f(x).sum())(x))
    for rank, out in enumerate(spawned_collectives):
        np.testing.assert_array_equal(out["gathered"], np.asarray(x))
        np.testing.assert_allclose(out["grad"], want[8 * rank: 8 * (rank + 1)], rtol=1e-6)


def test_mean_reductions_and_host_gathers(spawned_collectives):
    for out in spawned_collectives:
        assert out["psum_mean"] == 1.5
        assert out["metrics"] == {"a": 0.5, "b": 2.0}
        np.testing.assert_array_equal(out["host"], [[0, 0], [1, 1]])
        # shards of 3 and 1 rows, in rank order, no padding left
        want = np.arange(4, dtype=np.float32)[:, None] * [1, -1]
        np.testing.assert_array_equal(out["ragged"], want)
    assert parallel.allgather_ragged(np.ones((3, 2))).shape == (3, 2)  # one process


def test_gathered_clip_loss_is_the_global_batch_loss(spawned_collectives):
    """``clip_contrastive_step_fn(gather=True)`` on 2 processes, 4 rows
    each: every rank's loss is the JAX function's loss of the whole batch
    (one device), and the gradients of each rank's rows, summed over the
    ranks' losses by the gather's reduce-scatter, are 2 x (the number of
    ranks) those rows' gradients of that loss."""
    from peft_vit_tpu.engine import contrastive as jax_contrastive

    img, txt = _clip_feats()
    fn = jax_contrastive.clip_contrastive_step_fn(lambda p, x: x, lambda p, x: x)
    want, (gi, gt) = jax.value_and_grad(lambda a, b: fn(None, a, b, jnp.float32(CLIP_SCALE)),
                                        (0, 1))(
        jnp.asarray(img), jnp.asarray(txt))
    rows = CLIP_FEATS[0] // WORLD
    for rank, out in enumerate(spawned_collectives):
        np.testing.assert_allclose(out["clip_loss"], float(want), rtol=1e-6)
        for got, full in zip(out["clip_grads"], (gi, gt)):
            np.testing.assert_allclose(got, WORLD * np.asarray(full)[rank * rows:(rank + 1) * rows],
                                       rtol=1e-5, atol=1e-7)


def test_two_ranks_on_one_card_are_refused(monkeypatch, tmp_path):
    """NCCL needs one card a rank: a group of 2 on a host with 1 card (no
    torchrun environment), or a LOCAL_RANK past the host's cards, raises at
    ``init_distributed``, before any group forms."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    rendezvous = f"file://{tmp_path}/rendezvous"
    with pytest.raises(ValueError, match="2 ranks on a host with 1 card.*one card a rank"):
        port_dist.init_distributed(init_method=rendezvous, num_processes=2, process_id=0,
                                   device="cuda")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(ValueError, match="NCCL needs one card a rank"):
        port_dist.init_distributed(init_method=rendezvous, num_processes=2, process_id=1,
                                   device="cuda")
    assert not port_dist.group_initialized()
