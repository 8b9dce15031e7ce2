"""The port's tensor parallelism (Megatron over the mesh's ``model`` axis)
against the JAX package on the CPU: the cut of each leaf against the JAX
``param_shardings``; then, in 2 spawned gloo processes (``_port_dist``) on a
mesh of data 1 x model 2, two sharded SGD steps of the tiny LoRA flagship
and the eval step against JAX's ``make_sharded_train_step`` on a mesh of the
same shape (2 of the 8 virtual CPU devices), and two ZeRO-1 steps of the
tower with the LoRA-MoE gate; the dryrun over 2 processes.  The hooks and
int8 under tensor parallelism: ``test_torch_port_tp_hooks.py``.

The JAX spec of ``in_proj``'s kernel, ``P(None, "model")``, splits its
output columns contiguously; the port cuts the rank's heads of q, of k and
of v.  GSPMD computes the unsplit model whatever the layout, so both give
the JAX one-device step's numbers: the JAX step on the model-2 mesh is held
to the one-device step, and the port to both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

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
from peft_vit_tpu_torch import parallel
from peft_vit_tpu_torch.models import flagship
from peft_vit_tpu_torch.models import params_to_jax
from peft_vit_tpu_torch.models.convert import jax_path
from peft_vit_tpu_torch.parallel.dryrun import dryrun_multichip

import _port_dist
from test_torch_port_model import randomize

TOL_STEP = dict(rtol=1e-5, atol=1e-6)  # two fp32 runs of the same steps (test_torch_port_parallel)
TOL_LOGITS = dict(rtol=1e-5, atol=1e-5)  # one fp32 forward in each framework
MODEL = 2
BATCH = 8
LR, WD, STEPS = 1e-2, 1e-4, 2


def _jax_model(moe: bool = False):
    spec = JaxSpec(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
                   lora_post_scale_q=True, lora_moe=moe, lora_moe_group=2)
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
    out = {"x": x, "y": y}
    for moe, seed in ((False, 3), (True, 4)):
        model = _jax_model(moe)
        out[moe] = (model, randomize(model.init(jax.random.PRNGKey(0), jnp.asarray(x[:1])),
                                     seed))
    return out


@pytest.fixture(scope="module")
def spawned(data, tmp_path_factory):
    variables = [jax.tree_util.tree_map(np.asarray, data[moe][1]) for moe in (False, True)]
    return _port_dist.spawn(_port_dist.tp_steps, MODEL, tmp_path_factory.mktemp("tp"),
                            *variables, data["x"], data["y"], LR, WD, STEPS)


def _jax_steps(data, moe: bool, model_degree: int):
    model, variables = data[moe]
    mesh = jax_make_mesh(data=1, model=model_degree, devices=jax.devices()[:model_degree])
    params = variables["params"]
    trainable, frozen = jax_split(params, jax_build_mask(params, "lora",
                                                         num_layers=_port_dist.TINY_DP["layers"]))
    apply_fn = lambda v, xx, t: model.apply(v, xx, t)  # noqa: E731
    step, place = jax_train_step(apply_fn, jax_ce, mesh, zero1=moe, donate=False)
    state, frozen_p = place(jax_init_state(trainable), frozen)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, frozen_p, jnp.asarray(data["x"]), jnp.asarray(data["y"]),
                           jnp.float32(LR), jnp.float32(WD))
        losses.append(float(loss))
    leaves = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        state.trainable, sep="/").items() if v is not None}
    logits = np.asarray(jax_eval_step(apply_fn, mesh)(trainable, frozen, jnp.asarray(data["x"])))
    return leaves, losses, logits


@pytest.fixture(scope="module")
def jax_runs(data):
    return {(moe, m): _jax_steps(data, moe, m) for moe in (False, True) for m in (1, MODEL)}


def _port_leaves(arrays):
    tree = params_to_jax({k: torch.from_numpy(v) for k, v in arrays.items()})
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree["params"],
                                                                  sep="/").items()}


def test_the_cut_against_the_jax_shardings(data, spawned):
    """On the model-2 mesh: every 2-D kernel's part has the JAX shard's shape
    (the port's leaf is the kernel's transpose); the port also cuts what JAX
    replicates and GSPMD computes whole (in_proj's and c_fc's biases, the
    LoRA B matrices), row-parallel biases stay whole; the parts reassemble
    the leaf; and rank r's in_proj rows are its heads of q, of k and of v,
    not the contiguous block JAX names."""
    _, variables = data[False]
    mesh = jax_make_mesh(data=1, model=MODEL, devices=jax.devices()[:MODEL])
    shardings = traverse_util.flatten_dict(jax_mesh.param_shardings(mesh, variables["params"]),
                                           sep="/")
    model = flagship(**_port_dist.TINY_DP, dtype=torch.float32, device="cpu")
    kinds = set()
    for name, p in model.named_parameters():
        shape, path = tuple(p.shape), jax_path(name, p.dim())
        cut = parallel.tp_cut(name, shape)
        parts = [parallel.tp_slice(p.detach(), cut, r, MODEL) for r in range(MODEL)]
        assert torch.equal(parallel.tp_unslice(parts, cut), p.detach()), name
        jax_shape = shardings[path].shard_shape(shape[::-1] if p.dim() == 2 else shape)
        if p.dim() == 2 and cut in ("qkv", "rows", "cols") and "adapter" not in name:
            assert parts[0].shape[::-1] == jax_shape, name  # a JAX-split kernel
        else:
            assert jax_shape == (shape[::-1] if p.dim() == 2 else shape), name  # JAX replicates
        kinds.add(cut)
        for out in spawned:
            assert out["cut"].get(name, tuple(parts[0].shape)) == tuple(parts[0].shape), name
    assert kinds == {None, "qkv", "rows", "cols"}
    w = torch.arange(3 * 8.0).reshape(24, 1)  # q, k, v of 8 rows: 2 heads of 4 a rank
    assert parallel.tp_slice(w, "qkv", 1, 2).flatten().tolist() == [
        4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]


@pytest.mark.parametrize("moe", [False, True])
def test_sharded_tp_steps_match_jax(spawned, jax_runs, moe):
    """Two sharded SGD steps on data 1 x model 2 (with the MoE gate: under
    ZeRO-1) against the JAX step on a mesh of that shape: each step's loss
    and every trainable leaf, gathered from the model ranks; each rank's
    replicated leaves equal on both ranks, bit for bit."""
    want_leaves, want_losses, _ = jax_runs[(moe, MODEL)]
    key = "moe" if moe else "lora"
    for rank, out in enumerate(spawned):
        assert out["mesh"] == ((1, MODEL, 1, 0), rank)
        np.testing.assert_allclose(out[key]["losses"], want_losses, **TOL_STEP)
        got = _port_leaves(out[key]["trainable"])
        assert set(got) == set(want_leaves)
        for k, v in want_leaves.items():
            np.testing.assert_allclose(got[k], v, **TOL_STEP, err_msg=k)
    own = [out[key]["own"] for out in spawned]
    replicated = [k for k in own[0] if parallel.tp_cut(k, own[0][k].shape) is None]
    assert replicated
    for k in replicated:
        np.testing.assert_array_equal(own[0][k], own[1][k], err_msg=k)


@pytest.mark.parametrize("moe", [False, True])
def test_both_layouts_give_the_one_device_step(spawned, jax_runs, moe):
    """The JAX step on the model-2 mesh (its contiguous layout) equals the
    JAX step on one device, and so does the port's head layout."""
    one_leaves, one_losses, one_logits = jax_runs[(moe, 1)]
    tp_leaves, tp_losses, _ = jax_runs[(moe, MODEL)]
    np.testing.assert_allclose(tp_losses, one_losses, **TOL_STEP)
    for k, v in one_leaves.items():
        np.testing.assert_allclose(tp_leaves[k], v, **TOL_STEP, err_msg=k)
    got = _port_leaves(spawned[0]["moe" if moe else "lora"]["trainable"])
    for k, v in one_leaves.items():
        np.testing.assert_allclose(got[k], v, **TOL_STEP, err_msg=k)


def test_sharded_tp_eval_step_matches_jax(spawned, jax_runs):
    for out in spawned:
        np.testing.assert_allclose(out["logits"], jax_runs[(False, MODEL)][2], **TOL_LOGITS)
        np.testing.assert_allclose(out["logits"], jax_runs[(False, 1)][2], **TOL_LOGITS)


def test_dryrun_multichip_over_two_processes():
    """``dryrun_multichip(2)`` on gloo CPU processes: the mesh of data 1 x
    model 2, both losses finite, the first within 1e-5 relative of the
    one-process loss."""
    out = dryrun_multichip(2, device="cpu")
    assert out["mesh"] == {"data": 1, "model": 2}
    assert np.isfinite(out["loss"]) and np.isfinite(out["zero1_moe_loss"])
    assert out["loss_rel"] <= 1e-5 and len(out["ranks"]) == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a host without CUDA")
def test_dryrun_multichip_runs_on_the_card_unless_told():
    """``dryrun_multichip`` without a device is the card's: without CUDA it
    raises before it starts a process."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun_multichip(2)
