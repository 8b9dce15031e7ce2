"""The port's sequence parallelism (``TPU.SEQUENCE_PARALLEL``, Megatron-SP
over the mesh's ``model`` axis) against the JAX package on the CPU, in 2
spawned gloo processes (``_port_dist``) on a mesh of data 1 x model 2:

* two sharded LoRA steps of the tiny flagship at 48 px (10 tokens, 5 a rank)
  against JAX's sharded step of the model with ``act_sharding`` on a 2-device
  mesh of the same shape, and against JAX's one-device step;
* one full fine-tune step, whose LayerNorms' and row-parallel biases'
  gradients each rank holds a part of, against JAX's one-device step; the
  same step with the model group's sum of those parts left out
  (``train_step.sp_partial`` patched to name no leaf) parts from JAX, so the
  sum is needed;
* an epoch of the Trainer at the JAX ``TestSequenceParallelTrainer``'s
  config against the JAX trainer on the 2-device mesh under ``set_mesh``,
  and on the stacked layout equal to the unrolled run;
* the builder's ``ValueError`` for a token count the model degree does not
  divide, word for word.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.sharding import PartitionSpec as P

import _port_dist
from peft_vit_tpu import config as jax_config
from peft_vit_tpu.data import synthetic_dataset
from peft_vit_tpu.engine import ce_per_example as jax_ce, init_cell_state as jax_init_state
from peft_vit_tpu.engine.trainer import Trainer as JaxTrainer
from peft_vit_tpu.engine.trainer import batch_iterator as jax_batches
from peft_vit_tpu.models import ImageClassifier as JaxClassifier
from peft_vit_tpu.models import VisionTransformer as JaxViT
from peft_vit_tpu.models import build_image_classifier as jax_build
from peft_vit_tpu.parallel import make_mesh as jax_make_mesh
from peft_vit_tpu.parallel import make_sharded_train_step as jax_train_step
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu.peft import build_mask as jax_mask
from peft_vit_tpu.peft import spec_from_config as jax_spec_from_config
from peft_vit_tpu.peft import split_params as jax_split
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.models import build_image_classifier
from peft_vit_tpu_torch.models.convert import params_to_jax, stack_flat_blocks
from peft_vit_tpu_torch.peft import spec_from_config
from test_torch_port_model import randomize
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

MODEL = 2
BATCH = 8
LR, WD, STEPS = 1e-2, 1e-4, 2
TOL_STEP = dict(rtol=1e-5, atol=1e-6)  # two fp32 runs of the same steps (test_torch_port_parallel)
TOL_LOSS = dict(rtol=1e-4)  # the JAX TestSequenceParallelTrainer's bound
UNSUMMED_MIN = 1e-3  # a LayerNorm leaf without the sum: half its gradient, far outside TOL_STEP
SP_SHARDING = P(P.UNCONSTRAINED, "model", None)


def _jax_flagship(act_sharding=None):
    spec = JaxSpec(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
                   lora_post_scale_q=True)
    t = _port_dist.SP_DP
    vit = JaxViT(image_size=t["image"], patch_size=t["patch"], width=t["width"],
                 layers=t["layers"], heads=t["heads"], style="clip", output_dim=512, spec=spec,
                 use_flash=False, act_sharding=act_sharding)
    return JaxClassifier(backbone=vit, num_classes=t["num_classes"])


def _trainer_vit(act_sharding=None):
    return JaxClassifier(backbone=JaxViT(image_size=24, patch_size=8, width=32, layers=2,
                                         heads=2, style="timm", use_flash=False,
                                         act_sharding=act_sharding), num_classes=4)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    t = _port_dist.SP_DP
    x = rng.standard_normal((BATCH, t["image"], t["image"], 3)).astype(np.float32)
    y = (np.arange(BATCH) % t["num_classes"]).astype(np.int64)
    # compiled inits: the first eager flax init pays for every op's dispatch
    variables = randomize(jax.jit(_jax_flagship().init)(jax.random.PRNGKey(0),
                                                        jnp.asarray(x[:1])), 5)
    tx, ty = synthetic_dataset(4, 24, 24)
    tparams = jax.device_get(jax.jit(_trainer_vit().init)(jax.random.PRNGKey(0),
                                                          jnp.zeros((1, 24, 24, 3))))["params"]
    stacked = traverse_util.unflatten_dict(stack_flat_blocks(
        {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tparams, sep="/").items()},
        2), sep="/")
    return {"x": x, "y": y, "variables": jax.tree_util.tree_map(np.asarray, variables),
            "tx": tx.astype(np.float32) / 255.0, "ty": ty, "tparams": tparams,
            "stacked": stacked}


@pytest.fixture(scope="module")
def spawned(data, tmp_path_factory):
    return _port_dist.spawn(_port_dist.sp_runs, MODEL, tmp_path_factory.mktemp("sp"),
                            data["variables"], data["x"], data["y"], LR, WD, STEPS,
                            data["tparams"], data["stacked"], data["tx"], data["ty"])


def _mesh():
    return jax_make_mesh(data=1, model=MODEL, devices=jax.devices()[:MODEL])


def _jax_steps(data, method: str, steps: int, sequence_parallel: bool):
    """``steps`` JAX sharded SGD steps: the SP model on the model-2 mesh, or
    the plain model on one device."""
    model = _jax_flagship(SP_SHARDING if sequence_parallel else None)
    mesh = _mesh() if sequence_parallel else jax_make_mesh(data=1, model=1,
                                                           devices=jax.devices()[:1])
    params = data["variables"]["params"]
    trainable, frozen = jax_split(params, jax_mask(params, method,
                                                   num_layers=_port_dist.SP_DP["layers"]))
    step, place = jax_train_step(lambda v, xx, t: model.apply(v, xx, t), jax_ce, mesh,
                                 donate=False)
    losses = []
    with jax.set_mesh(mesh):
        state, frozen_p = place(jax_init_state(trainable), frozen)
        for _ in range(steps):
            state, loss = step(state, frozen_p, jnp.asarray(data["x"]), jnp.asarray(data["y"]),
                               jnp.float32(LR), jnp.float32(WD))
            losses.append(float(loss))
    leaves = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        state.trainable, sep="/").items() if v is not None}
    return leaves, losses


def _port_leaves(arrays):
    tree = params_to_jax({k: torch.from_numpy(v) for k, v in arrays.items()})
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree["params"],
                                                                  sep="/").items()}


def _close(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **tol, err_msg=k)


def test_sp_lora_steps_against_jax(data, spawned):
    """Two SP LoRA steps on 2 ranks (each holding 5 of the 10 tokens between
    the regions) against JAX's SP step on the model-2 mesh and JAX's
    one-device step: the losses and every leaf, gathered from the ranks,
    within ``TOL_STEP``; the JAX SP step is held to its one-device step."""
    assert [r["mesh"] for r in spawned] == [((1, 2, 1, 0), 0), ((1, 2, 1, 0), 1)]
    sp_leaves, sp_losses = _jax_steps(data, "lora", STEPS, True)
    one_leaves, one_losses = _jax_steps(data, "lora", STEPS, False)
    np.testing.assert_allclose(sp_losses, one_losses, **TOL_STEP)
    _close(sp_leaves, one_leaves, **TOL_STEP)
    for r in spawned:
        got = _port_leaves(r["lora"]["trainable"])
        for leaves, losses in ((sp_leaves, sp_losses), (one_leaves, one_losses)):
            np.testing.assert_allclose(r["lora"]["losses"], losses, **TOL_STEP)
            _close(got, leaves, **TOL_STEP)


def test_partial_gradients_need_the_model_groups_sum(data, spawned):
    """A full fine-tune SP step against JAX's one-device step: every leaf,
    the LayerNorms' and the row-parallel biases' included, within
    ``TOL_STEP``.  Without the model group's sum of the partial gradients the
    LayerNorm leaves part from JAX's by more than ``UNSUMMED_MIN``."""
    want, losses = _jax_steps(data, "full", 1, False)
    ln = [k for k in want if "/ln_" in k and "/blocks_" in k]
    assert ln
    for r in spawned:
        np.testing.assert_allclose(r["full"]["losses"], losses, **TOL_STEP)
        _close(_port_leaves(r["full"]["trainable"]), want, **TOL_STEP)
        unsummed = _port_leaves(r["unsummed"]["trainable"])
        worst = max(float(np.abs(unsummed[k] - want[k]).max()) for k in ln)
        assert worst > UNSUMMED_MIN, worst


def test_sp_trainer_against_jax(data, spawned):
    """An epoch of the Trainer with ``TPU.SEQUENCE_PARALLEL`` on data 1 x
    model 2 (the JAX ``TestSequenceParallelTrainer``'s model and schedule)
    against the JAX trainer of the SP model on the model-2 mesh: the loss
    within rtol 1e-4, every leaf within ``TOL_STEP``, both ranks equal."""
    cfg = _port_dist.trainer_cfg(jax_config, **_port_dist.SP_TRAINER)
    mesh = _mesh()
    with jax.set_mesh(mesh):
        model = _trainer_vit(SP_SHARDING)
        params = data["tparams"]
        jt = JaxTrainer(cfg, model, params, jax_mask(params, "full", num_layers=2),
                        steps_per_epoch=_port_dist.TRAINER_STEPS, mesh=mesh,
                        rng=jax.random.PRNGKey(7))
        loss = jt.train_one_epoch(jax_batches(data["tx"], data["ty"], _port_dist.TRAINER_BATCH,
                                              seed=0), epoch=0)["loss"]
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(jt.state.trainable,
                                                                   sep="/").items()}
    for r in spawned:
        run = r["trainer"]
        np.testing.assert_allclose(run["losses"], [loss], **TOL_LOSS)
        _close(_port_leaves(run["trainable"]), want, **TOL_STEP)
    for k, v in spawned[0]["trainer"]["trainable"].items():
        np.testing.assert_array_equal(spawned[1]["trainer"]["trainable"][k], v, err_msg=k)


def test_sp_trainer_on_the_stacked_layout_equals_the_unrolled(data, spawned):
    """The SP Trainer's epoch with the blocks stacked (each stacked leaf cut
    layer by layer over the model ranks) equals the unrolled run bit for bit:
    the loss and every leaf, the unrolled ones stacked."""
    for r in spawned:
        want = stack_flat_blocks(_port_leaves(r["trainer"]["trainable"]), 2)
        got = _port_leaves(r["trainer_stacked"]["trainable"])
        assert r["trainer_stacked"]["losses"] == r["trainer"]["losses"]
        assert set(got) == set(want) and "backbone/blocks/block/attn/in_proj/kernel" in got
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_token_count_that_does_not_split_raises_the_jax_value_error():
    """ViT-B/16's 197 tokens over a model degree of 2: the JAX builder's
    ``ValueError`` word for word, naming ``PEFT.PROMPT_TOKENS=1``."""
    over = {"TPU.SEQUENCE_PARALLEL": True, "TPU.MESH.MODEL": MODEL, "TRAIN.IMAGE_SIZE": [224, 224],
            "MODEL.SPEC.VISION.PATCH_SIZE": 16, "MODEL.NAME": "clip_tiny"}
    errors = []
    for pkg, build, spec_of in ((jax_config, jax_build, jax_spec_from_config),
                                (port_config, build_image_classifier, spec_from_config)):
        cfg = _port_dist.set_keys(pkg.get_default_config(), over)
        with pytest.raises(ValueError, match=r"PEFT\.PROMPT_TOKENS=1 ") as err:
            if pkg is jax_config:
                build(cfg, spec_of(cfg), 4)
            else:
                build(cfg, spec_of(cfg), 4, device="cpu")
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "197-token" in errors[1]
