"""The port's GPipe (``parallel.pipeline``) against the plain block stack and
the JAX package on the CPU: in 2 spawned gloo processes (``_port_dist``) on a
mesh of data 1 x pipe 2, ``pipeline_apply`` of a 4-block stack at 1, 2 and 4
microbatches (forward and gradients) against the stack applied layer by
layer, bit for bit at one microbatch, and the local ring (the stages in turn
in one process, the card check's stand-in) equal to the 2-process run bit
for bit at every microbatch count; the Trainer with ``TPU.MESH.PIPE`` 2 and
``TPU.SCAN_LAYERS`` against the JAX trainer of ``TestPipelineTrainer``'s
config; ``vit_pipeline_forward`` against JAX's on a 2-device pipe mesh; and
the JAX trainer's two ``ValueError``s, word for word.

Microbatching changes the GEMMs' row counts, so at 2 and 4 microbatches the
output and the gradients differ from the plain stack by fp32 summation order
(``_close``: within ``TOL_MICRO_REL`` of each element and ``TOL_MICRO_SCALED``
of the tensor's largest magnitude)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import _port_dist
from peft_vit_tpu import config as jax_config
from peft_vit_tpu.data import synthetic_dataset
from peft_vit_tpu.engine.trainer import Trainer as JaxTrainer
from peft_vit_tpu.engine.trainer import batch_iterator as jax_batches
from peft_vit_tpu.models import ImageClassifier as JaxClassifier
from peft_vit_tpu.models import VisionTransformer as JaxViT
from peft_vit_tpu.parallel import make_mesh as jax_make_mesh
from peft_vit_tpu.parallel.pipeline import vit_pipeline_forward as jax_pipeline_forward
from peft_vit_tpu.peft import build_mask as jax_mask
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch.engine import trainer as port_trainer
from peft_vit_tpu_torch.models import ImageClassifier, VisionTransformer, load_jax_variables
from peft_vit_tpu_torch.models.convert import params_to_jax
from peft_vit_tpu_torch.models.layers import Block
from peft_vit_tpu_torch.parallel import LocalRing, vit_pipeline_forward
from peft_vit_tpu_torch.parallel.mesh import Mesh
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

PIPE = 2
LAYERS = 4
# the plain stack's GEMMs over fewer rows: a sum of B / M rows' products in
# another order, an error that scales with the tensor, not with the element
TOL_MICRO_REL, TOL_MICRO_SCALED = 1e-5, 1e-6
TOL_LOSS = dict(rtol=2e-4)  # the JAX TestPipelineTrainer's bound
TOL_LEAF = dict(rtol=1e-4, atol=1e-5)  # two fp32 runs of 16 steps, another summation order
TOL_LOGITS = dict(rtol=1e-5, atol=1e-5)  # one fp32 forward in each framework


def _jax_model(scan_layers=True):
    vit = JaxViT(image_size=16, patch_size=8, width=32, layers=LAYERS, heads=2, style="timm",
                 use_flash=False, scan_layers=scan_layers)
    return JaxClassifier(backbone=vit, num_classes=4)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    torch.manual_seed(0)
    blocks = [Block(32, 2, act="gelu", device="cpu") for _ in range(LAYERS)]
    stacked = {k: torch.stack([dict(b.named_parameters())[k].detach() for b in blocks]).numpy()
               for k, _ in blocks[0].named_parameters()}
    tokens = rng.standard_normal((8, 5, 32)).astype(np.float32)
    x, y = synthetic_dataset(4, 16, 16)
    model = _jax_model()
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 16, 16, 3))))
    return {"stacked": stacked, "tokens": tokens, "x": x.astype(np.float32) / 255.0, "y": y,
            "model": model, "params": params["params"]}


@pytest.fixture(scope="module")
def spawned(data, tmp_path_factory):
    return _port_dist.spawn(_port_dist.pipe_runs, PIPE, tmp_path_factory.mktemp("pipe"),
                            data["stacked"], data["tokens"], data["params"], data["x"],
                            data["y"])


@pytest.fixture(scope="module")
def plain(data):
    """The stack layer by layer: ``pipe_stack`` on one stage at one
    microbatch."""
    return _port_dist.pipe_stack(data["stacked"], data["tokens"], 1, LocalRing(1))


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=TOL_MICRO_REL,
                               atol=TOL_MICRO_SCALED * float(np.abs(want).max()), err_msg=err_msg)


def _equal(a, b):
    np.testing.assert_array_equal(a["out"], b["out"])
    np.testing.assert_array_equal(a["dx"], b["dx"])
    for k in b["grads"]:
        np.testing.assert_array_equal(a["grads"][k], b["grads"][k], err_msg=k)


@pytest.mark.parametrize("microbatches", _port_dist.PIPE_MICROBATCHES)
def test_pipeline_over_two_processes_against_the_plain_stack(spawned, plain, microbatches):
    """Each rank's output (the last stage's, broadcast) and the pipe group's
    sum of the gradients (each stage's rows, x's on stage 0) against the
    plain stack: bit for bit at one microbatch, within ``_close``
    otherwise."""
    assert [r["mesh"] for r in spawned] == [((1, 1, 2, 0), 0), ((1, 1, 2, 0), 1)]
    for r in spawned:
        got = r[microbatches]
        if microbatches == 1:
            _equal(got, plain)
            continue
        _close(got["out"], plain["out"])
        _close(got["dx"], plain["dx"])
        for k, g in plain["grads"].items():
            _close(got["grads"][k], g, k)


@pytest.mark.parametrize("microbatches", _port_dist.PIPE_MICROBATCHES)
def test_local_ring_equals_the_two_process_run(spawned, data, microbatches):
    """The two stages in turn in one process compute the 2-process run's
    numbers bit for bit: the card check's local ring stands for the group."""
    local = _port_dist.pipe_stack(data["stacked"], data["tokens"], microbatches, LocalRing(PIPE))
    for r in spawned:
        _equal(r[microbatches], local)


def _jax_plain_run(data):
    cfg = _port_dist.trainer_cfg(jax_config, **_port_dist.PIPE_TRAINER)
    params = data["params"]
    jt = JaxTrainer(cfg, data["model"], params, jax_mask(params, "full", num_layers=LAYERS),
                    steps_per_epoch=_port_dist.TRAINER_STEPS, rng=jax.random.PRNGKey(7))
    losses = [jt.train_one_epoch(jax_batches(data["x"], data["y"], _port_dist.TRAINER_BATCH,
                                             seed=e), epoch=e)["loss"] for e in range(2)]
    return jt, losses


def test_pipelined_trainer_against_jax(spawned, data):
    """``TPU.MESH.PIPE`` 2 with ``TPU.SCAN_LAYERS`` through the port's
    Trainer (2 microbatches, the default: the pipe degree) against the JAX
    trainer of the same config, as the JAX ``TestPipelineTrainer`` holds its
    pipelined run to the plain one: each epoch's loss within rtol 2e-4, every
    stacked leaf within ``TOL_LEAF``, both ranks alike."""
    jt, losses = _jax_plain_run(data)
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(jt.state.trainable,
                                                                   sep="/").items()}
    for r in spawned:
        assert r["microbatches"] == PIPE
        run = r["trainer"]
        np.testing.assert_allclose(run["losses"], losses, **TOL_LOSS)
        got = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params_to_jax(
            {k: torch.from_numpy(v) for k, v in run["trainable"].items()})["params"],
            sep="/").items()}
        assert set(got) == set(want) and "backbone/blocks/block/attn/in_proj/kernel" in got
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, **TOL_LEAF, err_msg=k)
    for k, v in spawned[0]["trainer"]["trainable"].items():
        np.testing.assert_array_equal(spawned[1]["trainer"]["trainable"][k], v, err_msg=k)


def test_vit_pipeline_forward_against_jax(data):
    """The port's ``vit_pipeline_forward`` (the local ring of 2 stages, 2
    microbatches) on the stacked JAX tree against JAX's on a 2-device pipe
    mesh, and against the port's unpipelined stacked model."""
    x = jnp.asarray(data["x"][:8])
    mesh = jax_make_mesh(data=1, model=1, pipe=PIPE, devices=jax.devices()[:PIPE])
    want = np.asarray(jax_pipeline_forward(data["model"], {"params": data["params"]}, x,
                                           mesh=mesh, microbatches=2))
    model = ImageClassifier(VisionTransformer(image_size=16, patch_size=8, width=32,
                                              layers=LAYERS, heads=2, style="timm",
                                              scan_layers=True), num_classes=4)
    load_jax_variables(model, {"params": data["params"]})
    xt = torch.from_numpy(data["x"][:8])
    with torch.no_grad():
        got = vit_pipeline_forward(model, {}, xt, microbatches=2, transport=LocalRing(PIPE),
                                   train=False)
        whole = model.eval()(xt)
    np.testing.assert_allclose(got.numpy(), want, **TOL_LOGITS)
    _close(got.numpy(), whole.numpy())


@pytest.mark.parametrize("case", ["unstacked", "batch_norm"])
def test_pipe_degree_raises_the_jax_trainers_value_errors(data, case):
    """A pipe degree without ``TPU.SCAN_LAYERS``, or with BatchNorm
    statistics: the JAX trainer's ``ValueError``, word for word (the JAX one
    on a 2-device pipe mesh beside the port's ``check_mesh`` on a pipe
    degree of 2)."""
    cfg = port_config.get_default_config()
    jax_cfg = _port_dist.trainer_cfg(jax_config)
    mesh = jax_make_mesh(data=1, model=1, pipe=PIPE, devices=jax.devices()[:PIPE])
    scan = case == "batch_norm"
    model = _jax_model(scan_layers=scan)
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 16, 16, 3))))["params"]
    stats = {"bn": {"mean": np.zeros(4, np.float32)}} if scan else None
    with pytest.raises(ValueError, match="SCAN_LAYERS" if not scan else "LN towers") as jax_err:
        JaxTrainer(jax_cfg, model, params, jax_mask(params, "full", num_layers=LAYERS),
                   steps_per_epoch=8, mesh=mesh, batch_stats=stats)
    port_model = ImageClassifier(VisionTransformer(image_size=16, patch_size=8, width=32,
                                                   layers=LAYERS, heads=2, style="timm",
                                                   scan_layers=scan), num_classes=4)
    with pytest.raises(ValueError) as port_err:
        port_trainer.check_mesh(cfg, port_model, Mesh(1, pipe=PIPE), has_bn=scan)
    assert str(port_err.value) == str(jax_err.value)
