"""The port's tensor and sequence parallelism under every PEFT hook and int8,
on the CPU, in one spawn of 2 gloo processes (``_port_dist.tp_hook_runs``)
on a mesh of data 1 x model 2:

* two sharded steps of the tower with every hook the JAX ``PEFTSpec`` takes
  at once (KAdaptation's kron deltas, the Houlsby adapter, the shared qkv
  adapter, LePE, RPB and 5 deep prompts that straddle the ranks' token
  slices; full fine-tune), under tensor and under sequence parallelism,
  against JAX's sharded step on a 2-device mesh, which GSPMD computes
  unsplit;
* the same for the int8 LoRA tower (static scales, int8 dx) on JAX's int8
  tree and scales: GSPMD sums the int32 partials exactly, so JAX's sharded
  int8 is its unsplit int8, and so is the port's (the global row scale and
  the int32 sum over the model group);
* each hook and int8 recipe alone (``_port_dist.HOOKS``; the ids of the
  refusals they replace among them) under both against the port's own
  one-process step on the same weights, which the per-hook and int8 tests
  hold against JAX;
* the gradient sums the partial leaves need: without the model group's sum
  of the kron leaves (tensor parallelism) or of the deep prompts (sequence
  parallelism, where only the owning rank replaces a prompt's row) the step
  parts from the one-process step;
* an epoch of the sequence-parallel Trainer with deep prompts, the adapter
  and the int8 static recipe (calibrated over the model group) against the
  one-process Trainer (the int8 dx, which the steps above hold, flipped a
  code over the epoch: see ``_port_dist.HOOK_TRAINER``);
* ViT-B/16's geometry with the one prompt the JAX factory prescribes (198
  tokens) built by the factory and stepped under sequence parallelism;
* on the CPU plain versions, no spawn: the K-cut int8 route against the
  unsplit GEMM bit for bit, and the rank-local row scale flipping codes;
  the cut of the new leaves.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import _port_dist
from peft_vit_tpu.engine import ce_per_example as jax_ce, init_cell_state as jax_init_state
from peft_vit_tpu.models import ImageClassifier as JaxClassifier
from peft_vit_tpu.models import VisionTransformer as JaxViT
from peft_vit_tpu.ops import int8 as jint8
from peft_vit_tpu.parallel import make_mesh as jax_make_mesh
from peft_vit_tpu.parallel import make_sharded_train_step as jax_train_step
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu.peft import build_mask as jax_mask
from peft_vit_tpu.peft import split_params as jax_split
from peft_vit_tpu_torch import config as port_config
from peft_vit_tpu_torch import parallel
from peft_vit_tpu_torch.models import VisionTransformer
from peft_vit_tpu_torch.models.convert import params_to_jax
from peft_vit_tpu_torch.ops import int8 as i8
from test_torch_port_int8_model import _bridge
from test_torch_port_model import randomize
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

MODEL = 2
BATCH = 8
LR, WD, STEPS = 1e-2, 1e-4, 2
TOL_STEP = dict(rtol=1e-5, atol=1e-6)  # two fp32 runs of the same steps (test_torch_port_parallel)
TOL_LOSS = dict(rtol=1e-4)  # an epoch's mean loss (the JAX TestSequenceParallelTrainer's bound)
# a partial leaf without the model group's sum takes the gradient of one
# rank's heads or tokens: its change over the steps parts from the
# one-process step's by about half of that change, far more than TOL_STEP;
# held at a tenth
UNSUMMED_MIN_REL = 0.1
# the K-cut route's shapes: M rows, the whole K (cut in 2), N; K a multiple of
# 128 so that each half holds whole 64-wide slabs, as on the card
KCUT = (40, 256, 64)


def _jax_combined():
    t = _port_dist.TINY_DP
    vit = JaxViT(image_size=t["image"], patch_size=t["patch"], width=t["width"],
                 layers=t["layers"], heads=t["heads"], style="clip", output_dim=512,
                 spec=JaxSpec(**_port_dist.COMBINED), use_flash=False)
    return JaxClassifier(backbone=vit, num_classes=t["num_classes"])


def _jax_int8():
    t = _port_dist.SP_DP
    spec = JaxSpec(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
                   lora_post_scale_q=True)
    vit = JaxViT(image_size=t["image"], patch_size=t["patch"], width=t["width"],
                 layers=t["layers"], heads=t["heads"], style="clip", output_dim=512, spec=spec,
                 use_flash=False, int8_train=True)
    return JaxClassifier(backbone=vit, num_classes=t["num_classes"])


def _batch(image: int, seed: int):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((BATCH, image, image, 3)).astype(np.float32)
    return x, (np.arange(BATCH) % _port_dist.TINY_DP["num_classes"]).astype(np.int64)


@pytest.fixture(scope="module")
def data():
    out = {}
    for key, model, image, seed in (("combined", _jax_combined(), _port_dist.TINY_DP["image"], 40),
                                    ("int8", _jax_int8(), _port_dist.SP_DP["image"], 41)):
        x, y = _batch(image, seed)
        # compiled inits: the first eager flax init pays for every op's dispatch
        variables = randomize(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1])),
                              seed)
        # the parameters alone: the int8 tower's init also sows its qstats
        out[key] = {"model": model, "x": x, "y": y,
                    "variables": {"params": jax.tree_util.tree_map(np.asarray,
                                                                   variables["params"])}}
    model, variables = out["int8"]["model"], out["int8"]["variables"]
    _, frozen = jax_split(variables["params"], jax_mask(variables["params"], "lora",
                                                        num_layers=2))
    # the calibration forward compiled: eager, its int8 ops' dispatch costs ~5 s
    qstats = jax.jit(lambda v, xx: model.apply(v, xx, True, mutable=["qstats"])[1]["qstats"])(
        variables, jnp.asarray(out["int8"]["x"]))
    extra = {"qkernel": jint8.quantize_frozen_tree(frozen, bwd_dx=True),
             "qscale": jint8.activation_scales_from_stats(qstats, margin=1.5)}
    out["int8"]["extra"] = extra
    out["int8"]["bridged"] = {k: v.numpy() for part in extra.values()
                              for k, v in _bridge(part).items()}
    rng = np.random.RandomState(42)
    out["tx"] = rng.rand(64, 16, 16, 3).astype(np.float32)
    out["ty"] = rng.randint(0, 4, 64).astype(np.int64)
    return out


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The spawned processes' results and JAX's sharded steps, the latter
    compiled and run while the processes work."""
    c, q = data["combined"], data["int8"]
    results = _port_dist.spawn_start(_port_dist.tp_hook_runs, MODEL,
                                     tmp_path_factory.mktemp("tph"),
                                     (c["variables"], {}, c["x"], c["y"]),
                                     (q["variables"], q["bridged"], q["x"], q["y"]), LR, WD,
                                     STEPS, data["tx"], data["ty"])
    jax_runs = {"combined": _jax_steps(c, "full"), "int8": _jax_steps(q, "lora", q["extra"])}
    return results(), jax_runs


@pytest.fixture(scope="module")
def spawned(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[1]


def _jax_steps(entry, method: str, extra=None):
    """``STEPS`` of JAX's sharded step on the model-2 mesh: the leaves and
    losses."""
    model, params = entry["model"], entry["variables"]["params"]
    mesh = jax_make_mesh(data=1, model=MODEL, devices=jax.devices()[:MODEL])
    trainable, frozen = jax_split(params, jax_mask(params, method, num_layers=2))
    extra = extra or {}
    step, place = jax_train_step(lambda v, xx, t: model.apply({**v, **extra}, xx, t), jax_ce,
                                 mesh, donate=False)
    state, frozen_p = place(jax_init_state(trainable), frozen)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, frozen_p, jnp.asarray(entry["x"]), jnp.asarray(entry["y"]),
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


def _local(hook: str):
    """The one-process steps of ``hook``, and its initial leaves."""
    model, trainable, frozen = _port_dist.hook_model(hook)
    init = {k: v.detach().numpy().copy() for k, v in trainable.items()}
    x, y = _port_dist.hook_batch(_port_dist.HOOKS[hook][2])
    out = _port_dist.local_steps(model, trainable, frozen, x, y, LR, WD, _port_dist.HOOK_STEPS)
    return {**out, "init": init}


@pytest.mark.parametrize("mode", ["tp", "sp"])
@pytest.mark.parametrize("key", ["combined", "int8"])
def test_sharded_steps_against_jax(spawned, jax_runs, key, mode):
    """Two sharded steps on data 1 x model 2 (``mode``: tensor or sequence
    parallelism) of the tower with every hook at once (full fine-tune), or
    of the int8 LoRA tower on JAX's tree and scales, against JAX's sharded
    step on a mesh of that shape: each step's loss and every trainable leaf,
    gathered from the model ranks, within ``TOL_STEP``; both ranks equal."""
    want_leaves, want_losses = jax_runs[key]
    runs = [r[("combined" if key == "combined" else "int8_model", mode == "sp")]
            for r in spawned]
    assert [r["mesh"] for r in spawned] == [((1, 2, 1, 0), 0), ((1, 2, 1, 0), 1)]
    for run in runs:
        np.testing.assert_allclose(run["losses"], want_losses, **TOL_STEP)
        _close(_port_leaves(run["trainable"]), want_leaves, **TOL_STEP)
    for k, v in runs[0]["trainable"].items():
        np.testing.assert_array_equal(runs[1]["trainable"][k], v, err_msg=k)


@pytest.mark.parametrize("mode", ["tp", "sp"])
@pytest.mark.parametrize("hook", sorted(_port_dist.HOOKS))
def test_hook_under_tp_and_sp_equals_one_process(spawned, hook, mode):
    """Each hook and int8 recipe alone: two sharded steps on data 1 x model 2
    against the same steps in one process on the same weights (the int8 tree
    quantized whole, the static scales of the whole model), the losses and
    every trainable leaf within ``TOL_STEP``."""
    want = _local(hook)
    for r in spawned:
        got = r[(hook, mode == "sp")]
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL_STEP)
        _close(got["trainable"], want["trainable"], **TOL_STEP)


@pytest.mark.parametrize("hook,mode,leaf", [("kadaptation", "tp", "W_"),
                                            ("vpt", "sp", "deep_prompt_embeddings")])
def test_partial_gradients_need_the_model_groups_sum(spawned, hook, mode, leaf):
    """The same steps with the model group's sum left out: of the kron
    leaves under tensor parallelism (each rank's heads read only their
    columns of H), of the deep prompts under sequence parallelism (the
    prompts' rows 1-5 of 10 tokens: rank 0 replaces 4, rank 1 one): those
    leaves part from the one-process step by more than ``UNSUMMED_MIN_REL``
    of their change over the steps, where the summed run stands within
    ``TOL_STEP``."""
    local = _local(hook)
    want, init = local["trainable"], local["init"]
    names = [k for k in want if leaf in k]
    assert names
    for r in spawned:
        got = r[(hook, "unsummed")]["trainable"]
        worst = max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k] - init[k]).max())
                    for k in names)
        assert worst > UNSUMMED_MIN_REL, worst


def test_sp_trainer_with_deep_prompts_adapter_and_int8_static_equals_one_process(data, spawned):
    """An epoch of the Trainer with ``TPU.SEQUENCE_PARALLEL`` on data 1 x
    model 2 (deep prompts, the Houlsby adapter, the int8 static recipe; the
    scales calibrated by the sequence-parallel forward, each absmax over the
    model group) against the one-process Trainer: the loss
    within ``TOL_LOSS``, every leaf within ``TOL_STEP``, both ranks equal."""
    cfg = _port_dist.trainer_cfg(port_config, **_port_dist.HOOK_TRAINER)
    want = _port_dist.run_trainer(_port_dist.hooked_trainer(cfg), data["tx"], data["ty"], 0, 1,
                                  epochs=1)
    assert any("deep_prompt" in k for k in want["trainable"])
    for r in spawned:
        run = r["trainer"]
        np.testing.assert_allclose(run["losses"], want["losses"], **TOL_LOSS)
        _close(run["trainable"], want["trainable"], **TOL_STEP)
    for k, v in spawned[0]["trainer"]["trainable"].items():
        np.testing.assert_array_equal(spawned[1]["trainer"]["trainable"][k], v, err_msg=k)


def test_vitb16_geometry_with_one_prompt_steps_under_sp(spawned):
    """ViT-B/16's 196 patches and class token with the one deep prompt the
    JAX factory prescribes for a model degree of 2: built by the factory
    with ``TPU.SEQUENCE_PARALLEL`` (198 tokens, 99 a rank), one sharded step
    against the one-process step within ``TOL_STEP``."""
    model, trainable = _port_dist.vitb16_prompt_model()
    assert model.backbone.positional_embedding.shape[0] + model.backbone.num_prompts == 198
    x, y = _port_dist.vitb16_batch()
    want = _port_dist.local_steps(model, trainable, {}, x, y, LR, WD, 1)
    for r in spawned:
        np.testing.assert_allclose(r["vitb16"]["losses"], want["losses"], **TOL_STEP)
        _close(r["vitb16"]["trainable"], want["trainable"], **TOL_STEP)


class _Comm:
    """The model group of two ranks held in one process: ``parts`` the
    ranks' tensors of the collective in turn."""

    def __init__(self):
        self.parts = []

    def max(self, t):
        return torch.maximum(*self.parts.pop(0))

    def sum_int(self, t):
        return sum(self.parts.pop(0))

    def own_tokens(self, t):
        return t


@pytest.mark.parametrize("route", ["dynamic", "static", "column_dx"])
def test_kcut_route_equals_the_unsplit_gemm(route):
    """On the plain versions: the two halves of a K-cut GEMM at the global
    row scale (the halves' partial row absmax, their maximum), their int32
    partials summed, then the rescale, equal the unsplit int8 GEMM bit for
    bit (dynamic and static forward, and the column-parallel int8 dx, whose
    contraction is the forward's cut N); the rank-local row scale flips
    codes."""
    rng = np.random.RandomState(43)
    m, k, n = KCUT
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    x[3] *= 50.0  # an outlier row: its scale is set by one half
    w_i8, s_w = i8.quantize_cols(torch.from_numpy(
        rng.standard_normal((n, k)).astype(np.float32) * k**-0.5))
    halves = [(parallel.tp_slice(x, "cols", r, 2), parallel.tp_slice(w_i8, "cols", r, 2))
              for r in range(2)]
    amax = [i8.int8_row_absmax(xr) for xr, _ in halves]
    s = i8.row_scales(torch.maximum(*amax))
    if route == "static":
        s_x = x.abs().max() * 1.5 / 127.0
        acc = sum(i8.int8_gemm_partial(xr, wr, s_x=s_x) for xr, wr in halves)
        np.testing.assert_array_equal(i8._rescale(acc, s_x, s_w, x.dtype),
                                      i8.int8_gemm_static(x, w_i8, s_w, s_x))
        return
    if route == "dynamic":
        comm = _Comm()
        comm.parts = [amax, [i8.int8_gemm_partial(xr, wr, s_rows=s) for xr, wr in halves]]
        w0 = halves[0][1]
        got = i8.int8_row_parallel(halves[0][0], w0.float(), w0, s_w, None, None, None, comm)
        np.testing.assert_array_equal(got, i8.int8_gemm_dynamic(x, w_i8, s_w))
        local = sum(int((i8.quantize_rows(xr)[0] != torch.round(xr / s[:, None]).to(
            torch.int8)).sum()) for xr, _ in halves)
        assert local > 0  # the rank-local scale is another code for some values
        return
    # column_dx: the cotangent g (M, N) of a column-parallel GEMM cut by its
    # output rows, against the transposed codes cut by their columns
    g = x[:, :n].clone()
    wt_i8, s_wt = i8.quantize_cols(torch.from_numpy(
        rng.standard_normal((k, n)).astype(np.float32)))
    gh = [parallel.tp_slice(g, "cols", r, 2) for r in range(2)]
    wh = [parallel.tp_slice(wt_i8, "cols", r, 2) for r in range(2)]
    s = i8.row_scales(torch.maximum(*[i8.int8_row_absmax(t) for t in gh]))
    acc = sum(i8.int8_gemm_partial(t, w, s_rows=s) for t, w in zip(gh, wh))
    np.testing.assert_array_equal(i8._rescale(acc, s[:, None], s_wt, g.dtype),
                                  i8.int8_gemm_dynamic(g, wt_i8, s_wt))


def test_the_cut_of_the_hook_and_int8_leaves():
    """RPB's table by its heads (last dim), LePE's ``get_v`` by its v
    channels, the int8 tree as its weight (in_proj's codes and scales as
    its rows of q, k and v; ``wt_i8`` by the same columns; the row-parallel
    codes by K with ``s_w`` whole; their ``wt_i8`` / ``s_wt`` by K rows);
    the adapters, the kron leaves, the prompts and the static scales whole;
    every cut reassembles."""
    cuts = {
        "backbone.blocks.0.attn.relative_position_bias_table": ((9, 4), "cols"),
        "backbone.blocks.0.attn.get_v.weight": ((64, 1, 3, 3), "rows"),
        "backbone.blocks.0.attn.get_v.bias": ((64,), "rows"),
        "backbone.blocks.0.attn.in_proj.w_i8": ((192, 64), "qkv"),
        "backbone.blocks.0.attn.in_proj.s_w": ((192,), "qkv"),
        "backbone.blocks.0.attn.in_proj.wt_i8": ((64, 192), "qkv_cols"),
        "backbone.blocks.0.attn.in_proj.s_wt": ((64,), None),
        "backbone.blocks.0.mlp.c_fc.w_i8": ((256, 64), "rows"),
        "backbone.blocks.0.mlp.c_fc.wt_i8": ((64, 256), "cols"),
        "backbone.blocks.0.mlp.c_proj.w_i8": ((64, 256), "cols"),
        "backbone.blocks.0.mlp.c_proj.s_w": ((64,), None),
        "backbone.blocks.0.mlp.c_proj.wt_i8": ((256, 64), "rows"),
        "backbone.blocks.0.mlp.c_proj.s_wt": ((256,), "rows"),
        "backbone.blocks.0.attn.out_proj.w_i8": ((64, 64), "cols"),
        "backbone.blocks.0.attn.out_proj.s_x": ((), None),
        "backbone.blocks.0.attn.s_q": ((), None),
        "backbone.blocks.0.adapter.down.weight": ((8, 64), None),
        "backbone.blocks.0.attn.W_left1": ((4, 16, 1), None),
        "backbone.blocks.0.attn.qkv_adapter.down.weight": ((8, 16), None),
        "backbone.deep_prompt_embeddings": ((1, 5, 64), None),
    }
    for name, (shape, want) in cuts.items():
        assert parallel.tp_cut(name, shape) == want, name
        t = torch.arange(float(np.prod(shape))).reshape(shape)
        parts = [parallel.tp_slice(t, want, r, 2) for r in range(2)]
        assert torch.equal(parallel.tp_unslice(parts, want), t), name
    w = torch.arange(3 * 8.0).reshape(1, 24)  # q, k, v of 8 columns: 2 heads of 4 a rank
    assert parallel.tp_slice(w, "qkv_cols", 1, 2).flatten().tolist() == [
        4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]


class _Seq:
    """A sequence-parallel region's ``comm`` at ``rank`` (the deep prompts'
    placement reads the rank alone)."""

    def __init__(self, rank):
        self.comm = type("C", (), {"rank": rank})()


def test_deep_prompts_replace_only_their_global_rows():
    """Under sequence parallelism each rank's slice of 5 tokens gets the
    rows of the whole sequence's replacement: the class token, then the 5
    deep prompts at rows 1-5, so rank 0 replaces rows 1-4 of its slice and
    rank 1 its row 0, and the two slices joined are the whole sequence's
    replacement."""
    from peft_vit_tpu_torch.peft import PEFTSpec

    vit = VisionTransformer(image_size=32, patch_size=16, width=8, layers=2, heads=2,
                            spec=PEFTSpec(method="vpt", prompt_tokens=5, prompt_deep=True),
                            dtype=torch.float32, device="cpu")
    x = torch.randn(2, 10, 8)
    prompts = torch.randn(5, 8)
    whole = vit._prompts(x, prompts, replace=True)
    parts = [vit._deep_prompts(x[:, 5 * r:5 * (r + 1)], prompts, _Seq(r)) for r in range(2)]
    assert torch.equal(torch.cat(parts, 1), whole)
    assert torch.equal(parts[1][:, 1:], x[:, 6:]) and torch.equal(parts[0][:, 0], x[:, 0])


def test_tensor_parallelism_beyond_the_vit_names_its_item():
    """What stays refused: another tower than the ViT under a model axis
    raises at the step's build, naming its ROADMAP item."""
    from peft_vit_tpu_torch.engine import ce_per_example, make_apply_fn
    from peft_vit_tpu_torch.models import ImageClassifier
    from peft_vit_tpu_torch.models.resnet import ResNet

    model = ImageClassifier(ResNet(**_port_dist.RN_BN, device="cpu"), num_classes=4,
                            device="cpu")
    with pytest.raises(NotImplementedError, match=r"ResNet \(ROADMAP §1, parallelism \(tensor "
                                                  r"parallelism beyond the ViT\)\)"):
        parallel.make_sharded_train_step(make_apply_fn(model), ce_per_example,
                                         parallel.Mesh(1, model=MODEL), model=model)
