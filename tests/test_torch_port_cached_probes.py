"""The cached-prefix sweep and the probes through the port, against the JAX
package on the CPU:

* ``first_trainable_layer`` on the masks of the linear probe, AdapterDrop,
  LoRA, VPT, the transformer probe and first_mlp: the JAX function's cut on
  the JAX mask;
* the prefix and the suffix (``precompute_prefix_tokens`` then
  ``make_suffix_apply``) EQUAL to the whole forward at every cut, fp32 and
  bf16 (the tokens cross the host in fp32, which holds bf16 exactly), and
  the prefix tokens and the suffix's logits against the JAX package's at
  ``TOL``;
* ``finetune_main`` of both packages with ``TRAIN.CACHE_FROZEN_PREFIX`` at
  its default for the linear probe (through the sweep), AdapterDrop on the
  last block and the transformer probe: the same rounds, per-cell scores
  within 1e-4, the same choice and score;
* the drivers' cached sweep against the JAX driver's.

The probes are held in ``test_torch_port_probes.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peft_vit_tpu.engine import cached as jax_cached
from peft_vit_tpu.models import ImageClassifier as JaxImageClassifier
from peft_vit_tpu.models import VisionTransformer as JaxViT
from peft_vit_tpu.peft import PEFTSpec as JaxSpec
from peft_vit_tpu.peft import build_mask as jax_build_mask
from peft_vit_tpu_torch.engine import cached
from peft_vit_tpu_torch.models import ImageClassifier, load_jax_variables
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.peft import PEFTSpec, build_mask
from test_torch_port_driver import _run_both
from test_torch_port_layers import randomize

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = dict(image_size=16, patch_size=8, width=32, layers=3, heads=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(method, spec, dtype=torch.float32, shapes_only=False):
    """The tiny classifier of ``spec`` in both packages on the same weights
    (``shapes_only``: the JAX tree's shapes, for a mask)."""
    jax_model = JaxImageClassifier(backbone=JaxViT(**SHAPE, style="clip", output_dim=32,
                                                   spec=JaxSpec(**spec), use_flash=False),
                                   num_classes=4)
    x = np.random.RandomState(1).standard_normal((5, 16, 16, 3)).astype(np.float32)
    init = lambda: jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    if shapes_only:
        variables = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype),
                                           jax.eval_shape(init))
    else:
        variables = randomize(init(), 2)
    port = ImageClassifier(VisionTransformer(**SHAPE, output_dim=32, spec=PEFTSpec(**spec),
                                             dtype=dtype, device="cpu"),
                           num_classes=4, dtype=dtype, device="cpu")
    load_jax_variables(port, variables)
    return jax_model, port, variables, x


CASES = {
    "linear": ({}, 3),
    "adapterdrop": (dict(adapter="houlsby", adapter_dim=8, adapter_layers=(2,)), 2),
    "lora": (dict(attn_delta="lora", lora_rank=2, lora_alpha=4.0), 0),
    "vpt": (dict(prompt_tokens=2), 0),
    "transformer_probe": (dict(extra_block=True), 3),
    "first_mlp": ({}, 1),
}


@pytest.mark.parametrize("method", sorted(CASES))
def test_first_trainable_layer_as_jax(method):
    spec, cut = CASES[method]
    spec = dict(method=method, **spec)
    jax_model, port, variables, _ = _models(method, spec, shapes_only=True)
    want = jax_cached.first_trainable_layer(
        jax_build_mask(variables["params"], method, num_layers=3,
                       adapter_layers=spec.get("adapter_layers")), 3)
    got = cached.first_trainable_layer(
        build_mask(port, method, num_layers=3, adapter_layers=spec.get("adapter_layers")), 3)
    assert got == want == cut


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefix_and_suffix_equal_the_whole_forward(dtype):
    spec = dict(method="transformer_probe", extra_block=True)
    jax_model, port, variables, x = _models("transformer_probe", spec, getattr(torch, dtype))
    port.eval()
    with torch.no_grad():
        whole = port(torch.from_numpy(x))
    for cut in (1, 2, 3):
        toks = cached.precompute_prefix_tokens(port, x, cut, batch_size=2)
        assert toks.dtype == np.float32 and toks.shape == (5, 5, 32)
        with torch.no_grad():
            out = cached.make_suffix_apply(port, cut)({}, torch.from_numpy(toks), False)
        assert torch.equal(out, whole), cut
        if dtype == "float32":
            want_toks = jax_cached.precompute_prefix_tokens(jax_model, variables["params"], x,
                                                            cut, batch_size=2)
            np.testing.assert_allclose(toks, np.asarray(want_toks), **TOL)
            want = jax_cached.make_suffix_apply(jax_model, cut)(
                {"params": variables["params"]}, jnp.asarray(want_toks), False)
            np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method,over", [
    ("linear", {"TRAIN.NO_TUNING": False}),
    ("adapterdrop", {"PEFT.ADAPTER_LAYERS": [1], "MODEL.SPEC.VISION.LAYERS": 2}),
    ("transformer_probe", {}),
])
def test_cached_sweep_matches_jax(monkeypatch, tmp_path, method, over):
    """The linear probe through the sweep (2 lrs, 2 coarse wds, 2 epochs a
    cell), AdapterDrop on block 1 of 2 (the cut at 1) and the transformer
    probe (its extra block after the cut) with ``NO_TUNING``: every prefix
    computed once per split at the cut, the same cells, choice and score."""
    cuts = []
    real = cached.precompute_prefix_tokens
    monkeypatch.setattr(cached, "precompute_prefix_tokens",
                        lambda model, x, cut, *a: cuts.append(cut) or real(model, x, cut, *a))
    over = {"TRAIN.NO_TUNING": True, "TRAIN.END_EPOCH": 2, "TRAIN.LR": 1e-2,
            "TRAIN.SEARCH_WD_POINTS": 5, "TRAIN.SEARCH_WD_INIT_POINTS": 2,
            "MODEL.SPEC.VISION.LAYERS": 1, "PEFT.METHOD": method, **over}
    want, got = _run_both(monkeypatch, tmp_path, lr_grid=[1e-3, 3e-2], **over)
    assert cuts == [1] * 3  # train, val and test: after block 0 of 1, or of 2 for AdapterDrop
    assert [c[:2] for c in got["cells"]] == [c[:2] for c in want["cells"]]
    for g, w in zip(got["cells"], want["cells"]):
        np.testing.assert_allclose(g[2], w[2], atol=1e-4)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert (got["record"]["lr"], got["record"]["wd"]) == (want["record"]["lr"],
                                                          want["record"]["wd"])
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)


def test_prefix_batches_run_as_replays_of_one_graph(monkeypatch):
    """The card's path of ``precompute_prefix_tokens`` (each batch a replay
    of one graph, its output overwritten by the next replay) on the CPU
    through the stand-in of ``test_torch_port_cells``: the eager tokens, bit
    for bit, one graph of the batch, one replay a batch."""
    from peft_vit_tpu_torch.engine import train
    from test_torch_port_cells import _Rerun

    spec = dict(method="transformer_probe", extra_block=True)
    _, port, _, x = _models("transformer_probe", spec)
    eager = cached.precompute_prefix_tokens(port, x, 2, batch_size=2)
    monkeypatch.setattr(train, "StepGraph", _Rerun)
    monkeypatch.setattr(train, "runs_captured", lambda t: True)
    graphs = {}
    got = cached.precompute_prefix_tokens(port, x, 2, batch_size=2, graphs=graphs)
    np.testing.assert_array_equal(got, eager)
    assert list(graphs) == [("prefix", None, 2)] and graphs["prefix", None, 2].replays == 3
