"""The CLIP text side through the port against the JAX package on the CPU:

* the tokenizer's ids EQUAL to the JAX ``tokenize`` on a set of strings
  (punctuation, digits, html entities, non-ASCII, empty), truncation to the
  context with the end token kept included; ``HFTokenizer`` raises;
* the prompts: ``class_map`` and ``template_map`` of every registry dataset
  and of the built-in entries equal to the JAX package's, and
  ``register_prompts`` overriding them;
* ``TextTransformer`` and ``CLIP`` (both logits, the normalized image and
  text features) against the JAX modules on the same weights, fp32 at
  ``TOL``; the causal bias: a token's features do not depend on the tokens
  after it;
* the executed reference's CLIP (``refexec_clip_model.npz``: its Houlsby
  adapter visual tower, its text features and logits) and the text features
  of its LoRA CLIP (``refexec_lora_clip_model.npz``), loaded through the
  port's converter, at the JAX package's tolerances for the same fixtures
  (``tests/test_refexec_models.py``: rtol 1e-4, atol 1e-5; logits atol
  1e-4)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peft_vit_tpu.data import prompts as jax_prompts
from peft_vit_tpu.data import tokenizer as jax_tokenizer
from peft_vit_tpu.data.registry import _INFO
from peft_vit_tpu.models import CLIP as JaxCLIP
from peft_vit_tpu.models.text import TextTransformer as JaxText
from peft_vit_tpu_torch.data import prompts, tokenizer
from peft_vit_tpu_torch.models import CLIP, TextTransformer, load_jax_variables
from peft_vit_tpu_torch.models.convert import clip_state_dict, clip_state_dict_to_tree
from peft_vit_tpu_torch.models.convert import infer_clip_shape, text_state_dict
from peft_vit_tpu_torch.peft import PEFTSpec
from test_torch_port_layers import randomize

TOL = dict(rtol=1e-5, atol=1e-5)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
STRINGS = ["a photo of a cat.", "A  Photo\tOF the   dog!!", "itap of a 747 & 42 things",
           "café naïve über", "&amp; &lt;html&gt; it's we'll they'd",
           "", "x" * 40, "a photo of the number: \"7\".", "lymph node containing metastatic "
           "tumor tissue, a centered satellite photo of residential buildings"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("context", [77, 8])
def test_token_ids_equal_jax(context):
    got = tokenizer.tokenize(STRINGS, context)
    want = jax_tokenizer.tokenize(STRINGS, context)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if context == 8:  # truncated rows keep the end token last
        long = [i for i, s in enumerate(STRINGS) if len(jax_tokenizer.get_tokenizer().encode(s)) > 6]
        assert long and (got[long, -1] == tokenizer.get_tokenizer().eot).all()
    tok = tokenizer.get_tokenizer()
    assert (tok.sot, tok.eot, tok.vocab_size) == (49406, 49407, 49408)
    assert tok.decode(tok.encode("hello world")) == "hello world"
    with pytest.raises(NotImplementedError, match="ROADMAP §1, the rest"):
        tokenizer.HFTokenizer()


def test_prompts_resolve_for_every_registry_dataset_as_jax(monkeypatch):
    """Against the resources and the built-in maps alone: what other tests
    of the same process registered at run time (in either package) is set
    aside."""
    monkeypatch.setattr(jax_prompts, "_builtin_cache", {})
    monkeypatch.setattr(prompts, "_builtin_cache", {})
    names = sorted(set(_INFO) | set(jax_prompts._CLASS_MAP) | set(jax_prompts._TEMPLATE_MAP)
                   | {"some-unknown-dataset"})
    for name in names:
        assert prompts.class_map(name) == jax_prompts.class_map(name), name
        assert prompts.template_map(name) == jax_prompts.template_map(name), name
        classes = prompts.class_map(name)
        if classes is not None and not name.startswith("synthetic") and name in _INFO:
            assert len(classes) == _INFO[name].num_classes, name
    resources = [f[:-len(".json")] for f in os.listdir(prompts.PROMPTS_DIR) if f.endswith(".json")]
    assert len(resources) >= 20 and all(prompts.class_map(name) for name in resources)
    assert len(prompts.template_map("cifar-100")) == 18
    assert prompts.GENERIC_TEMPLATES == jax_prompts.GENERIC_TEMPLATES


def test_register_prompts_and_external_json_as_jax(tmp_path):
    for pkg in (prompts, jax_prompts):
        pkg.register_prompts("port-test-ds", ["a", "b"], ["x {}"])
    assert prompts.class_map("port-test-ds") == ["a", "b"] == jax_prompts.class_map(
        "port-test-ds")
    assert prompts.template_map("port-test-ds") == ["x {}"]
    (tmp_path / "mnist").mkdir()
    (tmp_path / "mnist" / "prompts.json").write_text('{"classes": ["zero"], "templates": ["{}!"]}')
    for pkg in (prompts, jax_prompts):
        assert pkg.class_map("mnist", str(tmp_path)) == ["zero"]
        assert pkg.template_map("mnist", str(tmp_path)) == ["{}!"]


TEXT = dict(vocab_size=64, context_length=8, width=32, layers=2, heads=2, output_dim=16)


def _tokens(seed, b=3):
    """Token rows as the tokenizer makes them: ids below the end token, the
    end token (the highest id) at a row-dependent place, zeros after."""
    rng = np.random.RandomState(seed)
    toks = np.zeros((b, TEXT["context_length"]), np.int32)
    for i in range(b):
        n = 2 + i
        toks[i, :n] = rng.randint(1, TEXT["vocab_size"] - 1, n)
        toks[i, n] = TEXT["vocab_size"] - 1
    return toks


def test_text_transformer_matches_jax():
    jax_text = JaxText(**TEXT, use_flash=False)
    toks = _tokens(1)
    variables = randomize(jax_text.init(jax.random.PRNGKey(0), jnp.asarray(toks)), 2)
    want = np.asarray(jax_text.apply(variables, jnp.asarray(toks)))
    port = load_jax_variables(TextTransformer(**TEXT, device="cpu"), variables).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # causal: changing a token after the end token moves no feature
    later = toks.copy()
    later[0, -1] = 5
    with torch.no_grad():
        np.testing.assert_array_equal(port(torch.from_numpy(later).long()).numpy()[0], got[0])


def test_clip_matches_jax():
    kw = dict(embed_dim=16, image_size=16, patch_size=8, vision_width=32, vision_layers=2,
              vision_heads=2, vocab_size=64, context_length=8, text_width=32, text_layers=2,
              text_heads=2)
    jax_clip = JaxCLIP(**kw, use_flash=False)
    img = np.random.RandomState(3).standard_normal((3, 16, 16, 3)).astype(np.float32)
    toks = _tokens(4)
    variables = randomize(jax_clip.init(jax.random.PRNGKey(0), jnp.asarray(img),
                                        jnp.asarray(toks)), 5)
    li, lt = (np.asarray(t) for t in jax_clip.apply(variables, jnp.asarray(img),
                                                     jnp.asarray(toks)))
    port = load_jax_variables(CLIP(**kw, device="cpu"), variables).eval()
    with torch.no_grad():
        gi, gt = port(torch.from_numpy(img), torch.from_numpy(toks).long())
        fi = port.encode_image(torch.from_numpy(img)).numpy()
        ft = port.encode_text(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(gi.numpy(), li, **TOL)
    np.testing.assert_allclose(gt.numpy(), lt, **TOL)
    np.testing.assert_allclose(fi, np.asarray(jax_clip.apply(
        variables, jnp.asarray(img), method=JaxCLIP.encode_image)), **TOL)
    np.testing.assert_allclose(ft, np.asarray(jax_clip.apply(
        variables, jnp.asarray(toks), method=JaxCLIP.encode_text)), **TOL)
    assert float(port.logit_scale) == pytest.approx(float(np.asarray(
        variables["params"]["logit_scale"])))


def _golden(name):
    g = np.load(os.path.join(GOLDEN, name))
    sd = {k[len("sd__"):].replace("__", "."): np.asarray(g[k])
          for k in g.files if k.startswith("sd__")}
    return g, sd


def _refexec_clip(sd, theads, spec):
    info = infer_clip_shape(sd)
    model = CLIP(embed_dim=info["embed_dim"], image_size=info["image_size"],
                 patch_size=info["patch_size"], vision_width=info["vision_width"],
                 vision_layers=info["vision_layers"],
                 vision_heads=max(info["vision_width"] // 64, 1),
                 vocab_size=info["vocab_size"], context_length=info["context_length"],
                 text_width=info["text_width"], text_layers=info["text_layers"],
                 text_heads=theads, spec=spec, device="cpu")
    model.load_state_dict(clip_state_dict(clip_state_dict_to_tree(sd)), strict=True)
    return model.eval()


def test_refexec_clip_model_text_features_and_logits():
    """The reference's adapter CLIP (Adapter(d, 64), relu, in every visual
    block): image and text features and the image logits."""
    g, sd = _golden("refexec_clip_model.npz")
    spec = PEFTSpec(method="adapter", adapter="houlsby", adapter_dim=64, adapter_act="relu")
    model = _refexec_clip(sd, int(g["theads"]), spec)
    x = torch.from_numpy(np.asarray(g["x"]).transpose(0, 2, 3, 1).copy())
    toks = torch.from_numpy(np.asarray(g["toks"]))
    with torch.no_grad():
        fi, ft = model.encode_image(x).numpy(), model.encode_text(toks).numpy()
        li, _ = model(x, toks)
    np.testing.assert_allclose(fi, g["feats_img"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ft, g["feats_txt"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(li.numpy(), g["logits_img"], rtol=1e-4, atol=1e-4)


def test_refexec_lora_clip_model_text_features():
    """The text half of the reference's LoRA CLIP, which the visual-only
    converter could not reach: its plain text tower through
    ``text_state_dict``."""
    g, sd = _golden("refexec_lora_clip_model.npz")
    info = infer_clip_shape(sd)
    text = TextTransformer(vocab_size=info["vocab_size"], context_length=info["context_length"],
                           width=info["text_width"], layers=info["text_layers"],
                           heads=int(g["theads"]), output_dim=info["embed_dim"], device="cpu")
    text.load_state_dict(text_state_dict(clip_state_dict_to_tree(sd)), strict=True)
    with torch.no_grad():
        ft = text.eval()(torch.from_numpy(np.asarray(g["toks"]))).numpy()
    np.testing.assert_allclose(ft, g["feats_txt"], rtol=1e-4, atol=1e-5)


def _clip_state_dict_with_text(seed=11, vocab=64, ctx=8, tw=32, tl=2, embed=24):
    """A small OpenAI CLIP export with both towers: the visual-only export of
    ``test_torch_port_driver`` and a text tower."""
    from test_torch_port_driver import _fake_clip_state_dict

    sd = _fake_clip_state_dict(embed=embed)
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1)

    sd.update({"token_embedding.weight": t(vocab, tw), "positional_embedding": t(ctx, tw),
               "ln_final.weight": 1.0 + t(tw), "ln_final.bias": t(tw),
               "text_projection": t(tw, embed)})
    for i in range(tl):
        p = f"transformer.resblocks.{i}"
        sd.update({f"{p}.ln_1.weight": 1.0 + t(tw), f"{p}.ln_1.bias": t(tw),
                   f"{p}.ln_2.weight": 1.0 + t(tw), f"{p}.ln_2.bias": t(tw),
                   f"{p}.attn.in_proj_weight": t(3 * tw, tw), f"{p}.attn.in_proj_bias": t(3 * tw),
                   f"{p}.attn.out_proj.weight": t(tw, tw), f"{p}.attn.out_proj.bias": t(tw),
                   f"{p}.mlp.c_fc.weight": t(4 * tw, tw), f"{p}.mlp.c_fc.bias": t(4 * tw),
                   f"{p}.mlp.c_proj.weight": t(tw, 4 * tw), f"{p}.mlp.c_proj.bias": t(tw)})
    return sd


def test_build_grafts_the_checkpoint_text_tower_as_jax(tmp_path):
    """``build_image_classifier`` on a CLIP checkpoint with a text tower: the
    converter's tree equals the JAX converter's, and ``encode_text`` (the
    checkpoint's tower, context from its embeddings) gives the JAX builder's
    features; ``model.aux`` keeps the checkpoint's logit scale."""
    from peft_vit_tpu import config as jax_config
    from peft_vit_tpu.models import convert as jax_convert
    from peft_vit_tpu.models import factory as jax_factory
    from peft_vit_tpu.peft import spec as jax_spec
    from peft_vit_tpu_torch import config as port_config
    from peft_vit_tpu_torch.models import factory as port_factory
    from peft_vit_tpu_torch.peft import spec as port_spec
    from test_torch_port_driver import tiny_cfg

    sd = _clip_state_dict_with_text()
    got, want = clip_state_dict_to_tree(sd), jax_convert.clip_state_dict_to_tree(sd)
    assert set(got) == set(want) and any(k.startswith("text/") for k in got)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
    path = tmp_path / "clip.pt"
    torch.save(sd, path)
    over = {"MODEL.PRETRAINED": str(path), "MODEL.SPEC.VISION.HEADS": 2}
    cfg = tiny_cfg(port_config, **over)
    model, _, encode_text = port_factory.build_image_classifier(
        cfg, port_spec.spec_from_config(cfg), 4, device="cpu")
    jcfg = tiny_cfg(jax_config, **over)
    _, _, jax_encode = jax_factory.build_image_classifier(jcfg, jax_spec.spec_from_config(jcfg), 4)
    toks = _tokens(12)
    assert encode_text.context_length == jax_encode.context_length == 8
    np.testing.assert_allclose(encode_text(toks).numpy(), np.asarray(jax_encode(jnp.asarray(toks))),
                               **TOL)
    assert model.aux["logit_scale"] == pytest.approx(float(sd["logit_scale"]))
