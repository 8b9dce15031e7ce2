"""Zero-shot, the logistic probe and the full-shot trainer on the Swin
family and ConvViT through both packages: ``zeroshot_main`` and
``logistic_main`` on tiny CLIP Swin, and the full-shot ``Trainer``'s epochs
on tiny cls_swin and ConvViT (its mixer's BN live) against the JAX
``Trainer``, then ``update_bn``.  The few-shot driver on Swin is in
``test_torch_port_swin_drivers.py``.

Tolerances: the zero-shot score within 1e-4; the Swin features within 1e-5
of the largest; the trainer's epoch
losses within 1e-4 relative, its leaves within 1e-4 relative + 1e-5 and its
BN statistics within 1e-4 of their largest value, eval top-1 equal.
"""

import numpy as np
import pytest

import jax
import peft_vit_tpu.commands.zeroshot_eval as jax_zs
import peft_vit_tpu_torch.commands.linear_probe as port_lp
import peft_vit_tpu_torch.commands.zeroshot_eval as port_zs
from peft_vit_tpu import config as jax_config
from peft_vit_tpu_torch import config as port_config
from test_torch_port_clip_resnet import _capture
from test_torch_port_driver import jax_text_variables, tiny_cfg
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)
from test_torch_port_swin_drivers import NAMES, SWIN
from test_torch_port_zeroshot import _synthetic_prompts  # noqa: F401 (an autouse fixture)


def test_zeroshot_and_logistic_probe_on_clip_swin_match_jax(monkeypatch, tmp_path):
    """``zeroshot_main`` (the text tower beside the Swin tower): the same
    score; ``logistic_main`` on the Swin tower: its features the JAX
    tower's."""
    over = {**SWIN, "MODEL.NAME": NAMES["clip"], "TEST.BATCH_SIZE_PER_GPU": 128,
            "TRAIN.SEARCH_WD_LOG_LOWER": -3, "TRAIN.SEARCH_WD_LOG_UPPER": 3}
    built = _capture(monkeypatch, jax_zs)
    want = jax_zs.zeroshot_main(tiny_cfg(jax_config, **over))
    variables = jax.tree_util.tree_map(np.asarray, dict(built["out"][1]))
    text = jax_text_variables(built["out"][2], {"PEFT.METHOD": "finetune_contrast"})
    got = port_zs.zeroshot_main(tiny_cfg(port_config, **over), device="cpu",
                                variables=variables, text_variables=text)
    assert got == pytest.approx(want, abs=1e-4)

    # the logistic probe: the port's logistic_main on the Swin tower, whose
    # features (train, val, test) are the JAX Swin tower's within 1e-5 of the
    # largest (fp32 sums in other orders, 2.5e-7 measured); the fit itself is
    # held against optax in test_torch_port_probes.py
    from peft_vit_tpu.models.factory import backbone_eval_variables

    sweeps = {}
    real = port_lp.logistic_probe_sweep
    monkeypatch.setattr(port_lp, "logistic_probe_sweep",
                        lambda *a, **kw: sweeps.setdefault("port", (a, real(*a, **kw)))[1])
    jmodel, jvars, _ = built["out"]
    got = port_lp.logistic_main(tiny_cfg(port_config, **over), str(tmp_path / "port"),
                                device="cpu", variables=variables)
    args, (acc, c) = sweeps["port"]
    assert got == acc and np.isfinite(acc) and c > 0
    from peft_vit_tpu.data import construct_splits
    from peft_vit_tpu.engine.zeroshot import extract_image_features

    splits = construct_splits(tiny_cfg(jax_config, **over))
    encode = jax.jit(lambda x: jmodel.backbone.apply(backbone_eval_variables(jvars), x))
    for i, x in ((0, splits.x_train), (2, splits.x_val), (4, splits.x_test)):
        want = np.asarray(extract_image_features(encode, x, batch_size=128))
        np.testing.assert_allclose(np.asarray(args[i]), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


TRAINER_TOWERS = {
    "cls_swin": {"MODEL.NAME": "cls_swin_tiny", **{k: v for k, v in SWIN.items()
                                                  if k.startswith(("MODEL.SPEC.VISION",
                                                                   "TRAIN"))}},
    "cls_vit_conv": {"MODEL.NAME": "cls_vit_conv", "TRAIN.IMAGE_SIZE": [32, 32],
                     "MODEL.SPEC.VISION.PATCH_SIZE": 8, "MODEL.SPEC.VISION.WIDTH": 16,
                     "MODEL.SPEC.VISION.LAYERS": 2, "MODEL.SPEC.VISION.HEADS": 2,
                     "MODEL.SPEC.VISION.RES_SCORE": True, "MODEL.SPEC.VISION.ADD_CLS": True},
}


@pytest.mark.parametrize("tower", sorted(TRAINER_TOWERS))
def test_trainer_epochs_on_swin_and_convvit_match_jax(tower):
    """The full fine-tune through the JAX builder's tower: two epochs of the
    port's Trainer against the JAX Trainer (SGD, warmup-cosine; ConvViT's
    mixer BN live, its statistics carried), then ``update_bn`` on ConvViT;
    at lr 1e-4 (train-mode BN at batch 8, as the ResNet's)."""
    from flax import traverse_util

    from peft_vit_tpu.engine.trainer import Trainer as JaxTrainer
    from peft_vit_tpu.engine.trainer import batch_iterator as jax_batches
    from peft_vit_tpu.models.factory import build_image_classifier as jax_build
    from peft_vit_tpu.peft import build_mask as jax_mask
    from peft_vit_tpu.peft.spec import spec_from_config as jax_spec_from
    from peft_vit_tpu_torch.engine.trainer import Trainer, batch_iterator
    from peft_vit_tpu_torch.models import build_image_classifier, load_jax_variables
    from peft_vit_tpu_torch.peft import build_mask, spec_from_config
    from test_torch_port_trainer import _data, _flat, _port_flat, make_cfg

    over = {**TRAINER_TOWERS[tower], "TRAIN.LR": 1e-4, "TRAIN.MOMENTUM": 0.9}
    x, y = _data(n_per_class=8)
    x = np.repeat(np.repeat(x, 2, axis=1), 2, axis=2)  # 16 -> 32 px
    jcfg, pcfg = make_cfg(jax_config.get_default_config, **over), make_cfg(**over)
    jmodel, variables, _ = jax_build(jcfg, jax_spec_from(jcfg), 4)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    stats = variables.get("batch_stats")
    jt = JaxTrainer(jcfg, jmodel, variables["params"],
                    jax_mask(variables["params"], "full", num_layers=12), steps_per_epoch=4,
                    batch_stats=stats)
    model, _, _ = build_image_classifier(pcfg, spec_from_config(pcfg), 4, device="cpu")
    load_jax_variables(model, variables)
    pt = Trainer(pcfg, model, build_mask(model, "full", num_layers=12), 4)
    assert pt.has_bn == (stats is not None) == (tower == "cls_vit_conv")
    for e in range(2):
        want = jt.train_one_epoch(jax_batches(x, y, 8, seed=e), epoch=e)["loss"]
        got = pt.train_one_epoch(batch_iterator(x, y, 8, seed=e), epoch=e)["loss"]
        assert got == pytest.approx(want, rel=1e-4)
    want = _flat(jt.state.trainable)
    for k, v in _port_flat(pt.state.trainable).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    kw = dict(shuffle=False, drop_last=False)
    assert pt.evaluate(batch_iterator(x, y, 8, **kw)) == jt.evaluate(jax_batches(x, y, 8, **kw))
    if stats is None:
        return

    def hold(got, want):
        want = traverse_util.flatten_dict(want, sep="/")
        got = _port_flat(got, "batch_stats")
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(v, np.asarray(want[k]), rtol=0,
                                       atol=1e-4 * np.abs(np.asarray(want[k])).max(), err_msg=k)

    hold(pt.state.batch_stats, jt.state.batch_stats)
    batches = list(batch_iterator(x, y, 8, shuffle=False))
    hold(pt.update_bn(iter(batches)), jt.update_bn(iter(batches)))
