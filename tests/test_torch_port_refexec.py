"""The port against the EXECUTED reference: the outputs that the original
PyTorch code produced, stored in ``tests/golden/refexec_*.npz`` (and, for the
post-scale-q attention, the independent re-implementation
``lora_post_scale_q.npz``), read through the port's own modules and
converters on the CPU in fp32, at the tolerances of the JAX package's tests
of the same fixtures:

* ``refexec_lora_post_scale_q.npz``: the LoRA ``MultiHeadAttention`` with
  the post-scale-q quirk (``tests/test_golden_quirks.py``), atol = rtol =
  1e-5;
* ``refexec_lora_clip_model.npz``: the image features of the reference's
  LoRA CLIP through the port's visual tower and
  ``models.convert.clip_state_dict_to_tree`` (``tests/test_refexec_models.py``),
  rtol 1e-4, atol 1e-5 (its text features: ``test_torch_port_text.py``);
* ``refexec_trajectory_lora.npz``: the reference's own few-shot training run
  (4 epochs of SGD at batch 4, step decay, channel BN) replayed through the
  port's ``make_epoch_fn`` / ``make_eval_fn``, with the reference's
  eval-mode BN after epoch 0 and its LoRA delta reshape
  (``PEFT.LORA_REF_RESHAPE``), as ``tests/test_refexec_trajectory.py``
  replays it through the JAX engine: losses rtol 2e-3, atol 2e-4; val
  accuracies and the best score exact;
* ``refexec_trajectory_adapter.npz``: the same for the reference's Houlsby
  adapter run (adapter_tuning_clip.py), its adapters loaded through the
  checkpoint converter.
"""

import os

import numpy as np
import pytest
import torch

from peft_vit_tpu_torch.engine import ce_per_example
from peft_vit_tpu_torch.engine.train import (
    init_cell_state,
    make_apply_fn,
    make_epoch_fn,
    make_eval_fn,
    step_decay_lr,
)
from peft_vit_tpu_torch.models.classifier import ImageClassifier
from peft_vit_tpu_torch.models.convert import (
    clip_state_dict_to_tree,
    infer_clip_shape,
    visual_state_dict,
)
from peft_vit_tpu_torch.models.layers import MultiHeadAttention
from peft_vit_tpu_torch.models.vit import VisionTransformer
from peft_vit_tpu_torch.peft import PEFTSpec, build_mask, split_params

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# the reference's LoRA CLIP: lora_attn_dim 4, lora_attn_alpha 128, q and v,
# q scaled before its delta is added (lora_model.py:465-469, 720-742)
LORA = dict(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
            lora_post_scale_q=True, lora_targets=("q", "v"))


def _load(name):
    return np.load(os.path.join(GOLDEN, name))


def _sd(g, prefix=""):
    """The torch state dict stored as ``sd__a__b`` keys, ``prefix`` cut."""
    sd = {k[len("sd__"):].replace("__", "."): np.asarray(g[k])
          for k in g.files if k.startswith("sd__")}
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _visual(sd, spec):
    """The port's visual tower of a CLIP state dict, its weights loaded
    strictly through the port's converter."""
    info = infer_clip_shape(sd)
    vit = VisionTransformer(
        image_size=info["image_size"], patch_size=info["patch_size"],
        width=info["vision_width"], layers=info["vision_layers"],
        heads=max(info["vision_width"] // 64, 1),  # the reference hardcodes width // 64
        output_dim=info["embed_dim"], spec=spec, device="cpu",
    )
    state = {k[len("backbone."):]: v for k, v in visual_state_dict(clip_state_dict_to_tree(sd)).items()}
    vit.load_state_dict(state, strict=True)
    return vit


def _nhwc(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1)))


@pytest.mark.parametrize("fname", ["lora_post_scale_q.npz", "refexec_lora_post_scale_q.npz"])
def test_lora_post_scale_q_attention_matches_the_reference(fname):
    g = _load(fname)
    d = g["x"].shape[-1]
    spec = PEFTSpec(**{**LORA, "lora_rank": int(g["rank"]), "lora_alpha": float(g["alpha"])})
    m = MultiHeadAttention(d, int(g["heads"]), spec=spec, device="cpu")
    weights = {
        "in_proj.weight": g["w_qkv"], "in_proj.bias": g["b_qkv"],
        "q_adapter1.weight": g["a_q"], "q_adapter2.weight": g["b_q"],
        "v_adapter1.weight": g["a_v"], "v_adapter2.weight": g["b_v"],
        "out_proj.weight": g["w_out"], "out_proj.bias": g["b_out"],
    }
    m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in weights.items()},
                      strict=True)
    with torch.no_grad():
        out = m(torch.from_numpy(g["x"]))
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=1e-5, atol=1e-5)


def test_lora_clip_image_features_match_the_executed_reference():
    """Every visual block of lora_model.py's CLIP runs the LoRA attention
    (rank 4, alpha 128, post-scale-q); batch 1 and one head make the
    reference's delta reshape the identity."""
    g = _load("refexec_lora_clip_model.npz")
    vit = _visual(_sd(g), PEFTSpec(**LORA)).eval()
    with torch.no_grad():
        feats = vit(_nhwc(g["x"]))
    np.testing.assert_allclose(feats.numpy(), g["feats_img"], rtol=1e-4, atol=1e-5)


def _replay_trajectory(fname, spec, method):
    g = _load(fname)
    sd = _sd(g)
    num_classes = int(g["y_train"].max()) + 1
    backbone = _visual(_sd(g, "backbone."), spec)
    model = ImageClassifier(backbone, num_classes=num_classes, use_bn=True, device="cpu")
    head = {"classifier.head.weight": sd["layers.0.weight"],
            "classifier.head.bias": sd["layers.0.bias"],
            "classifier.channel_bn.bn_mean": sd["channel_bn.running_mean"],
            "classifier.channel_bn.bn_var": sd["channel_bn.running_var"]}
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in head.items()}, strict=False)
    assert not unexpected and all(k.startswith("backbone.") for k in missing)

    batch, epochs = int(g["batch"]), int(g["epochs"])
    schedule = [int(s) for s in g["schedule"]]
    base_lr, wd = float(g["lr"]), float(g["wd"])
    trainable, frozen = split_params(model, build_mask(model, method,
                                                       num_layers=len(backbone.blocks)))
    bn = dict(model.named_buffers())
    apply_fn = make_apply_fn(model)
    # the executed reference never calls model.train() and validates in eval
    # mode after every epoch: epochs >= 1 train with channel BN in eval mode
    # (its running statistics from epoch 0), still taking gradients
    apply_eval_mode = lambda v, x, train: apply_fn(v, x, False)
    epoch_fns = [make_epoch_fn(fn, ce_per_example, batch, momentum=0.9, nesterov=True,
                               has_bn=True) for fn in (apply_fn, apply_eval_mode)]
    eval_fn = make_eval_fn(apply_fn, batch, has_bn=True)

    x_tr, y_tr = _nhwc(g["x_train"]), torch.from_numpy(np.asarray(g["y_train"]))
    x_va, y_va = _nhwc(g["x_val"]), np.asarray(g["y_val"])
    n = x_tr.shape[0]
    valid = torch.ones(n, dtype=torch.bool)
    perm = torch.arange(n)  # the reference iterates in dataset order
    state = init_cell_state(trainable, bn)
    losses, vals = [], []
    for epoch in range(epochs):
        lr = step_decay_lr(base_lr, epoch, schedule)
        state, mean_loss = epoch_fns[min(epoch, 1)](state, {}, x_tr, y_tr, valid, perm, lr, wd)
        losses.append(float(mean_loss))
        logits = eval_fn(state.trainable, frozen, x_va, state.bn)
        vals.append(float((logits.argmax(-1).numpy() == y_va).mean()))

    np.testing.assert_allclose(losses, g["train_losses"], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(vals, g["val_metrics"], atol=1e-6)
    np.testing.assert_allclose(100.0 * max(vals), float(g["best"]), atol=1e-4)


def test_lora_training_trajectory_matches_the_executed_reference():
    _replay_trajectory("refexec_trajectory_lora.npz",
                       PEFTSpec(**{**LORA, "lora_ref_reshape": True}), "lora")


def test_adapter_training_trajectory_matches_the_executed_reference():
    """adapter_tuning_clip.py's run: the Houlsby adapter (dim 64, ReLU) after
    every block's MLP, the adapters and the head trained, loaded from the
    reference's state dict through the checkpoint converter."""
    _replay_trajectory("refexec_trajectory_adapter.npz",
                       PEFTSpec(method="adapter", adapter="houlsby", adapter_dim=64,
                                adapter_act="relu"), "adapter")
