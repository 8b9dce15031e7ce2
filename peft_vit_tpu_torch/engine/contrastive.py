"""The contrastive training paths (counterpart of
``peft_vit_tpu/engine/contrastive.py``).

* The contrastive fine-tune and probe (the reference's
  evaluation/linear_classifier_contrast.py:62-524 with criterion.py:21-46
  HybridContrastive): image features against per-class text features, every
  pair of one class a positive.  ``hybrid_contrastive_per_example`` is the
  driver's criterion over ``models.classifier.ContrastiveClassifier``'s
  (B, C) pair logits.
* CLIP's contrastive loss of an (image, token) batch
  (``clip_contrastive_step_fn``, one device; the global-batch gather of the
  JAX function belongs to parallelism).
* ``make_clip_train_step``, CLIP pre-training, belongs to ``train_clip`` and
  parallelism and is not ported.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from .loss import clip_contrastive_loss, hybrid_contrastive_loss


def clip_contrastive_step_fn(encode_image: Callable, encode_text: Callable,
                             gather: bool = False):
    """``loss_fn(params, images, tokens, logit_scale)``: symmetric InfoNCE of
    the L2-normalized image and text features of one device's batch.
    ``gather`` (the JAX function's all-gathered global batch) raises."""
    if gather:
        raise NotImplementedError("the global-batch gather is not ported to peft_vit_tpu_torch "
                                  "(ROADMAP §1, parallelism)")

    def loss_fn(params, images, tokens, logit_scale):
        img = encode_image(params, images)
        txt = encode_text(params, tokens)
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        logits_i = torch.exp(logit_scale.to(torch.float32)) * img @ txt.t()
        return clip_contrastive_loss(logits_i, logits_i.t())

    return loss_fn


def hybrid_contrastive_step_fn(encode_image: Callable):
    """``loss_fn(params, text_features, images, labels, logit_scale)``: image
    features against the per-class text features of the batch's labels."""

    def loss_fn(params, text_features, images, labels, logit_scale):
        img = encode_image(params, images)
        return hybrid_contrastive_loss(img, text_features[labels], labels, logit_scale)

    return loss_fn


def hybrid_contrastive_per_example(class_logits: torch.Tensor,
                                   target: torch.Tensor) -> torch.Tensor:
    """Per-example HybridContrastive (i2t and t2i) of (B, C) scaled
    image-vs-class-text logits: the (B, B) image-text pair matrix of the
    reference's train_one (linear_classifier_contrast.py:258-264) is
    ``class_logits[:, target]``, since batch text j's feature is the class
    feature of label y_j; the soft targets mark every same-class pair
    positive, row-normalized, in both directions."""
    if target.dim() != 1:
        raise ValueError("hybrid contrastive needs integer class targets")
    pair = class_logits[:, target]  # (B, B)
    same = (target[:, None] == target[None, :]).to(torch.float32)
    soft = same / same.sum(dim=-1, keepdim=True).clamp_min(1e-8)
    row = -(soft * F.log_softmax(pair, dim=-1)).sum(dim=-1)
    col = -(soft * F.log_softmax(pair.t(), dim=-1)).sum(dim=-1)
    return 0.5 * (row + col)


def make_clip_train_step(*args, **kwargs):
    """CLIP pre-training (``train_clip``) is not ported."""
    raise NotImplementedError("make_clip_train_step (CLIP pre-training, train_clip) is not "
                              "ported to peft_vit_tpu_torch (ROADMAP §1, parallelism)")


def contrastive_eval_logits(image_features: torch.Tensor,
                            class_text_features: torch.Tensor) -> torch.Tensor:
    """Classification logits: 100 times the cosine against each class's
    text features (the linear_classifier_contrast validate path)."""
    img = image_features / torch.linalg.vector_norm(image_features, dim=-1, keepdim=True)
    txt = class_text_features / torch.linalg.vector_norm(class_text_features, dim=-1,
                                                         keepdim=True)
    return 100.0 * img @ txt.t()
