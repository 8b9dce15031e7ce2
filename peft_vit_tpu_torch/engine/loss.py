"""The loss zoo (counterpart of ``peft_vit_tpu/engine/loss.py``).

The reference's full-shot criteria (full_shot/main/lib/core/loss.py:17-154:
softmax cross entropy with label smoothing, soft-target cross entropy,
focal, sigmoid multilabel BCE, multi-softmax, MultiLabelSoftMarginLoss), the
contrastive losses (clip_openai.py CLIPContrastive, criterion.py:21-46
HybridContrastive) and ``build_criterion``.  Every function takes logits,
computes in fp32 and returns a scalar loss, with the JAX functions'
arithmetic: integer targets become one-hot rows as ``jax.nn.one_hot`` makes
them, so a negative label is a zero row (it adds nothing to the loss).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``jax.nn.one_hot``: fp32 rows, all zero for a label outside
    [0, num_classes)."""
    classes = torch.arange(num_classes, device=target.device)
    return (target[..., None] == classes).to(torch.float32)


def _as_onehot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    if target.dim() == 1:
        return one_hot(target, num_classes)
    return target.to(torch.float32)


def softmax_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Cross entropy with integer or probability-vector targets, the mean
    over the rows; optional label smoothing (timm's
    LabelSmoothingCrossEntropy)."""
    num_classes = logits.shape[-1]
    onehot = _as_onehot(target, num_classes)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -(onehot * logp).sum(dim=-1).mean()


def soft_target_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Cross entropy with probability-vector targets (timm's
    SoftTargetCrossEntropy; mixup's output), the mean over the rows."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -(target.to(torch.float32) * logp).sum(dim=-1).mean()


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, elementwise."""
    labels = labels.to(logits.dtype)
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def sigmoid_multilabel_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCEWithLogits, the mean over every element (the few-shot multilabel
    criterion)."""
    return sigmoid_binary_cross_entropy(logits.to(torch.float32),
                                        target.to(torch.float32)).mean()


def focal_loss(logits: torch.Tensor, target: torch.Tensor, alpha: float = 1.0,
               gamma: float = 0.5, normalize: bool = True) -> torch.Tensor:
    """Sigmoid focal loss, the reference's exact semantics (FocalLoss,
    loss.py:31-60): BCE-with-logits times the modulator
    exp(gamma * (-t x + log_sigmoid(x))), alpha-weighted, summed, and divided
    by target.sum() (at least 1e-8) when ``normalize``."""
    x = logits.to(torch.float32)
    t = _as_onehot(target, x.shape[-1])
    bce = sigmoid_binary_cross_entropy(x, t)
    if gamma == 0.0:
        modulator = 1.0
    else:
        modulator = torch.exp(gamma * (-t * x + F.logsigmoid(x)))
    loss = alpha * (modulator * bce).sum()
    if normalize:
        loss = loss / t.sum().clamp_min(1e-8)
    return loss


def multi_softmax_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MultiSoftmaxCrossEntropyLoss (loss.py:63-107): sum(-t log_softmax(x))
    over the whole batch divided by the total positive count t.sum()."""
    t = _as_onehot(target, logits.shape[-1])
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return (-t * logp).sum() / t.sum().clamp_min(1e-8)


def multilabel_soft_margin_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``torch.nn.MultiLabelSoftMarginLoss(reduction='sum')`` as the JAX
    package computes it: the per-row mean over classes of BCE-with-logits,
    summed over the batch (the full-shot 'sigmoid' criterion)."""
    bce = sigmoid_binary_cross_entropy(logits.to(torch.float32), target.to(torch.float32))
    return bce.mean(dim=-1).sum()


def clip_contrastive_loss(logits_per_image: torch.Tensor,
                          logits_per_text: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE: pair i is the positive of row i, both directions."""
    labels = torch.arange(logits_per_image.shape[0], device=logits_per_image.device)
    return 0.5 * (softmax_cross_entropy(logits_per_image, labels)
                  + softmax_cross_entropy(logits_per_text, labels))


def _same_class_targets(target: torch.Tensor) -> torch.Tensor:
    """Row-normalized soft targets marking every pair of one class positive."""
    t = target.reshape(-1, 1)
    same = (t == t.t()).to(torch.float32)
    return same / same.sum(dim=-1, keepdim=True).clamp_min(1e-8)


def hybrid_contrastive_loss(image_feats: torch.Tensor, text_feats: torch.Tensor,
                            target: torch.Tensor, logit_scale: torch.Tensor) -> torch.Tensor:
    """HybridContrastive: soft-target cross entropy in both directions of the
    (B, B) image-text logits ``exp(logit_scale)`` times the cosines, every
    pair with the same class label a positive."""
    img = image_feats / torch.linalg.vector_norm(image_feats, dim=-1, keepdim=True)
    txt = text_feats / torch.linalg.vector_norm(text_feats, dim=-1, keepdim=True)
    logits_i = torch.exp(logit_scale) * img @ txt.t()
    soft = _same_class_targets(target)
    return 0.5 * (soft_target_cross_entropy(logits_i, soft)
                  + soft_target_cross_entropy(logits_i.t(), soft))


def build_criterion(cfg, train: bool = True):
    """The criterion ``LOSS.LOSS`` names (loss.py:131-154 semantics), a
    function of (logits, target) -> scalar: softmax / CE (label-smoothed in
    training when ``LOSS.LABEL_SMOOTHING`` > 0), softmax_smooth /
    labelSmoothCE, soft_target / softTargetCE, sigmoid
    (MultiLabelSoftMarginLoss, summed), multilabel (BCE, mean), focal
    (``LOSS.FOCAL``), multi_softmax / multiSoftmax."""
    name = cfg.LOSS.LOSS
    smoothing = float(cfg.LOSS.LABEL_SMOOTHING)
    if name in ("softmax", "CE"):
        if train and smoothing > 0.0:
            return lambda logits, target: softmax_cross_entropy(logits, target, smoothing)
        return lambda logits, target: softmax_cross_entropy(logits, target)
    if name in ("softmax_smooth", "labelSmoothCE"):
        return lambda logits, target: softmax_cross_entropy(
            logits, target, smoothing if train else 0.0)
    if name in ("soft_target", "softTargetCE"):
        return soft_target_cross_entropy
    if name == "sigmoid":
        return multilabel_soft_margin_loss
    if name == "multilabel":
        return sigmoid_multilabel_loss
    if name == "focal":
        alpha = float(cfg.LOSS.FOCAL.ALPHA)
        gamma = float(cfg.LOSS.FOCAL.GAMMA)
        normalize = bool(cfg.LOSS.FOCAL.NORMALIZE)
        return lambda logits, target: focal_loss(logits, target, alpha, gamma, normalize)
    if name in ("multi_softmax", "multiSoftmax"):
        return multi_softmax_cross_entropy
    raise ValueError(f"Unknown loss {name!r}")
