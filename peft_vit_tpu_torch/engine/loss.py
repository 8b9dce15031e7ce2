"""The contrastive losses (the part of ``peft_vit_tpu/engine/loss.py`` the
contrastive methods use): symmetric InfoNCE (the reference's
clip_openai.py CLIPContrastive) and HybridContrastive (criterion.py:21-46),
over the softmax and soft-target cross entropies they are built from.  Every
function takes logits, computes in fp32 and returns a scalar mean loss.  The
rest of the loss zoo belongs to the full-shot trainer (ROADMAP §1, full-shot).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Cross entropy with integer targets, the mean over the rows."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logp.gather(-1, target[:, None].long())[:, 0].mean()


def soft_target_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Cross entropy with probability-vector targets (timm's
    SoftTargetCrossEntropy), the mean over the rows."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -(target.to(torch.float32) * logp).sum(dim=-1).mean()


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
