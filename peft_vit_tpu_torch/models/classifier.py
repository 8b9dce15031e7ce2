"""Classification head over a backbone (counterpart of
``peft_vit_tpu/models/classifier.py``).

Forward order as in the reference: channel BN (optional) -> optional L2
normalize -> Linear.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import dist as _dist
from .layers import Dense
from .resnet import _group_moments


class FeatureBatchNorm(nn.Module):
    """BatchNorm1d(affine=False) over (B, D) features with torch-exact
    running statistics: training normalizes with the biased batch variance
    and blends the unbiased one into ``bn_var`` at momentum 0.1; eval uses
    the running statistics.  Computes in fp32 and returns ``dtype``; the
    statistics stay fp32."""

    momentum = 0.1  # torch convention: weight of the new batch
    epsilon = 1e-5

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("bn_mean", torch.zeros(num_features, device=device))
        self.register_buffer("bn_var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training and _dist.current_shard() is not None:
            # a step over a data group: the global batch's moments
            # (``resnet.batch_norm``'s two passes over the group)
            mean, var = _group_moments(x, (0,))
            n = _dist.data_rows()
            with torch.no_grad():
                m = self.momentum
                self.bn_mean.copy_((1.0 - m) * self.bn_mean + m * mean)
                self.bn_var.copy_((1.0 - m) * self.bn_var + m * (var * (n / max(n - 1, 1))))
            return ((x - mean) * torch.rsqrt(var + self.epsilon)).to(self.dtype)
        y = F.batch_norm(
            x, self.bn_mean, self.bn_var, training=self.training,
            momentum=self.momentum, eps=self.epsilon,
        )
        return y.to(self.dtype)


class ClassifierHead(nn.Module):
    """channel_bn (optional) -> optional L2 normalize -> Linear head."""

    def __init__(self, in_features: int, num_classes: int, use_bn: bool = False,
                 normalize_input: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.normalize_input = normalize_input
        self.channel_bn = (
            FeatureBatchNorm(in_features, dtype=dtype, device=device) if use_bn else None
        )
        self.head = Dense(in_features, num_classes, dtype=dtype, device=device)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats.to(self.dtype)
        if self.channel_bn is not None:
            x = self.channel_bn(x)
        if self.normalize_input:
            x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
        return self.head(x)


class ImageClassifier(nn.Module):
    """backbone -> head; the flagship PEFT fine-tuning model.

    ``backbone`` returns pooled (B, backbone.num_features) features."""

    def __init__(self, backbone: nn.Module, num_classes: int = 10, use_bn: bool = False,
                 normalize_visual: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.backbone = backbone
        self.classifier = ClassifierHead(
            backbone.num_features, num_classes, use_bn=use_bn,
            normalize_input=normalize_visual, dtype=dtype, device=device,
        )

    def forward(self, images: torch.Tensor, start_layer: int = 0, progress=None,
                generator=None) -> torch.Tensor:
        """``start_layer`` > 0: ``images`` are the tokens after block
        ``start_layer - 1`` (the cached-prefix sweep, ``engine.cached``).
        ``progress`` (the DropBlock anneal's position) and ``generator`` (its
        draws) go to the backbone when given: only a ResNet takes them (the
        full-shot trainer passes them under ``AUG.DROPBLOCK_KEEP_PROB`` < 1)."""
        if progress is None and generator is None:
            return self.classifier(self.backbone(images, start_layer=start_layer))
        return self.classifier(self.backbone(images, start_layer=start_layer,
                                             progress=1.0 if progress is None else progress,
                                             generator=generator))


class ContrastiveClassifier(nn.Module):
    """Image tower and a trainable logit scale against a frozen bank of
    class-text features (counterpart of the JAX ``ContrastiveClassifier``;
    the reference's linear_classifier_contrast.py Classifier): the text
    tower is frozen, so the (C, D) L2-normalized class features are computed
    once (``engine.zeroshot.extract_text_features``) and held here as a
    buffer; the forward gives the (B, C) pair logits
    ``exp(logit_scale) * feats @ text^T`` in fp32, ``logit_scale`` a fresh
    scalar 1.0 in fp32."""

    def __init__(self, backbone: nn.Module, text_features: torch.Tensor, device=None):
        super().__init__()
        self.backbone = backbone
        self.register_buffer("text_features",
                             torch.as_tensor(text_features, dtype=torch.float32, device=device))
        self.logit_scale = nn.Parameter(torch.ones((), device=device))

    def forward(self, images: torch.Tensor, start_layer: int = 0) -> torch.Tensor:
        feats = self.backbone(images, start_layer=start_layer).to(torch.float32)
        return torch.exp(self.logit_scale) * feats @ self.text_features.t()
