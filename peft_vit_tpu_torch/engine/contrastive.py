"""The contrastive training paths (counterpart of
``peft_vit_tpu/engine/contrastive.py``).

* The contrastive fine-tune and probe (the reference's
  evaluation/linear_classifier_contrast.py:62-524 with criterion.py:21-46
  HybridContrastive): image features against per-class text features, every
  pair of one class a positive.  ``hybrid_contrastive_per_example`` is the
  driver's criterion over ``models.classifier.ContrastiveClassifier``'s
  (B, C) pair logits.
* CLIP pre-training (full_shot tools/train_clip.py +
  lib/core/function_clip.py + clip_openai.py:380-552): the symmetric InfoNCE
  of an (image, token) batch (``clip_contrastive_step_fn``), and the step of
  ``commands.train_clip`` (``make_clip_train_step``).  Over a process group
  the logits are those of the GLOBAL batch: each process's normalized
  features are gathered with their gradients (``parallel.gather_features``,
  the GATHER_TENSORS spec, clip_openai.py:551-552).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..parallel import collectives
from . import train as _train
from .loss import clip_contrastive_loss, hybrid_contrastive_loss


def _normalized(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def clip_contrastive_step_fn(encode_image: Callable, encode_text: Callable,
                             gather: bool = False):
    """``loss_fn(params, images, tokens, logit_scale)``: symmetric InfoNCE of
    the L2-normalized image and text features; with ``gather`` against the
    features of the whole group (``parallel.gather_features``: call it in
    every process of a group)."""

    def loss_fn(params, images, tokens, logit_scale):
        img = _normalized(encode_image(params, images))
        txt = _normalized(encode_text(params, tokens))
        if gather:
            img, txt = collectives.gather_features(img), collectives.gather_features(txt)
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


def _sub(params: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def clip_opt_state(tx, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The optimizer state of ``make_clip_train_step``: ``tx.init(params)``
    and ``step``, the schedule's count (int32, on the parameters' device)."""
    device = next(iter(params.values())).device
    return {**tx.init(params), "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_clip_train_step(model: nn.Module, tx, mesh=None, gather: bool = False):
    """The CLIP pre-training step (tools/train_clip.py +
    lib/core/function_clip.py): ``step(params, opt_state, images, tokens) ->
    (params, opt_state, loss)`` over ``model`` (``models.clip.CLIP``) with
    ``params`` (name -> fp32 tensor, every leaf ``tx`` trains,
    ``engine.optim.build_optimizer``) substituted, ``opt_state`` from
    ``clip_opt_state``.

    Without a mesh the loss is the model's own logits'
    (``clip_contrastive_loss``).  With a mesh (``parallel.make_mesh``, every
    process of the group calling the step on its rows) it is the global
    batch's: each process's normalized features are gathered with
    ``parallel.gather_features`` and the logits computed in fp32 over the
    global batch, and the parameter gradients are all-reduced as a mean
    before ``tx`` applies them; that is the JAX step's gradient of the
    global-batch loss.  ``gather`` names the JAX package's GATHER_TENSORS
    path; without it the JAX step computes the same global-batch loss
    through GSPMD, so over a mesh both take the gathered loss.

    On the card the step is a ``StepGraph`` replay (collectives included;
    the group's communicator made by one eager collective before the
    capture), and the ``params`` and ``opt_state`` it returns are the
    graph's buffers: hand them back to the next call.  The CPU runs it
    eagerly, updating ``params`` and ``opt_state`` in place."""
    del gather  # over a mesh the loss is the global batch's either way
    model.train(False)

    def loss_fn(params, images, tokens):
        if mesh is None:
            li, lt = functional_call(model, dict(params), (images, tokens))
            return clip_contrastive_loss(li, lt)
        img = _normalized(functional_call(model.visual, _sub(params, "visual."), (images,)))
        txt = _normalized(functional_call(model.text, _sub(params, "text."), (tokens,)))
        img, txt = collectives.gather_features(img), collectives.gather_features(txt)
        scale = torch.exp(params["logit_scale"].to(torch.float32))
        logits = scale * img.to(torch.float32) @ txt.to(torch.float32).t()
        return clip_contrastive_loss(logits, logits.t())

    def body(params, opt_state, images, tokens):
        for v in params.values():
            v.requires_grad_()
        loss = loss_fn(params, images, tokens)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        with torch.no_grad():
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(params.items(), grads)}
            if mesh is not None:
                grads = {k: collectives.psum_mean(g) for k, g in grads.items()}
            tx.step(params, grads, opt_state, opt_state["step"])
            opt_state["step"].add_(1)
        return loss.detach()

    graphs: Dict[str, _train.StepGraph] = {}

    def step(params, opt_state, images, tokens):
        if not _train.runs_captured(images):
            loss = body(params, opt_state, images, tokens)
            return params, opt_state, loss
        graph = graphs.get("step")
        if graph is None:
            if mesh is not None:  # the communicator exists before the capture
                torch.distributed.barrier()
            inputs = {"params": dict(params), "opt": dict(opt_state), "images": images,
                      "tokens": tokens}
            graph = graphs["step"] = _train.StepGraph(
                lambda b: body(b["params"], b["opt"], b["images"], b["tokens"]), inputs)
        held = graph.inputs
        if params is held["params"] and opt_state is held["opt"]:
            loss = graph(images=images, tokens=tokens)
        else:
            loss = graph(params=params, opt=opt_state, images=images, tokens=tokens)
        return held["params"], held["opt"], loss.clone()

    return step


def contrastive_eval_logits(image_features: torch.Tensor,
                            class_text_features: torch.Tensor) -> torch.Tensor:
    """Classification logits: 100 times the cosine against each class's
    text features (the linear_classifier_contrast validate path)."""
    img = image_features / torch.linalg.vector_norm(image_features, dim=-1, keepdim=True)
    txt = class_text_features / torch.linalg.vector_norm(class_text_features, dim=-1,
                                                         keepdim=True)
    return 100.0 * img @ txt.t()
