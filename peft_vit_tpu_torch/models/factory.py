"""Model builders (counterpart of ``peft_vit_tpu/models/factory.py``).

* ``flagship`` — the ViT-B/16 LoRA classifier of the benchmarks.
* ``build_image_classifier`` — the config-driven build of the few-shot
  driver and the full-shot trainer, the ViT branches of the JAX builder:
  for a CLIP model the architecture from ``MODEL.SPEC`` or from the
  ``MODEL.PRETRAINED`` OpenAI CLIP checkpoint, whose visual and text
  weights it loads (the PEFT leaves and the head stay fresh), and the
  frozen text tower as ``encode_text``; for any other name outside the
  backbone zoo's families (``cls_vit*``, ``vit*``) the supervised
  timm-style ViT from ``MODEL.SPEC.VISION``, a timm checkpoint grafted onto
  it when ``MODEL.PRETRAINED`` names one.
* ``init_head_from_text`` — the head from the zero-shot text classifier.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.attention import check_softmax_fp32
from ..ops.int8 import INT8_TARGET_MODULES
from ..peft.spec import PEFTSpec
from ..utils import resolve_device
from .classifier import ImageClassifier
from .convert import (clip_state_dict_to_tree, infer_clip_shape, load_torch_checkpoint,
                      text_state_dict, timm_vit_state_dict, timm_vit_state_dict_to_tree,
                      visual_state_dict)
from .layers import cast_frozen_
from .text import TextEncoder, TextTransformer
from .vit import VisionTransformer

logger = logging.getLogger(__name__)


def flagship(
    width: int = 768,
    layers: int = 12,
    heads: int = 12,
    image: int = 224,
    patch: int = 16,
    num_classes: int = 100,
    dtype: torch.dtype = torch.bfloat16,
    use_bn: bool = False,
    ln_fp32: bool = True,
    int8: bool = False,
    int8_train: bool = False,
    int8_targets: Sequence[str] = INT8_TARGET_MODULES,
    patch_gemm: bool = False,
    int8_attn: bool = False,
    int8_attn_pv: bool = False,
    device=None,
) -> ImageClassifier:
    """The flagship classifier: CLIP-style ViT (ViT-B/16 at the defaults,
    output_dim 512) with LoRA rank 4, alpha 128 on q and v with the
    post-scale-q quirk, and a linear head (``use_bn``: channel BN first).
    The same model as the JAX package's ``__graft_entry__._flagship``:
    ``dtype`` is the compute dtype, every weight is stored in fp32, and
    ``ln_fp32=False`` normalizes in the compute dtype.  ``int8`` runs the
    frozen tower's GEMMs (``int8_targets``) int8 on eval forwards,
    ``int8_train`` on training forwards too; ``patch_gemm`` computes the patch
    embedding as one matrix product; ``int8_attn`` (``int8_attn_pv``) the
    attention's scores (and P V) on int8 codes once calibrated scales are
    given.  ``device=None`` builds on the card."""
    device = resolve_device(device)
    spec = PEFTSpec(
        method="lora",
        attn_delta="lora",
        lora_rank=4,
        lora_alpha=128.0,
        lora_post_scale_q=True,
    )
    vit = VisionTransformer(
        image_size=image,
        patch_size=patch,
        width=width,
        layers=layers,
        heads=heads,
        output_dim=512,
        spec=spec,
        ln_fp32=ln_fp32,
        int8=int8,
        int8_train=int8_train,
        int8_targets=int8_targets,
        patch_gemm=patch_gemm,
        int8_attn=int8_attn,
        int8_attn_pv=int8_attn_pv,
        dtype=dtype,
        device=device,
    )
    return ImageClassifier(
        vit, num_classes=num_classes, use_bn=use_bn, dtype=dtype, device=device
    )


def is_clip_model(cfg) -> bool:
    name = str(cfg.MODEL.NAME).lower()
    return "clip" in name or bool(re.match(r"^rn\d+", name))


def _vision_model(cfg) -> str:
    return str(cfg.MODEL.SPEC.VISION.get("MODEL", "vit")).lower()


#: the JAX builder's other backbone families, each by the substrings of
#: ``MODEL.NAME`` and the ``MODEL.SPEC.VISION.MODEL`` values that select it
#: (``peft_vit_tpu/models/factory.py:38-103``); none is ported yet
_ZOO = (
    ("convvit", ("vit_conv", "cswin"), ("vit_conv", "cswin")),
    ("swin", ("swin",), ("swin",)),
    ("resnet", ("resnet", "resnext"), ("resnet",)),
    ("rexnet", ("rexnet",), ("rexnet",)),
    ("efficientnet", ("efficientnet",), ("efficientnet",)),
    ("ttnet", ("ttnet",), ("ttnet",)),
    ("hrnet", ("hrnet",), ("hrnet",)),
)


def zoo_family(cfg) -> Optional[str]:
    """The backbone family of a non-CLIP config other than the timm ViT, or
    None for the timm ViT (the JAX builder's fallback branch)."""
    name = str(cfg.MODEL.NAME).lower()
    vm = _vision_model(cfg)
    for family, names, models in _ZOO:
        if family == "swin" and "cswin" in name:
            continue
        if any(n in name for n in names) or vm in models:
            return family
    return None


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to peft_vit_tpu_torch yet (ROADMAP §1, {item})")


def compute_dtype(cfg, device: torch.device) -> torch.dtype:
    """bf16 when ``TPU.COMPUTE_DTYPE`` says so and the model runs on the
    card, else fp32 (the JAX rule gives bf16 only on its accelerator, so the
    CPU compares fp32 with fp32)."""
    if str(cfg.TPU.COMPUTE_DTYPE) == "bfloat16" and device.type == "cuda":
        return torch.bfloat16
    return torch.float32


def build_image_classifier(
    cfg,
    spec: PEFTSpec,
    num_classes: int,
    use_bn: bool = False,
    device=None,
    seed: int = 0,
) -> Tuple[ImageClassifier, Dict[str, torch.Tensor], Optional[TextEncoder]]:
    """Returns ``(model, params, encode_text)``: the ViT classifier on
    ``device`` (None: the card), its named parameters, and the frozen CLIP
    text tower as a function of token ids (``models.text.TextEncoder``), or
    None for a checkpoint without one (a visual-only export) and for the
    timm-style ViT (``_timm_classifier``).

    The weights are drawn on the CPU from ``seed`` (the JAX builder's
    ``PRNGKey(0)``; the text tower's from ``seed + 1``, its ``PRNGKey(1)``),
    then, when ``MODEL.PRETRAINED`` names an OpenAI CLIP checkpoint, its
    visual and text towers are loaded over them.  ``model.aux`` holds what
    the JAX builder keeps in ``variables["aux"]`` for the head's init from
    text: the checkpoint's ``logit_scale`` and, under
    ``TRAIN.MERGE_ENCODER_AND_HEAD_PROJ``, its visual ``proj`` (fp32 numpy).
    Every weight is stored in fp32; the compute dtype follows
    ``compute_dtype``.  The flags the JAX builder reads map one to one:
    ``TPU.BF16_SOFTMAX`` (refused on the card,
    ``ops.attention.check_softmax_fp32``), ``TPU.BF16_LN``,
    ``TPU.INT8_INFERENCE``, ``TPU.INT8_FWD_TRAIN``, ``TPU.INT8_TARGETS``,
    ``TPU.INT8_ATTN`` and ``INT8_ATTN_PV`` (which need ``INT8_FWD_TRAIN`` and
    ``INT8_STATIC_ACT``, as in the JAX builder), ``TPU.PATCH_EMBED_GEMM``,
    ``TPU.ATTN_BATCH_CHUNK``, ``TRAIN.MERGE_ENCODER_AND_HEAD_PROJ`` and
    ``TRAIN.NORMALIZE_VISUAL_FEATURE``.  ``TPU.FLASH_ATTENTION`` and
    ``TPU.REMAT`` do not apply: the card always runs the attention kernels,
    and autograd keeps what the backward needs.  The other backbone
    families (``zoo_family``), ``TPU.SCAN_LAYERS`` and ``TPU.SEQUENCE_PARALLEL`` raise
    ``NotImplementedError``.
    """
    device = resolve_device(device)
    tpu = cfg.TPU
    clip = is_clip_model(cfg)
    if clip and (_vision_model(cfg) != "vit" or re.match(r"^rn\d+", str(cfg.MODEL.NAME).lower())):
        raise _not_ported(f"MODEL.NAME {cfg.MODEL.NAME!r} (a CLIP tower other than the ViT)",
                          "the backbone zoo")
    if not clip and zoo_family(cfg) is not None:
        raise _not_ported(f"MODEL.NAME {cfg.MODEL.NAME!r} (the {zoo_family(cfg)} family; only "
                          "the CLIP and timm-style ViTs)", "the backbone zoo")
    if bool(tpu.get("SCAN_LAYERS", False)):
        raise _not_ported("TPU.SCAN_LAYERS", "the rest")
    if bool(tpu.get("SEQUENCE_PARALLEL", False)):
        raise _not_ported("TPU.SEQUENCE_PARALLEL", "parallelism")
    int8_train = bool(tpu.get("INT8_FWD_TRAIN", False))
    int8_attn = bool(tpu.get("INT8_ATTN", False))
    if int8_attn and not (int8_train and bool(tpu.get("INT8_STATIC_ACT", False))):
        raise ValueError(
            "TPU.INT8_ATTN quantizes the attention operands with statically calibrated "
            "scales: set TPU.INT8_FWD_TRAIN=True and TPU.INT8_STATIC_ACT=True (the "
            "calibration pass that produces them) to use it")
    softmax_fp32 = not bool(tpu.get("BF16_SOFTMAX", False))
    check_softmax_fp32(device.type, softmax_fp32)

    vit_kw = dict(
        spec=spec,
        ln_fp32=not bool(tpu.get("BF16_LN", False)),
        int8=bool(tpu.get("INT8_INFERENCE", False)),
        int8_train=int8_train,
        int8_attn=int8_attn,
        int8_attn_pv=bool(tpu.get("INT8_ATTN_PV", False)),
        int8_targets=tuple(tpu.get("INT8_TARGETS", INT8_TARGET_MODULES)),
        patch_gemm=bool(tpu.get("PATCH_EMBED_GEMM", False)),
        softmax_fp32=softmax_fp32,
        attn_batch_chunk=int(tpu.get("ATTN_BATCH_CHUNK", 0)),
        dtype=compute_dtype(cfg, device),
        device="cpu",
    )
    sd = None
    s = cfg.MODEL.SPEC
    if cfg.MODEL.PRETRAINED:
        sd = load_torch_checkpoint(cfg.MODEL.PRETRAINED,
                                   model_key=str(cfg.TEST.get("MODEL_KEY", "")))
        logger.info("=> loaded checkpoint %s", cfg.MODEL.PRETRAINED)
    if not clip:
        return _timm_classifier(cfg, num_classes, use_bn, sd, vit_kw, seed, device)
    if sd is not None:
        if "visual.conv1.weight" not in sd or "visual.attnpool.c_proj.weight" in sd:
            raise _not_ported("a checkpoint without a CLIP ViT visual tower",
                              "the backbone zoo")
        info = infer_clip_shape(sd)
        heads = int(s.VISION.get("HEADS", 0))
        if heads:  # not recoverable from a state dict
            info["vision_heads"] = heads
    else:
        info = dict(
            embed_dim=int(s.EMBED_DIM),
            image_size=int(cfg.TRAIN.IMAGE_SIZE[0]),
            patch_size=int(s.VISION.get("PATCH_SIZE", 32)),
            vision_width=int(s.VISION.WIDTH),
            vision_layers=int(s.VISION.LAYERS),
            vision_heads=int(s.VISION.HEADS),
            vocab_size=int(s.TEXT.VOCAB_SIZE),
            context_length=int(s.TEXT.CONTEXT_LENGTH),
            text_width=int(s.TEXT.WIDTH),
            text_layers=int(s.TEXT.LAYERS),
            text_heads=int(s.TEXT.HEADS),
            has_text=True,
        )
    merge_proj = bool(cfg.TRAIN.MERGE_ENCODER_AND_HEAD_PROJ)
    dtype = vit_kw["dtype"]
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        backbone = VisionTransformer(
            image_size=info["image_size"],
            patch_size=info["patch_size"],
            width=info["vision_width"],
            layers=info["vision_layers"],
            heads=info["vision_heads"],
            output_dim=None if merge_proj else info["embed_dim"],
            **vit_kw,
        )
        model = ImageClassifier(
            backbone, num_classes=num_classes, use_bn=use_bn,
            normalize_visual=bool(cfg.TRAIN.NORMALIZE_VISUAL_FEATURE), dtype=dtype,
            device="cpu",
        )
    model.aux = {}
    flat = None
    if sd is not None:
        flat = clip_state_dict_to_tree(sd)
        state = visual_state_dict(flat)
        if "logit_scale" in flat:
            # the checkpoint's trained logit scale, for INIT_HEAD_WITH_LOGIT_SCALE
            model.aux["logit_scale"] = float(np.asarray(flat["logit_scale"]))
        if merge_proj:
            # the module has no proj; the head's init from text absorbs it
            model.aux["visual_proj"] = state.pop("backbone.proj").numpy()
        missing, unexpected = model.load_state_dict(state, strict=False)
        if unexpected:
            raise ValueError(f"checkpoint leaves the model does not have: {sorted(unexpected)}")
        logger.info("=> grafted CLIP visual weights (%d fresh leaves)", len(missing))
    model = model.to(device)
    if not info["has_text"]:
        return model, dict(model.named_parameters()), None

    def build_text() -> TextTransformer:
        """The text tower of zero-shot, the head's init and the contrastive
        methods: the checkpoint's when it has one, fresh otherwise."""
        with torch.random.fork_rng(devices=[]):
            torch.default_generator.manual_seed(seed + 1)
            text = TextTransformer(
                vocab_size=info["vocab_size"], context_length=info["context_length"],
                width=info["text_width"], layers=info["text_layers"], heads=info["text_heads"],
                output_dim=info["embed_dim"], dtype=dtype, device="cpu")
        if flat is not None:  # as the JAX builder grafts: leaves it lacks stay fresh
            missing, _ = text.load_state_dict(text_state_dict(flat), strict=False)
            logger.info("=> grafted CLIP text weights (%d fresh leaves)", len(missing))
        return cast_frozen_(text.requires_grad_(False).to(device))

    return model, dict(model.named_parameters()), TextEncoder(build_text, info["context_length"])


def _timm_classifier(cfg, num_classes: int, use_bn: bool, sd, vit_kw: dict, seed: int,
                     device: torch.device):
    """The JAX builder's fallback branch (``factory.py:605-682``): the
    timm-style ViT of ``MODEL.SPEC.VISION`` at ``TRAIN.IMAGE_SIZE`` under the
    classifier head, with a timm state dict ``sd`` grafted onto it (the PEFT
    leaves and the head stay fresh).  No text tower."""
    v = cfg.MODEL.SPEC.VISION
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        backbone = VisionTransformer(
            image_size=int(cfg.TRAIN.IMAGE_SIZE[0]),
            patch_size=int(v.PATCH_SIZE),
            width=int(v.WIDTH),
            layers=int(v.LAYERS),
            heads=int(v.HEADS),
            style="timm",
            **vit_kw,
        )
        model = ImageClassifier(
            backbone, num_classes=num_classes, use_bn=use_bn,
            normalize_visual=bool(cfg.TRAIN.NORMALIZE_VISUAL_FEATURE), dtype=vit_kw["dtype"],
            device="cpu",
        )
    model.aux = {}
    if sd is not None:
        state = timm_vit_state_dict(timm_vit_state_dict_to_tree(sd))
        missing, unexpected = model.load_state_dict(state, strict=False)
        if unexpected:
            raise ValueError(f"checkpoint leaves the model does not have: {sorted(unexpected)}")
        logger.info("=> grafted timm ViT weights (%d fresh leaves)", len(missing))
    model = model.to(device)
    return model, dict(model.named_parameters()), None


def init_head_from_text(model: ImageClassifier, text_features, logit_scale: float = 1.0) -> None:
    """``TRAIN.INIT_HEAD_WITH_TEXT_ENCODER`` (full_model_finetune.py:105-135),
    in place: the head's weight is the zero-shot text classifier times
    ``logit_scale`` (``INIT_HEAD_WITH_LOGIT_SCALE`` folds exp(logit_scale)
    in), its bias zero.  ``text_features`` (C, D) in the head's (out, in)
    layout, the transpose of the JAX kernel's."""
    head = model.classifier.head
    w = torch.as_tensor(np.asarray(text_features, dtype=np.float32) * np.float32(logit_scale))
    if tuple(head.weight.shape) != tuple(w.shape):
        raise ValueError(f"head {tuple(head.weight.shape)} != text features {tuple(w.shape)}")
    with torch.no_grad():
        head.weight.copy_(w)
        head.bias.zero_()
