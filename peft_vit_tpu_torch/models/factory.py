"""Model builders (counterpart of ``peft_vit_tpu/models/factory.py``).

* ``flagship`` — the ViT-B/16 LoRA classifier of the benchmarks.
* ``build_image_classifier`` — the config-driven build of the few-shot
  driver, the CLIP-ViT branch of the JAX builder: the architecture from
  ``MODEL.SPEC`` or from the ``MODEL.PRETRAINED`` OpenAI CLIP checkpoint,
  whose visual weights it loads (the PEFT leaves and the head stay fresh).
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Sequence, Tuple

import torch

from ..ops.attention import check_softmax_fp32
from ..ops.int8 import INT8_TARGET_MODULES
from ..peft.spec import PEFTSpec
from ..utils import resolve_device
from .classifier import ImageClassifier
from .convert import clip_state_dict_to_tree, infer_clip_shape, load_torch_checkpoint, visual_state_dict
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
    embedding as one matrix product.  ``device=None`` builds on the card."""
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to peft_vit_tpu_torch yet (ROADMAP: {item})")


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
) -> Tuple[ImageClassifier, Dict[str, torch.Tensor], None]:
    """Returns ``(model, params, None)``: the CLIP-ViT classifier on
    ``device`` (None: the card), its named parameters, and no text encoder.

    The weights are drawn on the CPU from ``seed`` (the JAX builder's
    ``PRNGKey(0)``), then, when ``MODEL.PRETRAINED`` names an OpenAI CLIP
    checkpoint, its visual tower is loaded over them.  Every weight is
    stored in fp32; the compute dtype follows ``compute_dtype``.  The flags
    the JAX builder reads map one to one: ``TPU.BF16_SOFTMAX`` (refused on the
    card, ``ops.attention.check_softmax_fp32``), ``TPU.BF16_LN``,
    ``TPU.INT8_INFERENCE``, ``TPU.INT8_FWD_TRAIN``, ``TPU.INT8_TARGETS``,
    ``TPU.PATCH_EMBED_GEMM``, ``TPU.ATTN_BATCH_CHUNK``,
    ``TRAIN.MERGE_ENCODER_AND_HEAD_PROJ`` and
    ``TRAIN.NORMALIZE_VISUAL_FEATURE``.  ``TPU.FLASH_ATTENTION`` and
    ``TPU.REMAT`` do not apply: the card always runs the attention kernels,
    and autograd keeps what the backward needs.  Other backbones, the text
    tower and the features that need it, ``TPU.SCAN_LAYERS``,
    ``TPU.SEQUENCE_PARALLEL`` and ``TPU.INT8_ATTN`` raise
    ``NotImplementedError``.
    """
    device = resolve_device(device)
    tpu = cfg.TPU
    if not is_clip_model(cfg) or _vision_model(cfg) != "vit" or re.match(
            r"^rn\d+", str(cfg.MODEL.NAME).lower()):
        raise _not_ported(f"MODEL.NAME {cfg.MODEL.NAME!r} (only CLIP ViT towers)",
                          "item 8, the backbone zoo")
    if bool(cfg.TRAIN.INIT_HEAD_WITH_TEXT_ENCODER):
        raise _not_ported("TRAIN.INIT_HEAD_WITH_TEXT_ENCODER (the CLIP text tower)",
                          "item 5, probes and zero-shot")
    if bool(tpu.get("SCAN_LAYERS", False)):
        raise _not_ported("TPU.SCAN_LAYERS", "item 11, the rest")
    if bool(tpu.get("SEQUENCE_PARALLEL", False)):
        raise _not_ported("TPU.SEQUENCE_PARALLEL", "item 10, parallelism")
    if bool(tpu.get("INT8_ATTN", False)) or bool(tpu.get("INT8_ATTN_PV", False)):
        raise _not_ported("TPU.INT8_ATTN / INT8_ATTN_PV", "item 2, int8_attention")
    softmax_fp32 = not bool(tpu.get("BF16_SOFTMAX", False))
    check_softmax_fp32(device.type, softmax_fp32)

    sd = None
    if cfg.MODEL.PRETRAINED:
        sd = load_torch_checkpoint(cfg.MODEL.PRETRAINED,
                                   model_key=str(cfg.TEST.get("MODEL_KEY", "")))
        logger.info("=> loaded checkpoint %s", cfg.MODEL.PRETRAINED)
        if "visual.conv1.weight" not in sd or "visual.attnpool.c_proj.weight" in sd:
            raise _not_ported("a checkpoint without a CLIP ViT visual tower",
                              "item 8, the backbone zoo")
        info = infer_clip_shape(sd)
        heads = int(cfg.MODEL.SPEC.VISION.get("HEADS", 0))
        if heads:  # not recoverable from a state dict
            info["vision_heads"] = heads
    else:
        s = cfg.MODEL.SPEC
        info = dict(
            embed_dim=int(s.EMBED_DIM),
            image_size=int(cfg.TRAIN.IMAGE_SIZE[0]),
            patch_size=int(s.VISION.get("PATCH_SIZE", 32)),
            vision_width=int(s.VISION.WIDTH),
            vision_layers=int(s.VISION.LAYERS),
            vision_heads=int(s.VISION.HEADS),
        )
    merge_proj = bool(cfg.TRAIN.MERGE_ENCODER_AND_HEAD_PROJ)
    dtype = compute_dtype(cfg, device)
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        backbone = VisionTransformer(
            image_size=info["image_size"],
            patch_size=info["patch_size"],
            width=info["vision_width"],
            layers=info["vision_layers"],
            heads=info["vision_heads"],
            output_dim=None if merge_proj else info["embed_dim"],
            spec=spec,
            ln_fp32=not bool(tpu.get("BF16_LN", False)),
            int8=bool(tpu.get("INT8_INFERENCE", False)),
            int8_train=bool(tpu.get("INT8_FWD_TRAIN", False)),
            int8_targets=tuple(tpu.get("INT8_TARGETS", INT8_TARGET_MODULES)),
            patch_gemm=bool(tpu.get("PATCH_EMBED_GEMM", False)),
            softmax_fp32=softmax_fp32,
            attn_batch_chunk=int(tpu.get("ATTN_BATCH_CHUNK", 0)),
            dtype=dtype,
            device="cpu",
        )
        model = ImageClassifier(
            backbone, num_classes=num_classes, use_bn=use_bn,
            normalize_visual=bool(cfg.TRAIN.NORMALIZE_VISUAL_FEATURE), dtype=dtype,
            device="cpu",
        )
    if sd is not None:
        state = visual_state_dict(clip_state_dict_to_tree(sd))
        if merge_proj:
            state.pop("backbone.proj")
        missing, unexpected = model.load_state_dict(state, strict=False)
        if unexpected:
            raise ValueError(f"checkpoint leaves the model does not have: {sorted(unexpected)}")
        logger.info("=> grafted CLIP visual weights (%d fresh leaves)", len(missing))
    model = model.to(device)
    return model, dict(model.named_parameters()), None
