"""Model builders (counterpart of ``peft_vit_tpu/models/factory.py``).

* ``flagship`` — the ViT-B/16 LoRA classifier of the benchmarks.
* ``build_image_classifier`` — the config-driven build of the few-shot
  driver and the full-shot trainer, the ViT and ResNet branches of the JAX
  builder: a custom builder (``models.registry``) when ``MODEL.NAME`` names
  one; for a CLIP model the ViT or ModifiedResNet tower from ``MODEL.SPEC``
  or from the ``MODEL.PRETRAINED`` OpenAI CLIP checkpoint (an attention pool
  makes it an RN tower; ``MODEL.SPEC.VISION.MODEL`` swin a Swin tower),
  whose visual and text weights it loads (the PEFT leaves and the head stay
  fresh), and the frozen text tower as ``encode_text``; the cls_resnet
  family (``_build_resnet_backbone``) for a ResNet name; the Swin family
  (``_build_swin_backbone``) and ConvViT / CSwin (``_build_convvit_backbone``)
  for theirs; EfficientNet, ReXNet, TTNet v2 / v3 and HRNet v1 / v2-v4
  (``_build_hrnet_backbone``) for theirs, a timm EfficientNet checkpoint
  grafted onto EfficientNet; for any other name outside the backbone zoo's families
  (``cls_vit*``, ``vit*``) the supervised timm-style ViT from
  ``MODEL.SPEC.VISION``, a timm checkpoint grafted onto it when
  ``MODEL.PRETRAINED`` names one.
* ``backbone_eval_variables`` — the backbone's tensors for an eval forward.
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
from .clip_resnet import ModifiedResNet
from .convert import (clip_rn_state_dict_to_tree, clip_rn_visual_state_dict,
                      clip_state_dict_to_tree, infer_clip_rn_shape, infer_clip_shape,
                      is_clip_rn_state_dict, load_torch_checkpoint, text_state_dict,
                      timm_effnet_state_dict_to_tree, timm_vit_state_dict,
                      timm_vit_state_dict_to_tree, tower_state_dict, visual_state_dict)
from .efficientnet import EfficientNet
from .hrnet import HRNet, HRNetV, hrnet_v_spec
from .layers import cast_frozen_
from .registry import get_custom_builder
from .resnet import DyReLUSpec, ResNet
from .rexnet import ReXNet
from .swin import SwinTransformer
from .text import TextEncoder, TextTransformer
from .ttnet import TTNetV2, ttnet_v3_from_config
from .vit import VisionTransformer
from .vit_conv import ConvViT

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


def is_clip_rn_cfg(cfg) -> bool:
    """A CLIP ModifiedResNet tower asked for by the config (no checkpoint):
    an RN* model name, or a CLIP name with ``MODEL.SPEC.VISION.MODEL``
    resnet."""
    name = str(cfg.MODEL.NAME).lower()
    return bool(re.match(r"^rn\d+", name)) or ("clip" in name and _vision_model(cfg) == "resnet")


#: the JAX builder's other backbone families, each by the substrings of
#: ``MODEL.NAME`` and the ``MODEL.SPEC.VISION.MODEL`` values that select it
#: (``peft_vit_tpu/models/factory.py:38-103``), in the order its non-CLIP
#: branch tries them
_ZOO = (
    ("rexnet", ("rexnet",), ("rexnet",)),
    ("efficientnet", ("efficientnet",), ("efficientnet",)),
    ("ttnet", ("ttnet",), ("ttnet",)),
    ("hrnet", ("hrnet",), ("hrnet",)),
    ("resnet", ("resnet", "resnext"), ("resnet",)),
    ("convvit", ("vit_conv", "cswin"), ("vit_conv", "cswin")),
    ("swin", ("swin",), ("swin",)),
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


def _build_resnet_backbone(cfg, dtype: torch.dtype, device) -> ResNet:
    """The cls_resnet family from ``MODEL.SPEC.VISION`` and ``AUG.DROPBLOCK_*``
    (JAX ``factory.py:150-206``): ``VERSION`` (``'d'`` for a ``resnetd``
    name, else v1), ``DY_RELU``, ``LAYERS_PER_STAGE``, ``STEM_WIDTH``,
    ``CARDINALITY``, ``BASE_WIDTH``, ``SE_RATIO``, ``DEEP_STEM``,
    ``KERNEL_SIZE_STEM``, ``AVG_DOWN``, ``FROZEN_BN``, ``WITH_RELU``,
    ``DIMS_PROJ``, ``DROPOUT``; DropBlock on ``AUG.DROPBLOCK_LAYERS`` when
    ``AUG.DROPBLOCK_KEEP_PROB`` < 1."""
    s = cfg.MODEL.SPEC.VISION
    name = str(cfg.MODEL.NAME).lower()
    dy = s.get("DY_RELU", None)
    dy_spec = None
    if dy is not None and bool(dy.get("ENABLE", False)):
        dy_spec = DyReLUSpec(
            reduction=int(dy.get("REDUCTION", 4)),
            lambda_a=float(dy.get("LAMBDA_A", 1.0)),
            k2=bool(dy.get("K2", True)),
            use_bias=bool(dy.get("USE_BIAS", True)),
            init_a=tuple(float(v) for v in dy.get("INIT_A", (1.0, 0.0))),
            init_b=tuple(float(v) for v in dy.get("INIT_B", (0.0, 0.0))),
        )
    db_keep = float(cfg.AUG.get("DROPBLOCK_KEEP_PROB", 1.0))
    db_stages = (tuple(int(i) for i in cfg.AUG.get("DROPBLOCK_LAYERS", (3, 4)))
                 if db_keep < 1.0 else ())
    return ResNet(
        layers=tuple(s.get("LAYERS_PER_STAGE", (3, 4, 6, 3))),
        width=int(s.get("STEM_WIDTH", 64)),
        version=str(s.get("VERSION", "d" if "resnetd" in name else "v1")),
        cardinality=int(s.get("CARDINALITY", 1)),
        base_width=int(s.get("BASE_WIDTH", 64)),
        se_ratio=float(s.get("SE_RATIO", 0.0)),
        deep_stem=bool(s.get("DEEP_STEM", False)),
        stem_kernel=int(s.get("KERNEL_SIZE_STEM", 7)),
        avg_down=bool(s.get("AVG_DOWN", False)),
        frozen_bn=bool(s.get("FROZEN_BN", False)),
        with_relu=bool(s.get("WITH_RELU", True)),
        proj_dims=tuple(int(d) for d in s.get("DIMS_PROJ", ())),
        proj_dropout=float(s.get("DROPOUT", 0.0)),
        dy_relu=dy_spec,
        dropblock_stages=db_stages,
        dropblock_keep_prob=db_keep,
        dropblock_block_size=int(cfg.AUG.get("DROPBLOCK_BLOCK_SIZE", 7)),
        dtype=dtype,
        device=device,
    )


def _build_hrnet_backbone(cfg, dtype: torch.dtype, device):
    """The cls_hrnet family (JAX ``factory.py:106-143``): ``cls_hrnet_v2`` /
    ``v2_share`` / ``v3`` / ``v4`` build ``HRNetV`` from the reference
    experiment yaml's surface (``hrnet.hrnet_v_spec``), any other hrnet name
    ``HRNet`` from ``MODEL.SPEC.VISION.HRNET_WIDTH`` (18) and
    ``STAGE_MODULES`` ((1, 4, 3))."""
    name = str(cfg.MODEL.NAME).lower()
    if "hrnet_v" in name:
        version = name.split("hrnet_")[-1]  # v2 | v2_share | v3 | v4
        node = cfg.MODEL.SPEC if version in ("v2", "v2_share") else cfg.MODEL.EXTRA
        return HRNetV(**hrnet_v_spec(version, node), dtype=dtype, device=device)
    s = cfg.MODEL.SPEC.VISION
    return HRNet(width=int(s.get("HRNET_WIDTH", 18)),
                 stage_modules=tuple(s.get("STAGE_MODULES", (1, 4, 3))), dtype=dtype,
                 device=device)


def _build_cnn_backbone(cfg, family: str, num_classes: int, dtype: torch.dtype, device):
    """EfficientNet, ReXNet and TTNet (JAX ``factory.py:541-565``): the
    width and depth multipliers (and EfficientNet's ``STEM_CH`` /
    ``HEAD_CH``) of ``MODEL.SPEC.VISION``; TTNet v3 (a v3 name) from
    ``MODEL.EXTRA``, v2 its fixed topology, both as pooled features."""
    v = cfg.MODEL.SPEC.VISION
    if family == "efficientnet":
        return EfficientNet(width_mult=float(v.get("WIDTH_MULT", 1.0)),
                            depth_mult=float(v.get("DEPTH_MULT", 1.0)),
                            stem_ch=int(v.get("STEM_CH", 32)), head_ch=int(v.get("HEAD_CH", 1280)),
                            dtype=dtype, device=device)
    if family == "rexnet":
        return ReXNet(width_mult=float(v.get("WIDTH_MULT", 1.0)),
                      depth_mult=float(v.get("DEPTH_MULT", 1.0)), dtype=dtype, device=device)
    if "v3" in str(cfg.MODEL.NAME).lower():
        return ttnet_v3_from_config(cfg, num_classes, dtype, features_only=True, device=device)
    return TTNetV2(features_only=True, dtype=dtype, device=device)


def is_swin_cfg(cfg) -> bool:
    """A Swin tower (the JAX ``is_swin_model``): a name with swin but not
    cswin, or ``MODEL.SPEC.VISION.MODEL`` swin."""
    name = str(cfg.MODEL.NAME).lower()
    return ("swin" in name and "cswin" not in name) or _vision_model(cfg) == "swin"


def _build_swin_backbone(cfg, spec: PEFTSpec, output_dim: Optional[int], dtype: torch.dtype,
                         device) -> SwinTransformer:
    """The cls_swin / clip_swin visual tower (JAX ``factory.py:208-225``):
    ``PATCH_SIZE``, ``EMBED_DIM`` (else ``WIDTH``), ``DEPTHS``,
    ``NUM_HEADS``, ``WINDOW_SIZE`` of ``MODEL.SPEC.VISION`` at
    ``TRAIN.IMAGE_SIZE``; nothing else (``DROP_PATH_RATE``, ``USE_APE`` and
    ``PATCH_NORM`` are read by ``ssl_swin.build_ssl_swin`` only, as in the
    JAX package)."""
    s = cfg.MODEL.SPEC.VISION
    return SwinTransformer(
        image_size=int(cfg.TRAIN.IMAGE_SIZE[0]),
        patch_size=int(s.get("PATCH_SIZE", 4)),
        embed_dim=int(s.get("EMBED_DIM", s.get("WIDTH", 96))),
        depths=tuple(s.get("DEPTHS", (2, 2, 6, 2))),
        num_heads=tuple(s.get("NUM_HEADS", (3, 6, 12, 24))),
        window_size=int(s.get("WINDOW_SIZE", 7)),
        output_dim=output_dim,
        spec=spec,
        dtype=dtype,
        device=device,
    )


def _build_convvit_backbone(cfg, dtype: torch.dtype, device) -> ConvViT:
    """cls_vit_conv / cls_vit_cswin (JAX ``factory.py:575-600``): a cswin
    name or ``MODEL.SPEC.VISION.MODEL`` cswin turns LePE on and the conv
    mixer off by default."""
    v = cfg.MODEL.SPEC.VISION
    is_cswin = "cswin" in str(cfg.MODEL.NAME).lower() or _vision_model(cfg) == "cswin"
    return ConvViT(
        image_size=int(cfg.TRAIN.IMAGE_SIZE[0]),
        patch_size=int(v.PATCH_SIZE),
        width=int(v.WIDTH),
        layers=int(v.LAYERS),
        heads=int(v.HEADS),
        mlp_ratio=float(v.get("MLP_RATIO", 4.0)),
        use_cls_token=bool(v.get("USE_CLS_TOKEN", True)),
        norm_embed=bool(v.get("NORM_EMBED", False)),
        has_attn=bool(v.get("HAS_ATTN", True)),
        has_mlp=bool(v.get("HAS_MLP", True)),
        has_conv=bool(v.get("HAS_CONV", not is_cswin)),
        add_cls=bool(v.get("ADD_CLS", False)),
        conv_ratio=float(v.get("CONV_RATIO", 1.0)),
        lepe=is_cswin or bool(v.get("LEPE", False)),
        res_score=bool(v.get("RES_SCORE", False)),
        drop_path_rate=float(v.get("DROP_PATH_RATE", 0.0)),
        dtype=dtype,
        device=device,
    )


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
    """Returns ``(model, params, encode_text)``: the classifier on ``device``
    (None: the card), its named parameters, and the frozen CLIP text tower
    as a function of token ids (``models.text.TextEncoder``), or None for a
    checkpoint without one (a visual-only export), for the timm-style ViT
    (``_timm_classifier``) and for the zoo's families (``_zoo_classifier``).
    A custom builder registered under ``MODEL.NAME`` (or a
    ``module:function`` name) is called with ``(cfg, spec, num_classes,
    device, seed)`` and returns the same triple.

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
    and autograd keeps what the backward needs.  A CLIP RN tower takes no
    ViT flag and merges no projection (its pool's ``c_proj`` is structural).
    A Swin or ConvViT tower takes none of the ViT flags either (the JAX
    modules have none); a CLIP Swin tower is built from ``MODEL.SPEC`` and,
    as in the JAX builder, no checkpoint is grafted onto it.  The other CNNs
    (EfficientNet, ReXNet, TTNet, HRNet) take no ViT flag either, the
    ``TPU.INT8_*`` ones included, as in the JAX builder.  A CLIP tower other
    than the ViT, the ModifiedResNet and Swin, ``TPU.SCAN_LAYERS`` and
    ``TPU.SEQUENCE_PARALLEL`` raise ``NotImplementedError``.
    """
    device = resolve_device(device)
    custom = get_custom_builder(str(cfg.MODEL.NAME))
    if custom is not None:
        # the reference's get_cls_model / get_zeroshot_model extension contract
        logger.info("=> custom model builder for %s", cfg.MODEL.NAME)
        return custom(cfg, spec, num_classes, device, seed)
    tpu = cfg.TPU
    clip = is_clip_model(cfg)
    family = None if clip else zoo_family(cfg)
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
    if family is not None:
        return _zoo_classifier(cfg, family, spec, num_classes, use_bn, vit_kw["dtype"], seed,
                               device, sd)
    if not clip:
        return _timm_classifier(cfg, num_classes, use_bn, sd, vit_kw, seed, device)
    # the ModifiedResNet tower from a checkpoint's attention pool, else from the config
    rn_tower = is_clip_rn_state_dict(sd) if sd is not None else is_clip_rn_cfg(cfg)
    swin_tower = not rn_tower and is_swin_cfg(cfg)
    if not (rn_tower or swin_tower) and _vision_model(cfg) != "vit":
        raise _not_ported(f"MODEL.NAME {cfg.MODEL.NAME!r} (a CLIP tower other than the ViT, "
                          "the ModifiedResNet and Swin)", "the backbone zoo")
    if sd is not None and rn_tower:
        info = infer_clip_rn_shape(sd)
    elif sd is not None and "visual.conv1.weight" in sd:
        info = infer_clip_shape(sd)
        heads = int(s.VISION.get("HEADS", 0))
        if heads:  # not recoverable from a state dict
            info["vision_heads"] = heads
    else:
        # the config's shape: no checkpoint, or one the JAX builder does not
        # graft (a Swin tower's, or one without a CLIP visual tower)
        sd = None
        info = dict(
            embed_dim=int(s.EMBED_DIM),
            image_size=int(cfg.TRAIN.IMAGE_SIZE[0]),
            patch_size=int(s.VISION.get("PATCH_SIZE", 32)),
            vision_width=int(s.VISION.WIDTH),
            vision_layers=(tuple(int(n) for n in s.VISION.LAYERS) if rn_tower
                           else int(s.VISION.LAYERS)),
            vision_heads=int(s.VISION.HEADS),
            vocab_size=int(s.TEXT.VOCAB_SIZE),
            context_length=int(s.TEXT.CONTEXT_LENGTH),
            text_width=int(s.TEXT.WIDTH),
            text_layers=int(s.TEXT.LAYERS),
            text_heads=int(s.TEXT.HEADS),
            has_text=True,
        )
    # the RN tower's projection (the pool's c_proj) is structural: no merge there
    merge_proj = bool(cfg.TRAIN.MERGE_ENCODER_AND_HEAD_PROJ) and not rn_tower
    dtype = vit_kw["dtype"]
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        if rn_tower:
            backbone = ModifiedResNet(
                layers=info["vision_layers"], output_dim=info["embed_dim"],
                heads=info["vision_heads"], image_size=info["image_size"],
                width=info["vision_width"], dtype=dtype, device="cpu")
        elif swin_tower:
            backbone = _build_swin_backbone(
                cfg, spec, None if merge_proj else info["embed_dim"], dtype, "cpu")
        else:
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
        if rn_tower:
            flat, stats = clip_rn_state_dict_to_tree(sd)
            state = clip_rn_visual_state_dict(flat, stats)
        else:
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


def _zoo_classifier(cfg, family: str, spec: PEFTSpec, num_classes: int, use_bn: bool,
                    dtype: torch.dtype, seed: int, device: torch.device, sd=None):
    """The JAX builder's non-CLIP zoo branches (``factory.py:541-604``): the
    tower at ``TRAIN.IMAGE_SIZE`` under the classifier head, weights drawn
    from ``seed``.  As in the JAX builder a ``MODEL.PRETRAINED`` checkpoint
    ``sd`` is grafted onto EfficientNet only (a timm state dict, its
    BatchNorms' statistics included; leaves it lacks stay fresh, leaves the
    tower lacks are ignored) and onto no other family; there is no text
    tower."""
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        if family == "resnet":
            backbone = _build_resnet_backbone(cfg, dtype, "cpu")
        elif family == "swin":
            backbone = _build_swin_backbone(cfg, spec, None, dtype, "cpu")
        elif family == "convvit":
            backbone = _build_convvit_backbone(cfg, dtype, "cpu")
        elif family == "hrnet":
            backbone = _build_hrnet_backbone(cfg, dtype, "cpu")
        else:
            backbone = _build_cnn_backbone(cfg, family, num_classes, dtype, "cpu")
        model = ImageClassifier(
            backbone, num_classes=num_classes, use_bn=use_bn,
            normalize_visual=bool(cfg.TRAIN.NORMALIZE_VISUAL_FEATURE), dtype=dtype,
            device="cpu",
        )
    model.aux = {}
    if sd is not None and family == "efficientnet":
        state = {"backbone." + k: v for k, v in tower_state_dict(
            *timm_effnet_state_dict_to_tree(sd)).items()}
        missing, _ = model.load_state_dict(state, strict=False)
        fresh = [k for k in missing if k.rsplit(".", 1)[-1] not in ("bn_mean", "bn_var")]
        logger.info("=> grafted timm EfficientNet weights (%d fresh leaves)", len(fresh))
    model = model.to(device)
    return model, dict(model.named_parameters()), None


def backbone_eval_variables(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The backbone's tensors for a deterministic forward
    (``functional_call(model.backbone, ..., (x,))`` in eval mode): its
    parameters and, for a BatchNorm tower (the ModifiedResNet, the ResNet),
    its running statistics ``bn_mean`` / ``bn_var``, named relative to the
    backbone; a LayerNorm tower has none."""
    return {**dict(model.backbone.named_parameters()), **dict(model.backbone.named_buffers())}


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
