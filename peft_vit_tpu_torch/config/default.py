"""Default configuration tree (a copy of ``peft_vit_tpu/config/default.py``:
every key and default equal, so that one YAML drives both packages).

Mirrors the key names of the reference config systems so that existing
dataset/model YAMLs drive this framework unchanged:

* few-shot keys: reference ``few_shot/vision_benchmark/config/default.py:7-263``
* full-shot keys: reference ``full_shot/main/lib/config/default.py``

TPU-specific additions live under ``TPU.*`` (mesh shape, precision, remat) —
the analog of the reference's CUDNN/AMP/DEEPSPEED groups.
"""

from __future__ import annotations

import os.path as op

from .node import CfgNode as CN

_C = CN(new_allowed=False)

_C["BASE"] = [""]
_C["NAME"] = ""
_C["DATA_DIR"] = ""
_C["DIST_BACKEND"] = "ici"  # reference: 'nccl' (few_shot config/default.py:12)
_C["GPUS"] = (0,)
_C["MULTIPROCESSING_DISTRIBUTED"] = True
_C["OUTPUT_DIR"] = "output"
_C["PIN_MEMORY"] = True
_C["PRINT_FREQ"] = 20
_C["RANK"] = 0
_C["VERBOSE"] = True
_C["WORKERS"] = 4
_C["USE_DEEPSPEED"] = False

_C["AMP"] = CN({"ENABLED": False, "MEMORY_FORMAT": "nchw"})

# TPU execution knobs (new; replaces CUDNN group semantics).
_C["TPU"] = CN(
    {
        # PIPE > 1 adds a pipeline axis: the scan-layers block stack is
        # staged over it (parallel/pipeline.py GPipe schedule);
        # PP_MICROBATCHES 0 = one microbatch per stage
        "MESH": CN({"DATA": -1, "MODEL": 1, "PIPE": 1}, new_allowed=True),
        "PP_MICROBATCHES": 0,
        "COMPUTE_DTYPE": "bfloat16",
        "PARAM_DTYPE": "float32",
        "REMAT": True,  # rematerialize frozen-backbone activations
        "SCAN_LAYERS": False,  # compile the ViT block once via nn.scan
        "FLASH_ATTENTION": True,  # Pallas kernel on TPU, jnp fallback elsewhere
        "DONATE": True,
        # bf16 fast paths (profiled on v5e: attention scores + LayerNorm in
        # bf16 lift ViT-B/16 LoRA training 1573 -> 1851 img/s/chip at B=16)
        "BF16_SOFTMAX": False,  # attention scores in bf16 on the XLA path
        "BF16_LN": False,  # LayerNorm statistics in compute dtype
        # chain K train steps per dispatch (lax.scan over a (K, B, ...)
        # chunk): one host->device transfer + one dispatch per K steps
        "STEPS_PER_DISPATCH": 1,
        # ZeRO-1: shard full-shot optimizer state over the data mesh axis
        # (reduce-scatter + all-gather instead of all-reduce)
        "ZERO1": False,
        # int8 MXU GEMMs on deterministic (no-grad) forwards: feature
        # extraction, zero-shot, cached prefix (v5e: 394 TOPS s8 vs
        # 197 TF/s bf16); training forwards are never quantized
        "INT8_INFERENCE": False,
        # QLoRA-style training: the frozen tower's dense GEMMs run int8
        # on the TRAINING forward with a full-precision custom-vjp
        # backward (ops/int8.py).  Gradients of the PEFT params are
        # straight-through exact; convergence-parity gated in
        # tests/test_int8_fwd_train.py
        "INT8_FWD_TRAIN": False,
        # which frozen-tower GEMMs the int8 paths quantize; the MLP pair
        # carries 2/3 of the FLOPs with the best quantize amortization
        "INT8_TARGETS": ["in_proj", "out_proj", "c_fc", "c_proj"],
        # SwitchBack-style extension of INT8_FWD_TRAIN: the dx backward
        # (cotangent x frozen-weight^T) also runs on the int8 MXU using
        # per-dispatch pre-quantized transposed kernels; dw stays exact
        "INT8_BWD_DX": False,
        # STATIC per-tensor activation scales for INT8_FWD_TRAIN,
        # calibrated once per run on the first batch: replaces the
        # per-row dynamic absmax (whose reduce chains measured 13% of
        # the step at 2.9 TF/s, BASELINE.md round 4) with a saturating
        # elementwise quantize XLA fuses into the activation producers;
        # convergence-gated in tests/test_int8_fwd_train.py
        "INT8_STATIC_ACT": False,
        # TPU.INT8_ATTN: the attention QK^T dot ALSO runs on the int8
        # MXU with calibrated static q/k scales.  MEASURED NEGATIVE on
        # chip (BASELINE.md round 5: 1,933 vs 2,149 img/s — the N=197
        # score dots are shape-bound, not MXU-rate-bound, and the
        # quantize chains break XLA's fused attention); kept opt-in as
        # a tested negative.  Requires INT8_STATIC_ACT for the
        # calibration machinery; backward stays the bf16-exact
        # attention VJP (ops/attention.int8_attention)
        "INT8_ATTN": False,
        # ALSO quantize the P @ V dot (softmax output at the exact 1/127
        # scale).  Measured UNSTABLE in training — the attention-output
        # quantization noise feeds the residual stream and diverges late
        # runs (ops/attention.int8_attention docstring, CI gate
        # tests/test_int8_fwd_train.py) — opt-in for measurement only
        "INT8_ATTN_PV": False,
        # saturation headroom multiplier on the calibrated absmax; the
        # Trainer also recalibrates at every epoch start because the
        # PEFT deltas drift the frozen tower's layer-input ranges
        "INT8_CALIB_MARGIN": 1.5,
        # patchify via dot_general over (p, q, c) instead of the strided
        # conv.  Measured (BASELINE.md round-3): ties the conv on the
        # LoRA train step and on int8 eval, loses ~5% on bf16 eval at
        # B=256 — XLA's conv lowering is already near the form's limit,
        # so this stays opt-in
        "PATCH_EMBED_GEMM": False,
        # attention computed in lax.map slices of this batch size: at
        # B >= ~32 the fused score tensor spills VMEM; chunking keeps
        # attention linear in batch while the other GEMMs get large-M
        # MXU efficiency (0 = off)
        "ATTN_BATCH_CHUNK": 0,
        # background device_put of the next chunk while the current one
        # computes (depth of the transfer pipeline; 0 disables)
        "PREFETCH_DEPTH": 2,
        # Megatron-style sequence parallelism: shard the (B, N, C)
        # inter-block activations P(data, model, None) so norms/residual
        # adds run token-sharded over the tensor axis (GSPMD inserts the
        # all-gather / reduce-scatter pairs around attention and MLP).
        # Only meaningful on a mesh with a model axis > 1; the model must
        # be traced under the mesh context
        "SEQUENCE_PARALLEL": False,
    },
    new_allowed=True,
)

# Sweep-engine compatibility switches.
_C["SWEEP"] = CN(
    {
        # True reproduces the reference's wd-refinement loop verbatim,
        # INCLUDING its left-wd bug (adapter_tuning_clip.py:205: both
        # refine probes train with the LEFT candidate's wd) — use when
        # reproducing reference-reported hyperparameters exactly.
        # False (default): each candidate trains with its own wd.
        "REF_COMPAT": False,
    }
)

# kept so reference YAMLs with a CUDNN group still parse
_C["CUDNN"] = CN(
    {"BENCHMARK": True, "DETERMINISTIC": False, "ENABLED": True}
)

_C["MODEL"] = CN(
    {
        "NAME": "clip_vit",
        "INIT_WEIGHTS": True,
        "PRETRAINED": "",
        "NUM_PARAMS_IN_M": 0.0,
        "AUTHOR": "",
        "PRETRAINED_DATA": "",
        "CREATION_TIME": "",
        "CLIP_FP32": False,
        "PRETRAINED_LAYERS": ["*"],
        "NUM_CLASSES": 1000,
        "SPEC": CN(
            {
                "EMBED_DIM": 512,
                "VISION": CN(
                    {
                        "MODEL": "vit",
                        "PATCH_SIZE": 32,
                        "WIDTH": 768,
                        "LAYERS": 12,
                        "HEADS": 12,
                    },
                    new_allowed=True,
                ),
                "TEXT": CN(
                    {
                        "TOKENIZER": "clip",
                        "CONTEXT_LENGTH": 77,
                        "VOCAB_SIZE": 49408,
                        "WIDTH": 512,
                        "HEADS": 8,
                        "LAYERS": 12,
                    },
                    new_allowed=True,
                ),
            },
            new_allowed=True,
        ),
    },
    new_allowed=True,
)

# PEFT method group (new; replaces the reference's one-file-per-method fan-out,
# SURVEY.md §2.2).  METHOD selects injection points; the rest are the method
# hyper-parameters hard-coded across the reference model files.
_C["PEFT"] = CN(
    {
        "METHOD": "none",
        # lora (reference lora_model.py:459-464)
        "LORA_RANK": 4,
        "LORA_ALPHA": 128.0,
        "LORA_TARGETS": ["q", "v"],
        "LORA_POST_SCALE_Q": True,  # parity quirk: lora_model.py:720-734
        # parity quirk #2 (lora_model.py:730-731): flat (N,B,C)->(B*H,N,hd)
        # delta reshape — scrambles batch/sequence unless B=H=1; True
        # replays reference LoRA training trajectories bit-for-bit
        "LORA_REF_RESHAPE": False,
        # bottleneck adapter (reference adapter_model.py:204-296)
        "ADAPTER_DIM": 64,
        "ADAPTER_ACT": "relu",
        "ADAPTER_LAYERS": [],  # AdapterDrop: empty = all layers
        # compacter (reference compacter_model.py:358-440)
        "COMPACTER_REDUCTION": 12,
        "COMPACTER_PHM_DIM_DOWN": 32,
        "COMPACTER_PHM_DIM_UP": 4,
        "COMPACTER_ACT": "gelu_new",
        # kadaptation (reference kadaptation.py:117-244)
        "PHM_DIM": 768,
        "PHM_RANK": 1,
        # rpb (reference RPB.py:105-131 hardcodes ndim=7, which only fits
        # a 7x7 patch grid; -1 derives the grid from the model)
        "RPB_NDIM": -1,
        # vpt prompt tokens (north-star extension; not in reference)
        "PROMPT_TOKENS": 0,
        "PROMPT_DEEP": False,
        # transformer probe (reference transformer_classifier.py:338-347)
        "EXTRA_BLOCK": False,
        # intrinsic dimension (reference intrinsic/fastfood.py, SAID)
        "INTRINSIC_DIM": 0,
        "INTRINSIC_PROJECTION": "fastfood",  # or 'dense'
        "INTRINSIC_SAID": False,
        "INTRINSIC_LAYER": -1,  # -1 = whole trainable set
        "INTRINSIC_LAYER_TYPE": "mlp",  # 'attention'|'mlp'|'adapter'
        # trainable-mask override (regex on '/'-joined param path)
        "TRAINABLE_REGEX": "",
        "TRAIN_HEAD": True,
    },
    new_allowed=True,
)

_C["KNOWLEDGE"] = CN(
    {
        "WORDNET": CN(
            {"USE_HIERARCHY": False, "USE_DEFINITION": False},
            new_allowed=True,
        ),
        "WIKITIONARY": CN(
            {
                "USE_DEFINITION": False,
                "WIKI_DICT_PATH": "resources/knowledge/external",
                "PRE_EXTRACTED": True,
            },
            new_allowed=True,
        ),
        "GPT3": CN(
            {"USE_GPT3": False, "GPT3_DICT_PATH": "resources/knowledge/gpt3"},
            new_allowed=True,
        ),
        "AGGREGATION": CN(
            {"MEHTOD": "WIKI_THEN_GPT3", "NUM_GPT3_ITEMS": 1},
            new_allowed=True,
        ),
    },
    new_allowed=True,
)

_C["LOSS"] = CN(
    {
        "LABEL_SMOOTHING": 0.0,
        "LOSS": "softmax",
        "FOCAL": CN({"NORMALIZE": True, "ALPHA": 1.0, "GAMMA": 0.5}),
    }
)

_C["DATASET"] = CN(
    {
        "ROOT": "",
        "DATASET": "imagenet",
        "IMAGE_SIZE": (224,),
        "CENTER_CROP": True,
        "NUM_CLASSES": 0,
        "TRAIN_SET": "train",
        "VAL_SET": "",
        "TEST_SET": "val",
        "DATA_FORMAT": "jpg",
        "LABELMAP": "",
        "TRAIN_TSV_LIST": [],
        "TEST_TSV_LIST": [],
        "NUM_SAMPLES_PER_CLASS": -1,
        "RANDOM_SEED_SAMPLING": 0,
        "MERGE_TRAIN_VAL_FINAL_RUN": True,
        "TARGET_SIZE": -1,
        # Azure vision-datasets hub fetch (feature.py:540-551) — opt-in
        # because this rig is zero-egress; data/hub.py resolves the
        # shipped vision_datasets.json and downloads the split's index +
        # zip blobs into DATASET.ROOT
        "DOWNLOAD": False,
    },
    new_allowed=True,
)

_C["INPUT"] = CN(
    {"MEAN": [0.485, 0.456, 0.406], "STD": [0.229, 0.224, 0.225]}
)

_C["AUG"] = CN(
    {
        "RANDOM_CENTER_CROP": False,
        "SCALE": (0.08, 1.0),
        "RATIO": (3.0 / 4.0, 4.0 / 3.0),
        "COLOR_JITTER": [0.4, 0.4, 0.4, 0.1, 0.0],
        "GRAY_SCALE": 0.0,
        "GAUSSIAN_BLUR": 0.0,
        "DROPBLOCK_LAYERS": [3, 4],
        "DROPBLOCK_KEEP_PROB": 1.0,
        "DROPBLOCK_BLOCK_SIZE": 7,
        "MIXUP_PROB": 0.0,
        "MIXUP": 0.0,
        "MIXCUT": 0.0,
        "MIXCUT_MINMAX": [],
        "MIXUP_SWITCH_PROB": 0.5,
        "MIXUP_MODE": "batch",
        "MIXCUT_AND_MIXUP": False,
        "TIMM_AUG": CN(
            {"USE_LOADER": False, "USE_TRANSFORM": False}, new_allowed=True
        ),
        # timm-DataLoader RandomErasing block used by 3 shipped resnet
        # experiment yamls (r50s3a-augdeit*); absent from the reference's
        # own config (broken there) — accepted here and mapped onto the
        # device-side RandomErasing (data/augment.py) when ENABLED
        "TIMM_LOADER": CN({"ENABLED": False}, new_allowed=True),
    }
)

_C["SWA"] = CN(
    {
        "ENABLED": False,
        "DEVICE": "cpu",
        "BEGIN_EPOCH": -1,
        "LR_RATIO": 0.5,
        "ANNEAL_EPOCHS": 10,
        "ANNEAL_STRATEGY": "cos",
        "FROZEN_BN": False,
    }
)

_C["TRAIN"] = CN(
    {
        "AUTO_RESUME": True,
        "CHECKPOINT": "",
        # > 0: also checkpoint every N optimizer steps WITHIN an epoch
        # (exact-step preemption-tolerant resume: data order, flips and
        # the host RNG stream continue as if never interrupted).  The
        # reference resumes at epoch granularity only.
        "CHECKPOINT_EVERY_STEPS": 0,
        "LR_SCHEDULER": CN({"METHOD": "step"}, new_allowed=True),
        "SCHEDULE": [],
        "LR": 0.001,
        "SEARCH_WD_LOG_LOWER": -6,
        "SEARCH_WD_LOG_UPPER": 6,
        "FREEZE_IMAGE_BACKBONE": False,
        "TWO_LR": False,
        "INIT_HEAD_WITH_TEXT_ENCODER": False,
        "INIT_HEAD_WITH_LOGIT_SCALE": False,
        "MERGE_ENCODER_AND_HEAD_PROJ": False,
        "NORMALIZE_VISUAL_FEATURE": False,
        # channel_bn = BatchNorm1d(affine=False) on the pooled feature —
        # present in EVERY reference few-shot Classifier (linear probe,
        # full fine-tune and all PEFT drivers, full_model_finetune.py:
        # 98-101 / adapter_tuning_clip.py:124-130); consumed by the
        # few-shot driver (commands/run.py) only — the full_shot finetune
        # tools carry a bare Linear head (tools/finetune_lora.py:173)
        "CHANNEL_BN": True,
        "SEARCH_RESULT_ON_LAST_EPOCH": False,
        "OPTIMIZER": "sgd",
        "OPTIMIZER_ARGS": CN(new_allowed=True),
        "MOMENTUM": 0.9,
        "WD": 0.0001,
        "WITHOUT_WD_LIST": [],
        "NESTEROV": True,
        "GAMMA1": 0.99,
        "GAMMA2": 0.0,
        "BEGIN_EPOCH": 0,
        "END_EPOCH": 100,
        "EXTRA_FINAL_TRAIN_EPOCH": 0,
        "EMULATE_ZERO_SHOT": False,
        "IMAGE_SIZE": [224, 224],
        "BATCH_SIZE_PER_GPU": 32,
        "SHUFFLE": True,
        "EMA_DECAY": 0.0,
        "EVAL_BEGIN_EPOCH": 0,
        "LARC": False,
        "DETECT_ANOMALY": False,
        "CLIP_GRAD_NORM": 0.0,
        "LOADER": "default",
        "SAMPLER": "default",
        "NUM_SAMPLES_CLASS": "average",
        "SAVE_ALL_MODELS": False,
        "SEARCH_WD_POINTS": 97,
        "SEARCH_WD_INIT_POINTS": 7,
        "VMAP_SWEEP": True,  # vectorize sweep cells over the batch dim (TPU win)
    },
    new_allowed=True,
)

_C["TEST"] = CN(
    {
        "BATCH_SIZE_PER_GPU": 32,
        "CENTER_CROP": True,
        "IMAGE_SIZE": [224, 224],
        "INTERPOLATION": 2,
        "MODEL_FILE": "",
        # unwrap nested torch checkpoints (state_dict = ckpt[MODEL_KEY]):
        # the SSL-eval yamls set 'teacher' (tools/finetune.py:213-214)
        "MODEL_KEY": "",
        "REAL_LABELS": False,
        "VALID_LABELS": "",
        "METRIC": "accuracy",
    }
)

_C["FINETUNE"] = CN(
    {
        "FINETUNE": False,
        "USE_TRAIN_AUG": False,
        "BASE_LR": 0.003,
        "BATCH_SIZE": 512,
        "EVAL_EVERY": 3000,
        "FROZEN_LAYERS": [],
    }
)

_C["DEBUG"] = CN({"DEBUG": False})
_C["DEEPSPEED"] = CN(new_allowed=True)


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def get_default_config() -> CN:
    return _C.clone()


def update_config(config: CN, args) -> None:
    """Merge ``args.cfg`` (with BASE inheritance) + ``args.opts`` remainder.

    Reproduces reference update_config (few_shot config/default.py:243-263)
    including the LR x world-size scaling (:248): the world size of the
    initialised ``torch.distributed`` process group, else 1.
    """
    config.defrost()
    config.merge_from_file(args.cfg)
    if getattr(args, "opts", None):
        config.merge_from_list(args.opts)
    config.TRAIN.LR *= _world_size()

    file_name, _ = op.splitext(op.basename(args.cfg))
    config.NAME = file_name + config.NAME
    aug = config.AUG
    if aug.MIXUP > 0.0 or aug.MIXCUT > 0.0 or aug.MIXCUT_MINMAX:
        aug.MIXUP_PROB = 1.0
    config.freeze()
