"""CLIP zero-shot evaluation through the port (counterpart of
``peft_vit_tpu/commands/zeroshot_eval.py``; the reference's
commands/zeroshot_eval.py:106-164): the test images' features from the
frozen visual tower, the text classifier from the prompt templates,
``100 * img @ text^T`` scored with the dataset's metric, on the card unless
the caller asks for the CPU.

    python -m peft_vit_tpu_torch.commands.zeroshot_eval --ds DS.yaml --model MODEL.yaml [KEY VALUE ...]
"""

from __future__ import annotations

import argparse
import logging
from typing import Mapping, Optional

import torch

from ..data import construct_splits
from ..engine.metrics import metric_for_dataset
from ..engine.zeroshot import clip_zeroshot_evaluator, extract_image_features, extract_text_features
from ..models import build_image_classifier, cast_frozen_, load_jax_variables
from ..peft import PEFTSpec
from ..utils import resolve_device
from ..utils.logging import final_result_line
from .common import add_finetuning_args, load_config, setup_run_logger

logger = logging.getLogger(__name__)


def image_encoder(model):
    """The frozen visual tower of ``model`` as a function of a numpy batch:
    an eval-mode forward without a gradient on the model's device, the
    frozen weights stored in the compute dtype."""
    model.eval().requires_grad_(False)
    cast_frozen_(model)
    device = next(model.parameters()).device

    @torch.no_grad()
    def encode_image(x):
        return model.backbone(torch.as_tensor(x, device=device))

    return encode_image


def zeroshot_main(cfg, *, device=None, variables: Optional[Mapping] = None,
                  text_variables: Optional[Mapping] = None) -> float:
    """The zero-shot score of ``cfg``'s test split.  ``device``: None is the
    card.  ``variables`` / ``text_variables`` (JAX-layout trees of the
    classifier and the text tower) replace the built weights: a test's seam."""
    device = resolve_device(device)
    splits = construct_splits(cfg, test_split_only=True)
    model, _, encode_text = build_image_classifier(cfg, PEFTSpec(), splits.num_classes,
                                                   device=device)
    if encode_text is None:
        raise ValueError("zero-shot evaluation needs a CLIP checkpoint with a text tower "
                         "(MODEL.PRETRAINED)")
    if variables is not None:
        load_jax_variables(model, variables)
    if text_variables is not None:
        load_jax_variables(encode_text.module, text_variables)
    img_feats = extract_image_features(image_encoder(model), splits.x_test,
                                       batch_size=int(cfg.TEST.BATCH_SIZE_PER_GPU))
    text_feats = extract_text_features(encode_text, cfg)
    metric_name = cfg.TEST.METRIC or metric_for_dataset(cfg.DATASET.DATASET)
    score, _ = clip_zeroshot_evaluator(img_feats, text_feats, splits.y_test, metric_name)
    final_result_line(metric_name, float(score))
    return float(score)


def main(argv=None, *, device=None):
    parser = argparse.ArgumentParser(description="CLIP zero-shot eval (PyTorch port)")
    add_finetuning_args(parser)
    args = parser.parse_args(argv)
    cfg = load_config(args)
    setup_run_logger(cfg, "zeroshot")
    cfg.freeze()
    return zeroshot_main(cfg, device=device)


if __name__ == "__main__":
    main()
