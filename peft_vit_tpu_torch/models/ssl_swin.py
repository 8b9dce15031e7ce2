"""SSL-Swin: the self-supervised Swin backbone and its helpers (counterpart
of ``peft_vit_tpu/models/ssl_swin.py``; the reference's
full_shot/main/lib/models/ssl_swin.py:574-956).

* ``build_ssl_swin``: the MoBY/EsViT student or teacher from the config,
  with ``USE_APE``, ``PATCH_NORM`` and ``DROP_PATH_RATE`` (the teacher runs
  without stochastic depth, get_cls_model :931-940);
* ``multi_crop_forward``: crops grouped by resolution, one forward per run
  of equal resolutions, the outputs concatenated in order (:700-739);
* ``extract_n_last_blocks``: the linear-eval features, the concatenated
  token means of the last n blocks (:775-814).

The backbone is ``models.swin.SwinTransformer``; the MoBY objective
(``engine.ssl`` in the JAX package) is not ported (ROADMAP §1).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from ..peft.spec import PEFTSpec
from ..utils import resolve_device
from .factory import compute_dtype
from .swin import SwinTransformer


def build_ssl_swin(cfg, is_teacher: bool = False, device=None) -> SwinTransformer:
    """The SSL-Swin backbone of ``MODEL.SPEC`` (``.VISION`` when present) at
    ``TRAIN.IMAGE_SIZE``, on ``device`` (None: the card); its weights drawn
    from torch's default generator.  The teacher has no drop path."""
    device = resolve_device(device)
    s = cfg.MODEL.SPEC
    v = s.VISION if "VISION" in s else s
    return SwinTransformer(
        image_size=int(cfg.TRAIN.IMAGE_SIZE[0]),
        patch_size=int(v.get("PATCH_SIZE", 4)),
        embed_dim=int(v.get("DIM_EMBED", v.get("EMBED_DIM", 96))),
        depths=tuple(v.get("DEPTHS", (2, 2, 6, 2))),
        num_heads=tuple(v.get("NUM_HEADS", (3, 6, 12, 24))),
        window_size=int(v.get("WINDOW_SIZE", 7)),
        mlp_ratio=float(v.get("MLP_RATIO", 4.0)),
        ape=bool(v.get("USE_APE", False)),
        patch_norm=bool(v.get("PATCH_NORM", True)),
        drop_path_rate=0.0 if is_teacher else float(v.get("DROP_PATH_RATE", 0.0)),
        spec=PEFTSpec(),
        dtype=compute_dtype(cfg, device),
        device=device,
    )


def multi_crop_forward(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                       crops: Sequence[torch.Tensor]) -> torch.Tensor:
    """``apply_fn`` over a list of (B, H, W, 3) crops: consecutive crops of
    one resolution concatenated into one batch, one call per run, the
    outputs concatenated in the crops' order."""
    outs: List[torch.Tensor] = []
    group: List[torch.Tensor] = []
    group_res = None
    for crop in list(crops) + [None]:
        res = None if crop is None else crop.shape[1]
        if group and res != group_res:
            outs.append(apply_fn(torch.cat(group)))
            group = []
        if crop is not None:
            group.append(crop)
            group_res = res
    return torch.cat(outs)


def extract_n_last_blocks(model: SwinTransformer, x: torch.Tensor, n: int) -> torch.Tensor:
    """The linear-eval features: the concatenated token means of the last
    ``n`` blocks, in eval mode without a gradient."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(x, n_last_blocks=n)
    finally:
        model.train(was_training)
