"""The few-shot driver on the Swin family through both packages:
``finetune_main`` on tiny CLIP Swin (linear, lora, rpb) and cls_swin
(full), rpb's sweep of rounds, and a round of 3 rpb cells against its cells
trained one by one.  Each package's driver is fed the same weights and
initial trainables (``test_torch_port_driver._run_both``).  Zero-shot, the
logistic probe and the full-shot trainer on Swin and ConvViT are in
``test_torch_port_swin_trainer.py``.

Tolerances: the epoch losses within 1e-4 relative (fp32, the same
arithmetic summed in other orders), the sweep's scores within 1e-3, the
same choice and score; the round's cells as ``test_torch_port_peft_rounds``
holds them.
"""

import numpy as np
import pytest
import torch

from test_torch_port_driver import _run_both
from test_torch_port_peft_hooks import _one_thread  # noqa: F401 (an autouse fixture)

SWIN = {"TRAIN.IMAGE_SIZE": [32, 32], "MODEL.SPEC.VISION.MODEL": "swin",
        "MODEL.SPEC.VISION.PATCH_SIZE": 4, "MODEL.SPEC.VISION.EMBED_DIM": 16,
        "MODEL.SPEC.VISION.DEPTHS": [2, 2], "MODEL.SPEC.VISION.NUM_HEADS": [1, 2],
        "MODEL.SPEC.VISION.WINDOW_SIZE": 4, "MODEL.SPEC.EMBED_DIM": 16,
        "MODEL.SPEC.TEXT.WIDTH": 16, "MODEL.SPEC.TEXT.HEADS": 2, "MODEL.SPEC.TEXT.LAYERS": 1,
        "PEFT.LORA_RANK": 2}
NAMES = {"clip": "clip_swin_tiny", "cls": "cls_swin_tiny"}


@pytest.mark.parametrize("tower,method", [("clip", "linear"), ("clip", "lora"), ("clip", "rpb"),
                                          ("cls", "full")])
def test_finetune_main_on_swin_matches_jax(monkeypatch, tmp_path, tower, method):
    """NO_TUNING, 2 epochs at lr 1e-4: epoch losses within 1e-4 relative,
    the same score and trainable count."""
    over = {**SWIN, "MODEL.NAME": NAMES[tower], "PEFT.METHOD": method, "TRAIN.END_EPOCH": 2,
            "TRAIN.LR": 1e-4}
    want, got = _run_both(monkeypatch, tmp_path, **over)
    assert len(got["losses"]) == len(want["losses"]) == 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4, atol=0)
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)
    assert got["record"]["trainable_params"] == want["record"]["trainable_params"]


def test_rpb_sweep_on_swin_matches_jax(monkeypatch, tmp_path):
    """rpb's sweep on CLIP Swin: rounds of cells, each with its own tables,
    so each window fold's bias is per cell: the same rounds, scores and
    choice."""
    over = {**SWIN, "MODEL.NAME": NAMES["clip"], "PEFT.METHOD": "rpb", "TRAIN.END_EPOCH": 2,
            "TRAIN.NO_TUNING": False, "TRAIN.SEARCH_WD_LOG_UPPER": -2}
    want, got = _run_both(monkeypatch, tmp_path, lr_grid=(1e-3,), **over)
    assert len(got["cells"]) == len(want["cells"]) > 0
    for (gl, gw, gs), (wl, ww, ws) in zip(got["cells"], want["cells"]):
        np.testing.assert_allclose(gl, wl)
        np.testing.assert_allclose(gw, ww)
        np.testing.assert_allclose(gs, ws, atol=1e-3)
    assert (got["record"]["lr"], got["record"]["wd"]) == (want["record"]["lr"],
                                                           want["record"]["wd"])
    assert got["score"] == pytest.approx(want["score"], abs=1e-4)


def test_rpb_round_trains_as_its_cells_one_by_one():
    """A round of 3 rpb cells on a tiny cls Swin (each cell its own tables,
    so a block's folded bias is (3, nW h, N, N)) against the same cells
    trained one by one, under ``test_torch_port_peft_rounds``'s bounds."""
    from peft_vit_tpu_torch.engine import (ce_per_example, init_cell_state, make_apply_fn,
                                           make_array_task, make_epoch_fn, make_eval_fn,
                                           step_decay_lr)
    from peft_vit_tpu_torch.models import ImageClassifier, cast_frozen_
    from peft_vit_tpu_torch.models.swin import SwinTransformer
    from peft_vit_tpu_torch.peft import build_mask, split_params
    from test_torch_port_cells import EPOCHS, F32, RTOL_LEAF, WDS
    from test_torch_port_peft_rounds import EVAL_ATOL, LRS, RTOL_MOMENTUM

    cells, batch = 3, 8
    model = ImageClassifier(SwinTransformer(image_size=32, patch_size=4, embed_dim=16,
                                            depths=(2, 2), num_heads=(1, 2), window_size=4,
                                            device="cpu"),
                            num_classes=5, use_bn=True, device="cpu")
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            fan = int(np.prod(p.shape[1:])) if p.dim() > 1 else 10
            p.copy_(torch.from_numpy((rng.standard_normal(p.shape) / np.sqrt(fan)).astype(
                np.float32)))
    mask = build_mask(model, "rpb")
    trainable, _ = split_params(model, mask)
    cast_frozen_(model)
    draws = [{k: torch.from_numpy((0.3 * np.random.RandomState(10 + i).standard_normal(
        v.shape)).astype(np.float32)) for k, v in trainable.items()} for i in range(cells)]
    bn0 = {k: v.clone() for k, v in model.named_buffers() if k.endswith(("bn_mean", "bn_var"))}
    apply_fn = make_apply_fn(model)
    x = rng.standard_normal((14, 32, 32, 3)).astype(np.float32)
    y = rng.randint(0, 5, 14)
    task = make_array_task(x, y, x[:6], y[:6], batch, device="cpu")
    perms = [np.random.RandomState(3 + e).permutation(task.x_train.shape[0])
             for e in range(EPOCHS)]
    one = make_epoch_fn(apply_fn, ce_per_example, batch, has_bn=True)
    many = make_epoch_fn(apply_fn, ce_per_example, batch, has_bn=True, cells=True)
    args = (task.x_train, task.y_train, task.valid_train)
    state = init_cell_state({k: torch.stack([d[k] for d in draws]) for k in draws[0]},
                            {k: v.expand(cells, *v.shape) for k, v in bn0.items()})
    for e, perm in enumerate(perms):
        state, losses = many(state, {}, *args, perm, step_decay_lr(LRS, e, ()),
                             torch.tensor(WDS))
    logits = make_eval_fn(apply_fn, batch, has_bn=True, cells=True)(state.trainable, {},
                                                                     task.x_val, state.bn)
    eval_one = make_eval_fn(apply_fn, batch, has_bn=True)
    for i in range(cells):
        alone = init_cell_state(draws[i], bn0)
        for e, perm in enumerate(perms):
            alone, loss = one(alone, {}, *args, perm, step_decay_lr(LRS[i], e, ()), WDS[i])
        torch.testing.assert_close(losses[i], loss, **F32)
        for part in ("trainable", "momentum", "bn"):
            rtol = RTOL_MOMENTUM if part == "momentum" else RTOL_LEAF
            for k, v in getattr(alone, part).items():
                diff = torch.linalg.vector_norm(getattr(state, part)[k][i] - v)
                assert diff <= rtol * torch.linalg.vector_norm(v), (part, k, i)
        want = eval_one(alone.trainable, {}, task.x_val, alone.bn)
        torch.testing.assert_close(logits[i], want, rtol=1e-5,
                                   atol=EVAL_ATOL * float(want.abs().max()))
