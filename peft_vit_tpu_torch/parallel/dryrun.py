"""The multichip dryrun (counterpart of ``__graft_entry__.dryrun_multichip``):
sharded training steps over n processes, on tiny shapes.

    python -m peft_vit_tpu_torch.parallel.dryrun [N] [--device cpu]

``dryrun_multichip(n, device)`` spawns n processes that join one group
through a ``file://`` rendezvous in a temporary directory (no network), and
runs in each:

1. a data x tensor-parallel step of the tiny LoRA flagship (width 128, 2
   blocks, 4 heads of 32, 32 px, patch 16, 8 classes) on a mesh of
   n / 2 x 2 (``model_par`` = 2 when n is even, else 1), a global batch of
   2n;
2. a ZeRO-1 step of the same tower with the LoRA-MoE gate (group 2) on the
   same mesh.

``device`` None is the card: NCCL, one card a rank (``utils.dist.
init_distributed`` refuses more ranks than the host has cards), the steps
on the attention kernels.  ``device='cpu'`` gives gloo CPU processes, one
torch thread each: the multi-rank arithmetic on a host with fewer cards.
The weights are drawn from a seed in every process alike, the batch from
another.  Both losses must be finite; the first is also held to the loss of
the global batch computed in one process, within ``TOL_LOSS_REL``.  The JAX
dryrun's sequence-parallel and pipeline steps are not ported (ROADMAP §1,
parallelism).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

TOL_LOSS_REL = 1e-5  # one fp32 forward, the products split over the model ranks
TIMEOUT_S = 600
SEED = 0
WIDTH, LAYERS, HEADS, IMAGE, PATCH, CLASSES = 128, 2, 4, 32, 16, 8  # head dim 32: K1-K3's
LR, WD = 1e-3, 1e-4


def _model(moe: bool, device: torch.device):
    """The dryrun's tower, its weights drawn from ``SEED`` (every process
    draws the same) on the CPU, then moved to ``device``."""
    from ..models import ImageClassifier, VisionTransformer, flagship
    from ..peft import PEFTSpec

    torch.manual_seed(SEED + int(moe))
    if not moe:
        model = flagship(width=WIDTH, layers=LAYERS, heads=HEADS, image=IMAGE, patch=PATCH,
                         num_classes=CLASSES, dtype=torch.float32, device="cpu")
    else:
        spec = PEFTSpec(method="lora", attn_delta="lora", lora_rank=4, lora_alpha=128.0,
                        lora_moe=True, lora_moe_group=2)
        model = ImageClassifier(
            VisionTransformer(image_size=IMAGE, patch_size=PATCH, width=WIDTH, layers=LAYERS,
                              heads=HEADS, output_dim=32, spec=spec, dtype=torch.float32,
                              device="cpu"),
            num_classes=CLASSES, dtype=torch.float32, device="cpu")
    with torch.no_grad():  # the LoRA B matrices too, so that every leaf acts
        for p in model.parameters():
            if not p.abs().sum():
                p.normal_(0.0, 0.02)
    return model.to(device)


def _batch(n: int, device: torch.device):
    rng = np.random.RandomState(SEED + 7)
    x = rng.standard_normal((2 * n, IMAGE, IMAGE, 3)).astype(np.float32)
    y = rng.randint(0, CLASSES, 2 * n).astype(np.int64)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


@contextlib.contextmanager
def _fp32_products():
    """fp32 convolutions and matmuls without TF32, in every process alike
    (a spawned process starts from PyTorch's defaults, which let cuDNN's
    convolutions take TF32): the ranks' steps and the one-process loss then
    differ by fp32 rounding only."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _device(device) -> torch.device:
    """``device`` resolved (None: the card), a card as this process's own."""
    from ..utils import resolve_device

    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _steps(rank: int, n: int, device: torch.device) -> dict:
    """Both steps in process ``rank`` of the group: their losses and the mesh."""
    from ..engine import ce_per_example, init_cell_state, make_apply_fn
    from ..peft import build_mask, split_params
    from .mesh import make_mesh, shard_batch
    from .train_step import make_sharded_train_step

    model_par = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(data=n // model_par, model=model_par)
    x, y = _batch(n, device)
    xs, ys = shard_batch(mesh, x), shard_batch(mesh, y)
    out = {"mesh": mesh.shape}
    for moe, key in ((False, "loss"), (True, "zero1_moe_loss")):
        model = _model(moe, device)
        trainable, _ = split_params(model, build_mask(model, "lora", num_layers=LAYERS))
        step, place = make_sharded_train_step(make_apply_fn(model), ce_per_example, mesh,
                                              zero1=moe, model=model)
        state, frozen = place(init_cell_state(trainable), {})
        with _fp32_products():
            state, loss = step(state, frozen, xs, ys, LR, WD)
        out[key] = float(loss)
    return out


def _entry(rank: int, n: int, tmp: str, device) -> None:
    from ..utils import dist as port_dist

    if device == "cpu":
        torch.set_num_threads(1)
    port_dist.init_distributed(init_method=f"file://{tmp}/rendezvous", num_processes=n,
                               process_id=rank, device=device)
    try:
        torch.save(_steps(rank, n, _device(device)), os.path.join(tmp, f"result{rank}.pt"))
    finally:
        port_dist.destroy_distributed()


def one_process_loss(n: int, device=None) -> float:
    """The first step's loss computed in one process: the whole tower's
    mean cross-entropy over the global batch."""
    from ..engine import ce_per_example

    device = _device(device)
    model = _model(False, device)
    model.train(True)
    x, y = _batch(n, device)
    with torch.no_grad(), _fp32_products():
        return float(ce_per_example(model(x).to(torch.float32), y).mean())


def dryrun_multichip(n: int, device=None) -> dict:
    """The two steps over ``n`` spawned processes on ``device`` (see the
    module docstring); returns rank 0's losses and mesh, every rank's losses
    and the one-process loss.  Raises if a process fails or a check does
    not hold."""
    import torch.multiprocessing as mp

    _device(device)  # no card: raise here, before any process starts
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_entry, args=(n, tmp, device), nprocs=n, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{n} dryrun processes still ran after {TIMEOUT_S} s")
        ranks = [torch.load(os.path.join(tmp, f"result{r}.pt")) for r in range(n)]
    out = dict(ranks[0])
    out["ranks"] = ranks
    out["one_process_loss"] = one_process_loss(n, device)
    for r in ranks:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["zero1_moe_loss"])):
            raise AssertionError(f"a dryrun loss is not finite: {r}")
    rel = abs(out["loss"] - out["one_process_loss"]) / abs(out["one_process_loss"])
    out["loss_rel"] = rel
    if rel > TOL_LOSS_REL:
        raise AssertionError(f"the dryrun's first loss {out['loss']} is {rel:.3e} relative from "
                             f"the one-process loss {out['one_process_loss']}")
    print(f"dryrun_multichip ok ({device or 'cuda'}): mesh={out['mesh']} loss={out['loss']:.6f} "
          f"zero1_moe_loss={out['zero1_moe_loss']:.6f} one-process loss "
          f"{out['one_process_loss']:.6f} ({rel:.2e} relative)", flush=True)
    return out


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="The multichip dryrun over N processes.")
    parser.add_argument("n", type=int, nargs="?", default=8, help="processes (default 8)")
    parser.add_argument("--device", default=None,
                        help="'cpu' for gloo CPU processes (default: the cards, one a rank)")
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device)
