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
   same mesh;
3. a sequence-parallel LoRA step (``TPU.SEQUENCE_PARALLEL``) of the flagship
   at width 64, 48 px, patch 16 (3 x 3 patches and the class token: 10
   tokens, 5 a rank over model 2) on the same mesh, 2 heads of 32 (the JAX
   dryrun's 4 heads of 16 are no head dim of K1-K3);
4. GPipe: a stack of 8 blocks (width 64, 2 heads) staged over a mesh of
   n / pipe x pipe, pipe = min(4, n), 2 microbatches of each data shard's
   rows, one SGD step of the staged leaves and of a linear head on the
   tokens' mean (the JAX dryrun's fourth step, on a random batch and head
   where it has zeros).

``device`` None is the card: NCCL, one card a rank (``utils.dist.
init_distributed`` refuses more ranks than the host has cards), the steps
on the attention kernels.  ``device='cpu'`` gives gloo CPU processes, one
torch thread each: the multi-rank arithmetic on a host with fewer cards.
The weights are drawn from a seed in every process alike, the batches from
others.  Every loss must be finite; the first, the sequence-parallel one and
the pipelined one (and the pipelined loss after its step) are also held to
the same losses computed in one process over the global batch, within
``TOL_LOSS_REL``.
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
SP_WIDTH, SP_HEADS, SP_IMAGE = 64, 2, 48  # 10 tokens; head dim 32
PP_BLOCKS, PP_TOKENS, PP_MICROBATCHES, PP_LR = 8, 5, 2, 1e-3


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


def _sp_model(device: torch.device):
    """The sequence-parallel step's tower (step 3), drawn from ``SEED + 2``."""
    from ..models import flagship

    torch.manual_seed(SEED + 2)
    model = flagship(width=SP_WIDTH, layers=LAYERS, heads=SP_HEADS, image=SP_IMAGE, patch=PATCH,
                     num_classes=CLASSES, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            if not p.abs().sum():
                p.normal_(0.0, 0.02)
    return model.to(device)


def _batch(n: int, device: torch.device, image: int = IMAGE, seed: int = SEED + 7):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((2 * n, image, image, 3)).astype(np.float32)
    y = rng.randint(0, CLASSES, 2 * n).astype(np.int64)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def _pp_setup(n: int, device: torch.device):
    """Step 4's block template, its 8 blocks' leaves stacked (L, ...), the
    head (width, classes) and the global batch of tokens and labels."""
    from ..models.layers import Block

    torch.manual_seed(SEED + 3)
    blocks = [Block(SP_WIDTH, SP_HEADS, device="cpu") for _ in range(PP_BLOCKS)]
    names = [k for k, _ in blocks[0].named_parameters()]
    stacked = {k: torch.stack([dict(b.named_parameters())[k].detach() for b in blocks])
               .to(device) for k in names}
    rng = np.random.RandomState(SEED + 11)
    head = torch.from_numpy(rng.standard_normal((SP_WIDTH, CLASSES)).astype(np.float32)
                            * 0.1).to(device)
    x = torch.from_numpy(rng.standard_normal((2 * n, PP_TOKENS, SP_WIDTH)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, CLASSES, 2 * n).astype(np.int64))
    return blocks[0].to(device), stacked, head, x.to(device), y.to(device)


def _pp_loss(block, stacked, head, x, y, transport=None):
    """Step 4's loss: the tokens through the stack (pipelined over
    ``transport``, or layer by layer), their mean, the head, the mean
    cross-entropy."""
    from torch.func import functional_call

    from ..engine import ce_per_example
    from .pipeline import pipeline_apply, stage_params

    def block_fn(p, h):
        return functional_call(block, p, (h,))

    if transport is None:
        h = x
        for i in range(PP_BLOCKS):
            h = block_fn({k: v[i] for k, v in stacked.items()}, h)
    else:
        h = pipeline_apply(block_fn, stage_params(stacked, transport.n_stages), x,
                           microbatches=PP_MICROBATCHES, transport=transport)
    return ce_per_example(h.mean(1) @ head, y).mean()


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
    """The four steps in process ``rank`` of the group: their losses and the
    meshes."""
    from ..engine import ce_per_example, init_cell_state, make_apply_fn
    from ..peft import build_mask, split_params
    from .collectives import psum_mean, sum_all_reduce
    from .mesh import make_mesh, shard_batch
    from .pipeline import GroupRing, LocalRing
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
    # 3: sequence parallelism on the same mesh
    model = _sp_model(device)
    trainable, _ = split_params(model, build_mask(model, "lora", num_layers=LAYERS))
    step, place = make_sharded_train_step(make_apply_fn(model), ce_per_example, mesh,
                                          model=model, sequence_parallel=True)
    state, frozen = place(init_cell_state(trainable), {})
    x, y = _batch(n, device, SP_IMAGE, SEED + 8)
    with _fp32_products():
        state, loss = step(state, frozen, shard_batch(mesh, x), shard_batch(mesh, y), LR, WD)
    out["seqpar_loss"] = float(loss)
    # 4: GPipe over data x pipe
    pipe = min(4, n)
    pp = make_mesh(data=n // pipe, model=1, pipe=pipe)
    out["pp_mesh"] = {"data": pp.data, "pipe": pipe}
    block, stacked, head, x, y = _pp_setup(n, device)
    leaves = {k: v.requires_grad_() for k, v in {**stacked, "head": head}.items()}
    transport = GroupRing(pp.pipe_group, pipe) if pipe > 1 else LocalRing(1)
    last = pp.pipe_rank == pipe - 1
    with _fp32_products():
        loss = _pp_loss(block, {k: v for k, v in leaves.items() if k != "head"}, leaves["head"],
                        shard_batch(pp, x), shard_batch(pp, y), transport)
        # the last stage's loss drives the backward; the pipe group's sum of
        # the gradients is then the whole one on every rank
        grads = torch.autograd.grad(loss * float(last), list(leaves.values()))
        with torch.no_grad():
            new = {k: v - PP_LR * psum_mean(sum_all_reduce(g, pp.pipe_group) if pipe > 1
                                            else g, pp.data_group)
                   for (k, v), g in zip(leaves.items(), grads)}
        out["pp_loss"] = float(psum_mean(loss.detach(), pp.data_group))
        after = _pp_loss(block, {k: v for k, v in new.items() if k != "head"}, new["head"],
                         shard_batch(pp, x), shard_batch(pp, y), transport)
        out["pp_loss_after"] = float(psum_mean(after.detach(), pp.data_group))
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


def one_process_losses(n: int, device=None) -> dict:
    """The losses of steps 1, 3 and 4 computed in one process over the
    global batch: the towers' mean cross-entropy, and step 4's loss before
    and after its SGD step, the stack applied layer by layer."""
    from ..engine import ce_per_example

    device = _device(device)
    out = {}
    for key, model, (x, y) in (
            ("loss", _model(False, device), _batch(n, device)),
            ("seqpar_loss", _sp_model(device), _batch(n, device, SP_IMAGE, SEED + 8))):
        model.train(True)
        with torch.no_grad(), _fp32_products():
            out[key] = float(ce_per_example(model(x).to(torch.float32), y).mean())
    block, stacked, head, x, y = _pp_setup(n, device)
    leaves = {k: v.requires_grad_() for k, v in {**stacked, "head": head}.items()}
    with _fp32_products():
        loss = _pp_loss(block, {k: v for k, v in leaves.items() if k != "head"},
                        leaves["head"], x, y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            new = {k: v - PP_LR * g for (k, v), g in zip(leaves.items(), grads)}
            after = _pp_loss(block, {k: v for k, v in new.items() if k != "head"},
                             new["head"], x, y)
    out["pp_loss"], out["pp_loss_after"] = float(loss.detach()), float(after)
    return out


CHECKED = ("loss", "seqpar_loss", "pp_loss", "pp_loss_after")


def dryrun_multichip(n: int, device=None) -> dict:
    """The four steps over ``n`` spawned processes on ``device`` (see the
    module docstring); returns rank 0's losses and meshes, every rank's
    losses, the one-process losses (``one_process``) and each checked loss's
    relative distance from its one-process value (``rel``; ``loss_rel`` the
    first's).  Raises if a process fails or a check does not hold."""
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
    one = out["one_process"] = one_process_losses(n, device)
    out["one_process_loss"] = one["loss"]
    for r in ranks:
        if not all(np.isfinite(r[k]) for k in (*CHECKED, "zero1_moe_loss")):
            raise AssertionError(f"a dryrun loss is not finite: {r}")
    out["rel"] = {k: abs(out[k] - one[k]) / abs(one[k]) for k in CHECKED}
    out["loss_rel"] = out["rel"]["loss"]
    for k, rel in out["rel"].items():
        if rel > TOL_LOSS_REL:
            raise AssertionError(f"the dryrun's {k} {out[k]} is {rel:.3e} relative from the "
                                 f"one-process {k} {one[k]}")
    print(f"dryrun_multichip ok ({device or 'cuda'}): mesh={out['mesh']} loss={out['loss']:.6f} "
          f"zero1_moe_loss={out['zero1_moe_loss']:.6f} seqpar_loss={out['seqpar_loss']:.6f} "
          f"pp_loss={out['pp_loss']:.6f} (pipe={out['pp_mesh']['pipe']} x "
          f"data={out['pp_mesh']['data']}); largest relative distance from one process "
          f"{max(out['rel'].values()):.2e}", flush=True)
    return out


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="The multichip dryrun over N processes.")
    parser.add_argument("n", type=int, nargs="?", default=8, help="processes (default 8)")
    parser.add_argument("--device", default=None,
                        help="'cpu' for gloo CPU processes (default: the cards, one a rank)")
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device)
