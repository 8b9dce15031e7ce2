"""The mesh over the process group, and the sharding rules as pure functions
(counterpart of ``peft_vit_tpu/parallel/mesh.py``).

The reference's only parallelism is DDP over NCCL (SURVEY §2.4:
tools/train.py:119-123, utils/comm.py).  The JAX package names the devices
of a ``jax.sharding.Mesh`` with ``data``, ``model`` and ``pipe`` axes and
lets GSPMD place the collectives; the port's mesh is the degrees of those
axes over the process group (``utils.dist``), one process a device, and its
steps call the collectives themselves (``parallel.collectives``,
``parallel.train_step``).

Data parallelism runs here.  The tensor-parallel rules
(``param_partition_spec``: Megatron's column-parallel first and row-parallel
second GEMM) are kept as data for the next slice; a ``model`` or ``pipe``
degree above 1 and ``TPU.SEQUENCE_PARALLEL`` raise.

A partition spec is a tuple with one entry a dim, the axis name that splits
it or None; ``()`` replicates.  The rules read the port's names and layouts
(a Linear weight is (out, in), the JAX kernel's transpose).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils import dist as _dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"

PartitionSpec = Tuple[Optional[str], ...]

_LATER = "ROADMAP §1, parallelism (tensor, sequence and pipeline)"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to peft_vit_tpu_torch yet ({_LATER})")


class Mesh(NamedTuple):
    """The degrees of the mesh's axes over the process group, and this
    process's index on the data axis."""

    data: int
    model: int = 1
    pipe: int = 1
    rank: int = 0

    @property
    def shape(self) -> dict:
        out = {DATA_AXIS: self.data, MODEL_AXIS: self.model}
        if self.pipe > 1:
            out[PIPE_AXIS] = self.pipe
        return out


def make_mesh(data: int = -1, model: int = 1, pipe: int = 1) -> Mesh:
    """``data`` = -1 takes every process of the group the other axes leave.
    A ``model`` or ``pipe`` degree above 1 raises."""
    if int(model) > 1:
        raise _not_ported(f"a model (tensor-parallel) degree of {model}")
    if int(pipe) > 1:
        raise _not_ported(f"a pipe (pipeline) degree of {pipe}")
    n = _dist.world_size()
    data = n if int(data) == -1 else int(data)
    if data * int(model) * int(pipe) != n:
        raise ValueError(f"a mesh of {data} x {model} x {pipe} over {n} processes")
    return Mesh(data, int(model), int(pipe), _dist.rank())


def mesh_from_config(cfg) -> Mesh:
    """The mesh of ``TPU.MESH`` (``DATA``, ``MODEL``, ``PIPE``);
    ``TPU.SEQUENCE_PARALLEL`` raises."""
    if bool(cfg.TPU.get("SEQUENCE_PARALLEL", False)):
        raise _not_ported("TPU.SEQUENCE_PARALLEL")
    return make_mesh(data=int(cfg.TPU.MESH.DATA), model=int(cfg.TPU.MESH.MODEL),
                     pipe=int(cfg.TPU.MESH.get("PIPE", 1)))


def batch_rows(mesh: Mesh, n: int) -> slice:
    """The rows of a global batch of ``n`` that this process holds: rows [r b,
    (r + 1) b) for b = n / data, the order of the JAX ``batch_sharding``."""
    if n % mesh.data:
        raise ValueError(f"a batch of {n} does not split over {mesh.data} processes")
    b = n // mesh.data
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This process's rows of the global batch ``x``."""
    return x[batch_rows(mesh, x.shape[0])]


def param_partition_spec(name: str, shape: Sequence[int]) -> PartitionSpec:
    """The tensor-parallel rule of a parameter over the ``model`` axis:
    column-parallel ``c_fc`` and ``in_proj`` (their output rows split),
    row-parallel ``c_proj`` and ``out_proj`` (their input columns split);
    everything else replicates.  With model = 1 all of them replicate."""
    if len(shape) != 2:
        return ()
    if "mlp.c_fc.weight" in name or "attn.in_proj.weight" in name:
        return (MODEL_AXIS, None)
    if "mlp.c_proj.weight" in name or "attn.out_proj.weight" in name:
        return (None, MODEL_AXIS)
    return ()


def zero_dim(shape: Sequence[int], data: int) -> Optional[int]:
    """The dim of a leaf that ZeRO-1 splits over ``data`` processes: the
    largest dim divisible by ``data`` and at least as large (the first of
    equals); None replicates the leaf."""
    best = None
    for i, d in enumerate(shape):
        if d % data == 0 and d >= data and (best is None or d > shape[best]):
            best = i
    return best


def zero_partition_spec(shape: Sequence[int], data: int) -> PartitionSpec:
    """``zero_dim`` as a partition spec over the ``data`` axis."""
    dim = zero_dim(shape, data)
    if dim is None:
        return ()
    return tuple(DATA_AXIS if i == dim else None for i in range(len(shape)))
