"""The mesh over the process group, and the sharding rules as pure functions
(counterpart of ``peft_vit_tpu/parallel/mesh.py``).

The reference's only parallelism is DDP over NCCL (SURVEY §2.4:
tools/train.py:119-123, utils/comm.py).  The JAX package names the devices
of a ``jax.sharding.Mesh`` with ``data``, ``model`` and ``pipe`` axes and
lets GSPMD place the collectives; the port's mesh is the degrees of those
axes over the process group (``utils.dist``), one process a device, and its
steps call the collectives themselves (``parallel.collectives``,
``parallel.train_step``).

Rank r sits at (r // (model pipe), (r // pipe) % model, r % pipe) of the
JAX device order, ``reshape(data, model, pipe)`` with the pipe axis fastest
(without one, (r // model, r % model)); each axis has its subgroups
(``Mesh.data_group``, ``Mesh.model_group``, ``Mesh.pipe_group``: the ranks
that differ from this one on that axis alone).  The model axis carries
tensor parallelism and, under ``TPU.SEQUENCE_PARALLEL``, sequence
parallelism (``parallel.train_step``, ``engine.trainer``); the pipe axis
GPipe's stages (``parallel.pipeline``).  The tensor-parallel rules are
Megatron's column-parallel first and row-parallel second GEMM:
``param_partition_spec`` mirrors the JAX specs as data, and ``tp_cut`` is
the port's cut of a leaf (whole heads: see ``parallel.train_step``).

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

    @property
    def model_rank(self) -> int:
        """This process's index on the model axis."""
        return (_dist.rank() // self.pipe) % self.model if self.model > 1 else 0

    @property
    def pipe_rank(self) -> int:
        """This process's index on the pipe axis: its GPipe stage."""
        return _dist.rank() % self.pipe if self.pipe > 1 else 0

    def _groups(self):
        return _dist.axis_groups(self.data, self.model, self.pipe)

    @property
    def data_group(self):
        """The subgroup of this process's data axis (None: the default
        group)."""
        return self._groups()[0] if self.model > 1 or self.pipe > 1 else None

    @property
    def model_group(self):
        """The subgroup of this process's model axis (None without one)."""
        return self._groups()[1] if self.model > 1 else None

    @property
    def pipe_group(self):
        """The subgroup of this process's pipe axis (None without one)."""
        return self._groups()[2] if self.pipe > 1 else None


def make_mesh(data: int = -1, model: int = 1, pipe: int = 1) -> Mesh:
    """``data`` = -1 takes every process of the group the other axes leave.
    A ``model`` or ``pipe`` degree above 1 makes the axes' subgroups (a
    collective call: every rank makes the mesh)."""
    n = _dist.world_size()
    model, pipe = int(model), int(pipe)
    data = n // (model * pipe) if int(data) == -1 else int(data)
    if model < 1 or pipe < 1 or data * model * pipe != n:
        raise ValueError(f"a mesh of {data} x {model} x {pipe} over {n} processes")
    mesh = Mesh(data, model, pipe, _dist.rank() // (model * pipe))
    if model > 1 or pipe > 1:
        _dist.axis_groups(data, model, pipe)
    return mesh


def mesh_from_config(cfg) -> Mesh:
    """The mesh of ``TPU.MESH`` (``DATA``, ``MODEL``, ``PIPE``), as the JAX
    ``mesh_from_config`` (``TPU.SEQUENCE_PARALLEL`` changes no axis)."""
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


def tp_cut(name: str, shape: Sequence[int]) -> Optional[str]:
    """How tensor parallelism cuts the port's leaf ``name`` over the model
    axis: ``"qkv"`` (``in_proj``'s weight and bias: the rank's heads of q,
    of k and of v, a block of rows from each third), ``"rows"`` (the output
    rows of a column-parallel leaf: ``c_fc``'s weight and bias, and the LoRA
    B matrices of the q or v rows they add to), ``"cols"`` (the input
    columns of a row-parallel weight: ``out_proj``, ``c_proj``), or None
    (replicated: every other leaf, the biases of the row-parallel GEMMs
    included, which are added once after the sum)."""
    if "attn.in_proj." in name and name.endswith(("weight", "bias")):
        return "qkv"
    if "mlp.c_fc." in name and name.endswith(("weight", "bias")):
        return "rows"
    if "_adapter2.weight" in name and ".attn." in name:
        return "rows"
    if name.endswith(("attn.out_proj.weight", "mlp.c_proj.weight")):
        return "cols"
    return None


def stack_lead(name: str) -> int:
    """The leading dims of a leaf before its per-layer shape: 1 in the
    stacked block layout (``blocks.block.``: the layers' axis), else 0."""
    return 1 if "blocks.block." in name else 0


def tp_slice(t: torch.Tensor, cut: Optional[str], index: int, size: int,
             lead: int = 0) -> torch.Tensor:
    """The model rank ``index``'s part of ``t`` under ``cut`` (of
    ``tp_cut``), of ``size`` ranks, each of the ``lead`` leading dims' slices
    cut alike (``stack_lead``); a contiguous copy."""
    if cut is None or size == 1:
        return t
    if cut in ("cols", "rows"):
        dim = lead + (cut == "cols")
        n = t.shape[dim] // size
        return t.narrow(dim, index * n, n).contiguous()
    third = t.shape[lead] // 3
    n = third // size
    return torch.cat([t.narrow(lead, j * third + index * n, n) for j in range(3)],
                     lead).contiguous()


def tp_unslice(parts: Sequence[torch.Tensor], cut: Optional[str], lead: int = 0) -> torch.Tensor:
    """The whole leaf from the model ranks' ``parts`` (``tp_slice``'s
    inverse)."""
    if cut is None or len(parts) == 1:
        return parts[0]
    if cut in ("cols", "rows"):
        return torch.cat(list(parts), lead + (cut == "cols"))
    return torch.cat([p.chunk(3, lead)[j] for j in range(3) for p in parts], lead)


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
