"""The process group (counterpart of ``peft_vit_tpu/utils/dist.py``; the
reference's lib/utils/utils.py:55-67 init_distributed and utils/comm.py).

The port runs one process a device, the PyTorch idiom: where the JAX
package's mesh spans the devices of one process (and ``jax.distributed``
joins hosts), the port's group spans processes, NCCL between cards and gloo
between CPU processes.  ``init_distributed`` joins the group from
``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), or from the JAX function's arguments (a
coordinator ``host:port``, the process count and index) mapped onto an init
method, or from an explicit ``init_method`` (``file://...`` needs no
network).  With no group the world is one process.

A step over a data group runs each rank on its rows of the global batch.
``data_shard(start, total, sum_fn)`` says so to the code under it: a random
draw of the batch's rows (``draw_rows``: the drop-path and DropBlock masks,
the erase's noise) is drawn for the whole global batch and cut to this
rank's rows, so that every rank draws what one process would; BatchNorm
takes its moments over the group (``sum_over_data``: ``sum_fn``, the
group's sum, whose gradient is the sum over the group too).  The collective
itself is ``parallel.collectives.sum_over_group``.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import resolve_device

logger = logging.getLogger(__name__)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def group_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     init_method: Optional[str] = None,
                     device=None) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).  Safe to call
    again: a joined group is kept.

    The rendezvous is ``init_method`` if given, else ``tcp://`` of
    ``coordinator_address`` (or ``MASTER_ADDR``:``MASTER_PORT``); the world
    size and rank are ``num_processes`` / ``process_id`` or ``WORLD_SIZE`` /
    ``RANK``.  With none of these there is no group: (0, 1).  ``device``
    None is the card (NCCL; this process's card is ``LOCAL_RANK``, else the
    rank modulo the cards); ``'cpu'`` gives gloo."""
    if group_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method is None:
        address = coordinator_address
        if address is None and os.environ.get("MASTER_ADDR"):
            address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        if address is not None:
            init_method = address if "://" in address else f"tcp://{address}"
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if init_method is None:
        if world not in (None, 1):
            raise ValueError(f"a world of {world} processes needs a rendezvous address")
        return 0, 1
    if world is None or rank is None:
        raise ValueError("a process group needs its world size and this process's rank")
    device = resolve_device(device)
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK")
        # without torchrun's LOCAL_RANK the group is one host's
        ranks_here = _env_int("LOCAL_WORLD_SIZE") or (int(world) if local is None else 1)
        cards = torch.cuda.device_count()
        if max(ranks_here, (local or 0) + 1) > cards:
            raise ValueError(
                f"{max(ranks_here, (local or 0) + 1)} ranks on a host with {cards} card(s): "
                "NCCL needs one card a rank (run at most one process a card)")
        torch.cuda.set_device(local if local is not None else int(rank))
        backend = "nccl"
    else:
        backend = "gloo"
    _AXIS_GROUPS.clear()  # a new group: no subgroup of an earlier one
    dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                            rank=int(rank))
    logger.info("=> process group (%s) joined: rank %d of %d", backend, rank, world)
    return dist.get_rank(), dist.get_world_size()


# (data, model) -> (data group, model group) of this rank, made once a mesh
# shape by every rank in the same order (dist.new_group's rule); emptied by
# destroy_distributed, so that no subgroup outlives its default group
_AXIS_GROUPS: Dict[Tuple[int, int], Tuple[Any, Any]] = {}


def axis_groups(data: int, model: int, pipe: int = 1) -> Tuple[Any, Any, Any]:
    """This rank's subgroups of a ``data`` x ``model`` x ``pipe`` mesh (rank r
    at (r // (model pipe), (r // pipe) % model, r % pipe), the pipe axis
    fastest): the data group (the ranks of its model and pipe indices), the
    model group (of its data and pipe indices) and the pipe group (of its data
    and model indices; None without a pipe axis).  A collective call: every
    rank makes them."""
    key = (int(data), int(model), int(pipe))
    if key not in _AXIS_GROUPS:
        me, mine = rank(), [None, None, None]

        def at(d, m, p):
            return (d * model + m) * pipe + p

        for axis, ranks_of in enumerate((
                [[at(d, m, p) for d in range(data)] for m in range(model) for p in range(pipe)],
                [[at(d, m, p) for m in range(model)] for d in range(data) for p in range(pipe)],
                [[at(d, m, p) for p in range(pipe)] for d in range(data) for m in range(model)]
                if pipe > 1 else [])):
            for ranks in ranks_of:
                g = dist.new_group(ranks)
                if me in ranks:
                    mine[axis] = g
        _AXIS_GROUPS[key] = tuple(mine)
    return _AXIS_GROUPS[key]


def destroy_distributed() -> None:
    """Leave the process group: the mesh subgroups first, then every group
    (a gloo subgroup still referenced when the process exits can abort it)."""
    _AXIS_GROUPS.clear()
    if group_initialized():
        dist.destroy_process_group()


def rank() -> int:
    """This process's index in the group, 0 without a group."""
    return dist.get_rank() if group_initialized() else 0


def is_main_process() -> bool:
    """comm.is_main_process (utils/comm.py:44-47)."""
    return rank() == 0


def world_size() -> int:
    return dist.get_world_size() if group_initialized() else 1


def barrier(name: str = "barrier") -> None:
    """dist.barrier (utils/comm.py:54-61): every process of the group meets
    here; without a group there is nothing to wait for."""
    del name
    if group_initialized():
        dist.barrier()


# -- a step over the data group ------------------------------------------------


class DataShard(NamedTuple):
    """This rank's rows [start, start + b) of a global batch of ``total``
    rows, and ``sum``: the sum over the data group, with its gradient
    (``parallel.collectives.sum_over_group`` of that group)."""

    start: int
    total: int
    sum: Callable[[torch.Tensor], torch.Tensor]


_SHARD: Optional[DataShard] = None


@contextlib.contextmanager
def data_shard(start: int, total: int, sum_fn: Callable[[torch.Tensor], torch.Tensor]):
    """Run the code under it as this rank's rows of a global batch (see the
    module docstring); ``sum_fn`` is the data group's sum."""
    global _SHARD
    prev, _SHARD = _SHARD, DataShard(int(start), int(total), sum_fn)
    try:
        yield
    finally:
        _SHARD = prev


def current_shard() -> Optional[DataShard]:
    return _SHARD


def draw_rows(draw: Callable[[Tuple[int, ...]], torch.Tensor],
              shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for a batch of ``shape[0]`` rows; under ``data_shard``
    the draw of the global batch's shape, cut to this rank's rows."""
    shape = tuple(shape)
    if _SHARD is None:
        return draw(shape)
    full = draw((_SHARD.total, *shape[1:]))
    return full[_SHARD.start:_SHARD.start + shape[0]]


def sum_over_data(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data group under ``data_shard`` (with its
    gradient), else ``x``."""
    return x if _SHARD is None else _SHARD.sum(x)


def data_rows() -> Optional[int]:
    """The global batch's rows under ``data_shard``, else None."""
    return None if _SHARD is None else _SHARD.total
