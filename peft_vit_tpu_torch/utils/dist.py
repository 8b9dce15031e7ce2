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
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

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
        torch.cuda.set_device(local if local is not None else rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                            rank=int(rank))
    logger.info("=> process group (%s) joined: rank %d of %d", backend, rank, world)
    return dist.get_rank(), dist.get_world_size()


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
