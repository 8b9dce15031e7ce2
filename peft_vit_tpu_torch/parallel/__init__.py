"""Data parallelism over a process group (counterpart of
``peft_vit_tpu/parallel``): the mesh and its rules, the collectives with
their gradients, the sharded train and eval steps with ZeRO-1.  Tensor,
sequence and pipeline parallelism (the JAX package's ``model`` and ``pipe``
axes, ``parallel/pipeline.py``) are not ported yet."""

from .collectives import (
    allgather_ragged,
    gather_features,
    host_allgather,
    psum_mean,
    reduce_mean_metrics,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    Mesh,
    batch_rows,
    make_mesh,
    mesh_from_config,
    param_partition_spec,
    shard_batch,
    zero_dim,
    zero_partition_spec,
)
from .train_step import make_sharded_eval_step, make_sharded_train_step

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "Mesh",
    "allgather_ragged",
    "batch_rows",
    "gather_features",
    "host_allgather",
    "make_mesh",
    "make_sharded_eval_step",
    "make_sharded_train_step",
    "mesh_from_config",
    "param_partition_spec",
    "psum_mean",
    "reduce_mean_metrics",
    "shard_batch",
    "zero_dim",
    "zero_partition_spec",
]
