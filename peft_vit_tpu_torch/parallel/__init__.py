"""Data and tensor parallelism over a process group (counterpart of
``peft_vit_tpu/parallel``): the mesh and its rules, the collectives with
their gradients, the sharded train and eval steps with ZeRO-1 and Megatron's
tensor parallelism over the ``model`` axis, the multi-process dryrun
(``dryrun``).  Sequence and pipeline parallelism (``TPU.SEQUENCE_PARALLEL``,
the JAX package's ``pipe`` axis and ``parallel/pipeline.py``) are not ported
yet."""

from .collectives import (
    allgather_ragged,
    copy_to_model,
    gather_features,
    host_allgather,
    max_all_reduce,
    mean_all_reduce,
    psum_mean,
    reduce_from_model,
    reduce_mean_metrics,
    roll_rows,
    sum_all_reduce,
    sum_over_group,
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
    tp_cut,
    tp_slice,
    tp_unslice,
    zero_dim,
    zero_partition_spec,
)
from .train_step import (
    check_tensor_parallel,
    make_sharded_eval_step,
    make_sharded_train_step,
    tp_gather,
    tp_place,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "Mesh",
    "allgather_ragged",
    "batch_rows",
    "check_tensor_parallel",
    "copy_to_model",
    "gather_features",
    "host_allgather",
    "make_mesh",
    "make_sharded_eval_step",
    "make_sharded_train_step",
    "max_all_reduce",
    "mean_all_reduce",
    "mesh_from_config",
    "param_partition_spec",
    "psum_mean",
    "reduce_from_model",
    "reduce_mean_metrics",
    "roll_rows",
    "shard_batch",
    "sum_all_reduce",
    "sum_over_group",
    "tp_cut",
    "tp_gather",
    "tp_place",
    "tp_slice",
    "tp_unslice",
    "zero_dim",
    "zero_partition_spec",
]
