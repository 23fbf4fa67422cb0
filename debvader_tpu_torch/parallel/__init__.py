"""Multi-device serving and training on a device mesh (parallel/mesh.py):
one process drives every shard, or several processes each drive their own
and train data-parallel through torch.distributed."""

from debvader_tpu_torch.parallel.collectives import all_gather, broadcast, psum
from debvader_tpu_torch.parallel.distributed import (
    barrier,
    global_devices,
    initialize_distributed,
    is_multi_host,
    process_count,
    process_index,
)
from debvader_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    make_mesh,
    param_shardings,
    replicate_module,
    replicated,
    require_single_process,
    shard_variables,
)
from debvader_tpu_torch.parallel.sharded import (
    create_sharded_train_state,
    make_sharded_apply,
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_batch,
    shard_train_state,
    sharded_forward,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "batch_sharding",
    "initialize_distributed",
    "is_multi_host",
    "process_index",
    "process_count",
    "barrier",
    "global_devices",
    "all_gather",
    "psum",
    "broadcast",
    "require_single_process",
    "make_mesh",
    "param_shardings",
    "replicate_module",
    "replicated",
    "shard_variables",
    "make_sharded_apply",
    "shard_batch",
    "sharded_forward",
    "create_sharded_train_state",
    "shard_train_state",
    "make_sharded_train_step",
    "make_sharded_eval_step",
]
