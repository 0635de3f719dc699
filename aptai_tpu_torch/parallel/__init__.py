"""Training and serving over several devices through ``torch.distributed``:
the data and model axes of the JAX package's ``parallel/`` (data
parallelism, FSDP, Megatron tensor and sequence parallelism, and the
multi-process launch). One device is one process.

The pipe axis (``parallel/pipeline.py``) is not implemented yet (ROADMAP
Queue 1 item 8e-iii)."""

from aptai_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    param_specs,
    replicated,
    shard_batch,
    shard_tree,
)
from aptai_tpu_torch.parallel.multihost import (
    init_distributed,
    is_primary,
    process_env_defaults,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "init_distributed",
    "is_primary",
    "make_mesh",
    "param_specs",
    "process_env_defaults",
    "replicated",
    "shard_batch",
    "shard_tree",
]
