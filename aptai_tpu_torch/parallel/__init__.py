"""Training over several devices through ``torch.distributed``: the data
axis of the JAX package's ``parallel/`` (data parallelism, FSDP and the
multi-process launch). One device is one process.

The model axis (tensor and sequence parallelism) and the pipeline are not
implemented yet (ROADMAP Queue 1 item 8e-ii)."""

from aptai_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
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
    "init_distributed",
    "is_primary",
    "make_mesh",
    "process_env_defaults",
    "shard_batch",
    "shard_tree",
]
