"""Training and serving over several devices through ``torch.distributed``:
the data, model and pipe axes of the JAX package's ``parallel/`` (data
parallelism, FSDP, Megatron tensor and sequence parallelism, the GPipe and
interleaved pipeline schedules over the encoder's layer stack, and the
multi-process launch). One device is one process."""

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
from aptai_tpu_torch.parallel.pipeline import (
    PIPE_AXIS,
    interleaved_layer_order,
    pipeline_layer_stack,
    pipelined_encoder_apply,
    place_stage,
    schedule_ticks,
    split_layer_params,
    stage_sharding,
    unstack_layer_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "batch_sharding",
    "init_distributed",
    "interleaved_layer_order",
    "is_primary",
    "make_mesh",
    "param_specs",
    "pipeline_layer_stack",
    "pipelined_encoder_apply",
    "place_stage",
    "process_env_defaults",
    "replicated",
    "schedule_ticks",
    "shard_batch",
    "shard_tree",
    "split_layer_params",
    "stage_sharding",
    "unstack_layer_params",
]
