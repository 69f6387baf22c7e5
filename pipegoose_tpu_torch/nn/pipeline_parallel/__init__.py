"""Pipeline parallelism (counterpart of ``pipegoose_tpu.nn.pipeline_parallel``):
GPipe and 1F1B over the "pipe" axis, their timetables, microbatches and
the stage partitioner."""
from pipegoose_tpu_torch.nn.pipeline_parallel.microbatch import merge, split  # noqa: F401
from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import (  # noqa: F401
    gpipe,
    last_stage_value,
    manual_grads_loss,
    one_f_one_b,
    pipe_stage_specs,
)
from pipegoose_tpu_torch.nn.pipeline_parallel.scheduler import (  # noqa: F401
    GPipeScheduler,
    JobType,
    OneFOneBScheduler,
    Task,
)

__all__ = [
    "gpipe",
    "one_f_one_b",
    "manual_grads_loss",
    "last_stage_value",
    "pipe_stage_specs",
    "GPipeScheduler",
    "OneFOneBScheduler",
    "JobType",
    "Task",
    "split",
    "merge",
]
