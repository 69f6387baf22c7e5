"""``torch.distributed`` process groups per parallel axis, and the
collectives over them (counterpart of ``pipegoose_tpu.distributed``)."""
from pipegoose_tpu_torch.distributed import functional  # noqa: F401
from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext  # noqa: F401
from pipegoose_tpu_torch.distributed.parallel_mode import (  # noqa: F401
    MESH_AXIS_ORDER,
    ParallelMode,
)

__all__ = ["ParallelContext", "ParallelMode", "MESH_AXIS_ORDER", "functional"]
