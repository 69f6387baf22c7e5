"""Optimizers (counterpart of ``pipegoose_tpu.optim``): ZeRO-1 and DiLoCo."""
from pipegoose_tpu_torch.optim.diloco import (  # noqa: F401
    DiLoCo,
    DiLoCoHybrid,
    outer_optimizer,
)
from pipegoose_tpu_torch.optim.zero import (  # noqa: F401
    DistributedOptimizer,
    ZeroState,
    adam,
)
