"""Optimizers (counterpart of ``pipegoose_tpu.optim``): ZeRO-1."""
from pipegoose_tpu_torch.optim.zero import (  # noqa: F401
    DistributedOptimizer,
    ZeroState,
    adam,
)
