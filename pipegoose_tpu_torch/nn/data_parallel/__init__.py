"""Data parallelism (counterpart of ``pipegoose_tpu.nn.data_parallel``)."""
from pipegoose_tpu_torch.nn.data_parallel.data_parallel import (  # noqa: F401
    DataParallel,
    average_gradients,
)
