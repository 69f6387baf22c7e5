"""Tensor-parallel layer functions and the parameter sharding policy."""
from pipegoose_tpu_torch.nn.tensor_parallel.layers import (  # noqa: F401
    column_parallel_linear,
    layer_norm,
    row_parallel_linear,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)
from pipegoose_tpu_torch.nn.tensor_parallel.tensor_parallel import (  # noqa: F401
    TensorParallel,
    pad_vocab,
)
