"""Parallel train-step composition (counterpart of ``pipegoose_tpu.parallel``):
so far the gradient sync of the sequence-parallel step."""
from pipegoose_tpu_torch.parallel.hybrid import (  # noqa: F401
    spec_mentions,
    sync_replicated_grads,
)
