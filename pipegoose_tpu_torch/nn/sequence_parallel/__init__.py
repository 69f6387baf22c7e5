"""Sequence parallelism (counterpart of ``pipegoose_tpu.nn.sequence_parallel``):
ring attention, dense and through the chunk kernels B7-B9, Ulysses, and
the next-token targets across shards."""
from pipegoose_tpu_torch.nn.sequence_parallel.ring_attention import (  # noqa: F401
    make_causal_alibi_bias_fn,
    ring_attention,
    ring_flash_attention,
)
from pipegoose_tpu_torch.nn.sequence_parallel.ulysses import ulysses_attention  # noqa: F401

__all__ = ["ring_attention", "make_causal_alibi_bias_fn", "ulysses_attention"]
