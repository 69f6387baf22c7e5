"""Microbatch splitting for the pipeline.

The counterpart of ``pipegoose_tpu/nn/pipeline_parallel/microbatch.py``:
an explicit reshape to a leading microbatch dim, (B, ...) -> (n, B/n, ...),
over a tree of dicts, lists and tuples whose leaves are tensors or numpy
arrays.
"""
from __future__ import annotations

from typing import Any

from pipegoose_tpu_torch.core.accumulation import _map_batch


def split(batch: Any, n_microbatches: int) -> Any:
    """Reshape every leaf (B, ...) -> (n_microbatches, B/n, ...)."""
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_microbatches}")

    def f(x):
        if x.shape[0] % n_microbatches != 0:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"n_microbatches={n_microbatches}")
        return x.reshape((n_microbatches, x.shape[0] // n_microbatches,
                          *x.shape[1:]))

    return _map_batch(f, batch)


def merge(microbatches: Any) -> Any:
    """The inverse of :func:`split`: (n, b, ...) -> (n*b, ...)."""
    return _map_batch(lambda x: x.reshape((x.shape[0] * x.shape[1], *x.shape[2:])),
                      microbatches)
