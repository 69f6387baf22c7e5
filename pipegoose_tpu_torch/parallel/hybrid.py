"""The gradient sync of the hybrid train step.

The counterpart of ``spec_mentions`` and ``sync_replicated_grads`` of
``pipegoose_tpu/parallel/hybrid.py``. A spec is a tuple with one entry per
dimension of a parameter: an axis name, a tuple of axis names, or None
(the JAX ``PartitionSpec``). ``make_hybrid_train_step`` itself (ZeRO-1,
data and tensor parallelism, accumulation) waits for ROADMAP.md queue A,
item 5; the sequence-parallel step (``trainer.step.sp_train_step``) uses
the sync alone.
"""
from __future__ import annotations

from typing import Any, Optional

from pipegoose_tpu_torch.distributed.functional import all_reduce


def spec_mentions(spec, axis: str) -> bool:
    """Whether a spec shards any dimension over ``axis``."""
    for entry in spec:
        if entry == axis:
            return True
        if isinstance(entry, (tuple, list)) and axis in entry:
            return True
    return False


def _map(fn, grads, specs):
    if isinstance(grads, dict):
        return {k: _map(fn, v, None if specs is None else specs[k])
                for k, v in grads.items()}
    if isinstance(grads, list):
        specs = [None] * len(grads) if specs is None else specs
        return [_map(fn, g, s) for g, s in zip(grads, specs)]
    return fn(grads, () if specs is None else specs)


def sync_replicated_grads(grads: Any, param_specs: Optional[Any], axes: tuple) -> Any:
    """Reduce the gradients of parameters NOT sharded over an axis, for
    each entry of ``axes``: an axis name (sum) or ``(axis, op)`` with op
    "sum" or "mean". ``grads`` is a tree (dicts and lists) of tensors;
    ``param_specs`` the same tree of specs, or None when every parameter
    is replicated (at tp = 1 every BLOOM leaf is).

    "sum": every rank holds a partial contribution (the sequence axis: each
    rank's loss covers its own tokens), the gradient is the sum; "mean":
    the axis carries different samples, the gradient is the mean."""
    entries = [e if isinstance(e, tuple) else (e, "sum") for e in axes]
    for _, op in entries:
        if op not in ("sum", "mean"):
            raise ValueError(f"grad sync op must be 'sum' or 'mean', got {op!r}")

    def sync(g, spec):
        for ax, op in entries:
            if not spec_mentions(spec, ax):
                g = all_reduce(g, ax, op)
        return g

    return _map(sync, grads, param_specs)
