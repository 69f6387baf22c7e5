"""Data parallelism.

The counterpart of ``pipegoose_tpu/nn/data_parallel/data_parallel.py``: the
batch is split over the ``data`` axis, each rank computes the gradients of
its part, and :func:`average_gradients` takes their mean over the axis.
Expert parameters, flagged by a policy table, average over
``expert_axis`` instead (or stay local without one). ``grad_comm`` "bf16"
or "int8" runs the mean over the data axis as a compressed all-reduce
(``distributed.compressed``); expert gradients always sync in float32.
"""
from __future__ import annotations

from typing import Any, Optional

from pipegoose_tpu_torch.distributed.compressed import (
    check_grad_comm,
    compressed_all_reduce_mean,
)
from pipegoose_tpu_torch.distributed.functional import all_reduce
from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.nn.parallel import (
    Parallel,
    path_str,
    shard_tree,
    spec_tree,
    tree_map_with_path,
)
from pipegoose_tpu_torch.nn.parallel_mapping import ParallelMapping


def average_gradients(grads: Any, axis_name: Optional[str] = "data",
                      expert_mapping: Optional[ParallelMapping] = None,
                      expert_axis: Optional[str] = None,
                      grad_comm: str = "fp32") -> Any:
    """The mean of a gradient tree over the data axis. Leaves that
    ``expert_mapping`` marks ``expert`` average over ``expert_axis``
    instead; ``expert_axis=None`` leaves them local. ``grad_comm``: the
    wire precision of the data-axis mean, "fp32" (the plain mean), "bf16"
    or "int8" (a compressed all-reduce); expert gradients always sync in
    float32 (they are few and routing-sensitive)."""
    if axis_name is None:
        return grads
    mode = check_grad_comm(grad_comm)

    def avg(path, g):
        if expert_mapping is not None and expert_mapping.is_expert(path_str(path)):
            return g if expert_axis is None else all_reduce(g, expert_axis, "mean")
        if mode == "fp32":
            return all_reduce(g, axis_name, "mean")
        return compressed_all_reduce_mean(g, axis_name, mode)[0]

    return tree_map_with_path(avg, grads)


class DataParallel(Parallel):
    """``parallelize`` keeps every leaf whole (replicas are identical); the
    work is :meth:`average_gradients` in the train step and the batch split
    of :meth:`batch_spec`."""

    def __init__(self, parallel_context: Optional[ParallelContext] = None,
                 axis_name: str = "data"):
        super().__init__(parallel_context)
        self.axis_name = axis_name

    def parallelize(self, params: Any):
        specs = spec_tree(params, lambda _p, _x: ())
        return shard_tree(params, specs, self.parallel_context), specs

    def batch_spec(self) -> tuple:
        return (self.axis_name,)

    def average_gradients(self, grads: Any, **kw) -> Any:
        return average_gradients(grads, self.axis_name, **kw)
