"""Data parallelism.

The counterpart of ``pipegoose_tpu/nn/data_parallel/data_parallel.py``: the
batch is split over the ``data`` axis, each rank computes the gradients of
its part, and :func:`average_gradients` takes their mean over the axis.
Expert parameters, flagged by a policy table, average over
``expert_axis`` instead (or stay local without one). Only the float32
reduction is ported: a compressed ``grad_comm`` is ROADMAP.md queue A,
item 6, and raises.
"""
from __future__ import annotations

from typing import Any, Optional

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


def _check_grad_comm(grad_comm: str) -> None:
    if grad_comm != "fp32":
        raise NotImplementedError(
            f"grad_comm={grad_comm!r}: the compressed gradient reduction is not "
            f"ported yet (ROADMAP.md queue A, item 6); only 'fp32' runs")


def average_gradients(grads: Any, axis_name: Optional[str] = "data",
                      expert_mapping: Optional[ParallelMapping] = None,
                      expert_axis: Optional[str] = None,
                      grad_comm: str = "fp32") -> Any:
    """The mean of a gradient tree over the data axis. Leaves that
    ``expert_mapping`` marks ``expert`` average over ``expert_axis``
    instead; ``expert_axis=None`` leaves them local."""
    _check_grad_comm(grad_comm)
    if axis_name is None:
        return grads

    def avg(path, g):
        if expert_mapping is not None and expert_mapping.is_expert(path_str(path)):
            return g if expert_axis is None else all_reduce(g, expert_axis, "mean")
        return all_reduce(g, axis_name, "mean")

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
