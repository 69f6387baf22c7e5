"""Parameter trees and their sharding over a ``ParallelContext``.

The counterpart of ``pipegoose_tpu/nn/parallel.py``. A tree is nested dicts
and lists whose leaves are tensors (or numpy arrays); a spec tree mirrors
it with one spec per leaf (``nn.parallel_mapping``). The JAX package hands
a spec to ``device_put`` and lets XLA slice; here each rank is one process,
so :func:`shard_tree` keeps this rank's slice of every leaf and
:func:`unshard_tree` all-gathers the slices back.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.distributed.parallel_mode import ParallelMode


def path_str(path) -> str:
    """'/'-joined readable parameter path of a tuple of keys and indices."""
    return "/".join(str(k) for k in path)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *other_leaves)`` over a tree of dicts and lists, the other
    trees walked in step (a spec tree's tuples are its leaves)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, _path=()) -> Any:
    """``fn(path, leaf, *other_leaves)``, ``path`` a tuple of keys."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), _path=_path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest), _path=_path + (i,))
                for i, v in enumerate(tree)]
    return fn(_path, tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts and lists, in a fixed order."""
    out = []
    tree_map(out.append, tree)
    return out


def spec_tree(params: Any, spec_fn: Callable[[str, Any], tuple]) -> Any:
    """Every leaf to its spec through ``spec_fn(path, leaf)``."""
    return tree_map_with_path(lambda p, x: spec_fn(path_str(p), x), params)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _context(ctx: Optional[ParallelContext]) -> ParallelContext:
    ctx = ctx or ParallelContext.get_context()
    if ctx is None:
        raise ValueError("no ParallelContext; construct one first")
    return ctx


def shard_leaf(x, spec: tuple, ctx: Optional[ParallelContext] = None):
    """This rank's slice of one leaf (a tensor or a numpy array) under
    ``spec``: each sharded dimension is cut into as many even chunks as the
    product of its axes' sizes, the first axis of a tuple the major one.
    The result owns its storage."""
    ctx = _context(ctx)
    for dim, entry in enumerate(spec):
        idx, n = 0, 1
        for ax in _axes(entry):
            size = ctx.axis_size(ax)
            idx = idx * size + ctx.get_local_rank(ParallelMode(ax))
            n *= size
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(x.shape)} does not divide "
                             f"over {n} ranks of {entry!r}")
        chunk = x.shape[dim] // n
        x = (x.narrow(dim, idx * chunk, chunk) if isinstance(x, torch.Tensor)
             else np.take(x, np.arange(idx * chunk, (idx + 1) * chunk), axis=dim))
    return x.clone().contiguous() if isinstance(x, torch.Tensor) else np.ascontiguousarray(x)


def shard_tree(params: Any, specs: Any, ctx: Optional[ParallelContext] = None) -> Any:
    """This rank's slice of every leaf (:func:`shard_leaf`)."""
    ctx = _context(ctx)
    return tree_map(lambda x, s: shard_leaf(x, s, ctx), params, specs)


@torch.no_grad()
def unshard_leaf(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole leaf from every rank's slice: an all-gather along each
    sharded dimension, over the innermost axis of a tuple first."""
    from pipegoose_tpu_torch.distributed.functional import all_gather

    x = x.detach()
    for dim, entry in enumerate(spec):
        for ax in reversed(_axes(entry)):
            x = all_gather(x, ax, dim=dim)
    return x


def unshard_tree(params: Any, specs: Any, ctx: Optional[ParallelContext] = None) -> Any:
    """Every leaf gathered whole on every rank (the JAX ``unshard_tree``
    replicates through ``device_put``; here the specs say what to gather)."""
    _context(ctx)
    return tree_map(unshard_leaf, params, specs)


class Parallel:
    """Base of the parallelization wrappers (``TensorParallel``,
    ``DataParallel``): ``parallelize`` returns (this rank's params, specs)."""

    def __init__(self, parallel_context: Optional[ParallelContext] = None):
        self.parallel_context = parallel_context or ParallelContext.get_context()
        if self.parallel_context is None:
            raise ValueError("no ParallelContext; construct one first")

    def parallelize(self, params: Any):
        raise NotImplementedError

    def deparallelize(self, params: Any, specs: Any):
        return unshard_tree(params, specs, self.parallel_context)
