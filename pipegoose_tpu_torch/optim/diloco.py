"""DiLoCo: distributed low-communication training (the outer and inner loop).

The counterpart of ``pipegoose_tpu/optim/diloco.py``. W workers each run
local steps with no cross-worker traffic; every ``sync_every`` steps an
outer optimizer (SGD with Nesterov momentum) moves the shared anchor by the
averaged worker delta, and the workers restart from it:

    outer_grad = anchor - mean_w(worker_params)
    anchor     = outer_opt(anchor, outer_grad)
    workers    = anchor

The workers are the ranks of one axis of the ``ParallelContext``: "data"
for :class:`DiLoCo`, the outermost "diloco" axis for :class:`DiLoCoHybrid`,
whose workers each run the whole hybrid step (tensor, expert, pipeline
parallel, ZeRO-1 over "data") inside their own block of ranks. The sync
step is ONE all-reduce over the worker group, of every worker leaf
flattened into one buffer per dtype; the inner optimizer's state persists
across rounds.

Where this parts from the JAX package (ROADMAP.md § C): a JAX worker array
carries a leading W dim sharded over the worker axis; here each rank holds
its own worker's tensors, with no leading dim (as ZeRO's shards are each
rank's own). Optimizers are factories over a list of tensors, as
``optim.zero.adam`` is: the inner state is a ``torch.optim.Optimizer`` (or
the ZeRO-1 ``ZeroState``), the outer state the ``torch.optim.SGD`` that holds
the anchor's tensors and their momentum.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional

import torch

from pipegoose_tpu_torch.distributed.functional import all_reduce
from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.nn.parallel import tree_leaves, tree_map


def outer_optimizer(lr: float = 0.7, momentum: float = 0.9
                    ) -> Callable[[List[torch.Tensor]], torch.optim.Optimizer]:
    """The DiLoCo paper's outer optimizer, SGD with Nesterov momentum, as a
    factory over a list of tensors: step for step ``optax.sgd(lr, momentum,
    nesterov=True)`` (trace = g + m trace, update = -lr (g + m trace))."""
    return functools.partial(torch.optim.SGD, lr=lr, momentum=momentum, nesterov=True)


def _context(ctx: Optional[ParallelContext]) -> ParallelContext:
    ctx = ctx or ParallelContext.get_context()
    if ctx is None:
        raise ValueError("no ParallelContext; construct one first")
    return ctx


def _worker_copy(params: Any) -> Any:
    """The worker's own tensors: a copy of the anchor with storage of its
    own, leaf for leaf."""
    return tree_map(lambda p: p.detach().clone(), params)


@torch.no_grad()
def _mean_over_workers(leaves: List[torch.Tensor], axis: str) -> List[torch.Tensor]:
    """Every leaf averaged over the worker axis in ONE all-reduce per dtype
    (one in practice): the leaves flattened into one buffer, reduced, and
    cut back."""
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for dtype in dict.fromkeys(t.dtype for t in leaves):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        flat = all_reduce(torch.cat([leaves[i].reshape(-1) for i in idx]), axis, "mean")
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return out


@torch.no_grad()
def _sync(anchor: Any, worker_params: Any, outer_state: torch.optim.Optimizer,
          axis: str):
    """The outer step: the workers' mean, the outer gradient ``anchor -
    mean`` in the anchor's dtype, the outer optimizer's step on the anchor
    (in place), and every worker reset to the new anchor (in place)."""
    a_leaves, w_leaves = tree_leaves(anchor), tree_leaves(worker_params)
    held = outer_state.param_groups[0]["params"]
    if len(held) != len(a_leaves) or any(h is not a for h, a in zip(held, a_leaves)):
        raise ValueError("the anchor is not the tree the outer state was built over "
                         "(pass init's params as the anchor)")
    for a, m in zip(a_leaves, _mean_over_workers(w_leaves, axis)):
        a.grad = (a - m).to(a.dtype)
    outer_state.step()
    for a, w in zip(a_leaves, w_leaves):
        a.grad = None
        w.copy_(a)
    return anchor, worker_params, outer_state


class DiLoCo:
    """DiLoCo over a plain inner optimizer, the workers on ``worker_axis``
    ("data"): each rank is one worker and trains on its part of the batch
    (dim 0 cut over the axis) with no collective but the loss metric's.

    ``init(params) -> (worker_params, inner_state, outer_state)``: the
    workers start as a copy of ``params``, which is the anchor (the outer
    optimizer holds its tensors: pass the same tree to the sync step).
    ``make_inner_step(worker_params)(worker_params, inner_state, batch) ->
    (worker_params, inner_state, loss)``, the loss averaged over the workers
    (a global mean); ``make_sync_step(params)(anchor, worker_params,
    outer_state) -> (anchor, worker_params, outer_state)``, every tensor
    updated in place."""

    def __init__(self, loss_fn: Callable[[Any, Any], torch.Tensor],
                 inner_opt: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                 outer_opt: Optional[Callable] = None, sync_every: int = 8,
                 worker_axis: str = "data",
                 parallel_context: Optional[ParallelContext] = None):
        self.loss_fn = loss_fn
        self.inner_opt = inner_opt
        self.outer_opt = outer_opt or outer_optimizer()
        self.sync_every = sync_every
        self.axis = worker_axis
        self.ctx = _context(parallel_context)

    def init(self, params: Any):
        wp = _worker_copy(params)
        return wp, self.inner_opt(tree_leaves(wp)), self.outer_opt(tree_leaves(params))

    def make_inner_step(self, worker_params: Any):
        from pipegoose_tpu_torch.parallel.hybrid import _local_batch

        leaves = tree_leaves(worker_params)
        for p in leaves:
            p.requires_grad_(True)
        device = leaves[0].device

        def step(wp, inner_state, batch):
            for p in tree_leaves(wp):
                p.grad = None
            loss = self.loss_fn(wp, _local_batch(batch, (self.axis,), self.ctx, device))
            loss.backward()
            inner_state.step()
            return wp, inner_state, all_reduce(loss.detach(), self.axis, "mean")

        return step

    def make_sync_step(self, params: Any):
        return lambda anchor, wp, outer_state: _sync(anchor, wp, outer_state, self.axis)


class DiLoCoHybrid:
    """DiLoCo around the FULL hybrid train step: the workers live on the
    outermost "diloco" axis (``ParallelContext(diloco_parallel_size=W)``),
    and inside each worker the loss runs with any tensor / expert / pipe
    axis and the inner optimizer is the ZeRO-1 ``DistributedOptimizer``
    sharding its state over "data" (``parallel.make_hybrid_train_step``,
    whose collectives never leave the worker's block of ranks).

    Communication: parameters, gradients and optimizer state never cross
    workers until the sync step's one all-reduce. With ``metric_pmean=True``
    (the default) the inner step also averages the scalar loss over the
    workers, one scalar all-reduce a step; with False the inner step makes
    no collective over the worker axis and returns this worker's loss as a
    (1,) tensor (its entry of the JAX package's (W,) vector).

    ``batch_spec`` (default ``((worker_axis, "data"),)``: dim 0 over the
    workers and, inside each, over "data"), ``loss_axis``,
    ``grad_sync_axes`` and ``with_rng`` are the hybrid step's. The API is
    :class:`DiLoCo`'s, the inner step taking ``(worker_params, inner_state,
    batch[, rng])``; ``param_specs`` are this rank's shards' specs, the
    anchor and the workers hold this rank's shards."""

    def __init__(self, loss_fn: Callable[..., torch.Tensor], param_specs: Any,
                 inner_opt, outer_opt: Optional[Callable] = None, sync_every: int = 8,
                 worker_axis: str = "diloco",
                 parallel_context: Optional[ParallelContext] = None,
                 batch_spec: Optional[tuple] = None, loss_axis=("data",),
                 grad_sync_axes: tuple = (), with_rng: bool = False,
                 metric_pmean: bool = True):
        from pipegoose_tpu_torch.parallel.hybrid import make_hybrid_train_step

        self.outer_opt = outer_opt or outer_optimizer()
        self.sync_every = sync_every
        self.axis = worker_axis
        self.ctx = _context(parallel_context)
        self.metric_pmean = metric_pmean
        self._init_fn, self._make_step = make_hybrid_train_step(
            loss_fn, param_specs, inner_opt, self.ctx,
            batch_spec=batch_spec if batch_spec is not None else ((worker_axis, "data"),),
            loss_axis=loss_axis, grad_sync_axes=grad_sync_axes, with_rng=with_rng)

    def init(self, params: Any):
        """(worker_params, inner_state, outer_state): the worker starts as a
        copy of ``params`` (the anchor), the ZeRO-1 state over its shards,
        the outer optimizer over the anchor's tensors."""
        wp = _worker_copy(params)
        return wp, self._init_fn(wp), self.outer_opt(tree_leaves(params))

    def make_inner_step(self, worker_params: Any):
        """The hybrid step on this worker, then the loss metric (see the
        class docstring)."""
        hybrid = self._make_step(worker_params)

        def step(wp, inner_state, batch, *rng):
            wp, inner_state, loss = hybrid(wp, inner_state, batch, *rng)
            if self.metric_pmean:
                return wp, inner_state, all_reduce(loss, self.axis, "mean")
            return wp, inner_state, loss[None]

        return step

    def make_sync_step(self, params: Any):
        return lambda anchor, wp, outer_state: _sync(anchor, wp, outer_state, self.axis)


__all__ = ["outer_optimizer", "DiLoCo", "DiLoCoHybrid"]
