"""Hybrid-parallel train-step composition: tensor x data parallelism with a
ZeRO-1 optimizer, gradient accumulation, and the gradient sync of the
sequence-parallel step.

The counterpart of ``pipegoose_tpu/parallel/hybrid.py``. A spec is a tuple
with one entry per dimension of a parameter: an axis name, a tuple of axis
names, or None (the JAX ``PartitionSpec``). Where the JAX package compiles
one ``shard_map`` program over the mesh, here every rank runs the step in
its own process over the current ``ParallelContext``: the loss and its
backward tensor-parallel (``tp_axis`` collectives inside the loss), this
rank's part of the batch, the replicated-gradient sync, and the ZeRO-1
optimizer's reduce-scatter, inner update and all-gather.

``grad_comm`` sets the gradient reduction's wire precision
(``distributed.compressed``): inside the ZeRO-1 optimizer, or with an
unsharded optimizer as a compressed mean all-reduce over the loss axes.
``overlap_tp`` declares that the loss runs the ring collective-matmul path
(``BloomConfig.overlap_tp``), whose gradients need no other sync. Each
built step exports the comm engine's configuration to the telemetry
registry when it is enabled (``comm.overlap_enabled``,
``comm.bytes_saved``, ``comm.grad_wire_bits``). Not ported yet: the
in-graph health statistics (``with_health``, ROADMAP.md queue A, item
A13b), which raise.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from pipegoose_tpu_torch.core.accumulation import _map_batch, make_accumulating_loss
from pipegoose_tpu_torch.distributed.compressed import (
    check_grad_comm,
    compressed_all_reduce_mean,
)
from pipegoose_tpu_torch.distributed.functional import all_reduce
from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.nn.parallel import shard_leaf, tree_leaves, tree_map
from pipegoose_tpu_torch.optim.zero import (
    DistributedOptimizer,
    ZeroState,
    ef_state_specs,
    state_specs,
)


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


def zero_state_spec(optimizer: DistributedOptimizer, params: Any, param_specs: Any) -> Any:
    """The spec tree of the ZeRO-1 state's per-parameter moments
    (``optim.zero.state_specs``; the JAX function also takes the mesh, to
    shape the state's shards, which the port's specs do not need). With
    error feedback, ``{"inner": that tree, "ef": the residuals' specs}``
    (``optim.zero.ef_state_specs``)."""
    inner = state_specs(params, param_specs, optimizer.axis_name or "data")
    if not (optimizer.error_feedback and optimizer.axis_name):
        return inner
    return {"inner": inner,
            "ef": ef_state_specs(params, param_specs, optimizer.axis_name)}


def parallel_context_sizes(candidate: Any) -> dict:
    """``ParallelContext`` sizes of a planner candidate (anything with
    ``dp``/``tp``/``pp``/``ep`` attributes)."""
    return dict(
        tensor_parallel_size=int(getattr(candidate, "tp", 1)),
        pipeline_parallel_size=int(getattr(candidate, "pp", 1)),
        data_parallel_size=int(getattr(candidate, "dp", 1)),
        expert_parallel_size=int(getattr(candidate, "ep", 1)),
    )


def hybrid_step_kwargs(candidate: Any) -> dict:
    """:func:`make_hybrid_train_step` options of a planner candidate: the
    gradient wire precision, the overlap flag, and for a pipelined
    candidate the ``("pipe",)`` gradient sum."""
    kw: dict = dict(grad_comm=getattr(candidate, "grad_comm", None),
                    overlap_tp=bool(getattr(candidate, "overlap_tp", False)))
    if int(getattr(candidate, "pp", 1)) > 1:
        kw["grad_sync_axes"] = ("pipe",)
    return kw


def hybrid_build_config(loss_fn: Callable, param_specs: Any,
                        optimizer: DistributedOptimizer, batch_spec: tuple = ("data",),
                        loss_axis: Any = "data", grad_sync_axes: tuple = (),
                        with_rng: bool = False, n_accum: int = 1,
                        with_health: bool = False, grad_comm: Optional[str] = None,
                        overlap_tp: bool = False) -> dict:
    """Everything :func:`make_hybrid_train_step` takes but the context: what
    :func:`build_hybrid_train_step` rebuilds the step from on a new one."""
    return dict(loss_fn=loss_fn, param_specs=param_specs, optimizer=optimizer,
                batch_spec=batch_spec, loss_axis=loss_axis,
                grad_sync_axes=grad_sync_axes, with_rng=with_rng, n_accum=n_accum,
                with_health=with_health, grad_comm=grad_comm, overlap_tp=overlap_tp)


def build_hybrid_train_step(config: dict, parallel_context: ParallelContext):
    """(init_fn, make_step) of a stored :func:`hybrid_build_config` on
    ``parallel_context``."""
    cfg = dict(config)
    return make_hybrid_train_step(cfg.pop("loss_fn"), cfg.pop("param_specs"),
                                  cfg.pop("optimizer"), parallel_context, **cfg)


def _compressed_sync(axes: tuple, mode: str):
    """The compressed counterpart of ``sync_replicated_grads`` with (axis,
    "mean") for each of ``axes``: a leaf SHARDED over an axis holds its own
    gradient there and is left alone."""
    def sync(g, spec):
        for ax in axes:
            if not spec_mentions(spec, ax):
                g = compressed_all_reduce_mean(g, ax, mode)[0]
        return g

    return sync


def _grad_of(p: torch.Tensor) -> torch.Tensor:
    return p.grad if p.grad is not None else torch.zeros_like(p)


def _local_batch(batch: Any, batch_spec: Any, ctx: ParallelContext, device) -> Any:
    """This rank's part of the global batch (numpy arrays or tensors, in
    dicts, lists and tuples) by ``batch_spec`` (one spec for every leaf, or
    a dict of specs by the batch's keys), as tensors on ``device``; integer
    leaves as int64."""
    if isinstance(batch_spec, dict):
        return {k: _local_batch(v, batch_spec[k], ctx, device) for k, v in batch.items()}

    def local(x):
        if isinstance(x, np.ndarray):
            if x.dtype.kind == "u":   # a token file's uint32 ids
                x = x.astype(np.int64)
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = shard_leaf(x, batch_spec, ctx).to(device)
        return x.long() if not (x.is_floating_point() or x.dtype == torch.bool) else x

    return _map_batch(local, batch)


def _global_shape(p, spec, ctx) -> tuple:
    """The unsharded shape of this rank's shard ``p`` under ``spec``."""
    shape = list(p.shape)
    for dim, entry in enumerate(spec or ()):
        for ax in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if ax is not None:
                shape[dim] *= ctx.axis_size(ax)
    return tuple(shape)


def _set_comm_gauges(params, param_specs, ctx, optimizer, comm_mode: str,
                     overlap_tp: bool, dp_axis: str) -> None:
    """Export the comm engine's configuration and savings beside the MFU
    gauges: ``comm.overlap_enabled`` (0/1), and for a compressed gradient
    reduction the analytic per-step ``comm.bytes_saved`` of the whole
    (unsharded) tree, as the JAX step counts its global arrays
    (``distributed.compressed.grad_comm_bytes_saved``). One registry
    branch when telemetry is disabled."""
    from pipegoose_tpu_torch.telemetry.registry import get_registry

    reg = get_registry()
    if not reg.enabled:
        return
    reg.gauge(
        "comm.overlap_enabled",
        help="1 when the TP ring collective-matmul overlap path is on",
    ).set(1.0 if overlap_tp else 0.0)
    ax = getattr(optimizer, "axis_name", None) or dp_axis
    n = ctx.axis_size(ax) if ax in ctx.sizes else 1
    # always write all three (the last build wins): an fp32 build after a
    # quantized one must not leave stale savings on the exporters
    saved = 0.0
    if comm_mode != "fp32" and n > 1:
        from pipegoose_tpu_torch.distributed.compressed import grad_comm_bytes_saved

        whole = tree_map(lambda p, spec: torch.empty(_global_shape(p, spec, ctx),
                                                     device="meta"),
                         params, param_specs)
        saved = float(grad_comm_bytes_saved(whole, n, comm_mode))
    reg.gauge(
        "comm.bytes_saved",
        help="analytic per-step gradient-reduction wire bytes saved "
             "vs fp32 by grad_comm compression",
    ).set(saved)
    reg.gauge("comm.grad_wire_bits").set(
        {"fp32": 32.0, "bf16": 16.0, "int8": 8.0}[comm_mode])


def make_hybrid_train_step(loss_fn: Callable[..., torch.Tensor], param_specs: Any,
                           optimizer: DistributedOptimizer,
                           parallel_context: Optional[ParallelContext] = None,
                           batch_spec: tuple = ("data",), loss_axis: Any = "data",
                           grad_sync_axes: tuple = (), with_rng: bool = False,
                           n_accum: int = 1, with_health: bool = False,
                           grad_comm: Optional[str] = None, overlap_tp: bool = False):
    """(init_fn, make_step) of the hybrid train step on this rank.

    - ``loss_fn(params, batch) -> scalar`` runs on this rank's shards of the
      parameters and of the batch (use ``tp_axis="tensor"`` inside it);
    - ``param_specs``: the spec tree of the parameters (``bloom.tp_specs``);
    - ``optimizer``: the ZeRO-1 ``DistributedOptimizer``, its state sharded
      over its data axis.

    ``init_fn(params)`` gives the optimizer state; ``make_step(params)``
    marks every leaf as requiring grad and returns ``step(params,
    opt_state, batch) -> (params, opt_state, loss)``. ``batch`` is the
    GLOBAL batch, the same on every rank: the step keeps this rank's part
    by ``batch_spec`` (dim 0 over the data axis by default) and moves it to
    the parameters' device. It runs the loss and its backward, sums or
    averages the gradients of replicated parameters over
    ``grad_sync_axes`` (``sync_replicated_grads``), takes the ZeRO step
    (parameters updated in place), and returns the loss averaged over the
    loss axes, detached.

    ``with_rng=True``: ``loss_fn(params, batch, rng)`` and ``step(params,
    opt_state, batch, rng)``, rng an integer seed. ``n_accum > 1``: this
    rank's batch runs as ``n_accum`` microbatches, one forward and backward
    at a time (``core.accumulation.make_accumulating_loss``)."""
    if with_health:
        raise NotImplementedError(
            "with_health=True: the in-graph health statistics are not ported yet "
            "(ROADMAP.md queue A, item 13, its half A13b)")
    ctx = parallel_context or ParallelContext.get_context()
    if ctx is None:
        raise ValueError("no ParallelContext; construct one first")
    if grad_comm is not None and grad_comm != optimizer.grad_comm:
        optimizer = optimizer.replace(grad_comm=check_grad_comm(grad_comm))
    comm_mode = optimizer.grad_comm
    loss_axes = loss_axis if isinstance(loss_axis, tuple) else (loss_axis,)
    # no ZeRO axis to fold the compression into: a compressed mean
    # all-reduce runs on the gradients instead, over every loss axis
    plain_dp_comm = comm_mode != "fp32" and optimizer.axis_name is None
    if plain_dp_comm:
        for entry in grad_sync_axes:
            ax, op = entry if isinstance(entry, tuple) else (entry, "sum")
            if ax in loss_axes and op == "mean":
                raise ValueError(
                    f"grad_comm={comm_mode!r} with an unsharded optimizer already "
                    f"mean-syncs grads over {loss_axes}; drop ({ax!r}, 'mean') from "
                    f"grad_sync_axes")
    accumulating = make_accumulating_loss(loss_fn, n_accum) if n_accum > 1 else None

    def init_fn(params) -> ZeroState:
        return optimizer.init(params)

    def make_step(params):
        _set_comm_gauges(params, param_specs, ctx, optimizer, comm_mode, overlap_tp,
                         loss_axes[0])
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        device = leaves[0].device

        def step(params, opt_state, batch, *rng):
            if len(rng) != int(with_rng):
                raise TypeError(f"the step takes {'an' if with_rng else 'no'} rng argument "
                                f"(with_rng={with_rng})")
            leaves = tree_leaves(params)
            for p in leaves:
                p.grad = None
            local = _local_batch(batch, batch_spec, ctx, device)
            if accumulating is not None:
                loss = accumulating(params, local, *rng)
            else:
                loss = loss_fn(params, local, *rng)
                loss.backward()
            if grad_sync_axes or plain_dp_comm:
                grads = tree_map(_grad_of, params)
                if grad_sync_axes:
                    grads = sync_replicated_grads(grads, param_specs, grad_sync_axes)
                if plain_dp_comm:
                    grads = _map(_compressed_sync(loss_axes, comm_mode), grads,
                                 param_specs)
            else:
                grads = [_grad_of(p) for p in leaves]
            params, opt_state = optimizer.step(grads, opt_state, params)
            loss = loss.detach()
            for ax in loss_axes:
                loss = all_reduce(loss, ax, "mean")
            return params, opt_state, loss

        return step

    return init_fn, make_step
