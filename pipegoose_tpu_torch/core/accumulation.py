"""Gradient accumulation over K microbatches.

The counterpart of ``pipegoose_tpu/core/accumulation.py``. The JAX package
scans the microbatches inside one compiled step, with each microbatch
rematerialized so that peak activation memory is one microbatch's. In
PyTorch the same bound comes from running forward and backward one
microbatch at a time, each loss scaled by 1/K, into the parameters'
``.grad``: autograd over K stacked losses would keep all K graphs alive.
So the functions here run the backward themselves, but
:func:`make_accumulated_loss`, the loss alone that an evaluation runs.

Microbatch i of a batch is rows ``[i B/K, (i + 1) B/K)`` of every leaf, as
the JAX ``microbatch.split`` reshape gives them. With an rng argument each
microbatch gets ``fold_in(rng, i)``, an integer seed: it differs from
``jax.random.fold_in``, whose draws cannot be matched anyway (ROADMAP.md
§ C).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from pipegoose_tpu_torch.nn.parallel import tree_leaves, tree_map


def _map_batch(fn: Callable, batch: Any) -> Any:
    if isinstance(batch, dict):
        return {k: _map_batch(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map_batch(fn, v) for v in batch)
    return None if batch is None else fn(batch)


def split(batch: Any, n_microbatches: int) -> list:
    """``n_microbatches`` batches, each a contiguous run of rows of every
    leaf (dim 0 must divide)."""
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {n_microbatches}")

    def check(x):
        if x.shape[0] % n_microbatches:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             f"n_microbatches={n_microbatches}")
        return x

    _map_batch(check, batch)
    return [_map_batch(lambda x, i=i: x[i * (x.shape[0] // n_microbatches):
                                       (i + 1) * (x.shape[0] // n_microbatches)], batch)
            for i in range(n_microbatches)]


def fold_in(seed: int, i: int) -> int:
    """A microbatch's seed from the step's: a fixed mix of the two."""
    return (int(seed) * 1_000_003 + int(i) + 1) % (2 ** 63)


def accumulate_gradients(loss_fn: Callable[[Any, Any], torch.Tensor], params: Any,
                         microbatches: Any, mean: bool = True):
    """(mean loss, accumulated gradient tree) over K microbatches: a tree
    whose leaves have a leading dim K, microbatch i being ``leaf[i]``, as
    the JAX function takes them. Forward and backward run one microbatch
    at a time into the leaves' ``.grad`` (set to None first; every leaf
    must require grad), each loss scaled by 1/K with ``mean``. The loss
    comes back detached."""
    firsts = []
    _map_batch(firsts.append, microbatches)
    k = firsts[0].shape[0]
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
    total = None
    for i in range(k):
        loss = loss_fn(params, _map_batch(lambda x: x[i], microbatches))
        (loss / k if mean else loss).backward()
        total = loss.detach() if total is None else total + loss.detach()
    grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                     params)
    return (total / k if mean else total), grads


def make_accumulating_loss(loss_fn: Callable[..., torch.Tensor],
                           n_accum: int) -> Callable[..., torch.Tensor]:
    """``loss_fn(params, batch[, rng])`` as one that splits its batch into
    ``n_accum`` microbatches, runs each one's forward and backward (loss /
    n_accum) into ``.grad``, and returns the mean loss, detached: the
    caller must not call ``backward`` on it. An rng argument reaches
    microbatch i as ``fold_in(rng, i)``.

    As in the JAX function, microbatch losses are averaged with EQUAL
    weight: for masked losses whose microbatches hold different numbers of
    valid tokens this differs from the one-shot token-weighted mean."""
    def wrapped(params, batch, *rng):
        total = None
        for i, mb in enumerate(split(batch, n_accum)):
            extra = (fold_in(rng[0], i),) if rng else ()
            loss = loss_fn(params, mb, *extra)
            (loss / n_accum).backward()
            total = loss.detach() if total is None else total + loss.detach()
        return total / n_accum

    return wrapped


def make_accumulated_loss(loss_fn: Callable[..., torch.Tensor],
                          n_accum: int) -> Callable[..., torch.Tensor]:
    """The loss alone of :func:`make_accumulating_loss`: the equal-weight
    mean of ``loss_fn`` over ``n_accum`` microbatches, with no backward
    (what an evaluation runs, under ``torch.no_grad()``). An rng argument
    reaches microbatch i as ``fold_in(rng, i)``."""
    def wrapped(params, batch, *rng):
        total = None
        for i, mb in enumerate(split(batch, n_accum)):
            extra = (fold_in(rng[0], i),) if rng else ()
            loss = loss_fn(params, mb, *extra)
            total = loss if total is None else total + loss
        return total / n_accum

    return wrapped
