"""Collectives over a named parallel axis, with their gradients.

The counterpart of ``pipegoose_tpu/distributed/functional.py``, with the
same signatures. ``axis_name`` resolves through the current
``ParallelContext`` to that axis's process group; ``axis_name=None`` is
the single-device no-op, and so is an axis of size 1 (the JAX collectives
are the identity there too). Each collective is a
``torch.autograd.Function`` whose backward is the JAX AD of the same
operation: a ``ppermute`` backs off with the inverse permutation (a
``shift_right`` with a ``shift_left``), ``all_to_all`` with split and
concat swapped, ``all_gather`` with ``reduce_scatter`` and the reverse,
``psum`` with ``psum``; the Megatron f/g operators follow their
``custom_vjp``s. The point-to-point transfers go through
``batch_isend_irecv``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from pipegoose_tpu_torch._device import true_div
from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.distributed.parallel_mode import ParallelMode

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN, "mean": dist.ReduceOp.SUM}


def _context(axis_name: str) -> ParallelContext:
    ctx = ParallelContext.get_context()
    if ctx is None:
        raise RuntimeError(f"axis_name={axis_name!r} needs a ParallelContext; "
                           f"pass axis_name=None on a single device")
    return ctx


def axis_size(axis_name: Optional[str]) -> int:
    """Ranks along the axis (``lax.axis_size``); 1 for None."""
    return 1 if axis_name is None else _context(axis_name).axis_size(axis_name)


def axis_index(axis_name: Optional[str]) -> int:
    """This rank's coordinate on the axis (``lax.axis_index``); 0 for None."""
    if axis_name is None:
        return 0
    return _context(axis_name).get_local_rank(ParallelMode(axis_name))


def _group(axis_name: Optional[str]):
    """The axis's process group, or None where the collective is a no-op."""
    if axis_name is None:
        return None
    return _context(axis_name).group(axis_name)


class _Collective(torch.autograd.Function):
    """A linear collective ``fwd`` over a tuple of tensors with its adjoint
    ``bwd``, both mapping a tuple of tensors to a tuple of tensors."""

    @staticmethod
    def forward(ctx, fwd: Callable, bwd: Callable, *xs):
        ctx.bwd = bwd
        return tuple(fwd(*xs))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.bwd(*(g.contiguous() for g in grads)))


def _apply(fwd, bwd, *xs):
    return _Collective.apply(fwd, bwd, *xs)


# -- the raw collectives (no autograd), over a group of size > 1 ---------------

def _all_reduce_raw(x, group, op):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=_REDUCE_OPS[op], group=group)
    if op == "mean":
        y = true_div(y, dist.get_world_size(group))
    return y


def _all_gather_raw(x, group, dim):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _chunks(x, n, dim):
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} not divisible by {n}")
    return [c.contiguous() for c in x.chunk(n, dim)]


def _reduce_scatter_raw(x, group, dim):
    chunks = _chunks(x, dist.get_world_size(group), dim)
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def _all_to_all_raw(x, group, split_dim, concat_dim):
    chunks = _chunks(x, dist.get_world_size(group), split_dim)
    outs = [torch.empty_like(c) for c in chunks]
    dist.all_to_all(outs, chunks, group=group)
    return torch.cat(outs, concat_dim)


def _ppermute_raw(xs, axis_name, perm):
    """Each tensor of ``xs`` from this rank to its destination under
    ``perm`` ((src, dst) pairs of axis coordinates), in one batch of
    point-to-point ops; a rank that no pair sends to receives zeros."""
    ctx = _context(axis_name)
    mode = ParallelMode(axis_name)
    me, ranks = ctx.get_local_rank(mode), ctx.get_ranks_in_group(mode)
    group = ctx.group(axis_name)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    xs = [x.contiguous() for x in xs]
    outs = [x.clone() if src == [me] else torch.zeros_like(x) for x in xs]
    ops = []
    for x, out in zip(xs, outs):
        ops += [dist.P2POp(dist.isend, x, ranks[d], group) for d in dst if d != me]
        ops += [dist.P2POp(dist.irecv, out, ranks[s], group) for s in src if s != me]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return outs


def _no_grad(op):
    def bwd(*_):
        raise NotImplementedError(f"all_reduce op={op!r} has no gradient")
    return bwd


# -- plain collectives -----------------------------------------------------------

def all_reduce(x, axis_name: Optional[str], op: str = "sum"):
    """Sum, max, min or mean over the axis (``psum``/``pmax``/``pmin``/
    ``pmean``); the backward of sum and mean is the same reduction."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op: {op}")
    group = _group(axis_name)
    if group is None:
        return x
    bwd = ((lambda g: (_all_reduce_raw(g, group, op),)) if op in ("sum", "mean")
           else _no_grad(op))
    return _apply(lambda t: (_all_reduce_raw(t, group, op),), bwd, x)[0]


def all_gather(x, axis_name: Optional[str], dim: int = -1):
    """Concatenate the ranks' tensors along ``dim`` in axis order (tiled
    ``all_gather``); backward: ``reduce_scatter``."""
    group = _group(axis_name)
    if group is None:
        return x
    dim = dim % x.dim()
    return _apply(lambda t: (_all_gather_raw(t, group, dim),),
                  lambda g: (_reduce_scatter_raw(g, group, dim),), x)[0]


def scatter(x, axis_name: Optional[str], dim: int = -1):
    """Keep this rank's chunk of ``dim``; the backward places the gradient
    into zeros, as ``dynamic_slice``'s does."""
    size = axis_size(axis_name)
    if size == 1:
        return x
    dim = dim % x.dim()
    chunk = x.shape[dim] // size
    if chunk * size != x.shape[dim]:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} not divisible by {size}")
    return x.narrow(dim, axis_index(axis_name) * chunk, chunk)


def reduce_scatter(x, axis_name: Optional[str], dim: int = -1):
    """Sum over the axis and keep this rank's chunk of ``dim``
    (``psum_scatter``, tiled); backward: ``all_gather``."""
    group = _group(axis_name)
    if group is None:
        return x
    dim = dim % x.dim()
    return _apply(lambda t: (_reduce_scatter_raw(t, group, dim),),
                  lambda g: (_all_gather_raw(g, group, dim),), x)[0]


def broadcast(x, axis_name: Optional[str], src: int = 0):
    """Every rank gets the value of the rank at coordinate ``src``; the
    gradient is the sum of every rank's, on ``src`` (zeros elsewhere)."""
    group = _group(axis_name)
    if group is None:
        return x
    ctx = _context(axis_name)
    mode = ParallelMode(axis_name)
    root = ctx.get_ranks_in_group(mode)[src]
    is_src = ctx.get_local_rank(mode) == src

    def fwd(t):
        y = (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous().clone()
        dist.broadcast(y, src=root, group=group)
        return (y.to(t.dtype),)

    def bwd(g):
        total = _all_reduce_raw(g, group, "sum")
        return (total if is_src else torch.zeros_like(total),)

    return _apply(fwd, bwd, x)[0]


def reduce(x, axis_name: Optional[str], dst: int = 0, op: str = "sum"):
    """Reduce onto the rank at coordinate ``dst``; other ranks get zeros
    (the reduction times 0, as in JAX)."""
    if _group(axis_name) is None:
        return x
    out = all_reduce(x, axis_name, op=op)
    return out * (1 if axis_index(axis_name) == dst else 0)


def all_to_all(x, axis_name: Optional[str], split_dim: int, concat_dim: int):
    """Split ``split_dim`` into one chunk per rank, send chunk i to rank i,
    concatenate what arrives along ``concat_dim`` (tiled ``all_to_all``);
    backward: the same with the two dims swapped."""
    group = _group(axis_name)
    if group is None:
        return x
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    return _apply(lambda t: (_all_to_all_raw(t, group, split_dim, concat_dim),),
                  lambda g: (_all_to_all_raw(g, group, concat_dim, split_dim),),
                  x)[0]


def _flatten(tree):
    """(tensors, rebuild) of a tensor or a nested tuple/list of tensors and
    Nones, as ``ppermute`` takes JAX pytrees."""
    if tree is None:
        return [], lambda it: None
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t) for t in tree]
        leaves = [x for p, _ in parts for x in p]

        def rebuild(it):
            return type(tree)(r(it) for _, r in parts)
        return leaves, rebuild
    return [tree], lambda it: next(it)


def ppermute(x, axis_name: Optional[str], perm):
    """Point-to-point transfer of ``x`` (a tensor, or a tuple/list of
    tensors and Nones, all in one batch) along ``perm``, a list of (src,
    dst) axis coordinates; backward: the inverse permutation."""
    if _group(axis_name) is None:
        return x
    leaves, rebuild = _flatten(x)
    if not leaves:
        return x
    perm = [(int(s), int(d)) for s, d in perm]
    inverse = [(d, s) for s, d in perm]
    out = _apply(lambda *ts: _ppermute_raw(ts, axis_name, perm),
                 lambda *gs: _ppermute_raw(gs, axis_name, inverse), *leaves)
    return rebuild(iter(out))


def shift_right(x, axis_name: Optional[str]):
    """Send to the next rank on the axis ring."""
    n = axis_size(axis_name)
    return ppermute(x, axis_name, [(i, (i + 1) % n) for i in range(n)])


def shift_left(x, axis_name: Optional[str]):
    """Send to the previous rank on the axis ring."""
    n = axis_size(axis_name)
    return ppermute(x, axis_name, [(i, (i - 1) % n) for i in range(n)])


def barrier(axis_name: Optional[str] = None):
    """Wait for every rank of the axis (a no-op for None)."""
    group = _group(axis_name)
    if group is not None:
        dist.barrier(group=group)


# -- Megatron f/g conjugate operators ---------------------------------------------

def copy_to_tensor_group(x, axis_name: Optional[str]):
    """f: identity forward, all-reduce backward."""
    group = _group(axis_name)
    if group is None:
        return x
    return _apply(lambda t: (t.clone(),),
                  lambda g: (_all_reduce_raw(g, group, "sum"),), x)[0]


def reduce_from_tensor_group(x, axis_name: Optional[str]):
    """g: all-reduce forward, identity backward."""
    group = _group(axis_name)
    if group is None:
        return x
    return _apply(lambda t: (_all_reduce_raw(t, group, "sum"),),
                  lambda g: (g,), x)[0]


def gather_from_tensor_group(x, axis_name: Optional[str], dim: int = -1):
    """All-gather forward, scatter (this rank's chunk) backward."""
    group = _group(axis_name)
    if group is None:
        return x
    dim = dim % x.dim()
    n, idx = dist.get_world_size(group), axis_index(axis_name)
    return _apply(lambda t: (_all_gather_raw(t, group, dim),),
                  lambda g: (g.chunk(n, dim)[idx].contiguous(),), x)[0]


def scatter_to_tensor_group(x, axis_name: Optional[str], dim: int = -1):
    """Scatter (this rank's chunk) forward, all-gather backward."""
    group = _group(axis_name)
    if group is None:
        return x
    dim = dim % x.dim()
    n, idx = dist.get_world_size(group), axis_index(axis_name)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of shape {tuple(x.shape)} not divisible by {n}")
    return _apply(lambda t: (t.chunk(n, dim)[idx].contiguous(),),
                  lambda g: (_all_gather_raw(g, group, dim),), x)[0]
