"""ZeRO-1: optimizer state sharded over the data axis.

The counterpart of ``pipegoose_tpu/optim/zero.py``. Every parameter leaf is
cut evenly along its dim 0 (padded to divisibility; a scalar becomes shape
(1,)) over the data axis, and one step is

    grad shard   = reduce_scatter(local grads) / dp
    state/update = the inner optimizer on this rank's shard only
    new params   = all_gather(updated shards)

The inner optimizer is a factory, ``inner(list_of_tensors) ->
torch.optim.Optimizer``, in the role of the JAX package's optax transform:
:func:`adam` gives ``torch.optim.Adam`` with optax's defaults. It is built
over the shards, so its state (Adam's two moments) holds
``ceil(d0 / dp) x rest`` elements of a leaf on each rank. A shard that
needs no padding is a view of the parameter, which the inner optimizer
then updates in place; on a data axis of one rank the shards are the
parameters themselves and the step is the inner optimizer's alone.

Where this parts from the JAX package: the JAX tree stacks each per-layer
leaf on a leading ``n_layer`` dim, so its ZeRO shards split layers; the
port's per-layer leaves shard along their own dim 0. The updated
parameters are the same; the per-rank state layout is not, and neither are
the int8 reduction's chunks, which follow the leaves: each per-layer leaf
gets its own per-chunk scales.

With ``axis_name=None`` it is the plain, unsharded optimizer step.

``grad_comm`` sets the wire precision of the gradient reduce-scatter
("fp32", "bf16" or "int8", ``distributed.compressed``), and
``error_feedback`` carries each leaf's quantization residual from step to
step in ``ZeroState.ef``. A compressed reduction rounds the gradients on a
data axis of one rank too, as the JAX package's does: only the float32
reduction takes the one-rank shortcut.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, List, Optional

import torch

from pipegoose_tpu_torch._device import true_div
from pipegoose_tpu_torch.distributed.compressed import (
    check_grad_comm,
    compressed_reduce_scatter_mean,
)
from pipegoose_tpu_torch.distributed.functional import (
    all_gather,
    axis_index,
    axis_size,
    reduce_scatter,
)
from pipegoose_tpu_torch.nn.parallel import tree_leaves, tree_map

# optax.adam's defaults; eps is added outside the square root, after the
# bias correction, in both: update = m_hat / (sqrt(v_hat) + eps)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def adam(lr: float) -> Callable[[List[torch.Tensor]], torch.optim.Optimizer]:
    """The inner optimizer of ``optax.adam(lr)``: ``torch.optim.Adam`` with
    optax's defaults (b1 0.9, b2 0.999, eps 1e-8), as a factory over a list
    of tensors."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Pad dim 0 to a multiple of ``mult`` with zeros (a scalar becomes
    shape (1,) first, so that every leaf has a leading dim to cut). A
    view when nothing is padded."""
    if x.dim() == 0:
        x = x[None]
    rem = (-x.shape[0]) % mult
    if rem:
        x = torch.cat([x, x.new_zeros((rem, *x.shape[1:]))])
    return x


def _local_shard(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """This rank's chunk of dim 0 of the padded leaf."""
    n = axis_size(axis_name)
    xp = _pad_to(x, n)
    chunk = xp.shape[0] // n
    return xp.narrow(0, axis_index(axis_name) * chunk, chunk)


def _unshard(shard: torch.Tensor, orig_shape, axis_name: str) -> torch.Tensor:
    """The whole leaf from every rank's shard, the padding cut off."""
    full = all_gather(shard, axis_name, dim=0)
    if len(orig_shape) == 0:
        return full[0]
    return full[:orig_shape[0]]


@dataclasses.dataclass
class ZeroState:
    """The inner optimizer over this rank's shards, and the shards it
    updates: the parameters themselves on a data axis of one rank, None
    at ``axis_name=None``; ``axis_name`` the data axis the shards cut dim 0
    over (None without one), which a checkpoint reads to lay them out.

    ``ef``: with error feedback, one float32 residual per parameter leaf,
    shaped ``(1, ceil(d0 / dp) * dp, *rest)`` (the padded local gradient
    behind a leading dim that the data axis shards: every rank holds its
    own); None otherwise."""

    inner: torch.optim.Optimizer
    shards: Optional[List[torch.Tensor]] = None
    axis_name: Optional[str] = None
    ef: Optional[List[torch.Tensor]] = None


class DistributedOptimizer:
    """ZeRO-1 over an inner optimizer factory (:func:`adam`).

    ``grad_comm``: the wire precision of the gradient reduce-scatter,
    "fp32" (default), "bf16" or "int8" (``distributed.compressed``).
    ``error_feedback=True`` carries the local quantization residual in
    ``ZeroState.ef`` and adds it back before the next quantize; it needs a
    compressed ``grad_comm`` and a ZeRO ``axis_name`` (ValueError else, as
    in the JAX package)."""

    def __init__(self, inner: Callable, axis_name: Optional[str] = "data",
                 grad_comm: str = "fp32", error_feedback: bool = False):
        self.inner = inner
        self.axis_name = axis_name
        self.grad_comm = check_grad_comm(grad_comm)
        if error_feedback and self.grad_comm == "fp32":
            raise ValueError("error_feedback requires grad_comm bf16/int8")
        if error_feedback and axis_name is None:
            # the residual lives in ZeroState.ef, which only the sharded
            # path has: compressed comm without the asked-for feedback
            # would be worse than failing
            raise ValueError("error_feedback requires a ZeRO axis_name (the "
                             "plain-DP grad_comm path is stateless)")
        self.error_feedback = bool(error_feedback)

    def replace(self, **kw) -> "DistributedOptimizer":
        """A copy with fields overridden (``make_hybrid_train_step`` sets
        its ``grad_comm=`` here without changing the caller's optimizer)."""
        cfg = dict(inner=self.inner, axis_name=self.axis_name,
                   grad_comm=self.grad_comm, error_feedback=self.error_feedback)
        cfg.update(kw)
        return DistributedOptimizer(**cfg)

    @staticmethod
    def _ef_zero(p: torch.Tensor, n: int) -> torch.Tensor:
        shape = tuple(p.shape) if p.dim() else (1,)
        d0 = -(-shape[0] // n) * n
        return torch.zeros((1, d0, *shape[1:]), dtype=torch.float32, device=p.device)

    def init(self, params: Any) -> ZeroState:
        """The inner optimizer over this rank's shard of every leaf (its
        state exists for the shard only: the memory ZeRO-1 saves), and the
        zero residuals with error feedback."""
        leaves = tree_leaves(params)
        if self.axis_name is None:
            return ZeroState(self.inner(leaves))
        n = axis_size(self.axis_name)
        ef = [self._ef_zero(p, n) for p in leaves] if self.error_feedback else None
        if n == 1:
            return ZeroState(self.inner(leaves), leaves, self.axis_name, ef)
        shards = [_local_shard(p.detach(), self.axis_name) for p in leaves]
        return ZeroState(self.inner(shards), shards, self.axis_name, ef)

    @torch.no_grad()
    def step(self, grads: Any, state: ZeroState, params: Any):
        """One step from this rank's LOCAL (unreduced) gradients, a tree
        like ``params``: the reduce-scatter averages them over the data axis
        and hands each rank its shard in one collective, at ``grad_comm``'s
        wire precision. The parameters are updated in place; returns
        (params, state)."""
        leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
        ax = self.axis_name
        n = axis_size(ax)
        compressed = ax is not None and (self.grad_comm != "fp32" or state.ef is not None)
        if n == 1 and not compressed:   # the inner step on the parameters
            for p, g in zip(leaves, g_leaves):
                if p.grad is not g:
                    p.grad = g
            state.inner.step()
            return params, state
        ef = state.ef if state.ef is not None else [None] * len(leaves)
        for p, g, sh, e in zip(leaves, g_leaves, state.shards, ef):
            if compressed:
                gs, new_e = compressed_reduce_scatter_mean(
                    _pad_to(g, n), ax, self.grad_comm,
                    residual=None if e is None else e[0])
                if new_e is not None:
                    e.copy_(new_e[None])
                # the inner optimizer sees the gradient dtype of the
                # float32 wire path, whatever the wire was
                gs = gs.to(g.dtype)
            else:
                gs = true_div(reduce_scatter(_pad_to(g, n), ax, dim=0), n)
            sh.grad = gs.reshape(sh.shape).to(sh.dtype)
            if n > 1 and not _aliases(sh, p):   # a padded shard holds a copy
                sh.copy_(_local_shard(p.detach(), ax))
        state.inner.step()
        for p, sh in zip(leaves, state.shards):
            if n > 1:   # (on one rank the shard is the leaf: its .grad stays)
                sh.grad = None
                p.copy_(_unshard(sh, p.shape, ax).reshape(p.shape).to(p.dtype))
        return params, state


def _aliases(shard: torch.Tensor, p: torch.Tensor) -> bool:
    return shard.untyped_storage().data_ptr() == p.untyped_storage().data_ptr()


# -- specs of the sharded state --------------------------------------------------


def zero_param_spec(param_spec: tuple, param_ndim: int, axis_name: str = "data") -> tuple:
    """Spec of a ZeRO shard leaf's global layout: the data axis subdivides
    dim 0 inside any sharding it already has; a scalar becomes a (1,)
    shard."""
    if param_ndim == 0:
        return (axis_name,)
    dim0 = param_spec[0] if len(param_spec) > 0 else None
    if dim0 is None:
        new0 = axis_name
    elif isinstance(dim0, (tuple, list)):
        new0 = (*dim0, axis_name)
    else:
        new0 = (dim0, axis_name)
    rest = tuple(param_spec[1:])
    return (new0, *rest, *((None,) * (param_ndim - 1 - len(rest))))


def ef_param_spec(param_spec: tuple, param_ndim: int, axis_name: str = "data") -> tuple:
    """Spec of an error-feedback residual leaf: its local shape is ``(1,
    *padded_local_grad_shape)`` and every data rank holds its own, so the
    leading dim is sharded over the data axis and the rest follow the
    parameter's spec. A parameter sharded over the data axis itself has
    no such residual (ValueError)."""
    if param_ndim == 0:
        return (axis_name, None)
    rest = tuple(param_spec[:param_ndim])
    rest = rest + (None,) * (param_ndim - len(rest))
    for entry in rest:
        entries = entry if isinstance(entry, (tuple, list)) else (entry,)
        if axis_name in entries:
            raise ValueError(f"error feedback needs params unsharded over the "
                             f"{axis_name!r} axis, got spec {param_spec}")
    return (axis_name, *rest)


def ef_state_specs(params: Any, param_specs: Any, axis_name: str = "data") -> Any:
    """The spec tree of ``ZeroState.ef`` (each leaf's :func:`ef_param_spec`)."""
    return tree_map(lambda p, s: ef_param_spec(s, p.dim(), axis_name), params,
                    param_specs)


def state_specs(params: Any, param_specs: Any, axis_name: str = "data") -> Any:
    """The spec tree of the inner state's per-parameter moments (each
    leaf's :func:`zero_param_spec`); the step counts are replicated."""
    return tree_map(lambda p, s: zero_param_spec(s, p.dim(), axis_name),
                    params, param_specs)


def shard_shapes(params: Any, dp_size: int) -> Any:
    """The shape of every leaf's ZeRO shard on one of ``dp_size`` ranks."""
    def shape(p):
        s = tuple(p.shape) if p.dim() > 0 else (1,)
        return (-(-s[0] // dp_size), *s[1:])

    return tree_map(shape, params)
