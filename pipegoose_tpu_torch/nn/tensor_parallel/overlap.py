"""Ring collective-matmul: the tensor axis's collectives hidden behind
partial matmuls.

The counterpart of ``pipegoose_tpu/nn/tensor_parallel/overlap.py``
("On Optimizing the Communication of Model Parallelism", arxiv
2211.05322). An all-gather followed by a matmul becomes ``tp`` partial
matmuls interleaved with ``tp - 1`` ring hops, and a matmul followed by a
reduce becomes a ring matmul-reduce-scatter, so each hop's transfer runs
while the next partial matmul does:

- :func:`ring_all_gather_matmul`: ``concat_c(x_c) @ w``, rank r holding
  token chunk ``x_r`` (the column-parallel input gather);
- :func:`ring_matmul_reduce_scatter`: ``sum_r(x^(r) @ w^(r))`` with rank r
  keeping token chunk r (the row-parallel output reduce, its
  reduce-scatter half).

:func:`column_parallel_linear_overlap` and
:func:`row_parallel_linear_overlap` are ``torch.autograd.Function``s whose
backward is the JAX ``custom_vjp``'s hand-written ring: activations
between layers stay sharded on the token dim over the tensor axis, the
column layer gathers tokens while it projects and the row layer reduces
while it projects. Replicated parameters used on token shards go through
:func:`replicated_for_overlap` (the f-operator), so their gradients are
the full-sequence sums on every rank.

Each hop is a ``batch_isend_irecv`` started before that step's partial
matmul and waited on after it: on NCCL the transfer runs on its own stream
beside the matmul, which is the point of the module; on gloo it is only
correct. The partials and the accumulator that rides the ring are float32
(the JAX ``preferred_element_type=f32``), cast once at the end. Products
stay ``torch.matmul``, as the dense layers' are: the JAX module is ``jnp``
code with no Pallas kernel. On a tensor axis of one rank, and with
``axis_name=None``, every function is the plain product.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from pipegoose_tpu_torch.distributed.functional import (
    _context,
    axis_index,
    axis_size,
    copy_to_tensor_group,
)
from pipegoose_tpu_torch.distributed.parallel_mode import ParallelMode
from pipegoose_tpu_torch.nn.parallel import tree_map


def _chunk_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A partial matmul with float32 products and sums, whatever the
    inputs' dtype (the layers' convention)."""
    return torch.matmul(x.float(), w.float())


def _dw_dot(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``x^T @ dy`` summed over every leading (batch) dim, in float32."""
    return torch.einsum("...mk,...mn->kn", x.float(), dy.float())


def _dx_dot(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dy @ w^T`` in float32."""
    return torch.einsum("...mn,kn->...mk", dy.float(), w.float())


def _hop_start(x: torch.Tensor, axis_name: str):
    """Start one ring hop: send ``x`` to the next rank of the axis and
    receive the previous rank's tensor (after k hops rank r holds rank
    (r - k)'s). Returns the pending (buffer, requests)."""
    ctx = _context(axis_name)
    mode = ParallelMode(axis_name)
    me, ranks = ctx.get_local_rank(mode), ctx.get_ranks_in_group(mode)
    n, group = len(ranks), ctx.group(axis_name)
    x = x.contiguous()
    buf = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, ranks[(me + 1) % n], group),
        dist.P2POp(dist.irecv, buf, ranks[(me - 1) % n], group)])
    return buf, reqs, x


def _hop_wait(pending) -> torch.Tensor:
    buf, reqs, _sent = pending   # the sent tensor is kept alive until here
    for req in reqs:
        req.wait()
    return buf


def _rows(x: torch.Tensor, c: int, m: int) -> torch.Tensor:
    return x.narrow(-2, c * m, m)


def ring_all_gather_matmul(x_local: torch.Tensor, w: torch.Tensor,
                           axis_name: Optional[str]) -> torch.Tensor:
    """``concat_over_ranks(x) @ w`` with the gather decomposed into the ring.

    ``x_local``: (..., m, K), this rank's token chunk (chunk id = rank).
    Returns (..., n*m, N) float32, the chunks' rows in global order, the
    same on every rank up to float32 rounding."""
    n = axis_size(axis_name)
    if n == 1:
        return _chunk_dot(x_local, w)
    r = axis_index(axis_name)
    m = x_local.shape[-2]
    out = x_local.new_empty((*x_local.shape[:-2], n * m, w.shape[-1]),
                            dtype=torch.float32)
    cur = x_local
    for step in range(n):
        c = (r - step) % n   # the chunk id held now
        pending = _hop_start(cur, axis_name) if step < n - 1 else None
        _rows(out, c, m).copy_(_chunk_dot(cur, w))
        if pending is not None:
            cur = _hop_wait(pending)
    return out


def ring_matmul_reduce_scatter(x_full: torch.Tensor, w: torch.Tensor,
                               axis_name: Optional[str]) -> torch.Tensor:
    """``sum_over_ranks(x @ w)``, rank r keeping token chunk r.

    ``x_full``: (..., n*m, K), every token with a feature-sharded ``w``.
    Returns (..., m, N) float32, this rank's chunk of the summed output.
    The accumulator for chunk c starts at rank c + 1 and rides the ring for
    ``n - 1`` hops, each transfer beside the next chunk's partial matmul."""
    n = axis_size(axis_name)
    if n == 1:
        return _chunk_dot(x_full, w)
    r = axis_index(axis_name)
    m = x_full.shape[-2] // n
    acc = None
    for step in range(n):
        c = (r - 1 - step) % n   # the chunk this rank contributes to now
        pending = _hop_start(acc, axis_name) if acc is not None else None
        part = _chunk_dot(_rows(x_full, c, m), w)
        acc = part if pending is None else _hop_wait(pending) + part
    return acc   # after n steps: chunk (r - n) % n == r, fully summed


def _ring_accumulate_dw(x_local: torch.Tensor, dy_full: torch.Tensor,
                        axis_name: Optional[str]) -> torch.Tensor:
    """``dw = sum_c x_c^T @ dy[chunk c]`` with the x chunks ringed: the
    column backward's weight gradient, its hops beside the partials as the
    forward gather's are."""
    n = axis_size(axis_name)
    r = axis_index(axis_name) if n > 1 else 0
    m = x_local.shape[-2]
    cur = x_local
    dw = None
    for step in range(n):
        c = (r - step) % n
        pending = _hop_start(cur, axis_name) if step < n - 1 else None
        part = _dw_dot(cur, _rows(dy_full, c, m))
        dw = part if dw is None else dw + part
        if pending is not None:
            cur = _hop_wait(pending)
    return dw


class _ColumnOverlap(torch.autograd.Function):
    """Forward: the ring all-gather matmul. Backward: ``dx`` is a ring
    matmul-reduce-scatter of the dy chunks over the OUT-sharded kernel, and
    ``dw`` a second ring of the x chunks."""

    @staticmethod
    def forward(ctx, kernel, x_local, axis_name):
        ctx.save_for_backward(kernel, x_local)
        ctx.axis_name = axis_name
        return ring_all_gather_matmul(x_local, kernel, axis_name)

    @staticmethod
    def backward(ctx, dy):
        kernel, x_local = ctx.saved_tensors
        dx = ring_matmul_reduce_scatter(dy, kernel.t(), ctx.axis_name)
        dw = _ring_accumulate_dw(x_local, dy, ctx.axis_name)
        return dw.to(kernel.dtype), dx.to(x_local.dtype), None


class _RowOverlap(torch.autograd.Function):
    """Forward: the ring matmul-reduce-scatter. Backward: one ring of the dy
    chunks feeds both ``dx`` (rows of chunk c are ``dy_c @ W^T``) and
    ``dw`` (``x_c^T @ dy_c``)."""

    @staticmethod
    def forward(ctx, kernel, x_full, axis_name):
        ctx.save_for_backward(kernel, x_full)
        ctx.axis_name = axis_name
        return ring_matmul_reduce_scatter(x_full, kernel, axis_name)

    @staticmethod
    def backward(ctx, dy_own):
        kernel, x_full = ctx.saved_tensors
        axis_name = ctx.axis_name
        n = axis_size(axis_name)
        if n == 1:
            return (_dw_dot(x_full, dy_own).to(kernel.dtype),
                    _dx_dot(dy_own, kernel).to(x_full.dtype), None)
        r = axis_index(axis_name)
        m = dy_own.shape[-2]
        dx = x_full.new_empty(x_full.shape, dtype=torch.float32)
        dw = None
        cur = dy_own
        for step in range(n):
            c = (r - step) % n   # the dy chunk held now
            pending = _hop_start(cur, axis_name) if step < n - 1 else None
            _rows(dx, c, m).copy_(_dx_dot(cur, kernel))
            part = _dw_dot(_rows(x_full, c, m), cur)
            dw = part if dw is None else dw + part
            if pending is not None:
                cur = _hop_wait(pending)
        return dw.to(kernel.dtype), dx.to(x_full.dtype), None


def _check_fp(params: dict) -> None:
    if "q" in params:
        raise ValueError("overlap=True is a training-path option; quantized "
                         "(serving) kernels use the monolithic dequant matmul")


def column_parallel_linear_overlap(params: dict, x_local: torch.Tensor,
                                   axis_name: Optional[str]) -> torch.Tensor:
    """Column parallel with the input's token gather decomposed into the
    ring. ``x_local``: (..., m, K) token chunk; returns (..., n*m, O/n),
    every token and the OUT shard, as the monolithic
    ``column_parallel_linear`` gives from the gathered input (float32
    allclose). ``axis_name=None``: the plain product."""
    _check_fp(params)
    if axis_name is None:
        y = _chunk_dot(x_local, params["kernel"]).to(x_local.dtype)
    else:
        y = _ColumnOverlap.apply(params["kernel"], x_local, axis_name).to(x_local.dtype)
    bias = params.get("bias")
    return y if bias is None else y + bias


def row_parallel_linear_overlap(params: dict, x_full: torch.Tensor,
                                axis_name: Optional[str]) -> torch.Tensor:
    """Row parallel with the output reduce decomposed into the ring.
    ``x_full``: (..., n*m, I/n), every token and the IN shard; returns
    (..., m, O), this rank's token chunk of the reduced output (the
    all-reduce's reduce-scatter half). The replicated bias is added on the
    chunk through the f-operator, so its gradient sums every token's."""
    _check_fp(params)
    if axis_name is None:
        y = _chunk_dot(x_full, params["kernel"]).to(x_full.dtype)
    else:
        y = _RowOverlap.apply(params["kernel"], x_full, axis_name).to(x_full.dtype)
    bias = params.get("bias")
    if bias is None:
        return y
    if axis_name is not None:
        bias = copy_to_tensor_group(bias, axis_name)
    return y + bias


def replicated_for_overlap(params: Any, axis_name: Optional[str]) -> Any:
    """A replicated parameter (sub)tree through the f-operator before its
    use on a TOKEN SHARD: identity forward, all-reduce backward, so (say) a
    LayerNorm applied to 1/tp of the tokens still gets the full-sequence
    gradient on every rank."""
    if axis_name is None:
        return params
    return tree_map(lambda p: copy_to_tensor_group(p, axis_name), params)
