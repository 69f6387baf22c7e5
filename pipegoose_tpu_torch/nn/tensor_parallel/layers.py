"""Megatron-style tensor-parallel layers as functions over a params dict.

The counterpart of ``pipegoose_tpu/nn/tensor_parallel/layers.py``, with the
same conventions: kernels are laid out ``(in_features, out_features)``,
column parallelism shards the OUT dim and row parallelism the IN dim, and
``axis_name=None`` is the single-device path. Under an axis the
collectives are ``distributed.functional``'s over the current
``ParallelContext`` (no-ops on an axis of size 1). The vocab-parallel cross
entropy has the JAX ``custom_vjp``'s analytic backward, softmax minus one
hot on the local shard, as a ``torch.autograd.Function``; at
``axis_name=None`` it is the plain single-device one, differentiated by
autograd. ``chunked_ce_sums`` bounds the logits to one sequence chunk.
Dense products stay ``torch.matmul``: the JAX package leaves them to XLA,
so there is no kernel to port here. A quantized leaf (``quant.weights``)
goes through ``quant.matmul.quantized_linear`` instead, whose kernels are
ported and on the card add the bias in their epilogue.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from pipegoose_tpu_torch.distributed.functional import (
    all_reduce,
    axis_index,
    copy_to_tensor_group,
    reduce_from_tensor_group,
)
from pipegoose_tpu_torch.quant.matmul import quantized_linear


def _kernel_matmul(params: dict, x: torch.Tensor, with_bias: bool = True) -> torch.Tensor:
    """The local product both parallel linears share, with the bias unless
    ``with_bias`` is False, dispatching on the leaf: ``{"kernel": fp}`` is
    ``x @ kernel``; a quantized leaf ``{"q", "scale"}`` runs the
    dequant-fused matmul with the bias in its epilogue, so no float copy of
    the weight is made. Either result comes back in the activation dtype:
    in bf16 the product accumulates in float32 and is rounded once before
    the bias is added, as ``jnp.dot(..., preferred_element_type=f32)
    .astype(x.dtype) + b`` does."""
    bias = params.get("bias") if with_bias else None
    if "q" in params:
        return quantized_linear(x, params["q"], params["scale"], bias)
    y = torch.matmul(x, params["kernel"]).to(x.dtype)
    return y if bias is None else y + bias


def column_parallel_linear(params: dict, x: torch.Tensor,
                           axis_name: Optional[str] = None,
                           overlap: bool = False) -> torch.Tensor:
    """Y = X @ W[:, shard] (+ b[shard]): the f-operator on the input
    (identity forward, all-reduce backward), the local product and the
    shard's bias.

    ``overlap=True``: ``x`` is this rank's TOKEN CHUNK (dim -2 sharded over
    the axis) and the gather back to every token runs as ring hops beside
    partial matmuls (``overlap.column_parallel_linear_overlap``)."""
    if overlap:
        from pipegoose_tpu_torch.nn.tensor_parallel.overlap import (
            column_parallel_linear_overlap,
        )

        return column_parallel_linear_overlap(params, x, axis_name)
    if axis_name is not None:
        x = copy_to_tensor_group(x, axis_name)
    return _kernel_matmul(params, x)


def row_parallel_linear(params: dict, x: torch.Tensor,
                        axis_name: Optional[str] = None,
                        overlap: bool = False) -> torch.Tensor:
    """Y = sum over shards of X[shard] @ W[shard, :], + b: the local
    product, the g-operator (all-reduce forward, identity backward), then
    the bias ONCE, after the reduce. At ``axis_name=None`` the bias rides
    in the product (a quantized leaf's epilogue).

    ``overlap=True``: the reduce runs as a ring matmul-reduce-scatter and
    each rank gets its TOKEN CHUNK of the reduced output
    (``overlap.row_parallel_linear_overlap``)."""
    if overlap:
        from pipegoose_tpu_torch.nn.tensor_parallel.overlap import (
            row_parallel_linear_overlap,
        )

        return row_parallel_linear_overlap(params, x, axis_name)
    if axis_name is None:
        return _kernel_matmul(params, x)
    y = reduce_from_tensor_group(_kernel_matmul(params, x, with_bias=False), axis_name)
    bias = params.get("bias")
    return y if bias is None else y + bias


def vocab_parallel_embedding(params: dict, ids: torch.Tensor,
                             axis_name: Optional[str] = None) -> torch.Tensor:
    """Embedding lookup over a vocab-sharded table: ids outside this
    shard's ``[start, start + V/tp)`` look up row 0 and are zeroed, then
    the g-operator sums the shards (an identity backward: the loss is
    replicated over the axis, so a psum backward would scale the weight's
    gradient by tp)."""
    weight = params["weight"]
    if axis_name is None:
        return weight[ids]
    per_shard = weight.shape[0]
    start = axis_index(axis_name) * per_shard
    in_range = (ids >= start) & (ids < start + per_shard)
    out = weight[torch.where(in_range, ids - start, 0)]
    out = torch.where(in_range[..., None], out, torch.zeros((), dtype=out.dtype,
                                                            device=out.device))
    return reduce_from_tensor_group(out, axis_name)


def layer_norm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics whatever the activation dtype.
    The variance is the population variance (``jnp.var`` is ddof=0)."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"] + params["bias"]
    return y.to(dtype)


def mask_padded_vocab(logits: torch.Tensor, axis_name: Optional[str],
                      valid_size: int) -> torch.Tensor:
    """Logits of vocab slots >= ``valid_size`` set to -1e9, so padded
    slots never win a softmax or shift the log-sum-exp. Under an axis the
    slots are this shard's global columns."""
    shard_v = logits.shape[-1]
    slot = (axis_index(axis_name) * shard_v
            + torch.arange(shard_v, device=logits.device))
    return torch.where(slot < valid_size, logits, -1e9)


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 axis_name: Optional[str] = None,
                                 valid_size: Optional[int] = None) -> torch.Tensor:
    """Per-token cross entropy ``logsumexp(logits) - logits[target]`` in
    float32; callers take the (weighted) mean. ``valid_size`` excludes
    padded vocab slots from the log-sum-exp. Under ``axis_name`` the
    logits are this rank's vocab shard and the targets global ids: the
    global max, the log-sum-exp and the target's logit are all-reduced,
    and the backward is the analytic one of :class:`_VocabParallelCE`."""
    if valid_size is not None:
        logits = mask_padded_vocab(logits, axis_name, valid_size)
    if axis_name is not None:
        return _VocabParallelCE.apply(logits, targets, axis_name)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    pred = torch.gather(logits, -1, targets.long()[..., None])
    # subtract before dropping the gathered dim: the same numbers, and a
    # DTensor gather over a vocab-sharded dim (``parallel.auto``) stays a
    # partial whose mask keeps its shape until the subtraction resolves it
    return (lse[..., None] - pred)[..., 0]


def chunked_ce_sums(hidden: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor,
                    logits_fn: Callable[[torch.Tensor], torch.Tensor],
                    axis_name: Optional[str], valid_size: Optional[int],
                    n_chunks: int):
    """(weighted loss sum, weight sum) without the (B, T, V) logits: T is
    padded to a multiple of ``n_chunks`` with weight-0 positions and cut
    into chunks, each chunk's logits and cross entropy computed under
    ``torch.utils.checkpoint`` (non-reentrant), so that backward rebuilds
    one chunk's logits at a time. ``hidden`` (B, T, H) is already shifted
    to align with ``labels`` and ``weights`` (B, T); ``logits_fn`` maps
    (B, C, H) to (B, C, V/tp), this rank's vocab shard under
    ``axis_name``."""
    b, t, _ = hidden.shape
    if t % n_chunks:
        pad = n_chunks - t % n_chunks
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))
        t += pad
    c = t // n_chunks

    def chunk(h_c, l_c, w_c):
        per_tok = vocab_parallel_cross_entropy(logits_fn(h_c), l_c, axis_name,
                                               valid_size=valid_size)
        w_c = w_c.to(per_tok.dtype)
        return (per_tok * w_c).sum(), w_c.sum()

    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        part = slice(i * c, (i + 1) * c)
        s_c, n_c = checkpoint(chunk, hidden[:, part], labels[:, part],
                              weights[:, part], use_reentrant=False)
        tot, cnt = tot + s_c, cnt + n_c
    return tot, cnt


class _VocabParallelCE(torch.autograd.Function):
    """The JAX ``_vp_ce`` custom_vjp: per-token loss over vocab-sharded
    logits with no collective in its backward, whose gradient is ``g *
    (softmax_local - onehot_local)`` in the logits' dtype. Targets get no
    gradient."""

    @staticmethod
    def forward(ctx, logits, targets, axis_name):
        in_dtype = logits.dtype
        logits = logits.float()
        shard_v = logits.shape[-1]
        start = axis_index(axis_name) * shard_v
        global_max = all_reduce(logits.amax(dim=-1), axis_name, op="max")
        exp = (logits - global_max[..., None]).exp()
        sumexp = all_reduce(exp.sum(dim=-1), axis_name)
        t = targets.long()
        in_range = (t >= start) & (t < start + shard_v)
        local_t = torch.where(in_range, t - start, 0)
        picked = logits.gather(-1, local_t[..., None])[..., 0] - global_max
        pred = all_reduce(torch.where(in_range, picked, 0.0), axis_name)
        ctx.save_for_backward(exp.div_(sumexp[..., None]), in_range, local_t)
        ctx.in_dtype = in_dtype
        return torch.log(sumexp) - pred

    @staticmethod
    def backward(ctx, g):
        softmax_local, in_range, local_t = ctx.saved_tensors
        shard_v = softmax_local.shape[-1]
        grad = softmax_local.reshape(-1, shard_v).clone()
        rows = torch.nonzero(in_range.reshape(-1))[:, 0]
        grad[rows, local_t.reshape(-1)[rows]] -= 1.0
        grad = grad.reshape(softmax_local.shape).mul_(g[..., None])
        return grad.to(ctx.in_dtype), None, None
