"""The tensor-parallel layer functions of ``pipegoose_tpu.nn.tensor_parallel
.layers`` at tp=1.

Same conventions as the JAX module: a layer is a function over a params
dict, kernels are laid out ``(in_features, out_features)``, and
``axis_name=None`` is the single-device path. Tensor parallelism waits
for a later slice of the port, so any other ``axis_name`` raises. The
cross entropy is the plain single-device one; its backward is autograd's
softmax-minus-one-hot, which the JAX ``custom_vjp`` only needs under
TP. ``chunked_ce_sums`` bounds the logits to one sequence chunk. Dense
products stay ``torch.matmul``: the JAX package leaves them to XLA, so
there is no kernel to port here. A quantized leaf (``quant.weights``)
goes through ``quant.matmul.quantized_matmul`` instead, whose kernels
are ported.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from pipegoose_tpu_torch.quant.matmul import quantized_matmul


def _check_axis(axis_name: Optional[str]) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            f"axis_name={axis_name!r}: tensor parallelism is not ported yet "
            f"(ROADMAP.md queue A, TP serving); only axis_name=None runs"
        )


def _kernel_matmul(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The local product both parallel linears share, dispatching on the
    leaf: ``{"kernel": fp}`` is ``x @ kernel``; a quantized leaf ``{"q",
    "scale"}`` runs the dequant-fused matmul, so no float copy of the
    weight is made. Either result comes back in the activation dtype: in
    bf16 the product accumulates in float32 and is rounded once, as
    ``jnp.dot(..., preferred_element_type=f32).astype(x.dtype)`` does."""
    if "q" in params:
        return quantized_matmul(x, params["q"], params["scale"]).to(x.dtype)
    return torch.matmul(x, params["kernel"]).to(x.dtype)


def column_parallel_linear(params: dict, x: torch.Tensor,
                           axis_name: Optional[str] = None) -> torch.Tensor:
    """Y = X @ W (+ b)."""
    _check_axis(axis_name)
    y = _kernel_matmul(params, x)
    if params.get("bias") is not None:
        y = y + params["bias"]
    return y


def row_parallel_linear(params: dict, x: torch.Tensor,
                        axis_name: Optional[str] = None) -> torch.Tensor:
    """Y = X @ W + b (the psum over shards is the identity at tp=1)."""
    _check_axis(axis_name)
    y = _kernel_matmul(params, x)
    if params.get("bias") is not None:
        y = y + params["bias"]
    return y


def vocab_parallel_embedding(params: dict, ids: torch.Tensor,
                             axis_name: Optional[str] = None) -> torch.Tensor:
    """Embedding lookup over the whole vocabulary."""
    _check_axis(axis_name)
    return params["weight"][ids]


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
    slots never win a softmax or shift the log-sum-exp."""
    _check_axis(axis_name)
    slot = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(slot < valid_size, logits, -1e9)


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 axis_name: Optional[str] = None,
                                 valid_size: Optional[int] = None) -> torch.Tensor:
    """Per-token cross entropy ``logsumexp(logits) - logits[target]`` in
    float32 over the whole vocabulary; callers take the (weighted) mean.
    ``valid_size`` excludes padded vocab slots from the log-sum-exp."""
    _check_axis(axis_name)
    if valid_size is not None:
        logits = mask_padded_vocab(logits, axis_name, valid_size)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    pred = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - pred


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
    (B, C, H) to (B, C, V)."""
    _check_axis(axis_name)
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
