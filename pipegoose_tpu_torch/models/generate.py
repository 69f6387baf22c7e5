"""The attention pieces of ``pipegoose_tpu/models/generate.py`` that the
paged serving path shares: the fused qkv projection and the plain
attention core. The contiguous-cache ``generate`` waits for a later slice
of the port."""
from __future__ import annotations

from typing import Optional

import torch

from pipegoose_tpu_torch.nn.tensor_parallel.layers import column_parallel_linear


def _qkv_proj(blk: dict, x: torch.Tensor, config, tp_axis: Optional[str] = None):
    """Fused qkv projection split into (q, k, v), each (B, S, nh, hd).

    BLOOM's fused output interleaves q, k and v PER HEAD: it reshapes to
    (B, S, nh, 3, hd), not to three [q | k | v] blocks. The three results
    are strided views of the fused product."""
    b, s, _ = x.shape
    hd = config.head_dim
    fused = column_parallel_linear(blk["qkv"], x, tp_axis)
    fused = fused.reshape(b, s, config.n_head, 3, hd)
    return fused[..., 0, :], fused[..., 1, :], fused[..., 2, :]


def _attn_core(q, keys, values, bias, qmask, out_dtype):
    """Softmax attention of q (B, S, nh, hd) against a key/value view
    (B, K, nh, hd) under an additive bias (B|1, nh, S, K): float32 scores,
    probabilities cast to ``out_dtype`` before the value product, context
    of pad queries zeroed by ``qmask``. Returns (B, S, nh*hd) in
    ``out_dtype``. Invalid key columns must arrive masked (NEG_INF) in
    ``bias`` so their softmax weight is exactly zero."""
    hd = q.shape[-1]
    b, s, nh, _ = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), keys.float()) * (hd ** -0.5)
    probs = torch.softmax(scores + bias, dim=-1).to(out_dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), values.float())
    if qmask is not None:
        ctx = ctx * qmask[:, :, None, None].to(ctx.dtype)
    return ctx.to(out_dtype).reshape(b, s, nh * hd)
