"""Autoregressive generation with a contiguous KV cache for BLOOM.

The counterpart of ``pipegoose_tpu/models/generate.py``. The cache is
one fixed-size (max_len) tensor per k and v, stacked per layer
``(n_layer, B, max_len, nh, hd)``, written IN PLACE: a slice assignment
takes the place of ``dynamic_update_slice``, a Python loop over
``params["blocks"]`` the ``lax.scan`` over blocks, and a Python loop over
time steps the scanned decode. The fused qkv projection and the plain
attention core are shared with the paged serving path
(``serving/kv_pool.py``), and the serving engine's monolithic prefill runs
:func:`forward_cached` once per prompt.

Ragged batches follow HF generate's LEFT-padding convention: pass
``attention_mask`` and each row's prompt ends at the last column. ALiBi
then uses the mask-aware positions (``build_alibi``) and pad slots stay
masked as keys for the whole generation. Without a mask, prompts are
unpadded and plain global positions apply.

Greedy, or sampled at ``temperature > 0`` from a ``torch.Generator``.
:func:`generate_tp` is the tensor-parallel greedy decode over the current
``ParallelContext``: each rank keeps its shard of the whole tree
(``nn.parallel.shard_tree``), a cache of its ``n_head / tp`` heads and its
vocab shard of the logits, and every pick is the global argmax
(``_decode.global_greedy_pick``), so every rank returns the same ids.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pipegoose_tpu_torch._device import resolve_device
from pipegoose_tpu_torch.distributed.functional import axis_size
from pipegoose_tpu_torch.nn.tensor_parallel.layers import (
    column_parallel_linear,
    layer_norm,
    row_parallel_linear,
    vocab_parallel_embedding,
)


def init_cache(config, batch: int, max_len: int, tp: int = 1, device="cuda") -> dict:
    """Zero KV cache ``{"k", "v"}`` of ``config.dtype``, each (n_layer,
    batch, max_len, nh, hd), on ``device``; under a tensor axis of size
    ``tp`` the cache holds this rank's ``nh = n_head / tp`` heads."""
    dev = resolve_device(device)
    if config.n_head % tp:
        raise ValueError(f"n_head={config.n_head} not divisible by tp={tp}")
    shape = (config.n_layer, batch, max_len, config.n_head // tp, config.head_dim)
    return {"k": torch.zeros(shape, dtype=config.dtype, device=dev),
            "v": torch.zeros(shape, dtype=config.dtype, device=dev)}


def local_heads(config, tp_axis: Optional[str] = None) -> int:
    """Heads of this rank: ``n_head / tp``, whole heads per shard."""
    tp = axis_size(tp_axis)
    if config.n_head % tp:
        raise ValueError(f"n_head={config.n_head} must be divisible by the tensor "
                         f"axis size {tp} (whole heads per shard)")
    return config.n_head // tp


def _qkv_proj(blk: dict, x: torch.Tensor, config, tp_axis: Optional[str] = None):
    """Fused qkv projection split into (q, k, v), each (B, S, nh/tp, hd):
    under ``tp_axis`` the kernel is column-sharded by whole heads.

    BLOOM's fused output interleaves q, k and v PER HEAD: it reshapes to
    (B, S, nh, 3, hd), not to three [q | k | v] blocks. The three results
    are strided views of the fused product."""
    b, s, _ = x.shape
    hd = config.head_dim
    fused = column_parallel_linear(blk["qkv"], x, tp_axis)
    fused = fused.reshape(b, s, local_heads(config, tp_axis), 3, hd)
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


def _attn_cached(blk, x, k_cache, v_cache, start: int, config, tp_axis=None,
                 bias=None, qmask=None):
    """Attend S new tokens against cache[:start] + themselves and return
    the attention block's output. Writes the new k/v into ``k_cache``/
    ``v_cache`` (B, max_len, nh, hd) at ``start`` in place, where JAX
    returns updated caches. ``bias``/``qmask`` come from
    :func:`_decode_bias`, shared by all layers of one forward."""
    q, k, v = _qkv_proj(blk, x, config, tp_axis)
    s = x.shape[1]
    k_cache[:, start:start + s] = k.to(k_cache.dtype)
    v_cache[:, start:start + s] = v.to(v_cache.dtype)
    ctx = _attn_core(q, k_cache, v_cache, bias, qmask, x.dtype)
    return row_parallel_linear(blk["out"], ctx, tp_axis)


def _decode_bias(config, b: int, s: int, start: int, max_len: int, extras,
                 device, tp_axis: Optional[str] = None):
    """Attention bias of one cached forward, shared by all layers: causal
    by slot (which also hides slots not yet written) + ALiBi over this
    rank's heads (+ per-row key validity for ragged LEFT-padded prompts).
    Returns (bias (B|1, nh/tp, S, max_len), qmask (B, S) or None).

    ``extras={"mask": (B, max_len)}`` (the prompt's mask extended with ones
    over the generated tail): ALiBi positions become the mask-aware
    ``(cumsum(mask) - 1) * mask``, pad slots are masked as keys, and pad
    queries of the prefill get zero context."""
    from pipegoose_tpu_torch.models.bloom import NEG_INF, _local_slopes

    slopes = _local_slopes(config, tp_axis, device)
    key_pos = torch.arange(max_len, device=device)
    q_pos = start + torch.arange(s, device=device)
    keep = key_pos[None, :] <= q_pos[:, None]
    causal = torch.where(keep[None, None], 0.0, NEG_INF)
    if extras is None:
        bias = slopes[None, :, None, None] * key_pos[None, None, None, :].float()
        return bias + causal, None
    m = extras["mask"].float()                                # (B, max_len)
    apos = (torch.cumsum(m, dim=-1) - 1.0) * m
    bias = slopes[None, :, None, None] * apos[:, None, None, :]
    bias = bias + torch.where(m[:, None, None, :] > 0, 0.0, NEG_INF)
    return bias + causal, m[:, start:start + s]


@torch.no_grad()
def forward_cached(params, ids: torch.Tensor, cache: dict, start: int, config,
                   tp_axis: Optional[str] = None, extras=None):
    """Forward S tokens per row at positions ``start..start+S-1`` through
    the cache, writing their k/v into it in place. Returns (float32
    logits of the last position (B, V), the cache); under ``tp_axis`` the
    logits are this rank's vocab shard (B, V/tp) and the cache holds its
    heads (pair them with ``_decode.global_greedy_pick``).
    ``extras={"mask": (B, max_len)}`` enables ragged left-padded prompts
    (see :func:`_decode_bias`)."""
    from pipegoose_tpu_torch.models.bloom import bloom_gelu, logits_fn

    eps = config.layer_norm_epsilon
    x = vocab_parallel_embedding(params["embed"], ids, tp_axis).to(config.dtype)
    x = layer_norm(params["embed_ln"], x, eps)
    b, s = ids.shape
    bias, qmask = _decode_bias(config, b, s, int(start), cache["k"].shape[2],
                               extras, x.device, tp_axis)
    for i, blk in enumerate(params["blocks"]):
        ln1 = layer_norm(blk["ln_1"], x, eps)
        x = x + _attn_cached(blk["attn"], ln1, cache["k"][i], cache["v"][i],
                             int(start), config, tp_axis, bias, qmask)
        ln2 = layer_norm(blk["ln_2"], x, eps)
        up = column_parallel_linear(blk["mlp"]["up"], ln2, tp_axis)
        x = x + row_parallel_linear(blk["mlp"]["down"], bloom_gelu(up), tp_axis)
    x = layer_norm(params["ln_f"], x, eps)
    return logits_fn(params, x[:, -1:], tp_axis)[:, 0], cache


def _ragged_extras(attention_mask, max_new_tokens: int, device):
    """Extend a LEFT-padded prompt mask with ones over the generated tail:
    the side input of ragged decode (the prompt must END at the last
    column; generated tokens are always valid). A right-padded mask would
    put the generated tail after the pad gap, so it raises. The check
    runs on host masks (numpy, lists, CPU tensors); a mask already on the
    card skips it, as the JAX function skips device arrays, to keep the
    call free of a device-to-host sync."""
    if isinstance(attention_mask, torch.Tensor):
        mask = attention_mask
        ends_valid = bool(mask[:, -1].all()) if mask.device.type == "cpu" else True
    else:
        host = np.asarray(attention_mask)
        ends_valid = bool(host[:, -1].all())
        mask = torch.from_numpy(np.ascontiguousarray(host))
    if not ends_valid:
        raise ValueError(
            "ragged generate expects a LEFT-padded attention_mask (HF "
            "generate convention): the last column must be all ones, but "
            "some rows end in padding. Re-tokenize with "
            "padding_side='left'."
        )
    mask = mask.to(device)
    ones = torch.ones((mask.shape[0], max_new_tokens), dtype=mask.dtype,
                      device=device)
    return {"mask": torch.cat([mask, ones], dim=1)}


def generate(params: dict, input_ids, config, max_new_tokens: int,
             temperature: float = 0.0, eos_token_id: Optional[int] = None,
             attention_mask=None, device="cuda",
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (``temperature=0``) or sampled decoding: (B, S) prompt ids ->
    (B, S + max_new_tokens) int64 on ``device``. ``eos_token_id``: finished
    rows emit eos from then on (HF generate's pad-with-eos).
    ``attention_mask`` (B, S) enables ragged LEFT-padded prompts.
    ``params`` must live on ``device``. ``temperature > 0`` draws every
    token from ``softmax(logits / temperature)`` (padded vocabulary
    masked) with ``generator``, a ``torch.Generator`` on ``device``; one
    seeded 0 when None (the JAX function's ``rng`` defaults to
    ``PRNGKey(0)``)."""
    from pipegoose_tpu_torch.models._decode import (
        autoregressive_generate,
        vocab_mask_for,
    )

    dev = _params_device(params, device)
    ids = _as_ids(input_ids, dev)
    extras = (_ragged_extras(attention_mask, max_new_tokens, dev)
              if attention_mask is not None else None)
    return autoregressive_generate(
        forward_cached, init_cache, params, ids, config,
        max_new_tokens, temperature, eos_token_id,
        logits_mask=vocab_mask_for(config), extras=extras, generator=generator)


def _params_device(params: dict, device) -> torch.device:
    dev = resolve_device(device)
    where = params["embed"]["weight"].device
    if where.type != dev.type:
        raise ValueError(f"params are on {where}, generate runs on {dev}")
    return dev


def _as_ids(input_ids, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(input_ids) if not isinstance(
        input_ids, torch.Tensor) else input_ids).to(dev, torch.int64)


def generate_tp(params: dict, input_ids, config, max_new_tokens: int,
                param_specs, tp_axis: str = "tensor",
                eos_token_id: Optional[int] = None, attention_mask=None,
                device="cuda") -> torch.Tensor:
    """Tensor-parallel greedy decoding over the current ``ParallelContext``:
    ``params`` is the WHOLE tree on ``device``, as the JAX function takes
    global arrays; each rank keeps its shard by ``param_specs``
    (``models.bloom.tp_specs``), runs :func:`forward_cached` under
    ``tp_axis`` over a cache of its heads and picks every token by the
    global argmax over the sharded vocabulary (``_decode.global_greedy_pick``;
    a padded vocabulary's slots never win). Returns the same (B, S + max_new_tokens) int64 ids on every
    rank. ``eos_token_id`` and ``attention_mask`` (ragged LEFT-padded
    prompts) as in :func:`generate`. Greedy only, as the JAX function."""
    from pipegoose_tpu_torch.models._decode import autoregressive_generate_sharded
    from pipegoose_tpu_torch.nn.parallel import shard_tree

    dev = _params_device(params, device)
    local_heads(config, tp_axis)
    local = shard_tree(params, param_specs)
    ids = _as_ids(input_ids, dev)
    extras = (_ragged_extras(attention_mask, max_new_tokens, dev)
              if attention_mask is not None else None)
    return autoregressive_generate_sharded(
        forward_cached, init_cache, local, ids, config, max_new_tokens,
        tp_axis, eos_token_id, extras=extras)
