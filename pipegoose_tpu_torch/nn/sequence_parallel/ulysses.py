"""Ulysses sequence parallelism (DeepSpeed): the counterpart of
``pipegoose_tpu/nn/sequence_parallel/ulysses.py``.

Where the ring keeps heads whole and rotates K/V, Ulysses re-shards:
activations enter sharded on the sequence, an ``all_to_all`` re-shards q,
k and v on heads so that each rank attends over the FULL sequence with
nh/sp heads, and a last ``all_to_all`` restores sequence sharding. With
``use_flash`` the full-sequence attention runs the flash kernels B1-B3
(``ops.flash_attention.flash_attention``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from pipegoose_tpu_torch.distributed.functional import (
    all_gather,
    all_to_all,
    axis_index,
    axis_size,
)


def ulysses_attention(q, k, v, axis_name: Optional[str], attn_fn: Callable):
    """seq-sharded -> head-sharded -> ``attn_fn`` -> seq-sharded.
    ``attn_fn(q, k, v) -> (B, S_full, nh_local, hd)`` is full-sequence
    attention on the local head subset (masks and bias applied inside)."""
    if axis_name is None:
        return attn_fn(q, k, v)

    def seq_to_heads(x):   # (B, S/sp, nh, hd) -> (B, S, nh/sp, hd)
        return all_to_all(x, axis_name, split_dim=2, concat_dim=1)

    out = attn_fn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v))
    return all_to_all(out, axis_name, split_dim=1, concat_dim=2)


def ulysses_causal_attention(
    q, k, v,                     # (B, S_local, nh | nkv, hd), positions applied
    axis_name: str,
    pad_mask_local: Optional[torch.Tensor] = None,    # (B, S_local)
    alibi_slopes: Optional[torch.Tensor] = None,      # (nh,) LOCAL head slopes
    window: Optional[int] = None,
    use_flash: bool = False,
    alibi_pos_local: Optional[torch.Tensor] = None,   # (B, S_local) mask-aware pos
):
    """Causal Ulysses attention: ALiBi slopes follow their heads through the
    exchange (rank r serves the r-th head subset), the mask and the
    mask-aware ALiBi positions are gathered over the full sequence. GQA:
    both head counts must divide by the axis size."""
    from pipegoose_tpu_torch.nn.sequence_parallel.ring_attention import (
        make_causal_alibi_bias_fn,
        ring_attention,
    )

    sp = axis_size(axis_name)
    nh, nkv = q.shape[2], k.shape[2]
    if nh % sp or nkv % sp:
        raise ValueError(
            f"ulysses needs local q heads {nh} AND kv heads {nkv} divisible by "
            f"the sequence axis size {sp}; use the ring variant (no head-count "
            f"constraint)")
    full_mask = (all_gather(pad_mask_local, axis_name, dim=1)
                 if pad_mask_local is not None else None)
    full_apos = (all_gather(alibi_pos_local, axis_name, dim=1)
                 if alibi_pos_local is not None else None)
    sub_slopes = None
    if alibi_slopes is not None:
        nh_sub = nh // sp
        sub_slopes = alibi_slopes[axis_index(axis_name) * nh_sub:][:nh_sub]

    def attn_fn(qh, kh, vh):   # full sequence, nh/sp q heads, nkv/sp kv heads
        b, s_full = qh.shape[:2]
        if use_flash:
            from pipegoose_tpu_torch.ops.flash_attention import (
                flash_attention,
                mask_to_kv_bias,
            )

            if full_apos is not None:
                kv_pos = full_apos
            else:   # plain global positions, the ring's ALiBi semantics
                kv_pos = torch.arange(s_full, dtype=torch.float32,
                                      device=qh.device)[None].expand(b, s_full)
            kv_neg = mask_to_kv_bias(full_mask)[1] if full_mask is not None else None
            return flash_attention(qh, kh, vh, alibi_slopes=sub_slopes,
                                   kv_pos=kv_pos, kv_neg=kv_neg, causal=True,
                                   window=window)
        bias_fn = make_causal_alibi_bias_fn(s_full, None, alibi_slopes=sub_slopes,
                                            window=window)
        side = (full_mask, full_apos) if full_apos is not None else full_mask
        return ring_attention(qh, kh, vh, None, bias_fn, kv_side=side)

    return ulysses_attention(q, k, v, axis_name, attn_fn)


def ulysses_bidirectional_attention(
    q, k, v,                     # (B, S_local, nh, hd)
    axis_name: str,
    pad_mask_local: Optional[torch.Tensor] = None,    # (B, S_local)
    use_flash: bool = False,
):
    """Encoder (bidirectional) Ulysses attention: the same exchange, no
    causal mask, key padding only; with ``use_flash`` the flash kernels
    with ``causal=False``."""
    from pipegoose_tpu_torch.nn.sequence_parallel.ring_attention import (
        make_bidirectional_bias_fn,
        ring_attention,
    )

    sp = axis_size(axis_name)
    nh = q.shape[2]
    if nh % sp:
        raise ValueError(
            f"ulysses needs local heads {nh} divisible by the sequence axis "
            f"size {sp}; use the ring variant (no head constraint)")
    full_mask = (all_gather(pad_mask_local, axis_name, dim=1)
                 if pad_mask_local is not None else None)

    def attn_fn(qh, kh, vh):
        if use_flash:
            from pipegoose_tpu_torch.ops.flash_attention import (
                flash_attention,
                mask_to_kv_bias,
            )

            kv_neg = mask_to_kv_bias(full_mask)[1] if full_mask is not None else None
            return flash_attention(qh, kh, vh, causal=False, kv_neg=kv_neg)
        return ring_attention(qh, kh, vh, None, make_bidirectional_bias_fn(),
                              kv_side=full_mask)

    return ulysses_attention(q, k, v, axis_name, attn_fn)
