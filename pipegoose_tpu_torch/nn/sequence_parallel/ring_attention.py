"""Ring attention: exact attention over a sequence-sharded axis.

The counterpart of ``pipegoose_tpu/nn/sequence_parallel/ring_attention.py``.
Each rank holds a (B, S/sp, ...) chunk of Q, K and V; sp ring steps attend
the local queries against the resident K/V chunk with an online softmax and
pass K/V one hop to the right (``shift_right``), so every rank sees every
chunk once. The last step skips its rotation.

- :func:`ring_attention` computes each step with dense math and an additive
  bias from ``bias_fn``; its backward is autograd through the loop and the
  differentiable shifts.
- :func:`ring_flash_attention` runs each forward step in the chunk kernel
  B7 (``ops.flash_attention.flash_ring_chunk``) and owns its backward
  (``_RingFlash``): a second ring with B8 and B9 from the final logsumexp,
  whose dK/dV accumulators ride with their chunk back home. It saves q, k,
  v, out and lse only, no per-step state.

At sp = 1 (or ``axis_name=None``) neither runs a collective.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from pipegoose_tpu_torch.distributed.functional import axis_index, axis_size, shift_right

NEG_INF = -1e9


def _ring_scan(chunk_fn, state, k, v, kv_side, axis_name):
    """Apply ``chunk_fn(state, k_t, v_t, kv_rank, side_t) -> state`` to the
    resident K/V chunk, rotate K/V and the side data one hop, sp times; the
    last chunk skips the rotation (a dead K+V transfer per layer)."""
    sp, rank = axis_size(axis_name), axis_index(axis_name)
    for t in range(sp):
        state = chunk_fn(state, k, v, (rank - t) % sp, kv_side)
        if t < sp - 1:
            k, v, kv_side = shift_right((k, v, kv_side), axis_name)
    return state


def ring_attention(
    q: torch.Tensor,   # (B, Sq_local, nh, hd)
    k: torch.Tensor,   # (B, Skv_local, nh | nkv, hd): fewer kv heads = GQA
    v: torch.Tensor,
    axis_name: Optional[str],
    bias_fn: Callable,
    kv_side=None,      # e.g. the (B, Skv_local) pad mask, rides the ring
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact softmax(QKᵀ * scale + bias) V with K/V ring rotation, in
    float32 math, returned in q's dtype.

    ``bias_fn(kv_rank[, kv_side_block]) -> (B|1, nh|1, Sq, Skv)`` is the
    additive bias of the block whose K/V originated at ``kv_rank``. Under
    GQA (``nh = g * nkv``, query head h reading kv head h // g) only the
    nkv-headed K/V rides the ring."""
    b, sq, nh, hd = q.shape
    nkv = k.shape[2]
    if nh % nkv:
        raise ValueError(f"n_head={nh} must be a multiple of n_kv_head={nkv}")
    g = nh // nkv
    if scale is None:
        scale = hd ** -0.5
    qf = q.float() * scale

    def block(state, k_t, v_t, kv_rank, side_t):
        m, l, o = state
        skv = k_t.shape[1]
        if g == 1:
            s = torch.einsum("bqhd,bkhd->bhqk", qf, k_t.float())
        else:
            qg = qf.reshape(b, sq, nkv, g, hd)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_t.float()).reshape(b, nh, sq, skv)
        bias = bias_fn(kv_rank, side_t) if side_t is not None else bias_fn(kv_rank)
        s = s + bias.to(s.device)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        if g == 1:
            pv = torch.einsum("bhqk,bkhd->bhqd", p, v_t.float())
        else:
            pg = p.reshape(b, nkv, g, sq, skv)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", pg, v_t.float()).reshape(b, nh, sq, hd)
        return m_new, l_new, o * alpha[..., None] + pv

    f32 = dict(dtype=torch.float32, device=q.device)
    state0 = (torch.full((b, nh, sq), NEG_INF, **f32), torch.zeros((b, nh, sq), **f32),
              torch.zeros((b, nh, sq, hd), **f32))
    m, l, o = _ring_scan(block, state0, k, v, kv_side, axis_name)
    out = o / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_flash_attention(
    q: torch.Tensor,   # (B, S_local, nh, hd)
    k: torch.Tensor,   # (B, S_local, nh | nkv, hd)
    v: torch.Tensor,
    axis_name: Optional[str],
    alibi_slopes: Optional[torch.Tensor] = None,   # (nh,)
    kv_side: Optional[torch.Tensor] = None,        # (B, S_local) pad mask
    scale: Optional[float] = None,
    alibi_pos: Optional[torch.Tensor] = None,      # (B, S_local) global positions
) -> torch.Tensor:
    """Ring attention through the chunk kernels, forward and backward;
    differentiable in q, k and v. Semantics of ``ring_attention`` with
    ``make_causal_alibi_bias_fn``: causal on global positions, ALiBi slope
    times the global key position, padding from the chunk's mask.

    ``alibi_pos``: mask-aware global key positions (BLOOM's
    ``(cumsum(mask)-1)*mask`` over the full sequence, ``models.bloom.
    _sp_alibi_pos``), for left-padded batches. The kernels keep plain
    positions for the causal test; the correction ``slope * (alibi_pos -
    plain_pos)`` folds into the per-head key bias. It needs n_head ==
    n_kv_head. The JAX function's ``interpret`` flag has no counterpart:
    CPU tensors take the kernels' plain versions."""
    b, s_local, nh, hd = q.shape
    nkv = k.shape[2]
    if nh % nkv:
        raise ValueError(f"n_head={nh} must be a multiple of n_kv_head={nkv}")
    g = nh // nkv
    if alibi_pos is not None and g != 1:
        raise ValueError("alibi_pos requires n_head == n_kv_head (g == 1)")
    if scale is None:
        scale = hd ** -0.5
    dev = q.device
    if alibi_slopes is None:
        alibi_slopes = torch.zeros((nh,), dtype=torch.float32, device=dev)

    def flat(x):
        return x.transpose(1, 2).reshape(b * x.shape[2], s_local, hd).contiguous()

    slopes = alibi_slopes.float()[None].expand(b, nh).reshape(b * nh).contiguous()
    if kv_side is not None:
        kneg = (1.0 - kv_side.float()) * NEG_INF
    else:
        kneg = torch.zeros((b, s_local), dtype=torch.float32, device=dev)
    apos = None if alibi_pos is None else alibi_pos.float()
    out = _RingFlash.apply(flat(q), flat(k), flat(v), slopes, kneg, apos,
                           axis_name, float(scale), g)
    return out.reshape(b, nh, s_local, hd).transpose(1, 2).to(q.dtype)


def _ring_positions(axis_name, bh, s_local, device):
    rank = axis_index(axis_name)
    pos = rank * s_local + torch.arange(s_local, dtype=torch.float32, device=device)
    return pos[None].expand(bh, s_local).contiguous()


def _kpos_for(kv_rank, bh, s_local, device):
    pos = (kv_rank * s_local + torch.arange(s_local, device=device)).float()
    return pos[None].expand(bh, s_local).contiguous()


def _expand_heads(x_b, bh):
    """(B, S) per-batch array -> (B*nh, S) for the flat kernel layout."""
    b, s = x_b.shape
    return x_b[:, None, :].expand(b, bh // b, s).reshape(bh, s).contiguous()


def _key_bias(kneg_t, apos_t, slopes, kv_rank, bkv, s_local):
    """Per-head additive key bias of one chunk: the padding NEG_INF plus,
    when mask-aware ALiBi positions ride the ring, ``slope * (alibi_pos -
    plain_pos)`` (the kernel adds ``slope * plain_pos`` itself)."""
    kb = _expand_heads(kneg_t, bkv)
    if apos_t is not None:
        kpos = _kpos_for(kv_rank, bkv, s_local, kb.device)
        kb = kb + slopes[:, None] * (_expand_heads(apos_t, bkv) - kpos)
    return kb


def _ring_flash_fwd_pass(q, k, v, slopes, kneg, apos, axis_name, scale, g):
    from pipegoose_tpu_torch.ops.flash_attention import flash_ring_chunk

    bh, s_local, hd = q.shape
    bkv = k.shape[0]
    qpos = _ring_positions(axis_name, bh, s_local, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    state0 = (torch.full((bh, s_local), NEG_INF, **f32),
              torch.zeros((bh, s_local), **f32), torch.zeros((bh, s_local, hd), **f32))

    def chunk(state, k_t, v_t, kv_rank, side_t):
        kneg_t, apos_t = side_t
        return flash_ring_chunk(
            q, k_t, v_t, slopes, qpos, _kpos_for(kv_rank, bkv, s_local, q.device),
            _key_bias(kneg_t, apos_t, slopes, kv_rank, bkv, s_local), *state, scale, g)

    # the (kneg, apos) pair rides the ring with K/V, in one batch of transfers
    m, l, acc = _ring_scan(chunk, state0, k, v, (kneg, apos), axis_name)
    l = torch.clamp_min(l, 1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    return out, m + torch.log(l)


class _RingFlash(torch.autograd.Function):
    """The ``_ring_flash`` custom_vjp. Forward: the B7 ring; saves q, k, v,
    out and lse (and the slopes and key-bias inputs). Backward: the second
    ring. Each step adds this chunk's dQ (B8) locally and its dK/dV (B9,
    summed over each GQA group) into accumulators that ride the ring with
    their chunk; the last step ships only the accumulators home."""

    @staticmethod
    def forward(ctx, q, k, v, slopes, kneg, apos, axis_name, scale, g):
        out, lse = _ring_flash_fwd_pass(q, k, v, slopes, kneg, apos, axis_name,
                                        scale, g)
        ctx.save_for_backward(q, k, v, slopes, kneg, apos, out, lse)
        ctx.args = (axis_name, scale, g)
        return out

    @staticmethod
    def backward(ctx, dout):
        from pipegoose_tpu_torch.ops.flash_attention import flash_chunk_dkv, flash_chunk_dq

        q, k, v, slopes, kneg, apos, out, lse = ctx.saved_tensors
        axis_name, scale, g = ctx.args
        bh, s_local, hd = q.shape
        bkv = k.shape[0]
        sp, rank = axis_size(axis_name), axis_index(axis_name)
        qpos = _ring_positions(axis_name, bh, s_local, q.device)
        dout = dout.to(q.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)

        def contributions(dq, dk, dv, k_t, v_t, side_t, t):
            kneg_t, apos_t = side_t
            kv_rank = (rank - t) % sp
            kpos = _kpos_for(kv_rank, bkv, s_local, q.device)
            kneg_h = _key_bias(kneg_t, apos_t, slopes, kv_rank, bkv, s_local)
            args = (q, k_t, v_t, dout, lse, delta, slopes, qpos, kpos, kneg_h, scale, g)
            dq = dq + flash_chunk_dq(*args)
            dkc, dvc = flash_chunk_dkv(*args)
            if g > 1:   # per-query-head contributions -> the shared kv rows
                dkc = dkc.reshape(-1, g, s_local, hd).sum(dim=1)
                dvc = dvc.reshape(-1, g, s_local, hd).sum(dim=1)
            return dq, dk + dkc, dv + dvc

        f32 = dict(dtype=torch.float32, device=q.device)
        dq = torch.zeros((bh, s_local, hd), **f32)
        dk = torch.zeros((bkv, s_local, hd), **f32)
        dv = torch.zeros((bkv, s_local, hd), **f32)
        k_t, v_t, side_t = k, v, (kneg, apos)
        for t in range(sp):
            dq, dk, dv = contributions(dq, dk, dv, k_t, v_t, side_t, t)
            if t < sp - 1:
                k_t, v_t, side_t, dk, dv = shift_right((k_t, v_t, side_t, dk, dv),
                                                       axis_name)
            elif sp > 1:
                dk, dv = shift_right((dk, dv), axis_name)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def make_causal_alibi_bias_fn(
    seq_local: int,
    axis_name: Optional[str],
    alibi_slopes: Optional[torch.Tensor] = None,   # (nh,)
    q_rank: Optional[int] = None,
    window: Optional[int] = None,
):
    """Block bias under sequence sharding: causal on global positions (and
    an optional sliding window, Mistral semantics), ALiBi (omit the slopes
    for RoPE families) and the K/V chunk's padding, its mask riding the
    ring as ``kv_side``. For left-padded batches pass ``kv_side`` as the
    pair ``(mask, alibi_pos)`` of global mask-aware positions; the slope
    then multiplies those instead of the plain global key position."""
    rank = q_rank if q_rank is not None else axis_index(axis_name)
    q_pos = rank * seq_local + torch.arange(seq_local)

    def bias_fn(kv_rank, kv_side=None):
        if isinstance(kv_side, tuple):
            kv_pad_mask, apos = kv_side
        else:
            kv_pad_mask, apos = kv_side, None
        dev = kv_pad_mask.device if kv_pad_mask is not None else (
            alibi_slopes.device if alibi_slopes is not None else None)
        qp = q_pos.to(dev)
        kv_pos = kv_rank * seq_local + torch.arange(seq_local, device=dev)
        keep = qp[:, None] >= kv_pos[None, :]
        if window is not None:
            keep = keep & (qp[:, None] - kv_pos[None, :] < window)
        bias = torch.where(keep, 0.0, NEG_INF)[None, None]
        if alibi_slopes is not None:
            akp = (apos[:, None, None, :] if apos is not None
                   else kv_pos[None, None, None, :]).float()
            bias = bias + alibi_slopes[None, :, None, None] * akp
        if kv_pad_mask is not None:
            keep_pad = kv_pad_mask[:, None, None, :] > 0
            bias = bias + torch.where(keep_pad, 0.0, NEG_INF)
        return bias

    return bias_fn


def make_bidirectional_bias_fn():
    """Block bias for encoder attention under sequence sharding: no causal
    mask, only the key padding of the K/V chunk's mask riding the ring as
    ``kv_side``; ``kv_rank`` is accepted for the driver and unused."""

    def bias_fn(kv_rank, kv_side=None):
        del kv_rank
        if kv_side is None:
            return torch.zeros((1, 1, 1, 1), dtype=torch.float32)
        keep = kv_side[:, None, None, :] > 0
        return torch.where(keep, 0.0, NEG_INF)

    return bias_fn
