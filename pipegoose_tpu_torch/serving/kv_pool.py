"""Paged KV-cache pool: fixed-size pages + the page-table forward passes.

The counterpart of ``pipegoose_tpu/serving/kv_pool.py``. One pool per k
and v, ``(n_layer, num_pages, page_size, n_head, head_dim)``, from which
a sequence owns ``ceil(len / page_size)`` pages wired up by an integer
page table:

- :class:`PagePool`, the host-side allocator: a LIFO free list, so
  placement is a pure function of the request/evict order; page 0 is
  the NULL page that absorbs writes from padded slots and pad positions.
- :func:`paged_prefill_chunk` forwards a C-token chunk per row through
  the page tables; :func:`paged_decode_step` forwards one pending token
  per slot; :func:`write_prompt_pages` scatters a monolithic prefill's
  contiguous cache (``models.generate.forward_cached``) into the pages. Both read attention through ``ops.paged_attention``, whose
  keys keep logical positions ``w*ps + o`` whatever physical page holds
  them.

JAX donates the pools to its jitted steps; here the pools are updated IN
PLACE (``index_put_``), so the forward passes return only the logits.
Both run under ``torch.no_grad``: params that a trainer marked as
requiring grad are served without building an autograd graph.
``init_pages(kv_dtype="int8")`` makes each bank ``{"q": int8, "scale":
float32}``: writes quantize per (position, head), the attention read
dequantizes.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch

from pipegoose_tpu_torch._device import resolve_device, true_div
from pipegoose_tpu_torch.models.bloom import alibi_slopes, bloom_gelu, logits_fn
from pipegoose_tpu_torch.models.generate import _qkv_proj
from pipegoose_tpu_torch.nn.tensor_parallel.layers import (
    column_parallel_linear,
    layer_norm,
    row_parallel_linear,
    vocab_parallel_embedding,
)
from pipegoose_tpu_torch.ops.paged_attention import paged_attention

NULL_PAGE = 0

KV_DTYPES = (None, "fp", "int8")

_KV_INT8_MAX = 127.0

HISTORY_LIMIT = 1024   # pool events kept in PagePool.history


def check_kv_dtype(kv_dtype: Optional[str]) -> Optional[str]:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                         f"{kv_dtype!r}")
    return None if kv_dtype == "fp" else kv_dtype


def quantize_kv(x: torch.Tensor):
    """fp (..., hd) -> (int8 (..., hd), float32 scale (...,)): symmetric
    max-abs per position per head over the head dim, the same on the card
    as on the CPU (``true_div``). ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    x32 = x.float()
    scale = torch.clamp_min(true_div(x32.abs().amax(dim=-1), _KV_INT8_MAX),
                            torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(x32 / scale[..., None]),
                    -_KV_INT8_MAX, _KV_INT8_MAX).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def _is_quantized(pages) -> bool:
    return isinstance(pages, dict)


class PagePool:
    """Refcounted free-list allocator over ``num_pages`` fixed-size KV pages.

    Page 0 is the NULL page, never handed out. The free list is a LIFO
    stack, so the physical placement of any workload is a pure function
    of the submit/evict order. ``history`` keeps the most recent
    (event, pages, refcount-delta) triples, bounded so a long-lived
    engine never grows host memory per request."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the null page)")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}   # page -> refcount (allocated only)
        self.history: Deque[Tuple[str, Tuple[int, ...], int]] = deque(
            maxlen=HISTORY_LIMIT)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_pages - 1 - len(self._free)

    @property
    def capacity(self) -> int:
        """Allocatable pages (the null page is not allocatable)."""
        return self.num_pages - 1

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: requested {n}, free {len(self._free)} "
                f"of {self.capacity} (admission control should prevent this)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            if p == NULL_PAGE or p in self._ref:
                raise RuntimeError(f"allocator invariant broken: page {p} "
                                   f"double-allocated or null")
            self._ref[p] = 1
        self.history.append(("alloc", tuple(pages), +1))
        return pages

    def release(self, pages: List[int]) -> None:
        """Drop one reference per page; pages reaching refcount 0 return
        to the free list (LIFO)."""
        for p in pages:
            if p not in self._ref:
                raise RuntimeError(f"freeing page {p} that is not allocated")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                self._free.append(p)
        self.history.append(("release", tuple(pages), -1))


def init_pages(config, num_pages: int, page_size: int,
               kv_dtype: Optional[str] = None, device="cuda"):
    """The pool's k and v banks, zero-filled on ``device``: an fp pair in
    ``config.dtype``, or with ``kv_dtype="int8"`` two
    ``{"q": int8 (L, P, ps, nh, hd), "scale": float32 (L, P, ps, nh)}``."""
    dev = resolve_device(device)
    kv_dtype = check_kv_dtype(kv_dtype)
    shape = (config.n_layer, num_pages, page_size, config.n_head, config.head_dim)
    if kv_dtype is None:
        return (torch.zeros(shape, dtype=config.dtype, device=dev),
                torch.zeros(shape, dtype=config.dtype, device=dev))

    def bank():
        return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                "scale": torch.zeros(shape[:-1], dtype=torch.float32, device=dev)}

    return bank(), bank()


def layer_bank(pages, layer: int):
    """One layer's bank (a view) of an fp or int8 pool."""
    if _is_quantized(pages):
        return {"q": pages["q"][layer], "scale": pages["scale"][layer]}
    return pages[layer]


def _gather(arr: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, ps, ...) indexed by a (B, W) table -> (B, W*ps, ...)."""
    b, w = page_table.shape
    view = arr[page_table.long()]                 # (B, W, ps, ...)
    return view.reshape(b, w * arr.shape[1], *arr.shape[2:])


def gather_pages(pages, page_table: torch.Tensor) -> torch.Tensor:
    """Read ONE layer's bank through a page table: (B, W) -> the per-slot
    contiguous view (B, W * page_size, nh, hd). An int8 bank dequantizes
    here, per (position, head)."""
    if _is_quantized(pages):
        return dequantize_kv(_gather(pages["q"], page_table),
                             _gather(pages["scale"], page_table))
    return _gather(pages, page_table)


def page_size_of(pages) -> int:
    """page_size of an (L, P, ps, nh, hd) pool, fp or int8."""
    leaf = pages["q"] if _is_quantized(pages) else pages
    return leaf.shape[-3]


def _write_kv(pages, page_idx: torch.Tensor, off_idx: torch.Tensor,
              val: torch.Tensor) -> None:
    """Scatter fp values ``val`` at (page_idx, off_idx) of one layer's bank,
    in place, quantizing on write when the bank is int8 (value and scale
    plane in lockstep). Pad writes all land on the NULL page, whose
    contents are garbage by contract."""
    idx = (page_idx.long(), off_idx.long())
    if _is_quantized(pages):
        q, s = quantize_kv(val)
        pages["q"].index_put_(idx, q)
        pages["scale"].index_put_(idx, s)
    else:
        pages.index_put_(idx, val.to(pages.dtype))


@torch.no_grad()
def write_prompt_pages(k_pages, v_pages, cache: dict, phys_pages: torch.Tensor,
                       pad: int, page_size: int) -> None:
    """Scatter a prefill's contiguous cache into the pool, in place.

    ``cache`` is ``forward_cached``'s (L, 1, S_pad, nh, hd) pair holding a
    LEFT-padded prompt (``pad`` pad slots, then the prompt); logical
    prompt position p lands in page ``phys_pages[p // page_size]`` at
    offset ``p % page_size``, so decode sees the unpadded 0..len-1
    layout. Pad positions go to the NULL page. ``phys_pages`` is the
    slot's page-table row. An int8 pool quantizes on write."""
    k_seq, v_seq = cache["k"][:, 0], cache["v"][:, 0]     # (L, S_pad, nh, hd)
    dev = k_seq.device
    logical = torch.arange(k_seq.shape[1], device=dev) - pad
    valid = logical >= 0
    lclip = torch.where(valid, logical, 0)
    dest_page = torch.where(valid, phys_pages.long()[lclip // page_size], NULL_PAGE)
    dest_off = torch.where(valid, lclip % page_size, 0)

    def scatter(pages, seq):
        if _is_quantized(pages):
            q, s = quantize_kv(seq)
            pages["q"][:, dest_page, dest_off] = q
            pages["scale"][:, dest_page, dest_off] = s
        else:
            pages[:, dest_page, dest_off] = seq.to(pages.dtype)

    scatter(k_pages, k_seq)
    scatter(v_pages, v_seq)


def _local_slopes(config, device) -> torch.Tensor:
    """ALiBi slopes of every head (the port runs at tp=1)."""
    return torch.from_numpy(alibi_slopes(config.n_head)).to(device)


def _block(blk, h, kp, vp, dest_page, dest_off, page_table, start, slopes,
           qmask, config):
    """One transformer block of a paged forward: write this layer's k/v
    through the page table, attend through the kernel, then the MLP."""
    b, c, _ = h.shape
    eps = config.layer_norm_epsilon
    ln1 = layer_norm(blk["ln_1"], h, eps)
    q, k, v = _qkv_proj(blk["attn"], ln1, config)
    _write_kv(kp, dest_page, dest_off, k)
    _write_kv(vp, dest_page, dest_off, v)
    ctx = paged_attention(q, kp, vp, page_table, start, slopes=slopes)
    if qmask is not None:
        ctx = ctx * qmask[:, :, None, None].to(ctx.dtype)
    ctx = ctx.to(h.dtype).reshape(b, c, -1)
    h = h + row_parallel_linear(blk["attn"]["out"], ctx)
    ln2 = layer_norm(blk["ln_2"], h, eps)
    up = column_parallel_linear(blk["mlp"]["up"], ln2)
    return h + row_parallel_linear(blk["mlp"]["down"], bloom_gelu(up))


def _embed(params, tokens, config):
    x = vocab_parallel_embedding(params["embed"], tokens).to(config.dtype)
    return layer_norm(params["embed_ln"], x, config.layer_norm_epsilon)


@torch.no_grad()
def paged_decode_step(params, tokens, k_pages, v_pages, page_table, seq_lens,
                      config) -> torch.Tensor:
    """One decode step for every slot of the ragged active batch.

    ``tokens`` (B,) are the pending tokens, ``seq_lens`` (B,) int32 the
    tokens already cached per slot, i.e. the pending token's position.
    Each slot's k/v is written through its ``page_table`` (B, W) row at
    page ``seq_len // ps``, offset ``seq_len % ps``. Padded slots point
    every table entry at the NULL page. Updates the pools in place and
    returns the logits (B, V) in float32."""
    ps = page_size_of(k_pages)
    x = _embed(params, tokens[:, None], config)
    seq = seq_lens.long()[:, None]                    # (B, 1): one write per row
    phys = torch.gather(page_table.long(), 1, seq // ps)
    off = seq % ps
    slopes = _local_slopes(config, x.device)
    for i, blk in enumerate(params["blocks"]):
        x = _block(blk, x, layer_bank(k_pages, i), layer_bank(v_pages, i),
                   phys, off, page_table, seq_lens, slopes, None, config)
    x = layer_norm(params["ln_f"], x, config.layer_norm_epsilon)
    return logits_fn(params, x)[:, 0]


@torch.no_grad()
def paged_prefill_chunk(params, tokens, k_pages, v_pages, page_table, start,
                        n_valid, config) -> torch.Tensor:
    """Forward one CHUNK of C tokens per row straight through the pool.

    ``tokens`` (B, C) are each row's next prompt tokens, ``start`` (B,)
    int32 the logical position of the row's first chunk token, ``n_valid``
    (B,) how many of the C are real. Valid tokens' k/v are written through
    the row's page table; pad tails write to the NULL page and get zero
    context. Attention is causal over the global position, with the same
    ALiBi bias as the decode step, so chunk boundaries are invisible in
    the math. Updates the pools in place and returns float32 logits at
    each row's last valid position, (B, V)."""
    b, c = tokens.shape
    ps = page_size_of(k_pages)
    x = _embed(params, tokens, config)
    dev = x.device
    pos = start.long()[:, None] + torch.arange(c, device=dev)[None, :]   # (B, C)
    valid = torch.arange(c, device=dev)[None, :] < n_valid.long()[:, None]
    dest_page = torch.where(
        valid, torch.gather(page_table.long(), 1, torch.where(valid, pos // ps, 0)),
        NULL_PAGE)
    dest_off = torch.where(valid, pos % ps, 0)
    slopes = _local_slopes(config, dev)
    for i, blk in enumerate(params["blocks"]):
        x = _block(blk, x, layer_bank(k_pages, i), layer_bank(v_pages, i),
                   dest_page, dest_off, page_table, start, slopes, valid, config)
    x = layer_norm(params["ln_f"], x, config.layer_norm_epsilon)
    last = (n_valid.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
    return logits_fn(params, torch.gather(x, 1, last))[:, 0]
