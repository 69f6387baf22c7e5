"""Paged KV-cache pool: fixed-size pages + the page-table forward passes.

The counterpart of ``pipegoose_tpu/serving/kv_pool.py``. One pool per k
and v, ``(n_layer, num_pages, page_size, n_head, head_dim)``, from which
a sequence owns ``ceil(len / page_size)`` pages wired up by an integer
page table:

- :class:`PagePool`, the host-side allocator: a LIFO free list, so
  placement is a pure function of the request/evict order; page 0 is
  the NULL page that absorbs writes from padded slots and pad positions.
  Pages are refcounted (alloc / share / release), so the prefix cache
  (``serving/prefix_cache.py``) can point many requests at one page;
  :func:`copy_page` is the copy-on-write step for a shared page whose
  tail a new owner must write.
- :func:`paged_prefill_chunk` forwards a C-token chunk per row through
  the page tables (chunked prefill, and with ``all_logits=True`` the
  speculative verification); :func:`paged_decode_step` forwards one
  pending token per slot (with ``draft_layers`` the speculative draft);
  :func:`write_prompt_pages` scatters a monolithic prefill's contiguous
  cache (``models.generate.forward_cached``) into the pages. The two
  forwards read attention through ``ops.paged_attention``, whose keys
  keep logical positions ``w*ps + o`` whatever physical page holds them.

JAX donates the pools to its jitted steps; here the pools are updated IN
PLACE (``index_put_``), so the forward passes return only the logits.
Both run under ``torch.no_grad``: params that a trainer marked as
requiring grad are served without building an autograd graph.
``init_pages(kv_dtype="int8")`` makes each bank ``{"q": int8, "scale":
float32}``: writes quantize per (position, head), the attention read
dequantizes.

Under a tensor axis (``tp_axis``, over the current ``ParallelContext``)
each rank holds ``n_head / tp`` heads of every bank (``init_pages(tp=)``;
an int8 bank's scale plane shards with its heads), runs the kernel on its
heads with its slice of the ALiBi slopes, and returns its vocab shard of
the logits: pair them with ``models._decode.global_greedy_pick``. The page
tables, positions and tokens are the same on every rank.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch

from pipegoose_tpu_torch._device import resolve_device, true_div
from pipegoose_tpu_torch.models.bloom import _local_slopes, bloom_gelu, logits_fn
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
    of the submit/evict order. ``alloc`` hands out pages at refcount 1,
    ``share`` adds a reader, ``release`` drops one; a page returns to the
    free list when its last reference goes (``free`` is an alias of
    ``release``). The scheduler never lets a write land in a page with
    refcount > 1: copy-on-write duplicates it first.

    ``history`` keeps the most recent ``HISTORY_LIMIT`` (event, pages,
    refcount-delta) triples, in the JAX pool's order; ``history_dropped``
    counts the events the bounded ring has let go. ``ledger``, when set
    (``telemetry.memledger.MemoryLedger.bind``), observes every event with
    the ``owner`` its call passed (``("req", uid)``, ``("cow", uid)``,
    ``("cache",)``; None is untagged); no ledger (the default) costs one
    attribute read and a branch per event."""

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
        self.history_dropped = 0
        self.ledger = None

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

    @property
    def shared_count(self) -> int:
        """Pages currently referenced more than once."""
        return sum(1 for c in self._ref.values() if c > 1)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def fragmentation(self) -> float:
        """1 - (largest contiguous free run / free pages): 0.0 when the
        free space is one run, or empty. The page table makes it harmless
        for correctness; a rising value under sharing means mid-stream
        releases dice the LIFO stack."""
        if not self._free:
            return 0.0
        runs, best = 1, 1
        ordered = sorted(self._free)
        for a, b in zip(ordered, ordered[1:]):
            runs = runs + 1 if b == a + 1 else 1
            best = max(best, runs)
        return 1.0 - best / len(self._free)

    def _record(self, event: str, pages: Tuple[int, ...], delta: int,
                owner) -> None:
        """Ring the event (counting what the bounded ring drops) and feed
        the attached ledger with its owner."""
        if len(self.history) == self.history.maxlen:
            self.history_dropped += 1
        self.history.append((event, pages, delta))
        led = self.ledger
        if led is not None:
            led.on_pool_event(event, pages, owner)

    def alloc(self, n: int, owner=None) -> List[int]:
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
        self._record("alloc", tuple(pages), +1, owner)
        return pages

    def share(self, pages: List[int], owner=None) -> None:
        """Add one reference to each allocated page: a new reader (a
        prefix-cache hit, or the cache itself)."""
        for p in pages:
            if p not in self._ref:
                raise RuntimeError(f"sharing page {p} that is not allocated")
        for p in pages:
            self._ref[p] += 1
        self._record("share", tuple(pages), +1, owner)

    def release(self, pages: List[int], owner=None) -> None:
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
        self._record("release", tuple(pages), -1, owner)

    free = release


def init_pages(config, num_pages: int, page_size: int, tp: int = 1,
               kv_dtype: Optional[str] = None, device="cuda"):
    """The pool's k and v banks, zero-filled on ``device``: an fp pair in
    ``config.dtype``, or with ``kv_dtype="int8"`` two
    ``{"q": int8 (L, P, ps, nh, hd), "scale": float32 (L, P, ps, nh)}``.
    Under a tensor axis of size ``tp`` each rank's banks hold its
    ``nh = n_head / tp`` heads."""
    dev = resolve_device(device)
    kv_dtype = check_kv_dtype(kv_dtype)
    if config.n_head % tp:
        raise ValueError(f"n_head={config.n_head} not divisible by tp={tp}")
    shape = (config.n_layer, num_pages, page_size, config.n_head // tp,
             config.head_dim)
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


def _block(blk, h, kp, vp, dest_page, dest_off, page_table, start, slopes,
           qmask, config, tp_axis=None):
    """One transformer block of a paged forward: write this layer's k/v
    through the page table, attend through the kernel, then the MLP. Under
    ``tp_axis`` the banks and ``slopes`` (``models.bloom._local_slopes``)
    are this rank's heads, qkv and up column-parallel, out and down
    row-parallel."""
    b, c, _ = h.shape
    eps = config.layer_norm_epsilon
    ln1 = layer_norm(blk["ln_1"], h, eps)
    q, k, v = _qkv_proj(blk["attn"], ln1, config, tp_axis)
    _write_kv(kp, dest_page, dest_off, k)
    _write_kv(vp, dest_page, dest_off, v)
    ctx = paged_attention(q, kp, vp, page_table, start, slopes=slopes)
    if qmask is not None:
        ctx = ctx * qmask[:, :, None, None].to(ctx.dtype)
    ctx = ctx.to(h.dtype).reshape(b, c, -1)
    h = h + row_parallel_linear(blk["attn"]["out"], ctx, tp_axis)
    ln2 = layer_norm(blk["ln_2"], h, eps)
    up = column_parallel_linear(blk["mlp"]["up"], ln2, tp_axis)
    return h + row_parallel_linear(blk["mlp"]["down"], bloom_gelu(up), tp_axis)


def _embed(params, tokens, config, tp_axis=None):
    x = vocab_parallel_embedding(params["embed"], tokens, tp_axis).to(config.dtype)
    return layer_norm(params["embed_ln"], x, config.layer_norm_epsilon)


@torch.no_grad()
def copy_page(k_pages, v_pages, src: int, dst: int) -> None:
    """Copy-on-write: duplicate physical page ``src`` into ``dst`` across
    every layer's k and v planes, in place, one device copy per plane (an
    int8 bank copies its scale plane with the page, so the copy holds the
    values the readers of ``src`` dequantize). The prefix cache asks for
    it when a request's unique tail starts inside a shared page."""
    for bank in (k_pages, v_pages):
        planes = bank.values() if _is_quantized(bank) else (bank,)
        for plane in planes:
            plane[:, dst].copy_(plane[:, src])


@torch.no_grad()
def paged_decode_step(params, tokens, k_pages, v_pages, page_table, seq_lens,
                      config, tp_axis: Optional[str] = None, write_ok=None,
                      draft_layers: Optional[int] = None) -> torch.Tensor:
    """One decode step for every slot of the ragged active batch.

    ``tokens`` (B,) are the pending tokens, ``seq_lens`` (B,) int32 the
    tokens already cached per slot, i.e. the pending token's position.
    Each slot's k/v is written through its ``page_table`` (B, W) row at
    page ``seq_len // ps``, offset ``seq_len % ps``. Padded slots point
    every table entry at the NULL page. Updates the pools in place and
    returns the logits (B, V) in float32; under ``tp_axis`` this rank's
    vocab shard (B, V/tp).

    Self-speculative drafting: ``write_ok`` (B,) bool sends a row's k/v
    write to the NULL page, offset 0, where False; ``draft_layers=k``
    runs only the first k blocks over the first k layer banks, then the
    final LN and the tied head (the shallow-exit draft that shares every
    weight with the verifier)."""
    ps = page_size_of(k_pages)
    x = _embed(params, tokens[:, None], config, tp_axis)
    seq = seq_lens.long()[:, None]                    # (B, 1): one write per row
    idx, off = seq // ps, seq % ps
    if write_ok is not None:
        # a row held back may sit past its table: look up entry 0 instead
        ok = write_ok.bool()[:, None]
        idx, off = torch.where(ok, idx, 0), torch.where(ok, off, 0)
    phys = torch.gather(page_table.long(), 1, idx)
    if write_ok is not None:
        phys = torch.where(ok, phys, NULL_PAGE)
    slopes = _local_slopes(config, tp_axis, x.device)
    blocks = params["blocks"]
    if draft_layers is not None:
        blocks = blocks[:draft_layers]
    for i, blk in enumerate(blocks):
        x = _block(blk, x, layer_bank(k_pages, i), layer_bank(v_pages, i),
                   phys, off, page_table, seq_lens, slopes, None, config, tp_axis)
    x = layer_norm(params["ln_f"], x, config.layer_norm_epsilon)
    return logits_fn(params, x, tp_axis)[:, 0]


@torch.no_grad()
def paged_prefill_chunk(params, tokens, k_pages, v_pages, page_table, start,
                        n_valid, config, tp_axis: Optional[str] = None,
                        all_logits: bool = False) -> torch.Tensor:
    """Forward one CHUNK of C tokens per row straight through the pool.

    ``tokens`` (B, C) are each row's next prompt tokens, ``start`` (B,)
    int32 the logical position of the row's first chunk token (tokens
    already cached, written by earlier chunks or shared from the prefix
    cache), ``n_valid`` (B,) how many of the C are real. Valid tokens'
    k/v are written through the row's page table; pad tails write to the
    NULL page and get zero context. Attention is causal over the global
    position, with the same ALiBi bias as the decode step, so chunk
    boundaries are invisible in the math. Updates the pools in place and
    returns float32 logits at each row's last valid position, (B, V), or
    with ``all_logits=True`` at every chunk position, (B, C, V): the
    speculative verification scores a whole draft bundle in one pass.
    Under ``tp_axis`` V is this rank's vocab shard, V/tp."""
    b, c = tokens.shape
    ps = page_size_of(k_pages)
    x = _embed(params, tokens, config, tp_axis)
    dev = x.device
    pos = start.long()[:, None] + torch.arange(c, device=dev)[None, :]   # (B, C)
    valid = torch.arange(c, device=dev)[None, :] < n_valid.long()[:, None]
    dest_page = torch.where(
        valid, torch.gather(page_table.long(), 1, torch.where(valid, pos // ps, 0)),
        NULL_PAGE)
    dest_off = torch.where(valid, pos % ps, 0)
    slopes = _local_slopes(config, tp_axis, dev)
    for i, blk in enumerate(params["blocks"]):
        x = _block(blk, x, layer_bank(k_pages, i), layer_bank(v_pages, i),
                   dest_page, dest_off, page_table, start, slopes, valid, config,
                   tp_axis)
    x = layer_norm(params["ln_f"], x, config.layer_norm_epsilon)
    if all_logits:
        return logits_fn(params, x, tp_axis)
    last = (n_valid.long() - 1)[:, None, None].expand(b, 1, x.shape[-1])
    return logits_fn(params, torch.gather(x, 1, last), tp_axis)[:, 0]
