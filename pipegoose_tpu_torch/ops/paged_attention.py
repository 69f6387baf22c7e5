"""Paged attention: a ragged C-query attention that walks the page table.

The counterpart of ``pipegoose_tpu/ops/paged_attention.py``. ``q`` is
(B, C, nh, hd) and row ``b``'s query ``c`` sits at GLOBAL position
``start[b] + c``. A key at logical position ``w*ps + o`` (whatever
physical page the table maps it to) is kept iff ``key_pos <= q_pos``:
one mask for causality, unwritten offsets, stale tails of a page's
previous owner and NULL-page garbage. C=1 with ``start=seq_lens`` is the
decode step; C>1 is a prefill chunk. Pad queries produce rows that the
caller zeroes with its qmask.

Two implementations of one function:

- :func:`paged_attention_reference`, the plain PyTorch version: gather the
  page view, then attend (the JAX ``paged_attention_reference``);
- :func:`paged_attention`, the wrapper: on CPU tensors it calls the plain
  version, on CUDA tensors it launches the hand-written kernel
  ``csrc/paged_attention.cu`` or raises. There is no fallback between
  the two.

The kernel has two routes, one launch a call (:func:`paged_plan`): float32
FMAs with each (row, head) context split over warps and the blocks of a
thread-block cluster (decode, and float32 q or pages at every C), and bf16
tensor cores for bf16 q with bf16 or int8 pages at C >= 16 (chunked
prefill).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from pipegoose_tpu_torch.models.bloom import NEG_INF
from pipegoose_tpu_torch.models.generate import _attn_core
from pipegoose_tpu_torch.ops import _build

SMEM_LIMIT_BYTES = 232448   # opt-in dynamic shared memory of one H100 block
SM_COUNT = 132              # H100 SXM streaming multiprocessors
HEAD_DIMS = (32, 64, 128)   # head_dim values the source instantiates
WARPS = 4                   # warps a block, both routes (kThreads / 32)
MMA_MIN_QUERIES = 16        # C from which bf16 q takes the tensor cores
MMA_QUERY_TILE = 64         # queries a tensor-core block (kQT)
MMA_KEY_TILE = 64           # keys a staged tile (kKT)
MAX_SPLITS = 8              # blocks of one cluster (kMaxSplits)
FILL_BLOCKS = SM_COUNT      # blocks a call aims for before it splits keys
MIN_SPLIT_KEYS = {"fma": 8 * WARPS, "mma": MMA_KEY_TILE}   # keys a split at least

_DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}


def _is_quantized(pages) -> bool:
    return isinstance(pages, dict)


def paged_route(n_queries: int, q_dtype, page_dtype) -> str:
    """"mma" (bf16 tensor cores) for bf16 q with bf16 or int8 pages and at
    least MMA_MIN_QUERIES queries; "fma" (float32 FMAs) otherwise: decode,
    and float32 q or float32 pages at every C, so the float32 engine never
    rounds an operand to bf16."""
    if (n_queries >= MMA_MIN_QUERIES and q_dtype == torch.bfloat16
            and page_dtype in (torch.bfloat16, torch.int8)):
        return "mma"
    return "fma"


def paged_tile_geometry(page_size: int, head_dim: int, n_queries: int, *,
                        route: str = "fma", page_bytes: int = 2) -> dict:
    """One block of the kernel: its queries, warps and shared memory.

    - "fma": 1 query a block at C = 1, else 4; shared memory holds each
      warp's (m, l, acc) per query and the block's merged state.
    - "mma": 64 queries a block, 16 a warp; shared memory holds a
      two-deep ring of (64-key K tile, V tile[, their scales]) at the
      pages' own width with 16-byte row padding, for int8 the tile
      converted to bf16, and after the key walk each query's state.

    Keys are addressed by logical position, so the size depends on
    head_dim, not on page_size; ``fits`` is False for a head_dim the
    source does not instantiate or a page_size below 1."""
    if route == "mma":
        qt = MMA_QUERY_TILE
        int8 = page_bytes == 1
        stage = 2 * MMA_KEY_TILE * (head_dim * page_bytes + 16) + (
            2 * MMA_KEY_TILE * 4 if int8 else 0)
        conv = 2 * MMA_KEY_TILE * (head_dim * 2 + 16) if int8 else 0
        smem = max(2 * stage + conv, qt * (head_dim + 2) * 4)
    elif route == "fma":
        qt = 1 if n_queries == 1 else 4
        smem = (WARPS + 1) * qt * (head_dim + 2) * 4
    else:
        raise ValueError(f"unknown paged attention route {route!r}")
    fits = (head_dim in HEAD_DIMS and page_size >= 1
            and smem <= SMEM_LIMIT_BYTES)
    return {"route": route, "query_tile": qt, "warps": WARPS,
            "smem_bytes": smem, "fits": fits}


def check_paged_tile(page_size: int, head_dim: int, n_queries: int, *,
                     route: str = "fma", page_bytes: int = 2) -> dict:
    """Raise ``ValueError`` for a (page_size, head_dim) the kernel cannot
    take; otherwise return the geometry. Never falls back."""
    geom = paged_tile_geometry(page_size, head_dim, n_queries, route=route,
                               page_bytes=page_bytes)
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"paged attention: head_dim={head_dim} not in the "
                         f"kernel's {HEAD_DIMS}")
    if page_size < 1:
        raise ValueError(f"paged attention: page_size={page_size} < 1")
    if not geom["fits"]:
        raise ValueError(
            f"paged attention: a {route} block needs {geom['smem_bytes']} "
            f"bytes of shared memory (limit {SMEM_LIMIT_BYTES})")
    return geom


def paged_plan(rows: int, n_queries: int, n_heads: int, head_dim: int,
               page_size: int, width: int, q_dtype, page_dtype) -> dict:
    """The launch the wrapper makes: route, block geometry, and ``splits``,
    the blocks of one thread-block cluster that share a (row, head, query
    tile)'s keys. Splits double while the call has fewer than FILL_BLOCKS
    blocks, up to MAX_SPLITS and to one split per MIN_SPLIT_KEYS keys of
    the table's width. Pure Python: the host never reads ``start``, so the
    plan follows the table's capacity and the kernel splits each row's
    visible keys evenly on the card."""
    return dict(_plan(rows, n_queries, n_heads, head_dim, page_size, width,
                      q_dtype, page_dtype))


@functools.lru_cache(maxsize=256)   # the wrapper plans on every call
def _plan(rows: int, n_queries: int, n_heads: int, head_dim: int,
          page_size: int, width: int, q_dtype, page_dtype) -> dict:
    route = paged_route(n_queries, q_dtype, page_dtype)
    geom = check_paged_tile(page_size, head_dim, n_queries, route=route,
                            page_bytes=page_dtype.itemsize)
    tiles = rows * n_heads * -(-n_queries // geom["query_tile"])
    most = min(MAX_SPLITS, max(1, -(-width * page_size // MIN_SPLIT_KEYS[route])))
    splits = 1
    while splits < most and tiles * splits < FILL_BLOCKS:
        splits *= 2
    splits = min(splits, most)
    entry = f"paged_{route}_{_DTYPE_NAME[q_dtype]}q_{_DTYPE_NAME[page_dtype]}"
    return {**geom, "splits": splits, "blocks": tiles * splits, "entry": entry}


def paged_attention_reference(q, k_pages, v_pages, page_table, start, *, slopes):
    """Plain PyTorch version: gather the page view, then attend. Returns
    float32 (B, C, nh, hd), like the kernel."""
    from pipegoose_tpu_torch.serving.kv_pool import gather_pages

    b, c, nh, hd = q.shape
    keys = gather_pages(k_pages, page_table).float()
    vals = gather_pages(v_pages, page_table).float()
    key_pos = torch.arange(keys.shape[1], device=q.device)
    q_pos = start.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    keep = key_pos[None, None, :] <= q_pos[:, :, None]              # (B, C, K)
    bias = slopes.float()[None, :, None, None] * key_pos.float()[None, None, None, :]
    bias = bias + torch.where(keep[:, None], 0.0, NEG_INF)
    ctx = _attn_core(q.float(), keys, vals, bias, None, torch.float32)
    return ctx.reshape(b, c, nh, hd)


def _check_inputs(q, k_pages, v_pages, page_table, start, slopes):
    """Device, dtype, shape and contiguity checks for a kernel launch."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, C, nh, hd), got {tuple(q.shape)}")
    b, c, nh, hd = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.stride(-1) != 1:
        raise ValueError("q's head_dim axis must be contiguous (stride 1)")
    if _is_quantized(k_pages) != _is_quantized(v_pages):
        raise TypeError("k_pages and v_pages must both be int8 or both fp")
    planes = {"page_table": page_table, "start": start, "slopes": slopes}
    if _is_quantized(k_pages):
        kq = k_pages["q"]
        for name, bank in (("k_pages", k_pages), ("v_pages", v_pages)):
            if bank["q"].dtype != torch.int8 or bank["scale"].dtype != torch.float32:
                raise TypeError(f"{name} must be {{q: int8, scale: float32}}")
            if bank["q"].shape != kq.shape or bank["scale"].shape != kq.shape[:-1]:
                raise ValueError(f"{name} planes must be (P, ps, nh, hd) and (P, ps, nh)")
            planes[f"{name}.q"] = bank["q"]
            planes[f"{name}.scale"] = bank["scale"]
    else:
        kq = k_pages
        if kq.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"fp pages must be float32 or bfloat16, got {kq.dtype}")
        if v_pages.dtype != kq.dtype or v_pages.shape != kq.shape:
            raise ValueError("k_pages and v_pages must match in dtype and shape")
        planes["k_pages"] = k_pages
        planes["v_pages"] = v_pages
    if kq.dim() != 4 or kq.shape[2:] != (nh, hd):
        raise ValueError(f"pages must be (P, ps, {nh}, {hd}), got {tuple(kq.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be ({b}, W), got {tuple(page_table.shape)}")
    if start.shape != (b,):
        raise ValueError(f"start must be ({b},), got {tuple(start.shape)}")
    if slopes.shape != (nh,) or slopes.dtype != torch.float32:
        raise ValueError(f"slopes must be float32 ({nh},)")
    for name in ("page_table", "start"):
        if planes[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {planes[name].dtype}")
    for name, t in planes.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("k_pages", "v_pages", "k_pages.q", "v_pages.q"):
        if name in planes and planes[name].data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    return kq


def _kernel_fn(entry: str):
    fn = getattr(_build.load("paged_attention"), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_longlong] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(fn, q, k_pages, v_pages, page_table, start, slopes, out, plan,
            stream) -> None:
    """Queue one kernel call ``fn`` (an entry point of the source) with the
    split plan ``plan``; raises on a refused launch."""
    b, c, nh, hd = q.shape
    if _is_quantized(k_pages):
        kq = k_pages["q"]
        ptrs = (kq.data_ptr(), v_pages["q"].data_ptr(),
                k_pages["scale"].data_ptr(), v_pages["scale"].data_ptr())
    else:
        kq = k_pages
        ptrs = (k_pages.data_ptr(), v_pages.data_ptr(), None, None)
    n_pages, ps = kq.shape[:2]
    err = fn(q.data_ptr(), *ptrs, page_table.data_ptr(), start.data_ptr(),
             slopes.data_ptr(), out.data_ptr(), b, c, nh, hd, ps,
             page_table.shape[1], n_pages, plan["splits"], hd ** -0.5,
             q.stride(0), q.stride(1), q.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")


def paged_attention(q, k_pages, v_pages, page_table, start, *, slopes):
    """Paged attention over ONE layer's page bank.

    Args:
      q: (B, C, nh, hd) float32 or bfloat16 queries, any strides with a
        contiguous head_dim axis (a view of the fused qkv product is read
        as it is, with no cast).
      k_pages / v_pages: fp (P, ps, nh, hd) float32 or bfloat16, or int8
        ``{"q": int8 (P, ps, nh, hd), "scale": float32 (P, ps, nh)}``.
      page_table: (B, W) int32 physical page ids; entries beyond a row's
        live prefix must be the NULL page (0).
      start: (B,) int32 global position of each row's first query.
      slopes: (nh,) float32 ALiBi slopes.

    Returns float32 (B, C, nh, hd). CPU tensors take the plain version;
    CUDA tensors launch the kernel by the route ``paged_plan`` picks
    (``paged_attention.launches`` counts the launches, ``.routes`` them by
    route, ``.queries`` by C) or raise.
    """
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         start, slopes=slopes)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    kq = _check_inputs(q, k_pages, v_pages, page_table, start, slopes)
    b, c, nh, hd = q.shape
    plan = _plan(b, c, nh, hd, kq.shape[1], page_table.shape[1], q.dtype, kq.dtype)
    out = torch.empty((b, c, nh, hd), dtype=torch.float32, device=q.device)
    if b == 0 or c == 0:
        return out
    if q.device.index == torch.cuda.current_device():
        _launch(_kernel_fn(plan["entry"]), q, k_pages, v_pages, page_table,
                start, slopes, out, plan, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            _launch(_kernel_fn(plan["entry"]), q, k_pages, v_pages, page_table,
                    start, slopes, out, plan, torch.cuda.current_stream().cuda_stream)
    paged_attention.launches += 1
    paged_attention.routes[plan["route"]] += 1
    paged_attention.queries[c] = paged_attention.queries.get(c, 0) + 1
    return out


paged_attention.launches = 0
paged_attention.routes = {"fma": 0, "mma": 0}   # launches by route
paged_attention.queries = {}                     # launches by query count C
