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
"""
from __future__ import annotations

import ctypes

import torch

from pipegoose_tpu_torch.models.bloom import NEG_INF
from pipegoose_tpu_torch.models.generate import _attn_core
from pipegoose_tpu_torch.ops import _build

SMEM_LIMIT_BYTES = 232448   # opt-in dynamic shared memory of one H100 block
QUERY_TILE = 64             # queries per block (kQTile in the source)
HEAD_DIMS = (32, 64, 128)   # head_dim values the source instantiates

_ENTRY = {
    torch.float32: "paged_attention_f32",
    torch.bfloat16: "paged_attention_bf16",
    torch.int8: "paged_attention_int8",
}


def _is_quantized(pages) -> bool:
    return isinstance(pages, dict)


def paged_tile_geometry(page_size: int, head_dim: int, n_queries: int) -> dict:
    """Shared memory one block of the kernel asks for: the tile's float32
    queries, one K and one V page tile in float32 (rows padded by one
    word), the score rows and one rescale word per query. Every page
    format is staged as float32, so the size is the same for all."""
    qt = min(n_queries, QUERY_TILE)
    ld = head_dim + 1
    smem = 4 * (qt * ld + 2 * page_size * ld + qt * page_size + qt)
    return {"query_tile": qt, "smem_bytes": smem,
            "fits": smem <= SMEM_LIMIT_BYTES}


def check_paged_tile(page_size: int, head_dim: int, n_queries: int) -> dict:
    """Raise ``ValueError`` when a (page_size, head_dim) tile cannot fit one
    block's shared memory; otherwise return the geometry. Never falls
    back: a smaller ``page_size`` is the fix."""
    geom = paged_tile_geometry(page_size, head_dim, n_queries)
    if not geom["fits"]:
        raise ValueError(
            f"paged attention: a (page_size={page_size} x head_dim="
            f"{head_dim}) tile with {geom['query_tile']} queries needs "
            f"{geom['smem_bytes']} bytes of shared memory (limit "
            f"{SMEM_LIMIT_BYTES}); shrink page_size")
    return geom


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
    if not q.is_floating_point():
        raise TypeError(f"q must be floating point, got {q.dtype}")
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
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim={hd} not in the kernel's {HEAD_DIMS}")
    return kq


def _kernel_fn(dtype):
    fn = getattr(_build.load("paged_attention"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q, k_pages, v_pages, page_table, start, *, slopes):
    """Paged attention over ONE layer's page bank.

    Args:
      q: (B, C, nh, hd) queries, any float dtype (cast to contiguous
        float32 for the kernel).
      k_pages / v_pages: fp (P, ps, nh, hd) float32 or bfloat16, or int8
        ``{"q": int8 (P, ps, nh, hd), "scale": float32 (P, ps, nh)}``.
      page_table: (B, W) int32 physical page ids; entries beyond a row's
        live prefix must be the NULL page (0).
      start: (B,) int32 global position of each row's first query.
      slopes: (nh,) float32 ALiBi slopes.

    Returns float32 (B, C, nh, hd). CPU tensors take the plain version;
    CUDA tensors launch the kernel (``paged_attention.launches`` counts
    the launches) or raise.
    """
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         start, slopes=slopes)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cpu or cuda, not {q.device}")
    kq = _check_inputs(q, k_pages, v_pages, page_table, start, slopes)
    b, c, nh, hd = q.shape
    n_pages, ps = kq.shape[:2]
    width = page_table.shape[1]
    check_paged_tile(ps, hd, c)
    q32 = q.float().contiguous()
    out = torch.empty((b, c, nh, hd), dtype=torch.float32, device=q.device)
    if b == 0 or c == 0:
        return out
    if _is_quantized(k_pages):
        ptrs = (k_pages["q"].data_ptr(), v_pages["q"].data_ptr(),
                k_pages["scale"].data_ptr(), v_pages["scale"].data_ptr())
    else:
        ptrs = (k_pages.data_ptr(), v_pages.data_ptr(), None, None)
    with torch.cuda.device(q.device):
        fn = _kernel_fn(kq.dtype)
        err = fn(q32.data_ptr(), *ptrs, page_table.data_ptr(),
                 start.data_ptr(), slopes.data_ptr(), out.data_ptr(),
                 b, c, nh, hd, ps, width, n_pages, hd ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
