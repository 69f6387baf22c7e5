"""Flash attention, forward and backward, with ALiBi, padding, causal and
sliding-window masks and GQA.

The counterpart of ``pipegoose_tpu/ops/flash_attention.py``. The public
:func:`flash_attention` keeps the JAX layout, (B, S, nh, hd) in and out,
and flattens to (B*nh, S, hd) for three kernels:

- :func:`flash_fwd` -> (out, lse), the online-softmax forward;
- :func:`flash_dq` -> dq, and :func:`flash_dkv` -> (dk, dv) per query
  head, the two backward kernels, which recompute the probabilities from
  the saved logsumexp.

Each is a wrapper over one hand-written CUDA kernel
(``csrc/flash_attention.cu``): on CPU tensors it calls its plain PyTorch
version (``flash_fwd_reference``, ``flash_dq_reference``,
``flash_dkv_reference``, the math of the Pallas bodies), on CUDA tensors
it launches the kernel or raises; ``.launches`` counts the launches. Each
has two routes (:func:`fwd_plan` for the forward, :func:`bwd_plan` for dQ
and dK/dV): bf16 inputs on the tensor cores, float32 inputs on float32
FMAs; ``.routes`` counts the launches by route.
``_Flash`` ties them together as a ``torch.autograd.Function``, the
``jax.custom_vjp`` of the JAX file.

The ring-attention chunk kernels B7-B9 (``csrc/flash_chunk.cu``) sit at
the end of the file: :func:`flash_ring_chunk` (one ring step's update of
the unnormalized online-softmax state), :func:`flash_chunk_dq` and
:func:`flash_chunk_dkv`, each beside its plain version, with the causal
test on position values and the NEG_INF added (``_flash_chunk_pallas``).
Each has two routes (:func:`fwd_plan` for the forward,
:func:`chunk_bwd_plan` for the backward): bf16 inputs on the tensor cores,
float32 inputs on float32 FMAs.

Scores of the three whole-sequence kernels follow ``_bias_block``:
``q.k * scale + slope * kv_pos + kv_neg``, where the causal test
(``k_idx <= q_idx``, on the index) and the window test REPLACE that term
with the finite ``NEG_INF``; ``kv_neg`` adds ``NEG_INF`` for padded keys;
``kv_pos`` is BLOOM's mask-aware ALiBi position. A query row that sees no key at all gets finite garbage, which
the models zero with their query mask.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pipegoose_tpu_torch.ops import _build

NEG_INF = -1e9      # finite, as in the JAX package
HEAD_DIMS = (32, 64, 128)   # head_dim values the source instantiates
MAX_TILES = 65535           # grid.y limit: 64-position tiles per sequence

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
TILE = 64                  # queries of a query tile = keys of a key tile
FMA_THREADS = 256          # a block of the FMA route, 16 x 16 threads
MMA_THREADS = 128          # a block of the tensor-core route, four warps


def mask_to_kv_bias(attention_mask: torch.Tensor):
    """(B, S) 1/0 mask -> (kv_pos, kv_neg) float32: the mask-aware ALiBi
    position ``(cumsum(mask) - 1) * mask`` and 0 / NEG_INF key validity."""
    m = attention_mask.float()
    kv_pos = (torch.cumsum(m, dim=-1) - 1.0) * m
    kv_neg = (1.0 - m) * NEG_INF
    return kv_pos, kv_neg


def _expand(x: torch.Tensor, g: int) -> torch.Tensor:
    """kv rows -> query rows: query row r reads kv row r // g."""
    return x if g == 1 else x.repeat_interleave(g, dim=0)


def _scores(q, k, slopes, kpos, kneg, scale, causal, g, window):
    """float32 (BH, S, S) scores of the whole sequence, with the additive
    term of ``_bias_block``."""
    s = q.shape[1]
    kp, kn = _expand(kpos, g), _expand(kneg, g)
    bias = slopes[:, None, None] * kp[:, None, :] + kn[:, None, :]
    if causal or window is not None:
        qi = torch.arange(s, device=q.device)[:, None]
        kj = torch.arange(s, device=q.device)[None, :]
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device)
        if causal:
            keep = keep & (kj <= qi)
        if window is not None:
            keep = keep & (qi - kj < window)
        bias = torch.where(keep[None], bias, NEG_INF)
    dots = torch.einsum("bqd,bkd->bqk", q.float(), _expand(k, g).float())
    return dots * scale + bias


def flash_fwd_reference(q, k, v, slopes, kpos, kneg, scale, causal, g=1,
                        window=None):
    """Plain version of the forward kernel: (out in q's dtype, lse float32
    (BH, S)). The row max starts at NEG_INF and the row sum is clamped at
    1e-30, as in ``_flash_fwd_pallas``."""
    sc = _scores(q, k, slopes, kpos, kneg, scale, causal, g, window)
    m = torch.clamp_min(sc.amax(dim=-1), NEG_INF)
    p = torch.exp(sc - m[..., None])
    l = torch.clamp_min(p.sum(dim=-1), 1e-30)
    out = torch.einsum("bqk,bkd->bqd", p, _expand(v, g).float()) / l[..., None]
    return out.to(q.dtype), m + torch.log(l)


def _p_ds(q, k, v, do, lse, delta, slopes, kpos, kneg, scale, causal, g,
          window):
    """P recomputed from the saved lse, and dS = P * (dO.Vᵀ - delta)."""
    sc = _scores(q, k, slopes, kpos, kneg, scale, causal, g, window)
    p = torch.exp(sc - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), _expand(v, g).float())
    return p, p * (dp - delta[..., None])


def flash_dq_reference(q, k, v, do, lse, delta, slopes, kpos, kneg, scale,
                       causal, g=1, window=None):
    """Plain version of the dQ kernel: ``scale * dS . K`` in q's dtype."""
    _, ds = _p_ds(q, k, v, do, lse, delta, slopes, kpos, kneg, scale,
                  causal, g, window)
    dq = scale * torch.einsum("bqk,bkd->bqd", ds, _expand(k, g).float())
    return dq.to(q.dtype)


def flash_dkv_reference(q, k, v, do, lse, delta, slopes, kpos, kneg, scale,
                        causal, g=1, window=None):
    """Plain version of the dK/dV kernel: ``(scale * dSᵀ . Q, Pᵀ . dO)`` PER
    QUERY HEAD, (BH, S, hd) each in k's dtype."""
    p, ds = _p_ds(q, k, v, do, lse, delta, slopes, kpos, kneg, scale,
                  causal, g, window)
    dk = scale * torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, slopes, kpos, kneg, g, window, **extra):
    """Device, dtype, shape and contiguity checks before a launch."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B*nh, S, hd), got {tuple(q.shape)}")
    bh, s, hd = q.shape
    if q.dtype not in _SUFFIX:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim={hd} not in the kernels' {HEAD_DIMS}")
    if g < 1 or bh % g:
        raise ValueError(f"B*nh={bh} is not a multiple of g={g}")
    if -(-s // 64) > MAX_TILES:
        raise ValueError(f"S={s} needs more than {MAX_TILES} tiles")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _check_specs(q, {"k": (k, (bh // g, s, hd), q.dtype),
                     "v": (v, (bh // g, s, hd), q.dtype),
                     "slopes": (slopes, (bh,), torch.float32),
                     "kv_pos": (kpos, (bh // g, s), torch.float32),
                     "kv_neg": (kneg, (bh // g, s), torch.float32), **extra})


def _check_plan(dtype, hd, sq, skv):
    """What every kernel of this file refuses: raises TypeError for a dtype
    and ValueError for a head_dim or a length."""
    if dtype not in _SUFFIX:
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim={hd} not in the kernels' {HEAD_DIMS}")
    if min(sq, skv) < 0 or max(-(-sq // TILE), -(-skv // TILE)) > MAX_TILES:
        raise ValueError(f"Sq={sq} or Skv={skv} needs more than {MAX_TILES} tiles")


def _mma_tile_bytes(hd):
    """One staged 64-row bf16 tile of the tensor-core route: rows padded by
    16 bytes, so that each ldmatrix reads 8 rows from 8 distinct bank quads."""
    return TILE * (2 * hd + 16)


def fwd_plan(dtype, hd: int, sq: int, skv: int) -> dict:
    """The launch :func:`flash_fwd` (B1, ``sq == skv``) and
    :func:`flash_ring_chunk` (B7) make for q/k/v of ``dtype``, head_dim
    ``hd``, ``sq`` queries and ``skv`` keys. Pure Python, so the CPU tests
    check it.

    - "mma" (bf16): the tensor-core kernels on one main loop
      (``attn_mma.cuh`` ``fwd_mma_walk``): bf16 ``mma.sync`` with float32
      sums, four warps of 16 query rows each of the block's 64-query tile,
      the staged Q tile read as A fragments at each k step, the walked K
      and V tiles with their key positions and biases in a two-deep
      ``cp.async`` ring of bf16 rows padded by 16 bytes, ``blocks_per_sm``
      blocks an SM (128 registers a thread where shared memory holds 4).
      P is rounded once to bf16 before the PV product; l sums the float32
      p; exp is one ``ex2.approx``.
    - "fma" (float32): the float32-FMA kernels, 16 x 16 threads, tiles
      staged as float32 rows of stride hd + 1; exact in the inputs.

    One block per (row, query tile). On the tensor-core route both kernels
    run the query tiles in reverse, so that the longest walks start first;
    on the FMA route only B1 does.
    Raises TypeError for a dtype and ValueError for a head_dim or a length
    the kernels do not take."""
    _check_plan(dtype, hd, sq, skv)
    if dtype == torch.bfloat16:
        mat = _mma_tile_bytes(hd)
        smem = mat + 2 * (2 * mat + 2 * TILE * 4)      # Q + two stages of K, V, kpos, kneg
        route = {"route": "mma", "threads": MMA_THREADS,
                 "smem_bytes": {"fwd": smem, "chunk_fwd": smem},
                 "blocks_per_sm": 4 if hd <= 64 else 2,
                 "q_tiles_reversed": {"fwd": True, "chunk_fwd": True}}
    else:
        rows = TILE * (hd + 1)                          # one staged float32 tile
        score = TILE * (TILE + 1)
        route = {"route": "fma", "threads": FMA_THREADS,
                 "smem_bytes": {"fwd": 4 * (3 * rows + score + 2 * TILE),
                                "chunk_fwd": 4 * (3 * rows + score + 3 * TILE)},
                 "blocks_per_sm": None,
                 "q_tiles_reversed": {"fwd": True, "chunk_fwd": False}}
    return {**route, "tile": TILE, "grid_tiles": -(-sq // TILE)}


def _mma_bwd_route(hd):
    """The tensor-core route of the four backward kernels (B2, B3, B8, B9):
    the block's own two bf16 tiles resident, then a two-deep ring of stages,
    each two walked bf16 tiles and three float32 vectors."""
    mat = _mma_tile_bytes(hd)
    smem = 2 * mat + 2 * (2 * mat + 3 * TILE * 4)
    return {"route": "mma", "threads": MMA_THREADS, "smem_bytes": {"dq": smem, "dkv": smem},
            "blocks_per_sm": 4 if hd <= 64 else 2, "dkv_pass_queries": 16}


def bwd_plan(dtype, hd: int, s: int) -> dict:
    """The launches :func:`flash_dq` (B2) and :func:`flash_dkv` (B3) make
    for q/k/v/dO of ``dtype``, head_dim ``hd`` and ``s`` positions. Pure
    Python, so the CPU tests check it.

    - "mma" (bf16): the tensor-core kernels on the backward main loops they
      share with B8/B9 (``attn_mma.cuh`` ``dq_mma_walk``/``dkv_mma_walk``),
      as :func:`chunk_bwd_plan` describes them, with the flash walk: dq's
      block walks the key tiles from the window's first to the diagonal's,
      dkv's the query tiles from the diagonal to the window's far edge; the
      causal and window tests run per element only on a tile pair that
      straddles them. P and dS are rounded once to bf16 before the second
      product; exp is one ``ex2.approx``; dq, dk, dv come out in bf16.
    - "fma" (float32): the float32-FMA kernels, 16 x 16 threads, tiles
      staged as float32 rows of stride hd + 1; exact in the inputs.

    One block per (row, 64-position tile); dq runs the query tiles in
    reverse on both routes, so that the longest walks start first (dkv's
    natural order already does).
    Raises TypeError for a dtype and ValueError for a head_dim or a length
    the kernels do not take."""
    _check_plan(dtype, hd, s, s)
    if dtype == torch.bfloat16:
        route = _mma_bwd_route(hd)
    else:
        rows = TILE * (hd + 1)                    # one staged float32 tile
        score = TILE * (TILE + 1)
        route = {"route": "fma", "threads": FMA_THREADS,
                 "smem_bytes": {"dq": 4 * (4 * rows + score + 2 * TILE),
                                "dkv": 4 * (4 * rows + 2 * score + 2 * TILE)},
                 "blocks_per_sm": None, "dkv_pass_queries": TILE}
    return {**route, "tile": TILE, "grid_tiles": -(-s // TILE), "dq_tiles_reversed": True}


def _check_aligned(plan, **tensors):
    """The tensor-core route copies bf16 rows 16 bytes at a time (and reads
    float32 state pairs 8 bytes at a time): each tensor named with its
    boundary must start on it there."""
    if plan["route"] != "mma":
        return
    for name, (t, boundary) in tensors.items():
        if t.data_ptr() % boundary:
            raise ValueError(f"{name} must start on a {boundary}-byte boundary")


def _check_specs(q, specs):
    """Each ``name: (tensor, shape, dtype)`` of ``specs`` has that shape and
    dtype, and it and q lie on q's device, contiguous."""
    for name, (t, shape, dtype) in specs.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    for name, t in [("q", q)] + [(n, t) for n, (t, _, _) in specs.items()]:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel_fn(kind: str, dtype):
    fn = getattr(_build.load("flash_attention"), f"flash_{kind}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        n_ptr = {"fwd": 8, "dq": 10, "dkv": 11}[kind]
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(kind, q, ptrs, g, causal, window, scale):
    bh, s, hd = q.shape
    with torch.cuda.device(q.device):
        err = _kernel_fn(kind, q.dtype)(
            *ptrs, bh, s, hd, g, int(bool(causal)), window or 0, float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_{kind} kernel launch failed: cudaError {err}")


def _device_of(q, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    return q.device.type


def flash_fwd(q, k, v, slopes, kpos, kneg, scale, causal, g=1, window=None):
    """Forward kernel: q (BH, S, hd), k/v (BH/g, S, hd) float32 or bf16,
    slopes (BH,), kv_pos/kv_neg (BH/g, S) float32 -> (out (BH, S, hd) in
    q's dtype, lse (BH, S) float32). On CUDA tensors it launches by the
    route :func:`fwd_plan` picks (``.launches`` counts the launches,
    ``.routes`` them by route); bf16 q, k and v must start on a 16-byte
    boundary."""
    if _device_of(q, "flash_fwd") == "cpu":
        return flash_fwd_reference(q, k, v, slopes, kpos, kneg, scale, causal,
                                   g, window)
    _check(q, k, v, slopes, kpos, kneg, g, window)
    plan = fwd_plan(q.dtype, q.shape[2], q.shape[1], q.shape[1])
    _check_aligned(plan, q=(q, 16), k=(k, 16), v=(v, 16))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return out, lse
    _launch("fwd", q, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       slopes.data_ptr(), kpos.data_ptr(), kneg.data_ptr(),
                       out.data_ptr(), lse.data_ptr()), g, causal, window, scale)
    flash_fwd.launches += 1
    flash_fwd.routes[plan["route"]] += 1
    return out, lse


def _check_bwd(q, k, v, do, lse, delta, slopes, kpos, kneg, g, window):
    """The forward's checks plus dO, lse and delta; returns the backward
    plan. The tensor-core route copies bf16 rows 16 bytes at a time, so q,
    k, v and dO must start on a 16-byte boundary there."""
    bh, s, hd = q.shape
    _check(q, k, v, slopes, kpos, kneg, g, window,
           do=(do, tuple(q.shape), q.dtype),
           lse=(lse, (bh, s), torch.float32),
           delta=(delta, (bh, s), torch.float32))
    plan = bwd_plan(q.dtype, hd, s)
    _check_aligned(plan, q=(q, 16), k=(k, 16), v=(v, 16), do=(do, 16))
    return plan


def _bwd_ptrs(q, k, v, do, lse, delta, slopes, kpos, kneg):
    return tuple(t.data_ptr() for t in (q, k, v, do, lse, delta, slopes, kpos, kneg))


def flash_dq(q, k, v, do, lse, delta, slopes, kpos, kneg, scale, causal, g=1,
             window=None):
    """dQ kernel: + do (BH, S, hd) in q's dtype, lse and delta (BH, S)
    float32 -> dq (BH, S, hd) in q's dtype. On CUDA tensors it launches by
    the route :func:`bwd_plan` picks (``.launches`` counts the launches,
    ``.routes`` them by route); bf16 q, k, v and dO must start on a 16-byte
    boundary."""
    args = (q, k, v, do, lse, delta, slopes, kpos, kneg)
    if _device_of(q, "flash_dq") == "cpu":
        return flash_dq_reference(*args, scale, causal, g, window)
    plan = _check_bwd(*args, g, window)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    _launch("dq", q, _bwd_ptrs(*args) + (dq.data_ptr(),), g, causal, window, scale)
    flash_dq.launches += 1
    flash_dq.routes[plan["route"]] += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, slopes, kpos, kneg, scale, causal, g=1,
              window=None):
    """dK/dV kernel: the dq kernel's inputs -> (dk, dv), each (BH, S, hd)
    in k's dtype, PER QUERY HEAD (the caller sums the g heads of a group).
    Routes and counters as :func:`flash_dq`."""
    args = (q, k, v, do, lse, delta, slopes, kpos, kneg)
    if _device_of(q, "flash_dkv") == "cpu":
        return flash_dkv_reference(*args, scale, causal, g, window)
    plan = _check_bwd(*args, g, window)
    dk = torch.empty_like(q)
    dv = torch.empty_like(q)
    if q.numel() == 0:
        return dk, dv
    _launch("dkv", q, _bwd_ptrs(*args) + (dk.data_ptr(), dv.data_ptr()), g,
            causal, window, scale)
    flash_dkv.launches += 1
    flash_dkv.routes[plan["route"]] += 1
    return dk, dv


flash_fwd.launches = 0
flash_fwd.routes = {"fma": 0, "mma": 0}    # launches by route
flash_dq.launches = 0
flash_dkv.launches = 0
flash_dq.routes = {"fma": 0, "mma": 0}
flash_dkv.routes = {"fma": 0, "mma": 0}


class _Flash(torch.autograd.Function):
    """The ``_flash`` custom_vjp: the forward kernel saves (q, k, v,
    slopes, kv_pos, kv_neg, out, lse); the backward takes delta =
    rowsum(dO * O) in plain torch, then launches the dQ and dK/dV kernels
    and sums the per-query-head dK/dV over each GQA group. slopes, kv_pos
    and kv_neg get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, slopes, kpos, kneg, scale, causal, g, window):
        out, lse = flash_fwd(q, k, v, slopes, kpos, kneg, scale, causal, g, window)
        ctx.save_for_backward(q, k, v, slopes, kpos, kneg, out, lse)
        ctx.args = (scale, causal, g, window)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, slopes, kpos, kneg, out, lse = ctx.saved_tensors
        scale, causal, g, window = ctx.args
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(dim=-1)
        args = (q, k, v, do, lse, delta, slopes, kpos, kneg, scale, causal, g, window)
        dq = flash_dq(*args)
        dk, dv = flash_dkv(*args)
        if g > 1:
            s, hd = k.shape[1:]
            dk = dk.reshape(-1, g, s, hd).sum(dim=1).to(k.dtype)
            dv = dv.reshape(-1, g, s, hd).sum(dim=1).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,                       # (B, S, nh, hd)
    k: torch.Tensor,                       # (B, S, nh | nkv, hd)
    v: torch.Tensor,
    alibi_slopes: Optional[torch.Tensor] = None,    # (nh,)
    attention_mask: Optional[torch.Tensor] = None,  # (B, S) 1 keep, 0 pad
    kv_pos: Optional[torch.Tensor] = None,          # (B, S) ALiBi position per key
    kv_neg: Optional[torch.Tensor] = None,          # (B, S) 0 valid / NEG_INF pad
    causal: bool = True,
    scale: Optional[float] = None,
    window: Optional[int] = None,          # sliding window (Mistral semantics)
) -> torch.Tensor:
    """Fused attention, differentiable in q, k and v. Returns (B, S, nh, hd)
    in q's dtype.

    Padding: pass ``attention_mask`` (positions from BLOOM's mask-aware
    cumsum) or precomputed ``kv_pos``/``kv_neg``; a mask fills only what
    the caller left out. GQA: k/v with fewer heads than q (nh = g * nkv,
    query head h reading kv head h // g). The (B*nh, S, hd) operands are
    contiguous copies of the (possibly strided) inputs."""
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    if nh % nkv:
        raise ValueError(f"n_head={nh} must be a multiple of n_kv_head={nkv}")
    g = nh // nkv
    dev = q.device
    if scale is None:
        scale = hd ** -0.5
    if alibi_slopes is None:
        alibi_slopes = torch.zeros((nh,), dtype=torch.float32, device=dev)
    if attention_mask is not None and (kv_pos is None or kv_neg is None):
        pos, neg = mask_to_kv_bias(attention_mask)
        kv_pos = pos if kv_pos is None else kv_pos
        kv_neg = neg if kv_neg is None else kv_neg
    if kv_pos is None:
        kv_pos = torch.arange(s, dtype=torch.float32, device=dev)[None].expand(b, s)
    if kv_neg is None:
        kv_neg = torch.zeros((b, s), dtype=torch.float32, device=dev)
    slopes = alibi_slopes.float()[None].expand(b, nh).reshape(b * nh)

    def flat(x):
        return x.transpose(1, 2).reshape(b * x.shape[2], s, hd).contiguous()

    def flat_bs(x, h):   # (B, S) -> (B*h, S)
        return x.float()[:, None, :].expand(b, h, s).reshape(b * h, s).contiguous()

    out = _Flash.apply(flat(q), flat(k), flat(v), slopes.contiguous(),
                       flat_bs(kv_pos, nkv), flat_bs(kv_neg, nkv), float(scale),
                       causal, g, int(window) if window is not None else None)
    return out.reshape(b, nh, s, hd).transpose(1, 2)


def attention_reference(q, k, v, slopes, scale, causal, kpos=None, kneg=None):
    """Plain attention over flattened (BH, S, hd) operands with the same
    semantics (``_xla_reference`` of the JAX file): one softmax over the
    whole score matrix, output in q's dtype."""
    bh, s, _ = q.shape
    if kpos is None:
        kpos = torch.arange(s, dtype=torch.float32, device=q.device)[None].expand(bh, s)
    if kneg is None:
        kneg = torch.zeros((bh, s), dtype=torch.float32, device=q.device)
    sc = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    sc = sc + slopes[:, None, None] * kpos[:, None, :] + kneg[:, None, :]
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        sc = torch.where(keep[None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


# -- ring-attention chunks (B7-B9) -------------------------------------------------
#
# One ring step of ``ring_flash_attention`` (nn/sequence_parallel): q of this
# rank's chunk against ONE K/V chunk, with the causal test on the position
# VALUES qpos/kpos and the -1e9 ADDED to the ALiBi + key-bias term, as in
# ``_flash_chunk_pallas``/``_chunk_dq_pallas``/``_chunk_dkv_pallas``. Each
# wrapper runs its plain version on CPU tensors and launches its kernel
# (``csrc/flash_chunk.cu``) on CUDA tensors, or raises. The kernels skip a
# 64 x 64 tile pair whose keys all lie in the future of all its queries, as
# the Pallas kernels skip a block; the plain versions compute every pair. The
# two differ only on a query row that has seen no unmasked key yet (a padded
# query, whose m is still about NEG_INF), which the models zero.


def _chunk_scores(q, k, slopes, qpos, kpos, kneg, scale, g):
    """float32 (BH, Sq, Skv) scores of one chunk, in ``_xla_chunk``'s order:
    scaled dot, + slope * kpos, + kneg, + (kpos <= qpos ? 0 : NEG_INF)."""
    kp, kn = _expand(kpos, g), _expand(kneg, g)
    s = torch.einsum("bqd,bkd->bqk", q.float(), _expand(k, g).float()) * scale
    s = s + slopes[:, None, None] * kp[:, None, :] + kn[:, None, :]
    return s + torch.where(kp[:, None, :] <= qpos[:, :, None], 0.0, NEG_INF)


def flash_ring_chunk_reference(q, k, v, slopes, qpos, kpos, kneg, m, l, acc,
                               scale, g=1):
    """Plain version of the chunk forward (``_xla_chunk``): the carried
    unnormalized online-softmax state (m, l (BH, Sq), acc (BH, Sq, hd),
    float32) updated against one K/V chunk."""
    s = _chunk_scores(q, k, slopes, qpos, kpos, kneg, scale, g)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bqk,bkd->bqd", p, _expand(v, g).float())
    return m_new, l_new, acc_new


def _chunk_p_ds(q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, scale, g):
    """P from the FINAL lse, and dS = P * (dO.Vᵀ - delta), of one chunk."""
    s = _chunk_scores(q, k, slopes, qpos, kpos, kneg, scale, g)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), _expand(v, g).float())
    return p, p * (dp - delta[..., None])


def flash_chunk_dq_reference(q, k, v, do, lse, delta, slopes, qpos, kpos, kneg,
                             scale, g=1):
    """Plain version of the chunk dQ (``_chunk_dq_pallas``'s body): this
    chunk's float32 contribution ``scale * dS . K`` (BH, Sq, hd)."""
    _, ds = _chunk_p_ds(q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, scale, g)
    return scale * torch.einsum("bqk,bkd->bqd", ds, _expand(k, g).float())


def flash_chunk_dkv_reference(q, k, v, do, lse, delta, slopes, qpos, kpos, kneg,
                              scale, g=1):
    """Plain version of the chunk dK/dV (``_chunk_dkv_pallas``'s body):
    ``(scale * dSᵀ . Q, Pᵀ . dO)`` PER QUERY HEAD, float32 (BH, Skv, hd)
    each."""
    p, ds = _chunk_p_ds(q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, scale, g)
    dk = scale * torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    return dk, dv


def _check_chunk(q, k, v, slopes, qpos, kpos, kneg, g, **extra):
    """Device, dtype, shape and contiguity checks before a chunk launch."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q must be (B*nh, Sq, hd) and k (B*nkv, Skv, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    bh, sq, hd = q.shape
    skv = k.shape[1]
    if q.dtype not in _SUFFIX:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim={hd} not in the kernels' {HEAD_DIMS}")
    if g < 1 or bh % g:
        raise ValueError(f"B*nh={bh} is not a multiple of g={g}")
    if max(-(-sq // 64), -(-skv // 64)) > MAX_TILES:
        raise ValueError(f"Sq={sq} or Skv={skv} needs more than {MAX_TILES} tiles")
    _check_specs(q, {"k": (k, (bh // g, skv, hd), q.dtype),
                     "v": (v, (bh // g, skv, hd), q.dtype),
                     "slopes": (slopes, (bh,), torch.float32),
                     "qpos": (qpos, (bh, sq), torch.float32),
                     "kpos": (kpos, (bh // g, skv), torch.float32),
                     "kneg": (kneg, (bh // g, skv), torch.float32), **extra})


_CHUNK_PTRS = {"fwd": 13, "dq": 11, "dkv": 12}


def chunk_bwd_plan(dtype, hd: int, sq: int, skv: int) -> dict:
    """The launches :func:`flash_chunk_dq` and :func:`flash_chunk_dkv` make
    for q/k/v/dO of ``dtype``, head_dim ``hd``, ``sq`` queries and ``skv``
    keys. Pure Python, so the CPU tests check it.

    - "mma" (bf16): the tensor-core kernels, bf16 ``mma.sync`` with float32
      sums, four warps of 16 rows each of the block's 64-row tile, the
      walked tiles in a two-deep ``cp.async`` ring of bf16 rows padded by
      16 bytes, the block's own rows read from shared memory at each k
      step, ``blocks_per_sm`` blocks an SM (128 registers a thread where
      shared memory holds 4); dK/dV takes each query tile in passes of
      ``dkv_pass_queries``. P and dS are rounded once to bf16 before the
      second product.
    - "fma" (float32): the float32-FMA kernels, 16 x 16 threads, tiles
      staged as float32 rows of stride hd + 1; exact in the inputs.

    dq has one block per (row, query tile), on the tensor-core route the
    query tiles in reverse so that on the diagonal chunk the longest walks
    start first; dkv one per (row, key tile), whose natural order already
    starts the longest first.
    Raises TypeError for a dtype and ValueError for a head_dim or a length
    the kernels do not take."""
    _check_plan(dtype, hd, sq, skv)
    if dtype == torch.bfloat16:
        route = _mma_bwd_route(hd)
    else:
        rows = TILE * (hd + 1)                    # one staged float32 tile
        score = TILE * (TILE + 1)
        route = {"route": "fma", "threads": FMA_THREADS,
                 "smem_bytes": {"dq": 4 * (4 * rows + score + 3 * TILE),
                                "dkv": 4 * (4 * rows + 2 * score + 4 * TILE)},
                 "blocks_per_sm": None, "dkv_pass_queries": TILE}
    return {**route, "tile": TILE,
            "grid_tiles": {"dq": -(-sq // TILE), "dkv": -(-skv // TILE)},
            "dq_tiles_reversed": route["route"] == "mma"}


def _chunk_launch(kind, q, k, ptrs, g, scale):
    fn = getattr(_build.load("flash_chunk"), f"flash_chunk_{kind}_{_SUFFIX[q.dtype]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * _CHUNK_PTRS[kind] + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    bh, sq, hd = q.shape
    with torch.cuda.device(q.device):
        err = fn(*ptrs, bh, sq, k.shape[1], hd, g, float(scale),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_chunk_{kind} kernel launch failed: cudaError {err}")


def flash_ring_chunk(q, k, v, slopes, qpos, kpos, kneg, m, l, acc, scale, g=1):
    """One forward ring step (B7): q (BH, Sq, hd), k/v (BH/g, Skv, hd)
    float32 or bf16; slopes (BH,), qpos (BH, Sq), kpos/kneg (BH/g, Skv),
    the state m, l (BH, Sq) and acc (BH, Sq, hd), all float32 -> the
    updated (m, l, acc), new tensors. Not differentiable on its own: the
    ring owns the backward. On CUDA tensors it launches by the route
    :func:`fwd_plan` picks (``.launches`` counts the launches, ``.routes``
    them by route); bf16 q, k and v must start on a 16-byte boundary and
    acc on an 8-byte one."""
    if _device_of(q, "flash_ring_chunk") == "cpu":
        return flash_ring_chunk_reference(q, k, v, slopes, qpos, kpos, kneg, m, l,
                                          acc, scale, g)
    bh, sq, hd = q.shape
    _check_chunk(q, k, v, slopes, qpos, kpos, kneg, g,
                 m=(m, (bh, sq), torch.float32), l=(l, (bh, sq), torch.float32),
                 acc=(acc, (bh, sq, hd), torch.float32))
    plan = fwd_plan(q.dtype, hd, sq, k.shape[1])
    _check_aligned(plan, q=(q, 16), k=(k, 16), v=(v, 16), acc=(acc, 8))
    m_out, l_out, acc_out = torch.empty_like(m), torch.empty_like(l), torch.empty_like(acc)
    if q.numel() == 0 or k.shape[1] == 0:
        return m.clone(), l.clone(), acc.clone()
    ptrs = tuple(t.data_ptr() for t in (q, k, v, slopes, qpos, kpos, kneg, m, l,
                                        acc, m_out, l_out, acc_out))
    _chunk_launch("fwd", q, k, ptrs, g, scale)
    flash_ring_chunk.launches += 1
    flash_ring_chunk.routes[plan["route"]] += 1
    return m_out, l_out, acc_out


def _check_chunk_bwd(q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, g):
    """The chunk checks plus dO, lse and delta; returns the backward plan.
    The tensor-core route copies bf16 rows 16 bytes at a time, so q, k, v
    and dO must start on a 16-byte boundary there."""
    bh, sq = q.shape[:2]
    _check_chunk(q, k, v, slopes, qpos, kpos, kneg, g,
                 do=(do, tuple(q.shape), q.dtype),
                 lse=(lse, (bh, sq), torch.float32),
                 delta=(delta, (bh, sq), torch.float32))
    plan = chunk_bwd_plan(q.dtype, q.shape[2], sq, k.shape[1])
    _check_aligned(plan, q=(q, 16), k=(k, 16), v=(v, 16), do=(do, 16))
    return plan


def flash_chunk_dq(q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, scale, g=1):
    """This chunk's dQ (B8): + do (BH, Sq, hd) in q's dtype, the final lse
    and delta (BH, Sq) float32 -> dq float32 (BH, Sq, hd). On CUDA tensors
    it launches by the route :func:`chunk_bwd_plan` picks (``.launches``
    counts the launches, ``.routes`` them by route)."""
    args = (q, k, v, do, lse, delta, slopes, qpos, kpos, kneg)
    if _device_of(q, "flash_chunk_dq") == "cpu":
        return flash_chunk_dq_reference(*args, scale, g)
    plan = _check_chunk_bwd(*args, g)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.shape[1] == 0:
        return dq.zero_()
    _chunk_launch("dq", q, k, tuple(t.data_ptr() for t in args + (dq,)), g, scale)
    flash_chunk_dq.launches += 1
    flash_chunk_dq.routes[plan["route"]] += 1
    return dq


def flash_chunk_dkv(q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, scale, g=1):
    """This chunk's dK/dV (B9): the dq kernel's inputs -> (dk, dv) float32
    (BH, Skv, hd) each, PER QUERY HEAD (the ring sums the g heads of a
    group). Routes and counters as :func:`flash_chunk_dq`."""
    args = (q, k, v, do, lse, delta, slopes, qpos, kpos, kneg)
    if _device_of(q, "flash_chunk_dkv") == "cpu":
        return flash_chunk_dkv_reference(*args, scale, g)
    plan = _check_chunk_bwd(*args, g)
    shape = (q.shape[0], k.shape[1], q.shape[2])
    dk = torch.empty(shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(shape, dtype=torch.float32, device=q.device)
    if q.numel() == 0 or k.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    _chunk_launch("dkv", q, k, tuple(t.data_ptr() for t in args + (dk, dv)), g, scale)
    flash_chunk_dkv.launches += 1
    flash_chunk_dkv.routes[plan["route"]] += 1
    return dk, dv


flash_ring_chunk.launches = 0
flash_ring_chunk.routes = {"fma": 0, "mma": 0}    # launches by route
flash_chunk_dq.launches = 0
flash_chunk_dkv.launches = 0
flash_chunk_dq.routes = {"fma": 0, "mma": 0}    # launches by route
flash_chunk_dkv.routes = {"fma": 0, "mma": 0}
