"""Fused vocab cross entropy, forward and backward, straight from (hidden,
weight): the (T, V) logits never exist in device memory.

The counterpart of ``pipegoose_tpu/ops/fused_ce.py``. Three kernels, each
a wrapper over hand-written CUDA entry points (``csrc/fused_ce.cu``;
``csrc/fused_ce_fwd_wgmma.cu`` for the bf16 forward, ``csrc/fused_ce_mma.cu``
for the bf16 backward):

- :func:`fused_ce_fwd` -> (lse, target_logit), float32 (T,): the online
  log-sum-exp and the target's logit over vocab tiles;
- :func:`fused_ce_dh` -> dh (T, H) in h's dtype, and :func:`fused_ce_dw`
  -> dw in w's shape and dtype: the two backward products, each rebuilding
  ``dlogits = g * (softmax - onehot)`` tile by tile from the saved lse.

On CPU tensors a wrapper calls its plain PyTorch version
(``fused_ce_fwd_reference``, ``fused_ce_dh_reference``,
``fused_ce_dw_reference``: the math of the Pallas bodies over the whole
(T, V) at once); on CUDA tensors it launches its kernel or raises.
``.launches`` counts the launches, ``.routes`` by route and ``.layouts``
by weight layout ("vh", "hv"). The forward's routes (:func:`fwd_plan`):
"wgmma", the bf16 kernel of ``fused_ce_fwd_wgmma.cu`` (warpgroup MMAs on
TMA-loaded tiles) wherever TMA can address the operands, or "wmma", the
WMMA kernel of ``fused_ce.cu`` (float32 in split TF32, and bf16 that TMA
cannot address). The backward's (:func:`bwd_plan`): "mma", the bf16
tensor-core kernel of ``fused_ce_mma.cu`` (a thread-block cluster splits
H), or "wmma", the WMMA kernel of ``fused_ce.cu`` (float32, and bf16 with
H above 4096). ``_FusedCE`` ties them together as a
``torch.autograd.Function``, the ``_fused_ce`` custom_vjp of the JAX file.

Semantics of ``_dlogits_tile``: logits in float32; columns whose global
index ``offset + j`` is ``>= valid_size`` are set to the finite
``NEG_INF``; the target logit is read after that mask; lse is ``m +
log(max(l, 1e-30))`` with the running max starting at ``NEG_INF``;
dlogits is ``g * (exp(logit - lse) - onehot)``. ``weight_layout`` "vh" is
a (V, H) weight (BLOOM's tied embedding), "hv" an (H, V) one (an untied
head); both are read in place. Under a tensor axis the weight is this
rank's vocab shard: the kernels run on it at ``offset = axis_index x
V/tp`` (:func:`_shard_offset`), the shards' (lse, target logit) meet in
:func:`_combine`, and the backward all-reduces dh, as the JAX custom_vjp
does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pipegoose_tpu_torch.distributed.functional import all_reduce, axis_index
from pipegoose_tpu_torch.ops import _build

NEG_INF = -1e9      # finite, as in the JAX package
H_MULTIPLE = 16     # the kernels' product depth: H must be a multiple of it
SMS = 132           # H100 SXM streaming multiprocessors
FWD_TILE_T = 64     # "wmma" forward: token rows per block (csrc/fused_ce.cu kFwdBR)
FWD_TILE_V = 128    # vocab columns per tile (kBS)
FWD_BLOCKS_PER_SM = 2   # blocks resident on one SM (its launch bounds)
FWD_WAVES = 16      # waves of forward blocks: the last, partial one costs <= 1/16
# "wgmma" forward (csrc/fused_ce_fwd_wgmma.cu): one block an SM of BM token
# rows; a ring of FWD_STAGES stages of BK H columns; vocab tiles of 256
# columns, or 128 above FWD_CHAIN_H, where the kernel adds accumulator chains
# of FWD_CHAIN_H columns in float32
FWD_BM, FWD_BK, FWD_STAGES = 128, 64, 4
FWD_CHAIN_H = 1024
MAX_SMEM = 232448   # the shared memory a block may use on an H100
NO_VALID = 2 ** 31 - 1   # valid_size=None: no column is masked
# bf16 backward on the tensor cores (csrc/fused_ce_mma.cu): a block keeps
# BM resident rows and the float32 accumulator of an H slice of at most
# 32768 / BM columns (128 registers a thread); a cluster of up to 8 blocks
# splits H. (BM, widest slice), in the order tried:
MMA_CONFIGS = ((128, 256), (64, 512))
MAX_CLUSTER = 8          # the portable thread-block cluster size
# clusters of 1, 2, 4, 8 such blocks an H100 SXM holds at once (one block
# an SM; a cluster's blocks share a GPC), as fused_ce_mma.cu's
# fused_ce_mma_resident_clusters reports them there: bwd_plan's figures
# when no card is asked (a launch asks its card, card_plan)
RESIDENT_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}
MAX_SPLITS = 8           # dh: splits of the vocab walk, summed by a second kernel
WAVE_FILL = 0.95         # dh: the fewest splits whose waves are this full

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


# -- plain versions ------------------------------------------------------------

def _masked_logits(h, w, offset, valid, vh):
    """float32 (T, V) logits with columns >= ``valid`` set to NEG_INF."""
    wf = w.float()
    logits = h.float() @ (wf.t() if vh else wf)
    if valid is not None:
        col = offset + torch.arange(logits.shape[1], device=logits.device)
        logits.masked_fill_(col[None, :] >= valid, NEG_INF)
    return logits


def _target_index(targets, offset, v):
    """(local column of each target, whether it lies in this shard)."""
    idx = targets.long() - offset
    inside = (idx >= 0) & (idx < v)
    return idx.clamp(0, max(v - 1, 0)), inside


def fused_ce_fwd_reference(h, w, targets, offset=0, valid=None, vh=True):
    """Plain version of the forward kernel: (lse, target_logit), float32
    (T,). The target logit is the masked logit of the target's column, 0
    when the target lies outside ``[offset, offset + V)``."""
    logits = _masked_logits(h, w, offset, valid, vh)
    idx, inside = _target_index(targets, offset, logits.shape[1])
    tl = torch.where(inside, logits.gather(1, idx[:, None])[:, 0], 0.0)
    m = torch.clamp_min(logits.amax(dim=1), NEG_INF)
    l = logits.sub_(m[:, None]).exp_().sum(dim=1)
    return m + torch.log(torch.clamp_min(l, 1e-30)), tl


def _dlogits(h, w, targets, lse, g, offset, valid, vh):
    """float32 (T, V) ``g * (exp(logit - lse) - onehot)``, in place."""
    logits = _masked_logits(h, w, offset, valid, vh)
    idx, inside = _target_index(targets, offset, logits.shape[1])
    p = logits.sub_(lse[:, None]).exp_()
    rows = torch.nonzero(inside)[:, 0]
    p[rows, idx[rows]] -= 1.0
    return p.mul_(g[:, None])


def fused_ce_dh_reference(h, w, targets, lse, g, offset=0, valid=None, vh=True):
    """Plain version of the d-hidden kernel: ``dlogits @ W`` in h's dtype."""
    dl = _dlogits(h, w, targets, lse, g, offset, valid, vh)
    wf = w.float()
    return (dl @ (wf if vh else wf.t())).to(h.dtype)


def fused_ce_dw_reference(h, w, targets, lse, g, offset=0, valid=None, vh=True):
    """Plain version of the d-weight kernel: ``dlogitsᵀ @ h`` (vh) or
    ``hᵀ @ dlogits`` (hv), in w's dtype."""
    dl = _dlogits(h, w, targets, lse, g, offset, valid, vh)
    hf = h.float()
    return (dl.t() @ hf if vh else hf.t() @ dl).to(w.dtype)


# -- kernels -------------------------------------------------------------------

def _device_of(h, name):
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {h.device}")
    return h.device.type


def _check(h, w, targets, offset, vh, **extra):
    """Device, dtype, shape and contiguity checks before a launch; returns
    (T, H, V)."""
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"h must be (T, H) and w 2-D, got {tuple(h.shape)}, "
                         f"{tuple(w.shape)}")
    t, hd = h.shape
    if h.dtype not in _SUFFIX:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    if w.dtype != h.dtype:
        raise TypeError(f"w must be {h.dtype} like h, got {w.dtype}")
    if (w.shape[1] if vh else w.shape[0]) != hd:
        raise ValueError(f"w {tuple(w.shape)} does not match H={hd} "
                         f"({'vh' if vh else 'hv'} layout)")
    if hd % H_MULTIPLE:
        raise ValueError(f"H={hd} is not a multiple of {H_MULTIPLE}")
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    v = w.shape[0] if vh else w.shape[1]
    shapes = {"targets": (targets, (t,), torch.int32)}
    shapes.update(extra)
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    named = [("h", h), ("w", w)] + [(n, x) for n, (x, _, _) in shapes.items()]
    for name, x in named:
        if x.device != h.device:
            raise ValueError(f"{name} is on {x.device}, h on {h.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return t, hd, v


def _kernel_fn(source: str, entry: str, n_ptr: int, n_int: int):
    fn = getattr(_build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(kind, h, ptrs, ints, route="wmma"):
    """Launch ``fused_ce_{kind}_{dtype}`` of fused_ce.cu (route "wmma"; the
    forward also takes its splits), ``fused_ce_fwd_wgmma`` of
    fused_ce_fwd_wgmma.cu (route "wgmma": splits and bn follow the usual
    ints), or ``fused_ce_{kind}_mma`` of fused_ce_mma.cu (route "mma": a
    workspace pointer follows the usual pointers, bm, cluster and splits
    the usual ints)."""
    if route == "mma":
        fn = _kernel_fn("fused_ce_mma", f"fused_ce_{kind}_mma", len(ptrs), len(ints))
    elif route == "wgmma":
        fn = _kernel_fn("fused_ce_fwd_wgmma", "fused_ce_fwd_wgmma", len(ptrs), len(ints))
    else:
        fn = _kernel_fn("fused_ce", f"fused_ce_{kind}_{_SUFFIX[h.dtype]}", len(ptrs),
                        len(ints))
    with torch.cuda.device(h.device):
        err = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_{kind} kernel launch failed ({route} route): "
                           f"cudaError {err}")


def fwd_plan(dtype, t: int, hd: int, v: int, vh: bool, aligned: bool = True,
             sms: int = SMS) -> dict:
    """How the forward kernel runs on the card. ``route`` "wgmma" for bf16
    operands that TMA can address: ``aligned`` (h and w start on 16 bytes)
    and, for an (H, V) weight, V a multiple of 8 (rows of a multiple of 16
    bytes); else "wmma" (float32 always). Both routes split the vocabulary
    into ``splits`` ranges, combined per token in split order, so that the
    blocks fill FWD_WAVES waves of the ``sms`` SMs (one "wgmma" block an
    SM, two "wmma" ones; "wmma" always counts an H100 SXM's 132, so its
    splits, and its float32 bits, do not depend on the card). On "wgmma"
    also: ``bm`` token rows a block, ``bn`` vocab columns a tile (256, or
    128 above H = FWD_CHAIN_H), ``bk`` H columns a stage, ``stages`` of the
    ring, ``grid`` (token tiles, splits), ``smem_bytes`` of shared memory a
    block and ``part_bytes`` of float32 partials."""
    if dtype == torch.bfloat16 and aligned and (vh or v % 8 == 0):
        bn = 256 if hd <= FWD_CHAIN_H else 128
        t_tiles = -(-t // FWD_BM)
        splits = max(1, min(-(-v // bn), -(-FWD_WAVES * sms // t_tiles)))
        return {"route": "wgmma", "bm": FWD_BM, "bn": bn, "bk": FWD_BK,
                "stages": FWD_STAGES, "splits": splits, "grid": (t_tiles, splits),
                "smem_bytes": FWD_STAGES * (FWD_BM + bn) * FWD_BK * 2 + 16 * FWD_STAGES + 1024,
                "part_bytes": 3 * 4 * splits * t}
    t_tiles = -(-t // FWD_TILE_T)
    v_tiles = -(-v // FWD_TILE_V)
    wave = FWD_BLOCKS_PER_SM * SMS
    return {"route": "wmma", "splits": max(1, min(v_tiles, -(-FWD_WAVES * wave // t_tiles)))}


def _aligned(*xs) -> bool:
    return all(x.data_ptr() % 16 == 0 for x in xs)


def bwd_plan(dtype, t: int, hd: int, v: int, kind: str, resident=None) -> dict:
    """How the ``kind`` ("dh" or "dw") backward kernel runs on the card:
    ``route`` "mma" for bf16 with H <= MAX_CLUSTER x 512, else "wmma" (the
    plan has no other key then). On "mma": ``bm`` resident rows a block
    (tokens for dh, vocab rows for dw); ``bn`` streamed rows a tile;
    ``cluster`` blocks a cluster; ``slices`` the (first column, width) of
    each cluster rank's H slice, covering H exactly; ``splits`` the parts
    of the streamed rows that run as separate clusters (dh; their float32
    sums, ``ws_bytes`` of workspace, are added in split order by a second
    kernel); ``grid`` the blocks of the launch. "mma" takes the first of
    MMA_CONFIGS whose widest slice, times the smallest power-of-two
    cluster that covers H, needs at most MAX_CLUSTER blocks; H splits into
    16-column chunks dealt out evenly over the ranks. dh takes the fewest
    splits (at most MAX_SPLITS, and a streamed tile each) whose clusters
    fill their waves to WAVE_FILL on average, else the fullest: a wave is
    ``resident(bm, cluster)`` clusters, the count the card holds at once
    (default: RESIDENT_CLUSTERS, an H100 SXM's)."""
    if kind not in ("dh", "dw"):
        raise ValueError(f"kind must be 'dh' or 'dw', got {kind!r}")
    rows = t if kind == "dh" else v
    if dtype == torch.bfloat16:
        for bm, width in MMA_CONFIGS:
            cluster = 1
            while cluster * width < hd:
                cluster *= 2
            if cluster <= MAX_CLUSTER:
                n16 = hd // H_MULTIPLE
                edges = [r * n16 // cluster * H_MULTIPLE for r in range(cluster + 1)]
                clusters = -(-rows // bm)
                splits = 1
                if kind == "dh":
                    held = (resident(bm, cluster) if resident
                            else RESIDENT_CLUSTERS[cluster])
                    splits = _wave_splits(clusters, held, -(-v // (bm // 2)))
                return {"route": "mma", "bm": bm, "bn": bm // 2, "cluster": cluster,
                        "slices": [(a, b - a) for a, b in zip(edges, edges[1:])],
                        "splits": splits, "grid": cluster * clusters * splits,
                        "ws_bytes": 4 * splits * t * hd if splits > 1 else 0}
    return {"route": "wmma"}


def _wave_splits(clusters: int, resident: int, tiles: int) -> int:
    """Splits of the streamed rows for ``clusters`` clusters of which the
    card holds ``resident`` at once: the fewest whose waves are at least
    WAVE_FILL full on average, else the fullest; at most MAX_SPLITS and
    ``tiles``."""
    best, best_fill = 1, 0.0
    for splits in range(1, min(MAX_SPLITS, tiles) + 1):
        n = clusters * splits
        fill = n / (-(-n // resident) * resident)
        if fill >= WAVE_FILL:
            return splits
        if fill > best_fill:
            best, best_fill = splits, fill
    return best


def card_fwd_plan(h, w, vh=True) -> dict:
    """The :func:`fwd_plan` that ``fused_ce_fwd`` launches for h (T, H) and w
    on h's card: its alignment, and the card's SM count."""
    t, hd = h.shape
    v = w.shape[0] if vh else w.shape[1]
    sms = (torch.cuda.get_device_properties(h.device).multi_processor_count
           if h.device.type == "cuda" else SMS)
    return fwd_plan(h.dtype, t, hd, v, vh, _aligned(h, w), sms)


def fused_ce_fwd(h, w, targets, offset=0, valid=None, vh=True):
    """Forward kernel: h (T, H), w (V, H) "vh" or (H, V) "hv", both float32
    or bf16, targets int32 (T,) -> (lse, target_logit) float32 (T,)."""
    if _device_of(h, "fused_ce_fwd") == "cpu":
        return fused_ce_fwd_reference(h, w, targets, offset, valid, vh)
    t, hd, v = _check(h, w, targets, offset, vh)
    lse = torch.empty(t, dtype=torch.float32, device=h.device)
    tl = torch.empty(t, dtype=torch.float32, device=h.device)
    if t == 0:
        return lse, tl
    if v == 0:
        raise ValueError("w has no vocab columns")
    plan = card_fwd_plan(h, w, vh)
    part = torch.empty((3, plan["splits"], t), dtype=torch.float32, device=h.device)
    ints = (t, hd, v, offset, NO_VALID if valid is None else valid, int(bool(vh)),
            plan["splits"])
    if plan["route"] == "wgmma":
        ints += (plan["bn"],)
    _launch("fwd", h, (h.data_ptr(), w.data_ptr(), targets.data_ptr(), part.data_ptr(),
                       lse.data_ptr(), tl.data_ptr()), ints, plan["route"])
    fused_ce_fwd.launches += 1
    fused_ce_fwd.routes[plan["route"]] += 1
    fused_ce_fwd.layouts["vh" if vh else "hv"] += 1
    return lse, tl


def _check_bwd(h, w, targets, lse, g, offset, vh):
    t = h.shape[0] if h.dim() == 2 else -1
    return _check(h, w, targets, offset, vh,
                  lse=(lse, (t,), torch.float32), g=(g, (t,), torch.float32))


_RESIDENT = {}   # (device index, vh, bm, cluster) -> resident clusters of dh


def _resident_on(device, vh):
    """``resident(bm, cluster)`` for :func:`bwd_plan`: how many clusters of
    the dh kernel for layout ``vh`` the card ``device`` holds at once, read
    from ``fused_ce_mma_resident_clusters`` once per device, layout and
    configuration. Raises if the card holds none or the query fails."""
    def resident(bm, cluster):
        key = (device.index, bool(vh), bm, cluster)
        if key not in _RESIDENT:
            fn = _build.load("fused_ce_mma").fused_ce_mma_resident_clusters
            fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
            with torch.cuda.device(device):
                n = fn(0, int(bool(vh)), bm, cluster)
            if n < 1:
                raise RuntimeError(
                    f"fused_ce_dh: no cluster of {cluster} blocks (BM {bm}) can be resident "
                    f"on {device}" + (f" (cudaError {-n})" if n < 0 else ""))
            _RESIDENT[key] = n
        return _RESIDENT[key]
    return resident


def card_plan(h, w, kind: str, vh=True) -> dict:
    """The :func:`bwd_plan` that ``fused_ce_{kind}`` launches for h (T, H)
    and w on h's card: dh's waves are the resident clusters the card
    reports."""
    t, hd = h.shape
    v = w.shape[0] if vh else w.shape[1]
    resident = _resident_on(h.device, vh) if h.device.type == "cuda" else None
    return bwd_plan(h.dtype, t, hd, v, kind, resident)


def _launch_bwd(kind, fn, h, w, targets, lse, g, out, t, hd, v, offset, valid, vh):
    plan = card_plan(h, w, kind, vh)
    ints = (t, hd, v, offset, NO_VALID if valid is None else valid, int(bool(vh)))
    ptrs = tuple(x.data_ptr() for x in (h, w, targets, lse, g, out))
    if plan["route"] == "mma":
        ws = None
        if plan["splits"] > 1:
            ws = torch.empty((plan["splits"], t, hd), dtype=torch.float32, device=h.device)
        ptrs += (0 if ws is None else ws.data_ptr(),)
        ints += (plan["bm"], plan["cluster"], plan["splits"])
    _launch(kind, h, ptrs, ints, plan["route"])
    fn.launches += 1
    fn.routes[plan["route"]] += 1
    fn.layouts["vh" if vh else "hv"] += 1


def fused_ce_dh(h, w, targets, lse, g, offset=0, valid=None, vh=True):
    """d-hidden kernel: + the global lse and the per-token cotangent g,
    float32 (T,) -> dh (T, H) in h's dtype."""
    args = (h, w, targets, lse, g)
    if _device_of(h, "fused_ce_dh") == "cpu":
        return fused_ce_dh_reference(*args, offset, valid, vh)
    t, hd, v = _check_bwd(*args, offset, vh)
    dh = torch.empty_like(h)
    if t == 0 or v == 0:
        return dh.zero_()
    _launch_bwd("dh", fused_ce_dh, *args, dh, t, hd, v, offset, valid, vh)
    return dh


def fused_ce_dw(h, w, targets, lse, g, offset=0, valid=None, vh=True):
    """d-weight kernel: the dh kernel's inputs -> dw in w's shape and
    dtype."""
    args = (h, w, targets, lse, g)
    if _device_of(h, "fused_ce_dw") == "cpu":
        return fused_ce_dw_reference(*args, offset, valid, vh)
    t, hd, v = _check_bwd(*args, offset, vh)
    dw = torch.empty_like(w)
    if t == 0 or v == 0:
        return dw.zero_()
    _launch_bwd("dw", fused_ce_dw, *args, dw, t, hd, v, offset, valid, vh)
    return dw


fused_ce_fwd.launches = 0
fused_ce_fwd.routes = {"wgmma": 0, "wmma": 0}
fused_ce_fwd.layouts = {"vh": 0, "hv": 0}
fused_ce_dh.launches = 0
fused_ce_dw.launches = 0
fused_ce_dh.routes = {"mma": 0, "wmma": 0}
fused_ce_dw.routes = {"mma": 0, "wmma": 0}
fused_ce_dh.layouts = {"vh": 0, "hv": 0}
fused_ce_dw.layouts = {"vh": 0, "hv": 0}


# -- autograd and the public sums ----------------------------------------------

def _shard_offset(axis_name, v_local: int) -> int:
    """First global column of this vocab shard: ``axis_index x V/tp``."""
    return axis_index(axis_name) * v_local


def combine_shards(lse_l, tl_l, reduce_max, reduce_sum):
    """The shards' (lse, target_logit) -> the global pair, given the max
    and sum reductions over the shards: lse by max and log-sum-exp, the
    target logit by a sum (its column lies on one shard; the others hold
    0)."""
    m = reduce_max(lse_l)
    return m + torch.log(reduce_sum(torch.exp(lse_l - m))), reduce_sum(tl_l)


def _combine(lse_l, tl_l, axis_name):
    """Local-shard (lse, target_logit) -> global over ``axis_name``: the
    pmax / log-sum-exp / psum combine of the JAX file; the identity at
    ``axis_name=None``."""
    if axis_name is None:
        return lse_l, tl_l
    return combine_shards(lse_l, tl_l, lambda x: all_reduce(x, axis_name, "max"),
                          lambda x: all_reduce(x, axis_name))


class _FusedCE(torch.autograd.Function):
    """The ``_fused_ce`` custom_vjp: the forward kernel's (lse, target
    logit) give (loss_sum, weight_sum) and save (h, w, targets, token_w,
    lse); the backward takes ``g = ct_loss * token_w`` and launches the dh
    and dw kernels; under an axis dh is all-reduced over it (each shard's
    dh holds only its vocabulary rows' part: the f-operator of
    ``bloom.logits_fn``, fused into this backward). ``weight_sum`` is a
    count and gets no gradient, nor do targets and token_w."""

    @staticmethod
    def forward(ctx, h, w, targets, token_w, axis_name, valid, vh):
        offset = _shard_offset(axis_name, w.shape[0] if vh else w.shape[1])
        lse_l, tl_l = fused_ce_fwd(h, w, targets, offset, valid, vh)
        lse, tl = _combine(lse_l, tl_l, axis_name)
        ctx.save_for_backward(h, w, targets, token_w, lse)
        ctx.args = (axis_name, valid, vh, offset)
        weight_sum = token_w.sum()
        ctx.mark_non_differentiable(weight_sum)
        return ((lse - tl) * token_w).sum(), weight_sum

    @staticmethod
    def backward(ctx, ct_loss, _ct_count):
        h, w, targets, token_w, lse = ctx.saved_tensors
        axis_name, valid, vh, offset = ctx.args
        g = (ct_loss * token_w).float().contiguous()
        dh = fused_ce_dh(h, w, targets, lse, g, offset, valid, vh)
        if axis_name is not None:
            dh = all_reduce(dh, axis_name)
        dw = fused_ce_dw(h, w, targets, lse, g, offset, valid, vh)
        return dh, dw, None, None, None, None, None


def fused_ce_sums(hidden: torch.Tensor, weight: torch.Tensor,
                  targets: torch.Tensor, token_w: torch.Tensor,
                  axis_name: Optional[str] = None,
                  valid_size: Optional[int] = None,
                  weight_layout: str = "vh"):
    """(weighted loss sum, weight sum) of the cross entropy of ``hidden``
    (T, H) against ``weight``, fused: no (T, V) logits buffer, forward or
    backward. Differentiable in hidden and weight.

    ``weight_layout``: "vh" = (V, H) (BLOOM's tied embedding), "hv" =
    (H, V) (an untied head); both are read in place. The JAX function's
    ``block_t``/``block_v`` and its T padding are left out: they size the
    TPU's VMEM tiles, while the CUDA kernels take any T and V and mask the
    ragged edges themselves."""
    if weight_layout not in ("vh", "hv"):
        raise ValueError(f"weight_layout must be 'vh' or 'hv', got "
                         f"{weight_layout!r}")
    return _FusedCE.apply(
        hidden.contiguous(), weight.contiguous(),
        targets.to(torch.int32).contiguous(), token_w.float().contiguous(),
        axis_name, valid_size, weight_layout == "vh")


def fused_ce_shifted_sums(hidden, weight, labels, attention_mask,
                          axis_name: Optional[str] = None,
                          valid_size: Optional[int] = None,
                          weight_layout: str = "vh"):
    """Shift-by-one causal-LM (weighted loss sum, weight sum): hidden (B,
    S, H) predicts labels (B, S) one position on, weighted by
    ``attention_mask[:, 1:]`` (all ones when None)."""
    b, s, hd = hidden.shape
    w = (attention_mask[:, 1:] if attention_mask is not None
         else torch.ones_like(labels[:, 1:])).float()
    return fused_ce_sums(hidden[:, :-1].reshape(b * (s - 1), hd), weight,
                         labels[:, 1:].reshape(-1), w.reshape(-1), axis_name,
                         valid_size, weight_layout)


def fused_ce_shifted_loss(hidden, weight, labels, attention_mask,
                          axis_name: Optional[str] = None,
                          valid_size: Optional[int] = None,
                          weight_layout: str = "vh") -> torch.Tensor:
    """Causal-LM mean loss (shift by one, mask-weighted) through the fused
    kernels."""
    tot, cnt = fused_ce_shifted_sums(hidden, weight, labels, attention_mask,
                                     axis_name, valid_size, weight_layout)
    return tot / torch.clamp_min(cnt, 1)


def fused_ce_masked_sums(hidden, weight, labels, weights,
                         axis_name: Optional[str] = None,
                         valid_size: Optional[int] = None,
                         weight_layout: str = "vh"):
    """(weighted loss sum, weight sum) over positions already aligned with
    their labels (no shift): hidden (B, S, H), labels and weights (B, S)."""
    b, s, hd = hidden.shape
    return fused_ce_sums(hidden.reshape(b * s, hd), weight, labels.reshape(-1),
                         weights.reshape(-1).float(), axis_name, valid_size,
                         weight_layout)
