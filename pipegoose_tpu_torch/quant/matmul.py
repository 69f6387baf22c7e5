"""The dequant-fused matmul: y = x @ dequantize(q, scale), weights int8.

The counterpart of ``pipegoose_tpu/quant/matmul.py``. Two
implementations of one function:

- :func:`quantized_matmul_reference`, the plain PyTorch version of the
  JAX file's ``_matmul_xla``: int8 multiplies the int8-as-float32 product
  by the per-out-channel scale AFTER the sum; int4 dequantizes first
  (its scales vary along the contraction dim) and multiplies in float32;
- :func:`quantized_matmul_int8` / :func:`quantized_matmul_int4`, the
  wrappers of the hand-written kernels in ``ops/csrc/quant_matmul.cu``
  (kernels B10 and B11 of ROADMAP.md): on CPU tensors they call the plain
  version, on CUDA tensors they launch a kernel or raise. There is no
  fallback between the two. Each counts its launches in ``.launches``,
  and by route in ``.routes``.

On the card the wrappers take one of two routes (:func:`kernel_route`):

- ``"mma"``, the tensor-core kernel (bf16 ``mma.sync`` with float32
  accumulators), for bf16 x with K % 16 == 0, int4 groups of a multiple
  of 16 and a 16-byte aligned x: the serving path. The blocks of a K
  split form a cluster that adds its splits in split order through
  shared memory, and the same epilogue applies the int8 scale and, for
  :func:`quantized_linear`, the cast to bf16 and the bias, so one product
  is one launch;
- ``"fma"``, the float32-FMA kernel (plus its split-combine kernel),
  for float32 x, whose rounding to bf16 would change the function, and
  for any x the tensor-core route does not take (an int4 group of 8, say).

:func:`quantized_matmul` detects the layout from the ranks, flattens the
leading dims of ``x`` and returns float32, as the JAX function does;
:func:`quantized_linear` returns x's dtype with the bias added, as the
JAX ``_kernel_matmul`` plus the bias add of the parallel linears does.
The TPU tiling (``block_t``/``block_o``, the power-of-two token padding)
and the ``impl``/``interpret`` switches have no counterpart here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pipegoose_tpu_torch.ops import _build

BLOCK_N = 256          # float32 route: output columns per block, 16 lanes x 16 bytes (kBlockN)
K_LANES = 16           # float32 route: contraction lanes per block (kKLanes)
SMS = 132              # streaming multiprocessors of one H100
WAVES = 2              # float32 route: blocks per SM the K split aims for at small T
MMA_BK = 128           # tensor-core route: k per staged tile; a K split is a multiple (kMmaBK)
MMA_MAX_SPLITS = 8     # tensor-core route: a K split is a cluster of blocks, at most 8 (kMaxSplits)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//2, N) int8 -> (..., K, N) int8 values in [-8, 7]: the low
    nibble is row 2i, the high nibble row 2i+1. int8 ``<<`` wraps and
    ``>>`` is arithmetic, so the shifts sign-extend each nibble."""
    low = (packed << 4) >> 4
    high = packed >> 4
    inter = torch.stack([low, high], dim=-2)          # (..., K//2, 2, N)
    return inter.reshape(*packed.shape[:-2], packed.shape[-2] * 2,
                         packed.shape[-1])


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantized leaf -> float32 kernel. int8 per-channel scales have one
    dim fewer than ``q``; int4 grouped scales the same rank."""
    if scale.dim() == q.dim() - 1:
        return q.to(torch.float32) * scale[..., None, :]
    if scale.dim() != q.dim():
        raise ValueError(
            f"scale rank {scale.dim()} matches neither int8 (rank "
            f"{q.dim() - 1}) nor int4 (rank {q.dim()}) for q rank {q.dim()}"
        )
    q4 = unpack_int4(q)
    k = q4.shape[-2]
    groups = scale.shape[-2]
    if k % groups:
        raise ValueError(
            f"unpacked contraction dim {k} not divisible by "
            f"{groups} scale groups"
        )
    grouped = q4.reshape(*q4.shape[:-2], groups, k // groups, q4.shape[-1])
    w = grouped.to(torch.float32) * scale[..., None, :]
    return w.reshape(q4.shape)


def _check_layout(x, q, scale) -> bool:
    """The JAX function's shape checks; returns True for the int4 layout."""
    k_in = x.shape[-1]
    int4 = scale.dim() == q.dim()
    if not int4 and q.shape[-2] != k_in:
        raise ValueError(
            f"int8 weight contraction dim {q.shape[-2]} != x's {k_in}"
        )
    if int4 and q.shape[-2] * 2 != k_in:
        raise ValueError(
            f"int4-packed contraction dim {q.shape[-2]}*2 != x's {k_in}"
        )
    return int4


def quantized_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                               scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, float32 (..., N), in the JAX reference's
    scaling order."""
    int4 = _check_layout(x, q, scale)
    x32 = x.to(torch.float32)
    if int4:
        return torch.matmul(x32, dequantize_weight(q, scale))
    return torch.matmul(x32, q.to(torch.float32)) * scale


def quant_splits(t: int, n: int, units: int) -> tuple:
    """(splits, units per split) of the contraction dim: enough blocks for
    WAVES per SM when the (token, column) tiles alone are too few, each
    split a multiple of K_LANES units (an int8 row, or an int4 packed row
    of two), rounded down so the splits never fall short of the aim. One
    split needs no second pass."""
    tiles = -(-n // BLOCK_N) * -(-t // token_tile(t))
    aim = -(-WAVES * SMS // tiles)
    if aim <= 1:
        return 1, units
    per = max(K_LANES, units // aim // K_LANES * K_LANES)
    return -(-units // per), per


def token_tile(t: int) -> int:
    """Tokens per block (kernel template TT): a power of two up to 8."""
    tt = 1
    while tt < min(t, 8):
        tt *= 2
    return tt


def mma_token_tile(t: int) -> int:
    """Tokens per block of the tensor-core route (kernel template NT x 8):
    one, two, four or eight n8 MMA tiles."""
    return 8 if t <= 8 else 16 if t <= 16 else 32 if t <= 32 else 64


def mma_block_n(t: int) -> int:
    """Output columns per block of the tensor-core route: 16 per warp, four
    warps for token tiles of 8 and 16, eight above (MmaShape::kBN)."""
    return 64 if mma_token_tile(t) <= 16 else 128


def mma_blocks_per_sm(t: int) -> int:
    """Blocks of the tensor-core route one SM holds at once: two for token
    tiles of 8 and 16 (128 threads, a 50 KB ring); one above, where the
    ring (143 KB for int8) and ~170 registers a thread fill an SM."""
    return 2 if mma_token_tile(t) <= 16 else 1


def mma_splits(t: int, k: int, n: int) -> tuple:
    """(splits, k rows per split) of the tensor-core route. Where the
    (column, token) tiles leave SMs idle, K is cut into whole MMA_BK
    stages, as evenly as whole stages allow, into as many splits as fill
    one wave of blocks (SMS x :func:`mma_blocks_per_sm`) without passing
    it: a second wave costs more than the split saves. At most 8 splits
    (the blocks of one cluster) for tiles of 8-16 tokens, 6 above, where
    clusters of one-SM blocks spill into a second wave (measured on an
    H100). One split when the tiles alone fill the wave or K is one
    stage."""
    tiles = -(-n // mma_block_n(t)) * -(-t // mma_token_tile(t))
    stages = -(-k // MMA_BK)
    cap = MMA_MAX_SPLITS if mma_token_tile(t) <= 16 else 6
    target = min(stages, cap, SMS * mma_blocks_per_sm(t) // tiles)
    if target <= 1:
        return 1, k
    per = -(-stages // target)
    splits = -(-stages // per)
    return (1, k) if splits == 1 else (splits, per * MMA_BK)


def kernel_route(x_dtype: torch.dtype, k: int, group: int, x_ptr: int) -> str:
    """``"mma"`` (tensor cores) for a bf16 x whose K is a multiple of 16,
    int4 groups (``group`` > 0) a multiple of 16 and a 16-byte aligned
    data pointer; ``"fma"`` (float32 FMAs) for everything else."""
    if (x_dtype == torch.bfloat16 and k % 16 == 0 and group % 16 == 0
            and x_ptr % 16 == 0):
        return "mma"
    return "fma"


def _check_kernel_inputs(x, q, scale, int4: bool, name: str):
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"{name}: x must be (T, K) and q 2-D, got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if q.dtype != torch.int8:
        raise TypeError(f"{name}: q must be int8, got {q.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"{name}: scale must be float32, got {scale.dtype}")
    t, k = x.shape
    n = q.shape[1]
    if int4:
        if k % 2:
            raise ValueError(f"{name}: int4 needs an even contraction dim, got {k}")
        if q.shape[0] * 2 != k:
            raise ValueError(f"int4-packed contraction dim {q.shape[0]}*2 != x's {k}")
        if scale.dim() != 2 or scale.shape[1] != n or scale.shape[0] < 1:
            raise ValueError(f"{name}: scale must be (K/G, {n}), got {tuple(scale.shape)}")
        if k % scale.shape[0] or (k // scale.shape[0]) % 2:
            raise ValueError(f"{name}: {scale.shape[0]} scale groups must split "
                             f"K={k} into groups of an even size")
    else:
        if q.shape[0] != k:
            raise ValueError(f"int8 weight contraction dim {q.shape[0]} != x's {k}")
        if scale.shape != (n,):
            raise ValueError(f"{name}: scale must be ({n},), got {tuple(scale.shape)}")
    for label, tensor in (("x", x), ("q", q), ("scale", scale)):
        if tensor.device != x.device:
            raise ValueError(f"{name}: {label} is on {tensor.device}, x on {x.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    return t, k, n


def _kernel_fn(name: str, pointers: int, ints: int):
    """Entry ``name`` of the built library: ``pointers`` pointers, ``ints``
    ints and the stream."""
    fn = getattr(_build.load("quant_matmul"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(kind: str, x, q, scale, bias=None, out_dtype=torch.float32,
            route=None) -> torch.Tensor:
    """One product on the card: y (T, N) in ``out_dtype`` (float32, or x's
    bf16 with ``bias`` on the tensor-core route). :func:`kernel_route`
    picks the route; ``route="fma"`` forces the float32 one, which takes
    any x."""
    int4 = kind == "int4"
    wrapper = quantized_matmul_int4 if int4 else quantized_matmul_int8
    name = wrapper.__name__
    t, k, n = _check_kernel_inputs(x, q, scale, int4, name)
    group = k // scale.shape[0] if int4 else 0
    if route not in (None, "fma"):
        raise ValueError(f"{name}: only the float32 route can be forced, not {route!r}")
    route = route or kernel_route(x.dtype, k, group, x.data_ptr())
    if route == "fma" and (bias is not None or out_dtype != torch.float32):
        raise ValueError(f"{name}: the float32 route writes float32 without a bias")
    y = torch.empty((t, n), dtype=out_dtype, device=x.device)
    if t == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_() if bias is None else y.copy_(bias.expand(t, n))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if route == "mma":
            splits, per = mma_splits(t, k, n)
            err = _kernel_fn(f"quant_mma_{kind}", 5, 7)(
                x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(),
                t, k, n, group, splits, per, int(out_dtype == torch.bfloat16), stream)
        else:
            units = k // 2 if int4 else k
            splits, per = quant_splits(t, n, units)
            ws = (torch.empty((splits, t, n), dtype=torch.float32, device=x.device)
                  if splits > 1 else None)
            err = _kernel_fn(f"quant_matmul_{kind}_{_SUFFIX[x.dtype]}", 5, 6)(
                x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                None if ws is None else ws.data_ptr(), y.data_ptr(),
                t, k, n, group, splits, per, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed ({route} route): cudaError {err}")
    wrapper.launches += 1
    wrapper.routes[route] += 1
    return y


def _device_of(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return x.device.type


def quantized_matmul_int8(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """B10: x (T, K) float32 or bf16, q (K, N) int8, scale (N,) float32
    -> y (T, N) float32 = (x @ q) * scale. On the card, bf16 x takes the
    tensor-core route and float32 x the float32 one (:func:`kernel_route`)."""
    if _device_of(x, "quantized_matmul_int8") == "cpu":
        return quantized_matmul_reference(x, q, scale)
    return _launch("int8", x, q, scale)


def quantized_matmul_int4(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """B11: x (T, K) float32 or bf16, q (K/2, N) int8 (two nibbles a
    byte along K), scale (K/G, N) float32 -> y (T, N) float32 = x @
    (unpack(q) * scale[k/G, n]). On the card, bf16 x with G % 16 == 0
    takes the tensor-core route, anything else the float32 one."""
    if _device_of(x, "quantized_matmul_int4") == "cpu":
        return quantized_matmul_reference(x, q, scale)
    return _launch("int4", x, q, scale)


for _wrapper in (quantized_matmul_int8, quantized_matmul_int4):
    _wrapper.launches = 0                      # one per product, either route
    _wrapper.routes = {"mma": 0, "fma": 0}     # the same launches by route
del _wrapper


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """(..., K) -> contiguous (T, K); a float dtype other than float32/bf16
    widened to float32, as the JAX function widens every x."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype not in _SUFFIX:
        x2 = x2.to(torch.float32)
    return x2.contiguous()


def quantized_matmul(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """float32 ``x @ dequantize(q, scale)`` without a float weight.

    ``q`` is (K, N) int8 with ``scale`` (N,), or int4-packed (K//2, N)
    with grouped ``scale`` (K//G, N); the layout is read from the ranks.
    Leading dims of ``x`` are batch, flattened through the kernel and
    restored."""
    int4 = _check_layout(x, q, scale)
    kernel = quantized_matmul_int4 if int4 else quantized_matmul_int8
    y = kernel(_flatten(x), q, scale)
    return y.reshape(*x.shape[:-1], q.shape[-1])


def quantized_linear_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`quantized_linear`: the float32 product cast
    to x's dtype, then the bias added with PyTorch's type promotion."""
    y = quantized_matmul_reference(x, q, scale).to(x.dtype)
    return y if bias is None else y + bias


def quantized_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``quantized_matmul(x, q, scale).to(x.dtype) + bias``, bit for bit:
    for bf16 x, ``bf16(bf16(y) + bias)`` with both roundings to nearest
    even. Leading dims of ``x`` are batch.

    On the card's tensor-core route the cast and a bias of x's dtype, shape
    (N,) and device run in the kernel's epilogue: one launch a product. On
    the float32 route, or with another bias, they follow the kernel as
    PyTorch ops. Either way the kind's wrapper counts one launch."""
    int4 = _check_layout(x, q, scale)
    if _device_of(x, "quantized_linear") == "cpu":
        return quantized_linear_reference(x, q, scale, bias)
    kind = "int4" if int4 else "int8"
    x2 = _flatten(x)
    n = q.shape[-1]
    group = x2.shape[1] // scale.shape[0] if int4 else 0
    fused = (x2.dtype == torch.bfloat16
             and kernel_route(x2.dtype, x2.shape[1], group, x2.data_ptr()) == "mma"
             and (bias is None or (bias.dtype == x.dtype and tuple(bias.shape) == (n,)
                                   and bias.device == x.device and bias.is_contiguous())))
    if fused:
        y = _launch(kind, x2, q, scale, bias=bias, out_dtype=torch.bfloat16)
    else:
        y = _launch(kind, x2, q, scale).to(x.dtype)
        if bias is not None:
            y = y + bias
    return y.reshape(*x.shape[:-1], n)
