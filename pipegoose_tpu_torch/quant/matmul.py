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
  version, on CUDA tensors they launch the kernel or raise. There is no
  fallback between the two. Each counts its launches in ``.launches``.

:func:`quantized_matmul` detects the layout from the ranks, flattens the
leading dims of ``x`` and returns float32, as the JAX function does. The
TPU tiling (``block_t``/``block_o``, the power-of-two token padding) and
the ``impl``/``interpret`` switches have no counterpart here.
"""
from __future__ import annotations

import ctypes

import torch

from pipegoose_tpu_torch.ops import _build

BLOCK_N = 256          # output columns per block: 16 lanes x 16 bytes (kBlockN)
K_LANES = 16           # contraction lanes per block (kKLanes)
SMS = 132              # streaming multiprocessors of one H100
WAVES = 2              # blocks per SM the K split aims for at small T
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


def _kernel_fn(kind: str, dtype):
    fn = getattr(_build.load("quant_matmul"), f"quant_matmul_{kind}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(kind: str, x, q, scale) -> torch.Tensor:
    int4 = kind == "int4"
    name = f"quantized_matmul_{kind}"
    t, k, n = _check_kernel_inputs(x, q, scale, int4, name)
    y = torch.empty((t, n), dtype=torch.float32, device=x.device)
    if t == 0 or n == 0:
        return y
    if k == 0:
        return y.zero_()
    units = k // 2 if int4 else k
    group = k // scale.shape[0] if int4 else 0
    splits, per = quant_splits(t, n, units)
    ws = (torch.empty((splits, t, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = _kernel_fn(kind, x.dtype)(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(),
            None if ws is None else ws.data_ptr(), y.data_ptr(),
            t, k, n, group, splits, per, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return y


def _device_of(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    return x.device.type


def quantized_matmul_int8(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """B10: x (T, K) float32 or bf16, q (K, N) int8, scale (N,) float32
    -> y (T, N) float32 = (x @ q) * scale."""
    if _device_of(x, "quantized_matmul_int8") == "cpu":
        return quantized_matmul_reference(x, q, scale)
    y = _launch("int8", x, q, scale)
    quantized_matmul_int8.launches += 1
    return y


def quantized_matmul_int4(x: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """B11: x (T, K) float32 or bf16, q (K/2, N) int8 (two nibbles a
    byte along K), scale (K/G, N) float32 -> y (T, N) float32 = x @
    (unpack(q) * scale[k/G, n])."""
    if _device_of(x, "quantized_matmul_int4") == "cpu":
        return quantized_matmul_reference(x, q, scale)
    y = _launch("int4", x, q, scale)
    quantized_matmul_int4.launches += 1
    return y


quantized_matmul_int8.launches = 0
quantized_matmul_int4.launches = 0


def quantized_matmul(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """float32 ``x @ dequantize(q, scale)`` without a float weight.

    ``q`` is (K, N) int8 with ``scale`` (N,), or int4-packed (K//2, N)
    with grouped ``scale`` (K//G, N); the layout is read from the ranks.
    Leading dims of ``x`` are batch, flattened through the kernel and
    restored. x of a float dtype other than float32/bf16 is widened to
    float32 first, as the JAX function widens every x."""
    int4 = _check_layout(x, q, scale)
    batch = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype not in _SUFFIX:
        x2 = x2.to(torch.float32)
    kernel = quantized_matmul_int4 if int4 else quantized_matmul_int8
    y = kernel(x2.contiguous(), q, scale)
    return y.reshape(*batch, q.shape[-1])
