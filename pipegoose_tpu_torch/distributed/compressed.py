"""Quantized gradient collectives: a bf16 or int8 wire for the data-axis
gradient reduction, with optional error feedback.

The counterpart of ``pipegoose_tpu/distributed/compressed.py``, in three
wire precisions selected by ``grad_comm``:

- ``"fp32"``: the plain reduce-scatter;
- ``"bf16"``: cast, reduce-scatter in bf16, cast back (half the bytes);
- ``"int8"``: symmetric int8 with one float32 scale per destination chunk.
  An int8 reduce-scatter would wrap around, so the reduce phase is
  quantize -> ``all_to_all`` of the int8 payloads and their scales ->
  dequantize and sum in float32 on arrival: a quarter of the bytes, plus
  one scale per chunk.

ZeRO-1 stops after the reduce-scatter phase (``optim.zero``); the plain
data-parallel all-reduce adds a requantize and an ``all_gather``.

Error feedback carries the local quantization residual
``g - dequant(quant(g))`` from one step to the next and adds it back
before the next quantize, so the rounding error reaches later updates
instead of being lost. The residual lives in ``ZeroState.ef``.

The wire runs over the raw, gradient-free collectives of
``distributed.functional`` on the axis's process group. On an axis of one
rank there is no wire, but the rounding still happens: JAX's
``all_to_all`` and ``psum_scatter`` are the identity there, so an int8 or
bf16 reduction at dp = 1 still rounds every gradient, and so does this
one. Every division goes through ``_device.true_div`` or a divisor
tensor, so that the card rounds each quotient as the CPU and JAX do.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from pipegoose_tpu_torch._device import true_div
from pipegoose_tpu_torch.distributed.functional import (
    _all_gather_raw,
    _all_to_all_raw,
    _group,
    _reduce_scatter_raw,
    axis_size,
)

GRAD_COMM_MODES = ("fp32", "bf16", "int8")

_INT8_MAX = 127.0


def check_grad_comm(mode: Optional[str]) -> str:
    """The mode's name (None means "fp32"); ValueError for anything else."""
    mode = mode or "fp32"
    if mode not in GRAD_COMM_MODES:
        raise ValueError(f"grad_comm must be one of {GRAD_COMM_MODES}, got {mode!r}")
    return mode


def _quantize_chunks(flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_chunks, m) float32 -> (int8 values, per-chunk float32 scales):
    symmetric max-abs scaling per chunk, the scale floored at float32's
    ``tiny`` so that an all-zero chunk dequantizes to exact zeros.
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    scale = true_div(flat.abs().amax(dim=1), _INT8_MAX)
    scale = torch.clamp_min(scale, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(flat / scale[:, None]), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[:, None]


def _wire(raw, x, axis_name, *args):
    """A raw collective over the axis's group; the identity on one rank."""
    group = _group(axis_name)
    return x if group is None else raw(x, group, *args)


@torch.no_grad()
def compressed_reduce_scatter_mean(
    g_padded: torch.Tensor, axis_name: Optional[str], mode: str,
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The mean over ``axis_name`` of every rank's ``g_padded``, of which
    this rank keeps chunk ``rank`` of dim 0: the ZeRO-1 gradient phase at
    wire precision ``mode``.

    ``g_padded``: dim 0 already a multiple of the axis size.
    ``residual``: the previous step's error-feedback residual, shaped like
    ``g_padded`` (or None). Returns ``(float32 mean shard, new residual or
    None)``."""
    n = axis_size(axis_name)
    mode = check_grad_comm(mode)
    g32 = g_padded.float()
    if residual is not None:
        g32 = g32 + residual
    if mode == "fp32":
        out = _wire(_reduce_scatter_raw, g32, axis_name, 0)
        return true_div(out, n), (torch.zeros_like(g32) if residual is not None
                                  else None)
    if mode == "bf16":
        gq = g32.to(torch.bfloat16)
        new_res = g32 - gq.float() if residual is not None else None
        out = _wire(_reduce_scatter_raw, gq, axis_name, 0)
        return true_div(out.float(), n), new_res
    # int8: quantize per destination chunk, move the 1-byte payloads and
    # their scales with all_to_all, reduce in float32 on arrival
    shape = g32.shape
    flat = g32.reshape(n, -1)   # chunk row i is bound for rank i
    q, scale = _quantize_chunks(flat)
    new_res = ((flat - _dequantize(q, scale)).reshape(shape) if residual is not None
               else None)
    q_recv = _wire(_all_to_all_raw, q, axis_name, 0, 0)
    s_recv = _wire(_all_to_all_raw, scale, axis_name, 0, 0)
    mean = true_div(_dequantize(q_recv, s_recv).sum(dim=0), n)   # (m,)
    return mean.reshape((shape[0] // n, *shape[1:])), new_res


@torch.no_grad()
def compressed_all_reduce_mean(
    g: torch.Tensor, axis_name: Optional[str], mode: str,
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The full mean all-reduce at wire precision ``mode``, the plain-DP
    gradient sync: the compressed reduce-scatter above, then the reduced
    chunk requantized and all-gathered (both phases move compressed bytes).
    Any shape (dim 0 padded inside); returns ``(mean with g's shape and
    dtype, new residual or None)``."""
    n = axis_size(axis_name)
    mode = check_grad_comm(mode)
    orig_shape, orig_dtype = g.shape, g.dtype
    gp = g[None] if g.dim() == 0 else g
    pad = (-gp.shape[0]) % n
    if pad:
        gp = torch.cat([gp, gp.new_zeros((pad, *gp.shape[1:]))])
    own, new_res = compressed_reduce_scatter_mean(gp, axis_name, mode, residual)
    if mode == "fp32":
        full = _wire(_all_gather_raw, own, axis_name, 0)
    elif mode == "bf16":
        full = _wire(_all_gather_raw, own.to(torch.bfloat16), axis_name, 0).float()
    else:
        q, scale = _quantize_chunks(own.reshape(1, -1))
        q_full = _wire(_all_gather_raw, q, axis_name, 0)         # (n, m)
        s_full = _wire(_all_gather_raw, scale, axis_name, 0)     # (n,)
        full = _dequantize(q_full, s_full).reshape((-1, *own.shape[1:]))
    full = full[:orig_shape[0]] if len(orig_shape) else full[0]
    return full.reshape(orig_shape).to(orig_dtype), new_res


def wire_itemsize(mode: str) -> int:
    """Bytes per gradient element on the wire for a grad_comm mode."""
    return {"fp32": 4, "bf16": 2, "int8": 1}[check_grad_comm(mode)]


def grad_comm_bytes_saved(params: Any, n_ranks: int, mode: str) -> int:
    """The per-step wire bytes the reduce-scatter phase saves against
    float32: every leaf moves its padded size times the item size, and
    int8 adds one float32 scale per destination chunk. ``params``: a tree
    of dicts and lists whose leaves have ``shape`` (tensors or arrays)."""
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    mode = check_grad_comm(mode)
    isize = wire_itemsize(mode)
    saved = 0
    for p in tree_leaves(params):
        shape = tuple(p.shape)
        d0 = shape[0] if shape else 1
        size = 1
        for s in shape:
            size *= int(s)
        rest = size // max(d0, 1)
        padded = (-(-d0 // n_ranks) * n_ranks) * rest
        saved += padded * (4 - isize)
        if mode == "int8":
            saved -= n_ranks * 4   # the per-chunk float32 scales ride along
    return max(saved, 0)
