"""Weight quantization of the port's BLOOM params for serving.

The counterpart of ``pipegoose_tpu/quant/weights.py``. ``quantize_params
(params, spec)`` replaces every transformer-block kernel (``attn.qkv``,
``attn.out``, ``mlp.up``, ``mlp.down`` of each ``blocks[i]``) with a
quantized leaf that ``nn.tensor_parallel.layers`` dispatches on by the
shape of the dict:

    {"kernel": (in, out) fp, "bias": ...}
      -> int8: {"q": (in, out) int8,
                "scale": (out,) float32,          # per OUT channel
                "bias": ...}
      -> int4: {"q": (in // 2, out) int8,         # two nibbles a byte
                "scale": (in // G, out) float32,  # per (group, out)
                "bias": ...}

The port's ``blocks`` is a list of per-layer dicts, so the scales carry
no leading layer axis. The embedding (which is also the LM head), the
LayerNorms and the biases stay full precision. Scaling is symmetric
max-abs with the scale clamped to float32's smallest normal, and values
round half to even (``torch.round``, as ``jnp.round``), so the port's
``q`` and ``scale`` equal the JAX package's bit for bit. int4 values lie
in [-8, 7]; row 2i of the contraction dim is the low nibble of packed row
i, row 2i + 1 the high nibble.

``quantize_param_specs(param_specs, params, spec)`` maps the spec tree of
the fp tree (``models.bloom.tp_specs``) onto that layout, so a quantized
tree can be sharded over a tensor axis (``nn.parallel.shard_tree``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from pipegoose_tpu_torch._device import true_div

WEIGHT_DTYPES = ("int8", "int4")

_INT8_MAX = 127.0
_INT4_MAX = 7.0


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """One weight-quantization recipe.

    ``weight_dtype``: "int8" (per-out-channel scales) or "int4"
    (grouped: one scale per ``group_size`` contraction rows per out
    channel, values packed two per byte). ``group_size`` must be even
    and divide every quantized kernel's contraction dim."""

    weight_dtype: str = "int8"
    group_size: int = 32

    def __post_init__(self):
        if self.weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(
                f"weight_dtype must be one of {WEIGHT_DTYPES}, got "
                f"{self.weight_dtype!r}"
            )
        if self.group_size < 2 or self.group_size % 2:
            raise ValueError(
                f"group_size must be an even int >= 2, got {self.group_size}"
            )


def _is_target(node: Any) -> bool:
    """A dense layer of one block: a dict holding a rank-2 ``kernel``."""
    return (isinstance(node, dict) and "kernel" in node
            and getattr(node["kernel"], "ndim", 0) == 2)


def pack_int4(q4: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int values in [-8, 7] -> (..., K//2, N) int8, row 2i
    in the low nibble and row 2i+1 in the high nibble of each byte."""
    if q4.shape[-2] % 2:
        raise ValueError(
            f"int4 packing needs an even contraction dim, got {tuple(q4.shape)}"
        )
    pairs = q4.reshape(*q4.shape[:-2], q4.shape[-2] // 2, 2, q4.shape[-1])
    low = pairs[..., 0, :].to(torch.int32) & 0xF
    high = pairs[..., 1, :].to(torch.int32) & 0xF
    return (low | (high << 4)).to(torch.uint8).view(torch.int8)


def _quantize_kernel(kernel: torch.Tensor, spec: QuantSpec) -> dict:
    k32 = kernel.detach().to(torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    if spec.weight_dtype == "int8":
        # per-out-channel symmetric: scale over the contraction dim
        scale = torch.clamp_min(true_div(k32.abs().amax(dim=-2), _INT8_MAX), tiny)
        q = torch.clamp(torch.round(k32 / scale[..., None, :]),
                        -_INT8_MAX, _INT8_MAX).to(torch.int8)
        return {"q": q, "scale": scale}
    g = spec.group_size
    k_in = kernel.shape[-2]
    if k_in % g:
        raise ValueError(
            f"int4 group_size={g} must divide the contraction dim "
            f"{k_in} of kernel shape {tuple(kernel.shape)}"
        )
    grouped = k32.reshape(*kernel.shape[:-2], k_in // g, g, kernel.shape[-1])
    scale = torch.clamp_min(true_div(grouped.abs().amax(dim=-2), _INT4_MAX), tiny)
    q4 = torch.clamp(torch.round(grouped / scale[..., None, :]),
                     -8.0, _INT4_MAX).to(torch.int8)
    return {"q": pack_int4(q4.reshape(kernel.shape)), "scale": scale}


def quantize_params(params: dict, spec: QuantSpec) -> dict:
    """The same tree with every block kernel replaced by its quantized
    ``{"q", "scale"[, "bias"]}`` leaf, computed on the kernel's device.
    Bias and every other leaf pass through as the same objects."""

    def layer(blk: dict) -> dict:
        out = {}
        for k, v in blk.items():
            if _is_target(v):
                leaf = _quantize_kernel(v["kernel"], spec)
                leaf.update((kk, vv) for kk, vv in v.items() if kk != "kernel")
                out[k] = leaf
            elif isinstance(v, dict):
                out[k] = layer(v)
            else:
                out[k] = v
        return out

    return {k: ([layer(b) for b in v] if k == "blocks" else v)
            for k, v in params.items()}


def dequantize_params(qparams: dict, dtype=torch.float32) -> dict:
    """Quantized leaves back to ``{"kernel", ...}`` fp leaves of ``dtype``
    (lossy: the round-trip error is what the accuracy tests bound)."""
    from pipegoose_tpu_torch.quant.matmul import dequantize_weight

    def walk(node: Any) -> Any:
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, dict):
            if "q" in node and "scale" in node:
                out = {"kernel": dequantize_weight(node["q"], node["scale"]).to(dtype)}
                out.update((k, v) for k, v in node.items() if k not in ("q", "scale"))
                return out
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(qparams)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def bytes_by_dtype(tree) -> dict:
    """Bytes of every tensor leaf of ``tree``, grouped by the dtype's name
    as numpy and JAX give it ("int8", "bfloat16")."""
    by_dtype: dict = {}
    for leaf in _leaves(tree):
        key = str(leaf.dtype).removeprefix("torch.")
        by_dtype[key] = by_dtype.get(key, 0) + leaf.numel() * leaf.element_size()
    return by_dtype


def quantize_param_specs(param_specs: Any, params: Any, spec: QuantSpec) -> Any:
    """The spec tree matching ``quantize_params``' layout.

    ``q`` inherits the kernel's spec (int4's packed contraction dim is the
    same axis, halved: contiguous shards stay contiguous). The scale's spec
    drops the contraction entry for int8 (per-out-channel scales: a
    row-parallel kernel's are replicated over its shards) and keeps the
    kernel's spec for int4 (the grouped contraction dim shards with the
    kernel). ``params`` is the ORIGINAL fp tree, the port's (``blocks`` a
    list) or the JAX numpy one (``blocks`` stacked): it decides which
    leaves are targets, a ``kernel`` of rank >= 2 under ``blocks``, so
    specs and params cannot drift. Specs are tuples, one entry per
    dimension (``nn.parallel_mapping``)."""

    def walk(spec_node: Any, param_node: Any, in_blocks: bool) -> Any:
        if isinstance(param_node, list):
            return [walk(s, p, in_blocks) for s, p in zip(spec_node, param_node)]
        if not isinstance(param_node, dict):
            return spec_node
        if (in_blocks and "kernel" in param_node
                and getattr(param_node["kernel"], "ndim", 0) >= 2):
            kspec = tuple(spec_node["kernel"])
            entries = kspec + (None,) * (param_node["kernel"].ndim - len(kspec))
            sspec = (entries[:-2] + entries[-1:] if spec.weight_dtype == "int8"
                     else entries)
            out = {"q": kspec, "scale": sspec}
            out.update((k, v) for k, v in spec_node.items() if k != "kernel")
            return out
        return {k: walk(spec_node[k], v, in_blocks or k == "blocks")
                for k, v in param_node.items()}

    return walk(param_specs, params, False)


def quantized_weight_bytes(params: dict) -> dict:
    """Byte census of a (possibly quantized) param tree, grouped by dtype
    name as the JAX package names them, so the two reports compare
    equal. Works on fp trees too (one fp entry)."""
    by_dtype = bytes_by_dtype(params)
    return {"bytes_by_dtype": by_dtype,
            "total_bytes": int(sum(by_dtype.values()))}


def validate_tp_compat(config: Any, tp: int, spec: Optional[QuantSpec]) -> None:
    """int4 groups must divide the row-parallel kernels' per-shard
    contraction dims (h/tp for attn.out, 4h/tp for mlp.down), and the
    packed dim must split evenly over the shards."""
    if spec is None or spec.weight_dtype != "int4" or tp <= 1:
        return
    h = config.hidden_size
    for name, k_in in (("attn.out", h), ("mlp.down", 4 * h)):
        local = k_in // tp
        if k_in % tp or local % spec.group_size or local % 2:
            raise ValueError(
                f"int4 group_size={spec.group_size} incompatible with "
                f"tp={tp}: {name} kernel's per-shard contraction dim "
                f"{k_in}/{tp} must be even and a multiple of the group"
            )
