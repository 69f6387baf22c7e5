"""Weight-only quantized serving: int8/int4 block kernels and the
dequant-fused matmul (the counterpart of ``pipegoose_tpu/quant``).

- :mod:`pipegoose_tpu_torch.quant.weights`: ``quantize_params`` turns the
  block kernels of the port's params into ``{"q", "scale", "bias"}``
  leaves (per-channel symmetric int8, or grouped int4 packed two nibbles
  a byte) that the tensor-parallel layers dispatch on;
- :mod:`pipegoose_tpu_torch.quant.matmul`: ``quantized_matmul``, which on
  the card launches the hand-written kernels of ``ops/csrc/
  quant_matmul.cu`` and on the CPU runs their plain version.
"""
from pipegoose_tpu_torch.quant.matmul import (  # noqa: F401
    dequantize_weight,
    quantized_matmul,
    unpack_int4,
)
from pipegoose_tpu_torch.quant.weights import (  # noqa: F401
    QuantSpec,
    dequantize_params,
    quantize_params,
    quantized_weight_bytes,
)

__all__ = [
    "QuantSpec",
    "dequantize_params",
    "dequantize_weight",
    "quantize_params",
    "quantized_matmul",
    "quantized_weight_bytes",
    "unpack_int4",
]
