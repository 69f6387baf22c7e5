"""pipegoose_tpu on PyTorch and CUDA: the port of the JAX package
``pipegoose_tpu`` to an NVIDIA H100, slice by slice.

Ported so far: serving BLOOM through a paged KV pool
(``serving.ServingEngine``; its paged attention a CUDA kernel written for
Hopper, ``ops/csrc/paged_attention.cu``), with int8 or int4 weights
(``quant``; the dequant-fused matmul kernels of ``ops/csrc/
quant_matmul.cu``) and chunked or monolithic prefill; greedy
``models.generate.generate`` over a contiguous cache; and the
single-device BLOOM training step (``models.bloom.loss_fn``,
``trainer.train_step``; the flash-attention kernels of ``ops/csrc/
flash_attention.cu`` and the fused cross entropy of ``ops/csrc/
fused_ce.cu``). Entry points run on the card unless called with
``device="cpu"``; nothing here builds a kernel or touches a card at
import time.
"""
from pipegoose_tpu_torch._device import resolve_device  # noqa: F401
