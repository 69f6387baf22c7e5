"""pipegoose_tpu on PyTorch and CUDA: the port of the JAX package
``pipegoose_tpu`` to an NVIDIA H100, slice by slice.

Two slices are ported: serving BLOOM through a paged KV pool
(``serving.ServingEngine``, its paged attention a CUDA kernel written for
Hopper, ``ops/csrc/paged_attention.cu``), and the single-device BLOOM
training step (``models.bloom.loss_fn``, ``trainer.train_step``, its
flash-attention forward and backward CUDA kernels in
``ops/csrc/flash_attention.cu``). Entry points run on the card unless
called with ``device="cpu"``; nothing here builds a kernel or touches a
card at import time.
"""
from pipegoose_tpu_torch._device import resolve_device  # noqa: F401
