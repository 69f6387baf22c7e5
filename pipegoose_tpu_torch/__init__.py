"""pipegoose_tpu on PyTorch and CUDA: the port of the JAX package
``pipegoose_tpu`` to an NVIDIA H100, slice by slice.

Ported so far: serving BLOOM through a paged KV pool
(``serving.ServingEngine``; its paged attention a CUDA kernel written for
Hopper, ``ops/csrc/paged_attention.cu``), with int8 or int4 weights
(``quant``; the dequant-fused matmul kernels of ``ops/csrc/
quant_matmul.cu``) and chunked or monolithic prefill; greedy or sampled
``models.generate.generate`` over a contiguous cache; and the
single-device BLOOM training step (``models.bloom.loss_fn``,
``trainer.train_step``; the flash-attention kernels of ``ops/csrc/
flash_attention.cu`` and the fused cross entropy of ``ops/csrc/
fused_ce.cu``); and sequence-parallel BLOOM training over a
``torch.distributed`` ``distributed.ParallelContext``
(``models.bloom.loss_fn_sp``, ``trainer.sp_train_step``; ring attention
through the chunk kernels of ``ops/csrc/flash_chunk.cu``, or Ulysses); and
the hybrid tensor x data parallel step with a ZeRO-1 optimizer and
gradient accumulation (``parallel.make_hybrid_train_step``,
``optim.DistributedOptimizer``; the tensor-parallel layers of
``nn/tensor_parallel``, each rank's flash and fused cross-entropy kernels
on its heads and vocabulary shard); and the host-side telemetry core
(``telemetry``: registry, spans, exporters, SLOs, the flight recorder, the
serving memory ledger, ``TelemetryCallback``) wired into the engine, the
Trainer and recovery.
Entry points run on the card unless called with
``device="cpu"``; nothing here builds a kernel or touches a card at
import time.
"""
from pipegoose_tpu_torch._device import resolve_device  # noqa: F401
