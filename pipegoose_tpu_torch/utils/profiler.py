"""The profiler trace of a training run.

The counterpart of ``pipegoose_tpu/utils/profiler.py``'s ``trace``, which
wraps ``jax.profiler.trace``: here ``torch.profiler.profile`` records the
host and, where a card is present, its kernels, and writes one Chrome trace
(Perfetto and ``chrome://tracing`` read it) per rank into the directory.
``device_memory_stats`` reads the caching allocator's live statistics. The
cost-analysis helpers of the JAX module read XLA's compiled HLO and wait for
ROADMAP.md queue A, item A13b.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Optional

import torch
import torch.distributed as dist


def device_memory_stats(device: Optional[Any] = None) -> dict:
    """Live device-memory statistics, under the JAX backends' key names:
    ``bytes_in_use`` (the caching allocator's allocated bytes),
    ``peak_bytes_in_use``, ``bytes_reserved`` (held by the allocator),
    ``bytes_limit`` (the card's total memory) and ``bytes_free`` (free on
    the card, ``mem_get_info``). A CPU device returns ``{"unavailable":
    "cpu"}`` rather than an empty dict, so a blank gauge reads as "this
    backend cannot say", not "no pressure". ``device`` None is the current
    CUDA device, and raises without CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to ask the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {"unavailable": device.type}
    stats = torch.cuda.memory_stats(device)
    free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "num_allocs": int(stats.get("allocation.all.current", 0)),
        "bytes_limit": int(total),
        "bytes_free": int(free),
    }


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body and write ``<logdir>/trace_rank<r>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_rank{rank}.json"))
