"""The profiler trace of a training run.

The counterpart of ``pipegoose_tpu/utils/profiler.py``'s ``trace``, which
wraps ``jax.profiler.trace``: here ``torch.profiler.profile`` records the
host and, where a card is present, its kernels, and writes one Chrome trace
(Perfetto and ``chrome://tracing`` read it) per rank into the directory.
The cost-analysis helpers of the JAX module read XLA's compiled HLO and are
ROADMAP.md queue A, item 13.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist


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
