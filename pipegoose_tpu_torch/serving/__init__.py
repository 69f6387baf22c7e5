"""Continuous-batching serving over a paged KV pool."""
from pipegoose_tpu_torch.serving.engine import (  # noqa: F401
    RequestOutput,
    ServingEngine,
    make_skewed_replay,
    prefix_replay_benchmark,
)
from pipegoose_tpu_torch.serving.kv_pool import PagePool  # noqa: F401
from pipegoose_tpu_torch.serving.prefix_cache import PrefixCache, PrefixHit  # noqa: F401
from pipegoose_tpu_torch.serving.scheduler import Request, Scheduler, Status  # noqa: F401
