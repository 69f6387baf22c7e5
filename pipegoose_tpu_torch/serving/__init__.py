"""Continuous-batching serving over a paged KV pool."""
from pipegoose_tpu_torch.serving.engine import RequestOutput, ServingEngine  # noqa: F401
from pipegoose_tpu_torch.serving.kv_pool import PagePool  # noqa: F401
from pipegoose_tpu_torch.serving.scheduler import Request, Scheduler, Status  # noqa: F401
