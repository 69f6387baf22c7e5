"""Parallel train-step composition (counterpart of ``pipegoose_tpu.parallel``):
the hybrid tensor x data + ZeRO-1 step and the gradient sync, and the
auto-parallel step over DTensor."""
from pipegoose_tpu_torch.parallel.auto import make_auto_train_step  # noqa: F401
from pipegoose_tpu_torch.parallel.hybrid import (  # noqa: F401
    build_hybrid_train_step,
    hybrid_build_config,
    hybrid_step_kwargs,
    make_hybrid_train_step,
    parallel_context_sizes,
    spec_mentions,
    sync_replicated_grads,
    zero_state_spec,
)
