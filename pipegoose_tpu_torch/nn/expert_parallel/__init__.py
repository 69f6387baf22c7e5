"""Expert parallelism (counterpart of ``pipegoose_tpu.nn.expert_parallel``)."""
from pipegoose_tpu_torch.nn.expert_parallel.expert_parallel import ExpertParallel
from pipegoose_tpu_torch.nn.expert_parallel.experts import expert_mlp, init_experts, moe_layer
from pipegoose_tpu_torch.nn.expert_parallel.loss import ExpertLoss
from pipegoose_tpu_torch.nn.expert_parallel.routers import (
    RouterOutput,
    SwitchNoisePolicy,
    Top1Router,
    Top2Router,
    TopKRouter,
)

__all__ = [
    "ExpertParallel",
    "expert_mlp",
    "init_experts",
    "moe_layer",
    "ExpertLoss",
    "RouterOutput",
    "SwitchNoisePolicy",
    "Top1Router",
    "Top2Router",
    "TopKRouter",
]
