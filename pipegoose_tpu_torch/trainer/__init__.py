"""Training: the Trainer over the hybrid tensor x data parallel step, its
callbacks, logger and divergence recovery; and the single-device and the
sequence-parallel BLOOM train steps."""
from pipegoose_tpu_torch.trainer.callback import (  # noqa: F401
    Callback,
    CheckpointCallback,
    LossLoggerCallback,
)
from pipegoose_tpu_torch.trainer.logger import DistributedLogger  # noqa: F401
from pipegoose_tpu_torch.trainer.recovery import (  # noqa: F401
    AutoRecovery,
    FailureDetector,
    TrainingDiverged,
)
from pipegoose_tpu_torch.trainer.state import TrainerState, TrainerStatus  # noqa: F401
from pipegoose_tpu_torch.trainer.step import (  # noqa: F401
    make_optimizer,
    sp_train_step,
    train_step,
)
from pipegoose_tpu_torch.trainer.trainer import Trainer  # noqa: F401

__all__ = [
    "Trainer",
    "Callback",
    "LossLoggerCallback",
    "CheckpointCallback",
    "DistributedLogger",
    "TrainerState",
    "TrainerStatus",
    "FailureDetector",
    "AutoRecovery",
    "TrainingDiverged",
    "make_optimizer",
    "sp_train_step",
    "train_step",
]
