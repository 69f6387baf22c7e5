"""Training: the single-device and the sequence-parallel BLOOM train steps."""
from pipegoose_tpu_torch.trainer.step import (  # noqa: F401
    make_optimizer,
    sp_train_step,
    train_step,
)
