"""Training: the single-device BLOOM train step."""
from pipegoose_tpu_torch.trainer.step import make_optimizer, train_step  # noqa: F401
