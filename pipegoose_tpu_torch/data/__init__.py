"""Sharded token data loading (counterpart of ``pipegoose_tpu.data``)."""
from pipegoose_tpu_torch.data.dataloader import TokenDataset, write_token_file  # noqa: F401

__all__ = ["TokenDataset", "write_token_file"]
