"""BLOOM and BLOOM-MoE (counterparts of ``pipegoose_tpu.models``)."""
from pipegoose_tpu_torch.models import bloom, bloom_moe
from pipegoose_tpu_torch.models.bloom import BloomConfig
from pipegoose_tpu_torch.models.bloom_moe import BloomMoEConfig

__all__ = ["bloom", "bloom_moe", "BloomConfig", "BloomMoEConfig"]
