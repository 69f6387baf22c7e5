"""BLOOM, BLOOM-MoE, Llama, Mixtral and ALBERT, and the HF converter
(counterparts of ``pipegoose_tpu.models``)."""
from pipegoose_tpu_torch.models import albert, bloom, bloom_moe, llama, mixtral
from pipegoose_tpu_torch.models.albert import AlbertConfig
from pipegoose_tpu_torch.models.bloom import BloomConfig
from pipegoose_tpu_torch.models.bloom_moe import BloomMoEConfig
from pipegoose_tpu_torch.models.convert import from_hf, register_family
from pipegoose_tpu_torch.models.llama import LlamaConfig
from pipegoose_tpu_torch.models.mixtral import MixtralConfig

__all__ = ["albert", "bloom", "bloom_moe", "llama", "mixtral", "AlbertConfig",
           "BloomConfig", "BloomMoEConfig", "LlamaConfig", "MixtralConfig", "from_hf",
           "register_family"]
