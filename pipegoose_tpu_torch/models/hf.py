"""HuggingFace checkpoint interop.

The counterpart of ``pipegoose_tpu/models/hf.py``: HF weights are converted
once, through a declarative RULES table per family (``models.convert``),
into the stacked JAX-layout numpy tree, and from there into the port's
per-layer params on a device (``models.weights.params_from_jax``). Four
families are registered: bloom, llama, mixtral and albert (``AlbertForMaskedLM``
with one hidden group of one inner layer and ``gelu_new``; other ALBERT
layouts raise NotImplementedError).

Layout notes:
- torch Linear stores (out, in); the port's kernels are (in, out) ->
  transpose.
- per-layer tensors are stacked on a leading n_layer axis in the numpy tree
  (and split into the per-layer list by ``params_from_jax``).
- BLOOM's fused qkv keeps HF's [n_head, 3, head_dim] output layout, so
  head-contiguous TP slicing stays correct.
"""
from __future__ import annotations

from typing import Any

import torch

from pipegoose_tpu_torch.models.bloom import BloomConfig
from pipegoose_tpu_torch.models.convert import (
    params_from_state_dict,
    register_family,
    state_dict_from_params,
)
from pipegoose_tpu_torch.models.weights import params_from_jax, params_to_jax

# -- BLOOM -----------------------------------------------------------------------

BLOOM_RULES = [
    {"path": "embed/weight", "hf": "word_embeddings.weight"},
    {"path": "embed_ln/scale", "hf": "word_embeddings_layernorm.weight"},
    {"path": "embed_ln/bias", "hf": "word_embeddings_layernorm.bias"},
    {"path": "blocks/ln_1/scale", "hf": "h.{l}.input_layernorm.weight"},
    {"path": "blocks/ln_1/bias", "hf": "h.{l}.input_layernorm.bias"},
    {"path": "blocks/attn/qkv/kernel",
     "hf": "h.{l}.self_attention.query_key_value.weight", "transpose": True},
    {"path": "blocks/attn/qkv/bias",
     "hf": "h.{l}.self_attention.query_key_value.bias"},
    {"path": "blocks/attn/out/kernel",
     "hf": "h.{l}.self_attention.dense.weight", "transpose": True},
    {"path": "blocks/attn/out/bias", "hf": "h.{l}.self_attention.dense.bias"},
    {"path": "blocks/ln_2/scale", "hf": "h.{l}.post_attention_layernorm.weight"},
    {"path": "blocks/ln_2/bias", "hf": "h.{l}.post_attention_layernorm.bias"},
    {"path": "blocks/mlp/up/kernel",
     "hf": "h.{l}.mlp.dense_h_to_4h.weight", "transpose": True},
    {"path": "blocks/mlp/up/bias", "hf": "h.{l}.mlp.dense_h_to_4h.bias"},
    {"path": "blocks/mlp/down/kernel",
     "hf": "h.{l}.mlp.dense_4h_to_h.weight", "transpose": True},
    {"path": "blocks/mlp/down/bias", "hf": "h.{l}.mlp.dense_4h_to_h.bias"},
    {"path": "ln_f/scale", "hf": "ln_f.weight"},
    {"path": "ln_f/bias", "hf": "ln_f.bias"},
]


def bloom_config_from_hf(hf_config, **overrides) -> BloomConfig:
    if getattr(hf_config, "apply_residual_connection_post_layernorm", False):
        raise NotImplementedError(
            "apply_residual_connection_post_layernorm=True checkpoints are not "
            "supported (bloom._block uses the standard pre-LN residual)")
    return BloomConfig(
        vocab_size=hf_config.vocab_size, hidden_size=hf_config.hidden_size,
        n_layer=hf_config.n_layer, n_head=hf_config.n_head,
        layer_norm_epsilon=hf_config.layer_norm_epsilon,
        initializer_range=hf_config.initializer_range, **overrides)


def bloom_params_from_hf(model: Any, dtype=torch.float32, device="cuda") -> tuple:
    """An HF ``BloomForCausalLM`` (or ``BloomModel``) -> (BloomConfig, the
    port's params on ``device``). The head is tied to the embedding, so
    only the embedding table is kept."""
    sd = dict(model.state_dict())
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    cfg = bloom_config_from_hf(model.config, dtype=dtype)
    tree = params_from_state_dict(sd, BLOOM_RULES, cfg.n_layer, prefix=prefix)
    return cfg, params_from_jax(tree, cfg, device=device)


def _stacked(params: dict) -> dict:
    return params_to_jax(params) if isinstance(params["blocks"], list) else params


def bloom_params_to_hf_state_dict(params: dict) -> dict:
    """The inverse, for exporting back to HF: numpy arrays keyed by HF names
    (wrap them in torch tensors to load). ``params`` is the port's tree or
    the stacked numpy tree."""
    out = state_dict_from_params(_stacked(params), BLOOM_RULES, prefix="transformer.")
    out["lm_head.weight"] = out["transformer.word_embeddings.weight"]
    return out


# -- Mixtral ---------------------------------------------------------------------

MIXTRAL_RULES = [
    {"path": "embed/weight", "hf": "model.embed_tokens.weight"},
    {"path": "blocks/ln_1/scale", "hf": "model.layers.{l}.input_layernorm.weight"},
    {"path": "blocks/attn/q/kernel",
     "hf": "model.layers.{l}.self_attn.q_proj.weight", "transpose": True},
    {"path": "blocks/attn/k/kernel",
     "hf": "model.layers.{l}.self_attn.k_proj.weight", "transpose": True},
    {"path": "blocks/attn/v/kernel",
     "hf": "model.layers.{l}.self_attn.v_proj.weight", "transpose": True},
    {"path": "blocks/attn/o/kernel",
     "hf": "model.layers.{l}.self_attn.o_proj.weight", "transpose": True},
    {"path": "blocks/ln_2/scale",
     "hf": "model.layers.{l}.post_attention_layernorm.weight"},
    {"path": "blocks/router/gate/kernel",
     "hf": "model.layers.{l}.block_sparse_moe.gate.weight", "transpose": True},
    {"path": "blocks/moe/w1/kernel",
     "hf": "model.layers.{l}.block_sparse_moe.experts.{e}.w1.weight", "transpose": True},
    {"path": "blocks/moe/w3/kernel",
     "hf": "model.layers.{l}.block_sparse_moe.experts.{e}.w3.weight", "transpose": True},
    {"path": "blocks/moe/w2/kernel",
     "hf": "model.layers.{l}.block_sparse_moe.experts.{e}.w2.weight", "transpose": True},
    {"path": "ln_f/scale", "hf": "model.norm.weight"},
    {"path": "lm_head/kernel", "hf": "lm_head.weight", "transpose": True},
]


def mixtral_config_from_hf(hf_config, **overrides):
    from pipegoose_tpu_torch.models.mixtral import MixtralConfig

    # HF treats a window of 0 or None as no sliding window
    window = getattr(hf_config, "sliding_window", None)
    return MixtralConfig(
        sliding_window=window if window and window > 0 else None,
        vocab_size=hf_config.vocab_size, hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        n_layer=hf_config.num_hidden_layers, n_head=hf_config.num_attention_heads,
        n_kv_head=hf_config.num_key_value_heads, num_experts=hf_config.num_local_experts,
        top_k=hf_config.num_experts_per_tok, rope_theta=hf_config.rope_theta,
        rms_eps=hf_config.rms_norm_eps,
        router_jitter=getattr(hf_config, "router_jitter_noise", 0.0) or 0.0,
        # 0.001 is MixtralConfig's documented router_aux_loss_coef default
        aux_loss_weight=getattr(hf_config, "router_aux_loss_coef", 0.001),
        **overrides)


def mixtral_params_from_hf(model: Any, dtype=torch.float32, device="cuda") -> tuple:
    """An HF ``MixtralForCausalLM`` -> (MixtralConfig, the port's params on
    ``device``), each layer's experts stacked (E, in, out)."""
    cfg = mixtral_config_from_hf(model.config, dtype=dtype)
    tree = params_from_state_dict(dict(model.state_dict()), MIXTRAL_RULES, cfg.n_layer,
                                  n_experts=cfg.num_experts)
    return cfg, params_from_jax(tree, cfg, device=device)


# -- Llama -----------------------------------------------------------------------

LLAMA_RULES = [
    {"path": "embed/weight", "hf": "model.embed_tokens.weight"},
    {"path": "blocks/ln_1/scale", "hf": "model.layers.{l}.input_layernorm.weight"},
    {"path": "blocks/attn/q/kernel",
     "hf": "model.layers.{l}.self_attn.q_proj.weight", "transpose": True},
    {"path": "blocks/attn/k/kernel",
     "hf": "model.layers.{l}.self_attn.k_proj.weight", "transpose": True},
    {"path": "blocks/attn/v/kernel",
     "hf": "model.layers.{l}.self_attn.v_proj.weight", "transpose": True},
    {"path": "blocks/attn/o/kernel",
     "hf": "model.layers.{l}.self_attn.o_proj.weight", "transpose": True},
    {"path": "blocks/ln_2/scale",
     "hf": "model.layers.{l}.post_attention_layernorm.weight"},
    {"path": "blocks/mlp/gate/kernel",
     "hf": "model.layers.{l}.mlp.gate_proj.weight", "transpose": True},
    {"path": "blocks/mlp/up/kernel",
     "hf": "model.layers.{l}.mlp.up_proj.weight", "transpose": True},
    {"path": "blocks/mlp/down/kernel",
     "hf": "model.layers.{l}.mlp.down_proj.weight", "transpose": True},
    {"path": "ln_f/scale", "hf": "model.norm.weight"},
    {"path": "lm_head/kernel", "hf": "lm_head.weight", "transpose": True,
     "optional": True},  # absent on tied checkpoints
]


def llama_config_from_hf(hf_config, **overrides):
    from pipegoose_tpu_torch.models.llama import LlamaConfig
    from pipegoose_tpu_torch.models.mixtral import RopeScaling

    rope_scaling = RopeScaling.from_hf(
        getattr(hf_config, "rope_scaling", None),
        # HF 'dynamic' checkpoints omit original_max_position_embeddings and
        # rescale relative to the model's max_position_embeddings
        default_original_max=getattr(hf_config, "max_position_embeddings", 8192))
    if getattr(hf_config, "attention_bias", False):
        raise NotImplementedError("attention_bias=True checkpoints not supported")
    derived_hd = hf_config.hidden_size // hf_config.num_attention_heads
    if getattr(hf_config, "head_dim", None) not in (None, derived_hd):
        raise NotImplementedError(
            f"explicit head_dim={hf_config.head_dim} != "
            f"hidden_size/num_attention_heads={derived_hd} not supported")
    return LlamaConfig(
        vocab_size=hf_config.vocab_size, hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        n_layer=hf_config.num_hidden_layers, n_head=hf_config.num_attention_heads,
        n_kv_head=hf_config.num_key_value_heads,
        rope_theta=getattr(hf_config, "rope_theta", 1e4), rope_scaling=rope_scaling,
        rms_eps=hf_config.rms_norm_eps,
        tie_word_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        **overrides)


def llama_params_from_hf(model: Any, dtype=torch.float32, device="cuda") -> tuple:
    """An HF ``LlamaForCausalLM`` -> (LlamaConfig, the port's params on
    ``device``); a tied checkpoint keeps no ``lm_head``."""
    cfg = llama_config_from_hf(model.config, dtype=dtype)
    tree = params_from_state_dict(dict(model.state_dict()), LLAMA_RULES, cfg.n_layer)
    if cfg.tie_word_embeddings:
        tree.pop("lm_head", None)
    return cfg, params_from_jax(tree, cfg, device=device)


# -- ALBERT (encoder family) -------------------------------------------------------

_ALBERT_L = "albert.encoder.albert_layer_groups.0.albert_layers.0."

ALBERT_RULES = [
    {"path": "embed/word/weight", "hf": "albert.embeddings.word_embeddings.weight"},
    {"path": "embed/pos", "hf": "albert.embeddings.position_embeddings.weight"},
    {"path": "embed/type", "hf": "albert.embeddings.token_type_embeddings.weight"},
    {"path": "embed/ln/scale", "hf": "albert.embeddings.LayerNorm.weight"},
    {"path": "embed/ln/bias", "hf": "albert.embeddings.LayerNorm.bias"},
    {"path": "map_in/kernel",
     "hf": "albert.encoder.embedding_hidden_mapping_in.weight", "transpose": True},
    {"path": "map_in/bias", "hf": "albert.encoder.embedding_hidden_mapping_in.bias"},
    # ONE shared layer (cross-layer parameter sharing): group 0, layer 0
    {"path": "layer/attn/q/kernel", "hf": _ALBERT_L + "attention.query.weight",
     "transpose": True},
    {"path": "layer/attn/q/bias", "hf": _ALBERT_L + "attention.query.bias"},
    {"path": "layer/attn/k/kernel", "hf": _ALBERT_L + "attention.key.weight",
     "transpose": True},
    {"path": "layer/attn/k/bias", "hf": _ALBERT_L + "attention.key.bias"},
    {"path": "layer/attn/v/kernel", "hf": _ALBERT_L + "attention.value.weight",
     "transpose": True},
    {"path": "layer/attn/v/bias", "hf": _ALBERT_L + "attention.value.bias"},
    {"path": "layer/attn/dense/kernel", "hf": _ALBERT_L + "attention.dense.weight",
     "transpose": True},
    {"path": "layer/attn/dense/bias", "hf": _ALBERT_L + "attention.dense.bias"},
    {"path": "layer/attn/ln/scale", "hf": _ALBERT_L + "attention.LayerNorm.weight"},
    {"path": "layer/attn/ln/bias", "hf": _ALBERT_L + "attention.LayerNorm.bias"},
    {"path": "layer/ffn/up/kernel", "hf": _ALBERT_L + "ffn.weight", "transpose": True},
    {"path": "layer/ffn/up/bias", "hf": _ALBERT_L + "ffn.bias"},
    {"path": "layer/ffn/down/kernel", "hf": _ALBERT_L + "ffn_output.weight",
     "transpose": True},
    {"path": "layer/ffn/down/bias", "hf": _ALBERT_L + "ffn_output.bias"},
    {"path": "layer/ffn/ln/scale", "hf": _ALBERT_L + "full_layer_layer_norm.weight"},
    {"path": "layer/ffn/ln/bias", "hf": _ALBERT_L + "full_layer_layer_norm.bias"},
    # the MLM head; the decoder weight is TIED to the word embedding
    {"path": "mlm/dense/kernel", "hf": "predictions.dense.weight", "transpose": True},
    {"path": "mlm/dense/bias", "hf": "predictions.dense.bias"},
    {"path": "mlm/ln/scale", "hf": "predictions.LayerNorm.weight"},
    {"path": "mlm/ln/bias", "hf": "predictions.LayerNorm.bias"},
    {"path": "mlm/bias", "hf": "predictions.bias"},
]


def albert_config_from_hf(hf_config, **overrides):
    """An HF ``AlbertConfig`` -> ``AlbertConfig``. Refuses (NotImplementedError)
    a layout other than one hidden group of one inner layer, and an
    activation other than ``gelu_new`` (the released v1/v2 one)."""
    from pipegoose_tpu_torch.models.albert import AlbertConfig

    if (getattr(hf_config, "num_hidden_groups", 1) != 1
            or getattr(hf_config, "inner_group_num", 1) != 1):
        raise NotImplementedError(
            "albert with num_hidden_groups/inner_group_num != 1 not supported "
            "(the standard released configs use 1 group x 1 inner layer)")
    act = getattr(hf_config, "hidden_act", "gelu_new")
    if act != "gelu_new":
        raise NotImplementedError(
            f"albert hidden_act={act!r} not supported (models/albert.py applies "
            "gelu_new, the released albert-v1/v2 activation)")
    return AlbertConfig(
        vocab_size=hf_config.vocab_size, embedding_size=hf_config.embedding_size,
        hidden_size=hf_config.hidden_size, n_layer=hf_config.num_hidden_layers,
        n_head=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        initializer_range=hf_config.initializer_range, **overrides)


def albert_params_from_hf(model: Any, dtype=torch.float32, device="cuda") -> tuple:
    """An HF ``AlbertForMaskedLM`` -> (AlbertConfig, the port's shared-layer
    params on ``device``)."""
    cfg = albert_config_from_hf(model.config, dtype=dtype)
    tree = params_from_state_dict(dict(model.state_dict()), ALBERT_RULES, cfg.n_layer)
    return cfg, params_from_jax(tree, cfg, device=device)


# -- family registry ---------------------------------------------------------------


def _load_bloom(model, dtype, device):
    from pipegoose_tpu_torch.models import bloom as module

    return (*bloom_params_from_hf(model, dtype, device), module)


def _load_mixtral(model, dtype, device):
    from pipegoose_tpu_torch.models import mixtral as module

    return (*mixtral_params_from_hf(model, dtype, device), module)


def _load_llama(model, dtype, device):
    from pipegoose_tpu_torch.models import llama as module

    return (*llama_params_from_hf(model, dtype, device), module)


def _load_albert(model, dtype, device):
    from pipegoose_tpu_torch.models import albert as module

    return (*albert_params_from_hf(model, dtype, device), module)


register_family("bloom", _load_bloom)
register_family("mixtral", _load_mixtral)
register_family("llama", _load_llama)
register_family("albert", _load_albert)

__all__ = [
    "bloom_config_from_hf", "bloom_params_from_hf", "bloom_params_to_hf_state_dict",
    "mixtral_config_from_hf", "mixtral_params_from_hf",
    "llama_config_from_hf", "llama_params_from_hf",
    "albert_config_from_hf", "albert_params_from_hf",
    "BLOOM_RULES", "MIXTRAL_RULES", "LLAMA_RULES", "ALBERT_RULES",
]
