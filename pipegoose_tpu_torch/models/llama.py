"""Llama in PyTorch: the dense RoPE/GQA decoder (RMSNorm, RoPE with HF's
scaling, GQA, SwiGLU MLP).

The counterpart of ``pipegoose_tpu/models/llama.py``. The attention stack is
Mixtral's (``models.mixtral``: ``rms_norm``, ``rope_cos_sin`` with
``RopeScaling``, ``rope_attention_bias``, ``_attention`` through the flash
kernels B1-B3 with ``use_flash``, ``_attention_sp`` for the sequence-parallel
loss, ``_attn_cached`` for decode); only the MLP differs, a dense SwiGLU
instead of routed experts. Every parallel form applies: tensor parallel
(``specs``), the pipeline losses ``loss_fn_pp`` (GPipe) and ``loss_fn_1f1b``
with ``stage_layer_counts``, the sequence-parallel ``loss_fn_sp`` and KV-cache
generation. The head is tied to the embedding or untied; with ``fused_ce``
it goes to the fused kernels B4-B6 in its native layout, "vh" for the tied
(V, H) embedding, "hv" for an untied (H, V) kernel.

Where this parts from the JAX model (ROADMAP.md § C): q and k are cast back
to the model's dtype after RoPE, and ``init_params_numpy`` draws from a numpy
seed in place of ``init_params``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pipegoose_tpu_torch.distributed.functional import copy_to_tensor_group
from pipegoose_tpu_torch.models import mixtral as _mx
from pipegoose_tpu_torch.models.bloom import _split_batch
from pipegoose_tpu_torch.models.mixtral import (
    RopeScaling,
    _attention,
    rms_norm,
    rope_attention_bias,
)
from pipegoose_tpu_torch.nn.parallel import spec_tree
from pipegoose_tpu_torch.nn.pipeline_parallel.partitioner import stage_layers
from pipegoose_tpu_torch.nn.tensor_parallel.layers import (
    column_parallel_linear,
    row_parallel_linear,
)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32
    rope_theta: float = 1e4
    # HF rope_scaling (linear / dynamic / llama3); None = plain RoPE
    rope_scaling: Optional[RopeScaling] = None
    rms_eps: float = 1e-5
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.float32
    remat: bool = False
    # the flash kernels after RoPE; GQA on the nkv-headed K/V
    use_flash: bool = False
    # the fused cross-entropy kernels on the head in its native layout
    fused_ce: bool = False
    valid_vocab_size: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_head

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                   n_layer=32, n_head=32, n_kv_head=8, rope_theta=5e5, **kw)


# -- init ------------------------------------------------------------------------


def _shapes(config: LlamaConfig) -> dict:
    h, v, L = config.hidden_size, config.vocab_size, config.n_layer
    hd, nh, nkv = config.head_dim, config.n_head, config.n_kv_head
    f = config.intermediate_size
    shapes = {
        "embed": {"weight": (v, h)},
        "blocks": {
            "ln_1": {"scale": (L, h)},
            "attn": {"q": {"kernel": (L, h, nh * hd)}, "k": {"kernel": (L, h, nkv * hd)},
                     "v": {"kernel": (L, h, nkv * hd)}, "o": {"kernel": (L, nh * hd, h)}},
            "ln_2": {"scale": (L, h)},
            "mlp": {"gate": {"kernel": (L, h, f)}, "up": {"kernel": (L, h, f)},
                    "down": {"kernel": (L, f, h)}},
        },
        "ln_f": {"scale": (h,)},
    }
    if not config.tie_word_embeddings:
        shapes["lm_head"] = {"kernel": (h, v)}
    return shapes


def init_params_numpy(config: LlamaConfig, seed: int) -> dict:
    """Random weights in the JAX parameter layout, as float32 numpy arrays
    (the JAX ``init_params`` scheme: normal(0, initializer_range) kernels and
    embedding, ones RMSNorm scales, no ``lm_head`` when tied), from
    ``numpy.random.default_rng(seed)``. Feed the tree to
    ``weights.params_from_jax``."""
    return _mx.init_params_numpy(config, seed, _shapes(config))


def init_params(config: LlamaConfig, seed: int, device="cuda") -> dict:
    """The same scheme drawn straight into the port's per-layer tree on
    ``device`` from a ``torch.Generator`` (``mixtral.init_params``)."""
    return _mx.init_params(config, seed, device, _shapes(config))


# -- forward ---------------------------------------------------------------------


def _mlp(blk: dict, x: torch.Tensor, tp_axis: Optional[str]) -> torch.Tensor:
    """SwiGLU: down(silu(gate x) * up x), gate/up column, down row."""
    g = column_parallel_linear(blk["gate"], x, tp_axis)
    u = column_parallel_linear(blk["up"], x, tp_axis)
    return row_parallel_linear(blk["down"], torch.nn.functional.silu(g) * u, tp_axis)


def _block(blk: dict, x: torch.Tensor, cos, sin, bias: dict, config: LlamaConfig,
           tp_axis: Optional[str] = None) -> torch.Tensor:
    h = rms_norm(blk["ln_1"], x, config.rms_eps)
    x = x + _attention(blk["attn"], h, cos, sin, bias, config, tp_axis)
    h = rms_norm(blk["ln_2"], x, config.rms_eps)
    return x + _mlp(blk["mlp"], h, tp_axis)


def _rope(config: LlamaConfig, s: int, device):
    return _mx.rope_cos_sin(s, config.head_dim, config.rope_theta, config.rope_scaling,
                            device)


def forward_hidden(params: dict, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor], config: LlamaConfig,
                   tp_axis: Optional[str] = None) -> torch.Tensor:
    """Embedding -> blocks (each recomputed in backward with ``remat``) ->
    final RMSNorm. Returns (B, S, H)."""
    attention_mask = _mx._default_mask(input_ids, attention_mask)
    x = _mx.embed(params, input_ids, config, tp_axis)
    cos, sin = _rope(config, input_ids.shape[1], x.device)
    bias = rope_attention_bias(attention_mask, config)

    def block(blk, h):
        return _block(blk, h, cos, sin, bias, config, tp_axis)

    block = _mx.remat_wrap(block, config)
    for blk in params["blocks"]:
        x = block(blk, x)
    return rms_norm(params["ln_f"], x, config.rms_eps)


def logits_fn(params: dict, hidden: torch.Tensor, config: LlamaConfig,
              tp_axis: Optional[str] = None) -> torch.Tensor:
    """The head: tied checkpoints reuse the (vocab-sharded) embedding as
    BLOOM does (float32 logits of ``hidden @ Wᵀ``, the f-operator on
    ``hidden`` under TP), untied ones the column-parallel (H, V/tp) kernel."""
    if config.tie_word_embeddings:
        if tp_axis is not None:
            hidden = copy_to_tensor_group(hidden, tp_axis)
        return torch.matmul(hidden, params["embed"]["weight"].t()).float()
    return column_parallel_linear(params["lm_head"], hidden, tp_axis)


def forward(params, input_ids, attention_mask, config, tp_axis=None) -> torch.Tensor:
    """Logits (B, S, V/tp)."""
    return logits_fn(params, forward_hidden(params, input_ids, attention_mask, config,
                                            tp_axis), config, tp_axis)


def _head_weight_layout(params: dict, config: LlamaConfig):
    """(weight, fused-CE layout) of the head in its native form: tied = the
    (V/tp, H) embedding ("vh"), untied = the (H, V/tp) kernel ("hv")."""
    if config.tie_word_embeddings:
        return params["embed"]["weight"], "vh"
    return params["lm_head"]["kernel"], "hv"


def _head(params, config, tp_axis):
    return ((lambda h: logits_fn(params, h, config, tp_axis)),
            _head_weight_layout(params, config))


def loss_fn(params: dict, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
            config: LlamaConfig, tp_axis: Optional[str] = None) -> torch.Tensor:
    """Next-token cross entropy, weighted by ``attention_mask[:, 1:]``: with
    ``config.fused_ce`` through the fused kernels straight from the final
    hidden states and the head in its native layout (no logits buffer), else
    over the full logits."""
    hidden = forward_hidden(params, input_ids, attention_mask, config, tp_axis)
    fn, lw = _head(params, config, tp_axis)
    tot, cnt = _mx._shifted_sums(hidden, fn, lw, labels, attention_mask, config, tp_axis)
    return tot / torch.clamp_min(cnt, 1)


def specs(params: dict, tp_axis: str = "tensor") -> dict:
    """Specs: q/k/v/gate/up column, o/down row, the embedding vocab-sharded,
    the untied head column-parallel. On the JAX numpy tree (``blocks``
    stacked) each block spec has a leading None for the layer dim, as the
    JAX ``specs`` gives it; on the port's per-layer tree none."""
    t = tp_axis
    lead = (None,) if isinstance(params["blocks"], dict) else ()

    def spec_fn(path, x):
        if any(k in path for k in ("attn/q", "attn/k", "attn/v", "mlp/gate", "mlp/up")):
            return (*lead, None, t)
        if "attn/o" in path or "mlp/down" in path:
            return (*lead, t, None)
        if "embed/weight" in path:
            return (t, None)
        if "lm_head" in path:
            return (None, t)
        return ()

    return spec_tree(params, spec_fn)


def pp_specs(params: dict, tp_axis: str = "tensor", pipe_axis: str = "pipe") -> dict:
    """:func:`specs` with every block leaf marked with the pipe axis."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import pipe_stage_specs

    sp = specs(params, tp_axis)
    sp["blocks"] = pipe_stage_specs(sp["blocks"], pipe_axis)
    return sp


# -- pipeline-parallel compositions ----------------------------------------------


def _stage_fn(config, blocks, pipe_axis, stage_layer_counts, cos, sin, tp_axis):
    n_valid, _ = stage_layers(config.n_layer, blocks, stage_layer_counts, pipe_axis)

    def block(blk, h, bias):
        return _block(blk, h, cos, sin, bias, config, tp_axis)

    def stage_fn(blocks, h, side):
        for blk in blocks[:n_valid]:
            h = block(blk, h, side["bias"])
        return h

    return stage_fn


def loss_fn_pp(params: dict, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
               config: LlamaConfig, n_microbatches: int,
               tp_axis: Optional[str] = None, pipe_axis: str = "pipe",
               stage_layer_counts=None) -> torch.Tensor:
    """Pipeline-parallel (GPipe) loss over the "pipe" axis, structured as
    ``bloom.loss_fn_pp``: stage 0 embeds, :func:`gpipe` runs this stage's
    blocks (``pp_specs``), the last stage takes the final RMSNorm, the head
    (tied or untied) and the cross entropy; the loss and gradients equal
    :func:`loss_fn`'s. ``stage_layer_counts``: uneven stages."""
    from pipegoose_tpu_torch.distributed.functional import axis_index, axis_size
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import gpipe, last_stage_value

    _, mbs = _split_batch(input_ids, attention_mask, labels, n_microbatches)
    h0 = _mx.pipe_entry(params, mbs["ids"], config, tp_axis, pipe_axis)
    cos, sin = _rope(config, input_ids.shape[1], input_ids.device)
    side = {"bias": _mx.stacked_bias(mbs["mask"], config)}
    stage_fn = _stage_fn(config, params["blocks"], pipe_axis, stage_layer_counts, cos,
                         sin, tp_axis)
    outs = gpipe(stage_fn, params["blocks"], h0, side_inputs=side,
                 axis_name=pipe_axis, remat=config.remat)
    if axis_index(pipe_axis) != axis_size(pipe_axis) - 1:
        return last_stage_value(outs.float().sum() * 0, pipe_axis)
    fn, lw = _head(params, config, tp_axis)
    tot = cnt = 0.0
    for i in range(n_microbatches):
        h = rms_norm(params["ln_f"], outs[i], config.rms_eps)
        t, c = _mx._shifted_sums(h, fn, lw, mbs["labels"][i], mbs["mask"][i], config,
                                 tp_axis)
        tot, cnt = tot + t, cnt + c
    return last_stage_value(tot / torch.clamp_min(cnt, 1), pipe_axis)


def loss_fn_1f1b(params: dict, input_ids: torch.Tensor,
                 attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
                 config: LlamaConfig, n_microbatches: int,
                 tp_axis: Optional[str] = None, pipe_axis: str = "pipe",
                 stage_layer_counts=None) -> torch.Tensor:
    """Llama on the 1F1B runtime: the loss and gradients of
    :func:`loss_fn_pp`, a stage's live activations bounded by the stage
    count. Tied heads too: the embedding gets its input and head gradients."""
    mask, mbs = _split_batch(input_ids, attention_mask, labels, n_microbatches)
    cos, sin = _rope(config, input_ids.shape[1], input_ids.device)
    side = {"bias": _mx.stacked_bias(mbs["mask"], config), "labels": mbs["labels"],
            "mask": mbs["mask"]}
    count = torch.clamp_min(mask[:, 1:].sum().float(), 1)
    stage_fn = _mx.remat_wrap(
        _stage_fn(config, params["blocks"], pipe_axis, stage_layer_counts, cos, sin,
                  tp_axis), config)

    def head_fn(hp, h, side):
        h = rms_norm(hp["ln_f"], h, config.rms_eps)
        fn, lw = _head(hp, config, tp_axis)
        tot, _ = _mx._shifted_sums(h, fn, lw, side["labels"], side["mask"], config,
                                   tp_axis)
        return (tot / count).float()

    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import one_f_one_b_loss

    head_keys = ("ln_f", "embed") if config.tie_word_embeddings else ("ln_f", "lm_head")
    return one_f_one_b_loss(
        params, stage_fn, head_fn, ("embed",), head_keys,
        lambda ep: _mx.pipe_entry(ep, mbs["ids"], config, tp_axis, pipe_axis), side,
        pipe_axis)


# -- sequence-parallel composition -----------------------------------------------


def loss_fn_sp(params: dict, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
               config: LlamaConfig, tp_axis: Optional[str] = None,
               sp_axis: str = "seq", variant: str = "ring") -> torch.Tensor:
    """Sequence-parallel Llama loss: ring (or Ulysses) attention over
    ``sp_axis`` with RoPE at global positions (``rope_scaling`` honoured),
    through Mixtral's ``_attention_sp``; the cross entropy over the
    cross-chunk shifted targets. Replicated gradients are summed over
    ``sp_axis`` by the train step."""
    from pipegoose_tpu_torch.nn.sequence_parallel.targets import sp_shifted_targets

    attention_mask = _mx._default_mask(input_ids, attention_mask)
    x = _mx.embed(params, input_ids, config, tp_axis)

    def block(blk, h):
        ln1 = rms_norm(blk["ln_1"], h, config.rms_eps)
        h = h + _mx._attention_sp(blk["attn"], ln1, config, tp_axis, sp_axis,
                                  attention_mask, variant)
        return h + _mlp(blk["mlp"], rms_norm(blk["ln_2"], h, config.rms_eps), tp_axis)

    block = _mx.remat_wrap(block, config)
    for blk in params["blocks"]:
        x = block(blk, x)
    x = rms_norm(params["ln_f"], x, config.rms_eps)
    sl, sw = sp_shifted_targets(labels, attention_mask, sp_axis)
    fn, lw = _head(params, config, tp_axis)
    return _mx.sp_task(*_mx._masked_sums(x, fn, lw, sl, sw, config, tp_axis), sp_axis)


# -- generation (KV cache) -------------------------------------------------------


def init_cache(config: LlamaConfig, batch: int, max_len: int, device="cuda") -> dict:
    """Zero nkv-wide KV cache (``mixtral.init_cache``)."""
    return _mx.init_cache(config, batch, max_len, device=device)


def forward_cached(params: dict, ids: torch.Tensor, cache: dict, start: int,
                   config: LlamaConfig):
    """(logits of the last position (B, V), the cache written in place):
    Mixtral's grouped-GQA cached attention with the dense SwiGLU. Dynamic
    RoPE scaling raises NotImplementedError: its frequencies depend on the
    current length, so tables built at the cache's capacity would rescale
    short prompts that HF leaves unscaled."""
    if config.rope_scaling is not None and config.rope_scaling.rope_type == "dynamic":
        raise NotImplementedError(
            "rope_scaling type 'dynamic' is not supported in the KV-cache decode path "
            "(length-dependent frequencies)")
    x = _mx.decode_layers(params, ids, cache, start, config,
                          lambda blk, h: _mlp(blk["mlp"], h, None), config.rope_scaling)
    return logits_fn(params, x[:, -1:], config, None)[:, 0], cache


def generate(params: dict, input_ids, config: LlamaConfig, max_new_tokens: int,
             temperature: float = 0.0, eos_token_id: Optional[int] = None,
             device="cuda", generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy or sampled decoding with the GQA KV cache through the shared
    loop: (B, S) prompt ids -> (B, S + max_new_tokens) int64 on ``device``."""
    return _mx._generate(forward_cached, params, input_ids, config, max_new_tokens,
                         temperature, eos_token_id, device, generator)


__all__ = [
    "LlamaConfig", "RopeScaling", "init_params_numpy", "init_params", "forward_hidden",
    "logits_fn", "forward", "loss_fn", "specs", "pp_specs", "loss_fn_pp",
    "loss_fn_1f1b", "loss_fn_sp", "init_cache", "forward_cached", "generate",
]
