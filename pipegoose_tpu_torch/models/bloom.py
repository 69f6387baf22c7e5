"""BLOOM in PyTorch: the config, the random init scheme, and the
single-device causal-LM forward and loss.

The counterpart of ``pipegoose_tpu/models/bloom.py``: the config, the
ALiBi slopes, the tanh GeLU, the tied-embedding LM head, the random init
scheme drawn from numpy so that full-width weights can be made on the
card from a seed, and the training forward (``forward_hidden``,
``forward``, ``loss_fn``) over the per-layer list of blocks that
``models.weights.params_from_jax`` builds. Attention takes the plain
branch, or with ``use_flash`` the flash kernels of
``ops.flash_attention``; the loss takes the full logits, one sequence
chunk of them at a time (``ce_chunks``), or the fused cross-entropy
kernels of ``ops.fused_ce`` (``fused_ce``). Tensor, pipeline and sequence parallelism wait
for later slices of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from pipegoose_tpu_torch.models.generate import _attn_core, _qkv_proj
from pipegoose_tpu_torch.nn.tensor_parallel.layers import (
    chunked_ce_sums,
    column_parallel_linear,
    layer_norm,
    row_parallel_linear,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)

NEG_INF = -1e9   # finite, as in the JAX package: masked scores stay finite


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    vocab_size: int = 250880
    hidden_size: int = 64
    n_layer: int = 2
    n_head: int = 8
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    # dtype of activations/params at run time: float32 for parity,
    # bfloat16 for throughput
    dtype: torch.dtype = torch.float32
    # rematerialize each block's activations in backward
    # (torch.utils.checkpoint per block)
    remat: bool = False
    # selective-remat policy under remat=True: None = full remat; "dots"
    # saves the linear layers' products; "attn" saves the attention output
    remat_policy: Optional[str] = None
    # the flash-attention kernels (ops/flash_attention.py) instead of the
    # plain attention branch
    use_flash: bool = False
    # set when the embedding was padded for TP divisibility: the true
    # vocab size; padded logit slots never win a greedy pick or enter the
    # cross entropy
    valid_vocab_size: Optional[int] = None
    # sequence-chunked cross entropy: the logits of one chunk at a time
    ce_chunks: Optional[int] = None
    # the fused cross-entropy kernels (ops/fused_ce.py): no logits buffer
    fused_ce: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_head

    @classmethod
    def bloom_560m(cls, **kw) -> "BloomConfig":
        return cls(vocab_size=250880, hidden_size=1024, n_layer=24, n_head=16, **kw)


def init_params_numpy(config: BloomConfig, seed: int) -> dict:
    """Random weights in the JAX parameter layout, as float32 numpy arrays:
    HF's scheme as ``bloom.init_params`` draws it (normal(0,
    initializer_range) for dense and embedding kernels, zero biases,
    ones/zeros LayerNorms, per-layer leaves stacked on a leading
    ``n_layer`` axis), from ``numpy.random.default_rng(seed)``. Feed the
    tree to ``weights.params_from_jax``."""
    h, v, L = config.hidden_size, config.vocab_size, config.n_layer
    std = np.float32(config.initializer_range)
    rng = np.random.default_rng(seed)

    def dense(shape):
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= std
        return w

    def ln(*lead):
        return {"scale": np.ones((*lead, h), np.float32),
                "bias": np.zeros((*lead, h), np.float32)}

    return {
        "embed": {"weight": dense((v, h))},
        "embed_ln": ln(),
        "blocks": {
            "ln_1": ln(L),
            "attn": {
                "qkv": {"kernel": dense((L, h, 3 * h)),
                        "bias": np.zeros((L, 3 * h), np.float32)},
                "out": {"kernel": dense((L, h, h)),
                        "bias": np.zeros((L, h), np.float32)},
            },
            "ln_2": ln(L),
            "mlp": {
                "up": {"kernel": dense((L, h, 4 * h)),
                       "bias": np.zeros((L, 4 * h), np.float32)},
                "down": {"kernel": dense((L, 4 * h, h)),
                         "bias": np.zeros((L, h), np.float32)},
            },
        },
        "ln_f": ln(),
    }


def alibi_slopes(n_head: int) -> np.ndarray:
    """Per-head slopes from the ALiBi paper's geometric recipe (matches
    HF build_alibi_tensor's closest-power-of-2 construction)."""
    closest = 2 ** math.floor(math.log2(n_head))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** i for i in range(1, closest + 1)]
    if closest != n_head:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        n_extra = min(closest, n_head - closest)
        slopes += [extra_base ** i for i in range(1, 2 * n_extra, 2)]
    return np.asarray(slopes, dtype=np.float32)


def bloom_gelu(x: torch.Tensor) -> torch.Tensor:
    """Megatron-style tanh gelu with HF's truncated constant 0.79788456
    (not the full-precision sqrt(2/pi)), as the JAX package keeps it."""
    return x * 0.5 * (1.0 + torch.tanh(0.79788456 * x * (1.0 + 0.044715 * x * x)))


def logits_fn(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """LM head tied to the embedding: float32 logits ``hidden @ Wᵀ``.

    The (V, H) embedding is used where it lies, never copied to float32:
    in a bf16 run cuBLAS accumulates in float32, the product is rounded
    to bf16 once, and the result is cast up."""
    w = params["embed"]["weight"]
    return torch.matmul(hidden, w.t()).float()


def build_alibi(attention_mask: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, n_head, 1, S) float32 bias: slope * key position, the position
    being the mask-aware index ``(cumsum(mask) - 1) * mask``."""
    slopes = torch.from_numpy(alibi_slopes(n_head)).to(attention_mask.device)
    pos = (torch.cumsum(attention_mask, dim=-1) - 1) * attention_mask
    return slopes[None, :, None, None] * pos[:, None, None, :].float()


def _attn_out(x: torch.Tensor) -> torch.Tensor:
    """Mark the attention output for ``remat_policy="attn"``: an identity
    op the selective-checkpoint policy can recognise (the JAX package names
    the tensor with ``checkpoint_name(ctx, "attn_out")``)."""
    return torch.ops.pipegoose_tpu_torch.attn_out(x)


@torch.library.custom_op("pipegoose_tpu_torch::attn_out", mutates_args=())
def _attn_out_op(x: torch.Tensor) -> torch.Tensor:
    return x.clone()   # a custom op may not return its input


@_attn_out_op.register_fake
def _(x):
    return torch.empty_like(x)


_attn_out_op.register_autograd(lambda ctx, grad: grad)


def _saved_ops(policy: str) -> tuple:
    """The aten ops whose outputs a selective policy keeps for backward.

    "dots" mirrors ``dots_with_no_batch_dims_saveable``: the four linear
    layers' ``x @ kernel`` run as ``aten.mm``, while the attention einsums
    (batched, ``aten.bmm``) are recomputed. "attn" keeps only the marked
    attention output."""
    if policy == "dots":
        return (torch.ops.aten.mm.default,)
    return (torch.ops.pipegoose_tpu_torch.attn_out.default,)


def _remat_wrap(fn, config):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in backward, except, with
    ``config.remat_policy`` "dots" or "attn", the outputs of the ops that
    :func:`_saved_ops` names. Any other policy is full remat, as in the JAX
    package.

    A selective policy sees aten ops, not kernels: the flash
    ``autograd.Function`` is rerun in the recompute to rebuild its saved
    (q, k, v, out, lse), so its forward kernel launches twice per layer
    under every policy, as ``jax.checkpoint`` reruns the custom_vjp's
    forward for residuals no policy names."""
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    policy = getattr(config, "remat_policy", None)
    context_fn = None
    if policy in ("dots", "attn"):
        saved = _saved_ops(policy)

        def policy_fn(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        def context_fn():
            return create_selective_checkpoint_contexts(policy_fn)

    def wrapped(*args):
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return wrapped


def _mlp(blk: dict, x: torch.Tensor, config: BloomConfig,
         tp_axis: Optional[str] = None) -> torch.Tensor:
    """ln_2 -> column up -> gelu -> row down."""
    ln2 = layer_norm(blk["ln_2"], x, config.layer_norm_epsilon)
    h = column_parallel_linear(blk["mlp"]["up"], ln2, tp_axis)
    return row_parallel_linear(blk["mlp"]["down"], bloom_gelu(h), tp_axis)


def _attention(blk: dict, x: torch.Tensor, bias: dict, config: BloomConfig,
               tp_axis: Optional[str] = None) -> torch.Tensor:
    """Self-attention of one block; ``bias`` is the dict from
    :func:`attention_bias`. Pad-query context is zero on both branches."""
    b, s, _ = x.shape
    q, k, v = _qkv_proj(blk, x, config, tp_axis)
    if config.use_flash:
        from pipegoose_tpu_torch.ops.flash_attention import flash_attention

        slopes = torch.from_numpy(alibi_slopes(config.n_head)).to(x.device)
        ctx = flash_attention(q, k, v, slopes, kv_pos=bias["kv_pos"],
                              kv_neg=bias["kv_neg"], causal=True)
        ctx = ctx * bias["qmask"][:, :, None, None].to(ctx.dtype)
        ctx = ctx.to(x.dtype).reshape(b, s, config.hidden_size)
    else:
        ctx = _attn_core(q, k, v, bias["alibi"] + bias["mask_bias"],
                         bias["qmask"], x.dtype)
    if config.remat and config.remat_policy == "attn":
        ctx = _attn_out(ctx)
    return row_parallel_linear(blk["out"], ctx, tp_axis)


def _block(blk: dict, x: torch.Tensor, bias: dict, config: BloomConfig,
           tp_axis: Optional[str] = None) -> torch.Tensor:
    """One transformer block, pre-LN, residual from the un-normalized
    stream (HF BloomBlock ordering)."""
    ln1 = layer_norm(blk["ln_1"], x, config.layer_norm_epsilon)
    x = x + _attention(blk["attn"], ln1, bias, config, tp_axis)
    return x + _mlp(blk, x, config, tp_axis)


def embed_tokens(params: dict, input_ids: torch.Tensor, config: BloomConfig,
                 tp_axis: Optional[str] = None) -> torch.Tensor:
    """Embedding lookup + embedding LayerNorm."""
    x = vocab_parallel_embedding(params["embed"], input_ids, tp_axis)
    return layer_norm(params["embed_ln"], x.to(config.dtype),
                      config.layer_norm_epsilon)


def attention_bias(attention_mask: torch.Tensor, config: BloomConfig) -> dict:
    """What the configured attention branch consumes: for flash the
    per-key ``kv_pos``/``kv_neg`` (no (S, S) tensor), else the per-head
    ``alibi`` and the dense causal/padding ``mask_bias``; ``qmask`` for
    both."""
    if config.use_flash:
        from pipegoose_tpu_torch.ops.flash_attention import mask_to_kv_bias

        kv_pos, kv_neg = mask_to_kv_bias(attention_mask)
        return {"kv_pos": kv_pos, "kv_neg": kv_neg, "qmask": attention_mask}
    s = attention_mask.shape[-1]
    causal = torch.ones((s, s), dtype=torch.bool,
                        device=attention_mask.device).tril()
    keep = causal[None, None] & (attention_mask[:, None, None, :] > 0)
    return {
        "alibi": build_alibi(attention_mask, config.n_head),
        "mask_bias": torch.where(keep, 0.0, NEG_INF).float(),
        "qmask": attention_mask,
    }


def forward_hidden(params: dict, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor], config: BloomConfig,
                   tp_axis: Optional[str] = None) -> torch.Tensor:
    """Embedding -> blocks -> final LN. Returns (B, S, H)."""
    b, s = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32,
                                    device=input_ids.device)
    x = embed_tokens(params, input_ids, config, tp_axis)
    bias = attention_bias(attention_mask, config)

    def block(blk, h):
        return _block(blk, h, bias, config, tp_axis)

    if config.remat:
        block = _remat_wrap(block, config)
    for blk in params["blocks"]:
        x = block(blk, x)
    return layer_norm(params["ln_f"], x, config.layer_norm_epsilon)


def forward(params: dict, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor], config: BloomConfig,
            tp_axis: Optional[str] = None) -> torch.Tensor:
    """Full causal-LM forward -> float32 logits (B, S, V)."""
    return logits_fn(params, forward_hidden(params, input_ids, attention_mask,
                                            config, tp_axis))


def loss_fn(params: dict, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
            config: BloomConfig, tp_axis: Optional[str] = None) -> torch.Tensor:
    """Next-token cross entropy (shift by one), weighted by
    ``attention_mask[:, 1:]``: with ``config.fused_ce`` through the fused
    kernels straight from the final hidden states and the tied embedding
    (no logits buffer), else with ``config.ce_chunks`` one sequence chunk
    of logits at a time, else over the full logits."""
    if config.fused_ce:
        from pipegoose_tpu_torch.ops.fused_ce import fused_ce_shifted_loss

        hidden = forward_hidden(params, input_ids, attention_mask, config, tp_axis)
        return fused_ce_shifted_loss(hidden, params["embed"]["weight"], labels,
                                     attention_mask, tp_axis,
                                     config.valid_vocab_size)
    if config.ce_chunks:
        hidden = forward_hidden(params, input_ids, attention_mask, config, tp_axis)
        w = (attention_mask[:, 1:] if attention_mask is not None
             else torch.ones_like(labels[:, 1:])).float()
        tot, cnt = chunked_ce_sums(
            hidden[:, :-1], labels[:, 1:], w, lambda h: logits_fn(params, h),
            tp_axis, config.valid_vocab_size, config.ce_chunks)
        return tot / torch.clamp_min(cnt, 1)
    logits = forward(params, input_ids, attention_mask, config, tp_axis)
    per_tok = vocab_parallel_cross_entropy(
        logits[:, :-1], labels[:, 1:], tp_axis,
        valid_size=config.valid_vocab_size)
    if attention_mask is not None:
        w = attention_mask[:, 1:].to(per_tok.dtype)
        return (per_tok * w).sum() / torch.clamp_min(w.sum(), 1)
    return per_tok.mean()
