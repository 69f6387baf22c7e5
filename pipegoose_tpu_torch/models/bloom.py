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
kernels of ``ops.fused_ce`` (``fused_ce``). The sequence-parallel loss
(``loss_fn_sp``) runs the blocks on this rank's chunk of the sequence with
ring attention (the chunk kernels B7-B9 with ``use_flash``) or Ulysses.
Under ``tp_axis`` every path is Megatron tensor parallel: heads are
sharded over the axis (each rank's ALiBi slopes are its heads' slice),
the MLP column/row parallel, and the tied embedding and LM head
vocab-sharded (``pad_for_tp``, ``tp_mapping``, ``tp_specs``); with
``overlap_tp`` the stream between blocks is sharded over tokens and the
tensor axis's collectives run as ring hops beside partial matmuls
(``nn.tensor_parallel.overlap``). The pipeline losses (``loss_fn_pp``:
GPipe; ``loss_fn_1f1b``: 1F1B; ``loss_fn_pp_sp``: GPipe over
sequence-sharded stages) run this rank's stage of the blocks over the
"pipe" axis (``pp_specs``), even or uneven (``stage_layer_counts``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from pipegoose_tpu_torch.distributed.functional import (
    axis_index,
    axis_size,
    copy_to_tensor_group,
    gather_from_tensor_group,
    scatter_to_tensor_group,
)
from pipegoose_tpu_torch.models.generate import _attn_core, _qkv_proj, local_heads
from pipegoose_tpu_torch.nn.parallel import spec_tree
from pipegoose_tpu_torch.nn.parallel_mapping import Column, ParallelMapping, Row, Vocab
from pipegoose_tpu_torch.nn.tensor_parallel.overlap import replicated_for_overlap
from pipegoose_tpu_torch.nn.tensor_parallel.layers import (
    chunked_ce_sums,
    column_parallel_linear,
    layer_norm,
    row_parallel_linear,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)
from pipegoose_tpu_torch.nn.tensor_parallel.tensor_parallel import pad_vocab

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
    # the ring collective-matmul overlap of the tensor axis
    # (nn/tensor_parallel/overlap.py): the training forward keeps the stream
    # between blocks TOKEN-SHARDED over the tensor axis; serving and the
    # pipeline / sequence-parallel losses ignore it. Needs seq % tp == 0
    overlap_tp: bool = False

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


def logits_fn(params: dict, hidden: torch.Tensor,
              tp_axis: Optional[str] = None) -> torch.Tensor:
    """LM head tied to the embedding: float32 logits ``hidden @ Wᵀ``, under
    ``tp_axis`` this rank's vocab shard (what the vocab-parallel cross
    entropy takes).

    The f-operator on ``hidden`` is load-bearing: each rank's hidden
    cotangent is only its vocab shard's part, and the f-operator's
    backward all-reduce completes it; without it every gradient upstream
    of the head is wrong under TP. The (V/tp, H) embedding is used where
    it lies, never copied to float32: in a bf16 run cuBLAS accumulates in
    float32, the product is rounded to bf16 once, and the result is cast
    up."""
    if tp_axis is not None:
        hidden = copy_to_tensor_group(hidden, tp_axis)
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
         tp_axis: Optional[str] = None, overlap: bool = False) -> torch.Tensor:
    """ln_2 -> column up -> gelu -> row down. ``overlap``: ``x`` is this
    rank's token chunk, the up projection ring-gathers tokens and the down
    projection ring-reduces them back to the chunk; ``ln_2`` then sees
    local tokens only, so its parameters go through the f-operator."""
    ln2_p = blk["ln_2"]
    if overlap:
        ln2_p = replicated_for_overlap(ln2_p, tp_axis)
    ln2 = layer_norm(ln2_p, x, config.layer_norm_epsilon)
    h = column_parallel_linear(blk["mlp"]["up"], ln2, tp_axis, overlap=overlap)
    return row_parallel_linear(blk["mlp"]["down"], bloom_gelu(h), tp_axis,
                               overlap=overlap)


def _local_slopes(config: BloomConfig, tp_axis: Optional[str], device) -> torch.Tensor:
    """The ALiBi slopes of this rank's heads: ``slopes[h0 : h0 + nh/tp]``
    with ``h0 = axis_index x nh/tp``."""
    lh = local_heads(config, tp_axis)
    h0 = axis_index(tp_axis) * lh
    return torch.from_numpy(alibi_slopes(config.n_head)[h0:h0 + lh]).to(device)


def _attention(blk: dict, x: torch.Tensor, bias: dict, config: BloomConfig,
               tp_axis: Optional[str] = None, overlap: bool = False) -> torch.Tensor:
    """Self-attention of one block, heads sharded over ``tp_axis`` (qkv
    column-parallel, the output projection row-parallel); ``bias`` is the
    dict from :func:`attention_bias`. Pad-query context is zero on both
    branches. ``overlap``: ``x`` is this rank's token chunk; the qkv
    projection ring-gathers every token, attention runs on the whole
    sequence, and the output projection ring-reduces back to the chunk."""
    lh = local_heads(config, tp_axis)
    if overlap:
        fused = column_parallel_linear(blk["qkv"], x, tp_axis, overlap=True)
        b, s, _ = fused.shape
        fused = fused.reshape(b, s, lh, 3, config.head_dim)
        q, k, v = fused[..., 0, :], fused[..., 1, :], fused[..., 2, :]
    else:
        b, s, _ = x.shape
        q, k, v = _qkv_proj(blk, x, config, tp_axis)
    if config.use_flash:
        from pipegoose_tpu_torch.ops.flash_attention import flash_attention

        ctx = flash_attention(q, k, v, _local_slopes(config, tp_axis, x.device),
                              kv_pos=bias["kv_pos"], kv_neg=bias["kv_neg"],
                              causal=True)
        ctx = ctx * bias["qmask"][:, :, None, None].to(ctx.dtype)
        ctx = ctx.to(x.dtype).reshape(b, s, lh * config.head_dim)
    else:
        h0 = axis_index(tp_axis) * lh
        alibi = bias["alibi"][:, h0:h0 + lh]
        ctx = _attn_core(q, k, v, alibi + bias["mask_bias"], bias["qmask"], x.dtype)
    if config.remat and config.remat_policy == "attn":
        ctx = _attn_out(ctx)
    return row_parallel_linear(blk["out"], ctx, tp_axis, overlap=overlap)


def _block(blk: dict, x: torch.Tensor, bias: dict, config: BloomConfig,
           tp_axis: Optional[str] = None, overlap: bool = False) -> torch.Tensor:
    """One transformer block, pre-LN, residual from the un-normalized
    stream (HF BloomBlock ordering). ``overlap``: the ring collective-matmul
    path, ``x`` this rank's token chunk of the stream (set by
    :func:`forward_hidden` from ``config.overlap_tp``)."""
    ln1_p = blk["ln_1"]
    if overlap:
        ln1_p = replicated_for_overlap(ln1_p, tp_axis)
    ln1 = layer_norm(ln1_p, x, config.layer_norm_epsilon)
    x = x + _attention(blk["attn"], ln1, bias, config, tp_axis, overlap=overlap)
    return x + _mlp(blk, x, config, tp_axis, overlap=overlap)


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
    """Embedding -> blocks -> final LN. Returns (B, S, H).

    With ``config.overlap_tp`` under a tensor axis the stream between
    blocks is TOKEN-SHARDED: one scatter after the embedding, ring
    collective-matmuls inside every block, one gather before the final LN;
    the hidden states equal the monolithic path's (float32 allclose). The
    sequence length must divide over the axis (ValueError)."""
    b, s = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32,
                                    device=input_ids.device)
    x = embed_tokens(params, input_ids, config, tp_axis)
    bias = attention_bias(attention_mask, config)
    overlap = bool(config.overlap_tp) and tp_axis is not None
    if overlap:
        tp = axis_size(tp_axis)
        if s % tp:
            raise ValueError(f"overlap_tp: sequence length {s} must be divisible by "
                             f"the tensor axis size {tp} (token chunks ride the ring)")
        x = scatter_to_tensor_group(x, tp_axis, dim=1)

    def block(blk, h):
        return _block(blk, h, bias, config, tp_axis, overlap=overlap)

    if config.remat:
        block = _remat_wrap(block, config)
    for blk in params["blocks"]:
        x = block(blk, x)
    if overlap:
        x = gather_from_tensor_group(x, tp_axis, dim=1)
    return layer_norm(params["ln_f"], x, config.layer_norm_epsilon)


def forward(params: dict, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor], config: BloomConfig,
            tp_axis: Optional[str] = None) -> torch.Tensor:
    """Full causal-LM forward -> float32 logits (B, S, V/tp)."""
    return logits_fn(params, forward_hidden(params, input_ids, attention_mask,
                                            config, tp_axis), tp_axis)


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
            hidden[:, :-1], labels[:, 1:], w, lambda h: logits_fn(params, h, tp_axis),
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


# -- sequence-parallel composition ---------------------------------------------


def _sp_alibi_pos(pad_mask_local: torch.Tensor, sp_axis: str) -> torch.Tensor:
    """Global mask-aware ALiBi key positions of this sequence chunk: BLOOM's
    ``(cumsum(mask) - 1) * mask`` over the FULL sequence, from one small
    all_gather of the chunks' mask counts. Equal to plain global positions
    for unpadded or right-padded batches; what HF computes for left-padded
    ones. Computed once per step and threaded through the blocks."""
    from pipegoose_tpu_torch.distributed.functional import (
        all_gather,
        axis_index,
        axis_size,
    )

    m = pad_mask_local.float()
    counts = all_gather(m.sum(dim=-1)[None], sp_axis, dim=0)   # (sp, B)
    earlier = torch.arange(axis_size(sp_axis), device=m.device) < axis_index(sp_axis)
    prefix = torch.where(earlier[:, None], counts, 0.0).sum(dim=0)
    return (prefix[:, None] + torch.cumsum(m, dim=-1) - 1.0) * m


def _attention_sp(blk: dict, x: torch.Tensor, config: BloomConfig,
                  tp_axis: Optional[str], sp_axis: str,
                  pad_mask_local: torch.Tensor, variant: str = "ring",
                  alibi_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BLOOM attention with the sequence sharded over ``sp_axis``.

    ``variant="ring"``: K/V chunks rotate over the ring, through the chunk
    kernels B7-B9 with ``config.use_flash`` (``ring_flash_attention``),
    else in dense math (``ring_attention``); ``"ulysses"``: all_to_all
    re-sharding on heads around full-sequence attention (the flash kernels
    B1-B3 with ``use_flash``). ALiBi takes ``alibi_pos`` (global mask-aware
    positions, :func:`_sp_alibi_pos`), or plain global positions when None.
    Pad-query context is zero in every branch."""
    from pipegoose_tpu_torch.nn.sequence_parallel.ring_attention import (
        make_causal_alibi_bias_fn,
        ring_attention,
        ring_flash_attention,
    )

    if variant not in ("ring", "ulysses"):
        raise ValueError(f"unknown SP variant {variant!r} (ring, ulysses)")
    b, s_local, _ = x.shape
    q, k, v = _qkv_proj(blk, x, config, tp_axis)
    slopes = _local_slopes(config, tp_axis, x.device)
    if variant == "ulysses":
        from pipegoose_tpu_torch.nn.sequence_parallel.ulysses import (
            ulysses_causal_attention,
        )

        ctx = ulysses_causal_attention(q, k, v, sp_axis, pad_mask_local,
                                       alibi_slopes=slopes, use_flash=config.use_flash,
                                       alibi_pos_local=alibi_pos)
    elif config.use_flash:
        ctx = ring_flash_attention(q, k, v, sp_axis, alibi_slopes=slopes,
                                   kv_side=pad_mask_local, alibi_pos=alibi_pos)
    else:
        bias_fn = make_causal_alibi_bias_fn(s_local, sp_axis, alibi_slopes=slopes)
        side = ((pad_mask_local, alibi_pos) if alibi_pos is not None
                else pad_mask_local)
        ctx = ring_attention(q, k, v, sp_axis, bias_fn, kv_side=side)
    ctx = ctx * pad_mask_local[:, :, None, None].to(ctx.dtype)
    if config.remat and config.remat_policy == "attn":
        ctx = _attn_out(ctx)
    ctx = ctx.to(x.dtype).reshape(b, s_local, local_heads(config, tp_axis)
                                  * config.head_dim)
    return row_parallel_linear(blk["out"], ctx, tp_axis)


def _sp_block(blk: dict, h: torch.Tensor, config: BloomConfig,
              tp_axis: Optional[str], sp_axis: str, pad_mask_local: torch.Tensor,
              variant: str = "ring", alibi_pos=None) -> torch.Tensor:
    """One transformer block on sequence-sharded activations."""
    ln1 = layer_norm(blk["ln_1"], h, config.layer_norm_epsilon)
    h = h + _attention_sp(blk["attn"], ln1, config, tp_axis, sp_axis,
                          pad_mask_local, variant, alibi_pos=alibi_pos)
    return h + _mlp(blk, h, config, tp_axis)


def _sp_head_sums(params: dict, x: torch.Tensor, attention_mask: torch.Tensor,
                  labels: torch.Tensor, config: BloomConfig,
                  tp_axis: Optional[str], sp_axis: str):
    """Final LN, then the LOCAL (weighted loss sum, weight sum) of this
    shard against the next-token targets across shards
    (``sp_shifted_targets``): through the fused kernels with
    ``config.fused_ce``, else over the full (B, S_local, V) logits."""
    from pipegoose_tpu_torch.nn.sequence_parallel.targets import sp_shifted_targets

    x = layer_norm(params["ln_f"], x, config.layer_norm_epsilon)
    shifted_labels, shifted_w = sp_shifted_targets(labels, attention_mask, sp_axis)
    if config.fused_ce:
        from pipegoose_tpu_torch.ops.fused_ce import fused_ce_masked_sums

        return fused_ce_masked_sums(x, params["embed"]["weight"], shifted_labels,
                                    shifted_w, tp_axis, config.valid_vocab_size)
    per_tok = vocab_parallel_cross_entropy(logits_fn(params, x, tp_axis), shifted_labels,
                                           tp_axis, valid_size=config.valid_vocab_size)
    w = shifted_w.to(per_tok.dtype)
    return (per_tok * w).sum(), w.sum()


def loss_fn_sp(params: dict, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
               config: BloomConfig, tp_axis: Optional[str] = None,
               sp_axis: str = "seq", variant: str = "ring") -> torch.Tensor:
    """Sequence-parallel causal-LM loss: ``input_ids``, ``attention_mask``
    and ``labels`` are this rank's (B, S_local) chunk of the sequence axis
    ``sp_axis``; every activation stays sequence-sharded and attention is
    the ring (or Ulysses, see :func:`_attention_sp`). Returns the global
    loss on every rank; its backward gives each rank's partial gradients,
    which the train step sums over ``sp_axis``
    (``parallel.hybrid.sync_replicated_grads``). Under ``tp_axis`` heads,
    MLP and vocabulary are also sharded over the tensor axis."""
    from pipegoose_tpu_torch.distributed.functional import (
        all_reduce,
        reduce_from_tensor_group,
    )

    b, s_local = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s_local), dtype=torch.int32,
                                    device=input_ids.device)
    x = embed_tokens(params, input_ids, config, tp_axis)
    apos = _sp_alibi_pos(attention_mask, sp_axis)

    def block(blk, h):
        return _sp_block(blk, h, config, tp_axis, sp_axis, attention_mask, variant,
                         alibi_pos=apos)

    if config.remat:
        block = _remat_wrap(block, config)
    for blk in params["blocks"]:
        x = block(blk, x)
    total, w_sum = _sp_head_sums(params, x, attention_mask, labels, config,
                                 tp_axis, sp_axis)
    count = all_reduce(w_sum, sp_axis)
    # identity-backward combine: each rank's gradients stay its own partials
    return reduce_from_tensor_group(total / torch.clamp_min(count, 1), sp_axis)


# -- pipeline-parallel compositions ---------------------------------------------


def _stacked_bias(masks: torch.Tensor, config: BloomConfig) -> dict:
    """:func:`attention_bias` of each microbatch's mask (M, mb, S), stacked
    on a leading M dim: the pipeline's per-microbatch side inputs."""
    per = [attention_bias(m, config) for m in masks]
    return {k: torch.stack([b[k] for b in per]) for k in per[0]}


def _split_batch(input_ids, attention_mask, labels, n_microbatches):
    from pipegoose_tpu_torch.nn.pipeline_parallel import microbatch as mb

    if attention_mask is None:
        attention_mask = torch.ones(input_ids.shape, dtype=torch.int32,
                                    device=input_ids.device)
    return attention_mask, mb.split({"ids": input_ids, "mask": attention_mask,
                                     "labels": labels}, n_microbatches)


def _entry(params: dict, ids: torch.Tensor, config: BloomConfig,
           tp_axis: Optional[str], pipe_axis: str) -> torch.Tensor:
    """The pipeline-entry activations (M, mb, S, H): the embedding on stage
    0, and on the other stages a storage-free tensor of that shape and
    dtype (they read only its shape)."""
    if axis_index(pipe_axis) == 0:
        return embed_tokens(params, ids, config, tp_axis)
    shape = (*ids.shape, config.hidden_size)
    return torch.empty((), dtype=config.dtype, device=ids.device).expand(shape)


def _stage_fn(block_call, config: BloomConfig, blocks: list, pipe_axis: str,
              stage_layer_counts):
    """``stage_fn(blocks, h, side)`` over this stage's blocks: all of them
    on even stages (``n_layer / P``, ValueError otherwise), the first
    ``stage_layer_counts[stage]`` on uneven ones."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.partitioner import (
        masked_stage_scan,
        stage_layers,
    )

    n_valid, _ = stage_layers(config.n_layer, blocks, stage_layer_counts, pipe_axis)

    def stage_fn(blocks, h, side):
        return masked_stage_scan(lambda blk, hh: block_call(blk, hh, side),
                                 blocks, h, n_valid)

    return stage_fn


def _pp_head_sums(params: dict, h: torch.Tensor, mask: torch.Tensor,
                  labels: torch.Tensor, config: BloomConfig, tp_axis: Optional[str]):
    """Final LN -> the next-token cross entropy's (weighted loss sum, weight
    sum) of one microbatch: through the fused kernels with
    ``config.fused_ce``, else over the full logits."""
    h = layer_norm(params["ln_f"], h, config.layer_norm_epsilon)
    if config.fused_ce:
        from pipegoose_tpu_torch.ops.fused_ce import fused_ce_shifted_sums

        return fused_ce_shifted_sums(h, params["embed"]["weight"], labels, mask,
                                     tp_axis, config.valid_vocab_size)
    per_tok = vocab_parallel_cross_entropy(logits_fn(params, h, tp_axis)[:, :-1],
                                           labels[:, 1:], tp_axis,
                                           valid_size=config.valid_vocab_size)
    w = mask[:, 1:].to(per_tok.dtype)
    return (per_tok * w).sum(), w.sum()


def loss_fn_pp(params: dict, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
               config: BloomConfig, n_microbatches: int, tp_axis: Optional[str] = None,
               pipe_axis: str = "pipe", stage_layer_counts=None) -> torch.Tensor:
    """Pipeline-parallel (GPipe) loss over the "pipe" axis: stage 0 embeds
    every microbatch, :func:`gpipe` runs this stage's blocks
    (``params["blocks"]``: this rank's stage only, ``pp_specs``), the last
    stage takes the final LN, the tied head and the cross entropy of each
    microbatch, and the scalar is combined from the last stage
    (:func:`last_stage_value`). The loss and gradients equal
    :func:`loss_fn`'s on the whole batch.

    ``stage_layer_counts`` (P ints): uneven stages, each rank holding its
    ``repartition_blocks`` stage. With ``remat`` the whole stage is
    checkpointed, or each block under a ``remat_policy``."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import (
        gpipe,
        last_stage_value,
    )

    _, mbs = _split_batch(input_ids, attention_mask, labels, n_microbatches)
    h0 = _entry(params, mbs["ids"], config, tp_axis, pipe_axis)
    side = _stacked_bias(mbs["mask"], config)

    def block_call(blk, hh, side):
        return _block(blk, hh, side, config, tp_axis)

    gpipe_remat = config.remat
    if config.remat and config.remat_policy:
        block_call, gpipe_remat = _remat_wrap(block_call, config), False
    stage_fn = _stage_fn(block_call, config, params["blocks"], pipe_axis,
                         stage_layer_counts)
    outs = gpipe(stage_fn, params["blocks"], h0, side_inputs=side,
                 axis_name=pipe_axis, remat=gpipe_remat)
    if axis_index(pipe_axis) != axis_size(pipe_axis) - 1:
        return last_stage_value(outs.float().sum() * 0, pipe_axis)
    tot = cnt = 0.0
    for i in range(n_microbatches):
        t, c = _pp_head_sums(params, outs[i], mbs["mask"][i], mbs["labels"][i],
                             config, tp_axis)
        tot, cnt = tot + t, cnt + c
    return last_stage_value(tot / torch.clamp_min(cnt, 1), pipe_axis)


def loss_fn_1f1b(params: dict, input_ids: torch.Tensor,
                 attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
                 config: BloomConfig, n_microbatches: int,
                 tp_axis: Optional[str] = None, pipe_axis: str = "pipe",
                 stage_layer_counts=None) -> torch.Tensor:
    """Pipeline-parallel loss on the 1F1B (PipeDream-flush) runtime
    (:func:`one_f_one_b`): the same loss and gradients as
    :func:`loss_fn_pp`, with a stage's live activations bounded by the
    stage count. Its forward runs the whole pipeline, forward and backward,
    and keeps the gradients (:func:`manual_grads_loss`), so ``backward()``
    and ``make_hybrid_train_step`` take it unchanged;
    ``grad_sync_axes=("pipe",)`` completes the replicated leaves' gradients
    across stages, as for :func:`loss_fn_pp`. ``stage_layer_counts``: as
    there."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import one_f_one_b_loss

    mask, mbs = _split_batch(input_ids, attention_mask, labels, n_microbatches)
    side = {**_stacked_bias(mbs["mask"], config), "labels": mbs["labels"],
            "mask": mbs["mask"]}
    # each microbatch's head loss over the LOCAL token count, so that their
    # plain sum is loss_fn_pp's tot / cnt
    count = torch.clamp_min(mask[:, 1:].sum().float(), 1)

    def block(blk, h, side):
        return _block(blk, h, side, config, tp_axis)

    if config.remat:
        block = _remat_wrap(block, config)
    stage_fn = _stage_fn(block, config, params["blocks"], pipe_axis, stage_layer_counts)

    def head_fn(hp, h, side):
        tot, _ = _pp_head_sums(hp, h, side["mask"], side["labels"], config, tp_axis)
        return (tot / count).float()

    return one_f_one_b_loss(
        params, stage_fn, head_fn, ("embed", "embed_ln"), ("ln_f", "embed"),
        lambda ep: _entry(ep, mbs["ids"], config, tp_axis, pipe_axis), side, pipe_axis)


def pp_specs(params: dict, tp_axis: str = "tensor", pipe_axis: str = "pipe") -> dict:
    """:func:`tp_specs` with every block leaf marked with the pipe axis
    (``pipe_stage_specs``): on the JAX numpy tree the stacked n_layer dim is
    sharded over it (``params_from_jax`` then gives each rank its stage's
    blocks); on the port's per-layer tree each block belongs to its stage,
    and the gradient sync over "pipe" leaves it alone."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import pipe_stage_specs

    specs = tp_specs(params, tp_axis)
    specs["blocks"] = pipe_stage_specs(specs["blocks"], pipe_axis)
    return specs


def loss_fn_pp_sp(params: dict, input_ids: torch.Tensor,
                  attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
                  config: BloomConfig, n_microbatches: int,
                  tp_axis: Optional[str] = None, pipe_axis: str = "pipe",
                  sp_axis: str = "seq") -> torch.Tensor:
    """Pipeline x sequence parallel: ``input_ids``, ``attention_mask`` and
    ``labels`` are this rank's (B, S_local) chunk of the sequence axis;
    sequence-sharded activations flow through :func:`gpipe`, with ring
    attention over ``sp_axis`` inside each stage (every sp peer of a stage
    walks the same clocks). The train step syncs gradients with
    ``grad_sync_axes=(("pipe", "sum"), ("seq", "sum"))``."""
    from pipegoose_tpu_torch.distributed.functional import (
        all_reduce,
        reduce_from_tensor_group,
    )
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import (
        gpipe,
        last_stage_value,
    )

    _, mbs = _split_batch(input_ids, attention_mask, labels, n_microbatches)
    h0 = _entry(params, mbs["ids"], config, tp_axis, pipe_axis)
    # mask-aware global ALiBi positions per microbatch, once per step
    apos = torch.stack([_sp_alibi_pos(m, sp_axis) for m in mbs["mask"]])
    side = {"mask": mbs["mask"], "apos": apos}

    def block_call(blk, h, side):
        return _sp_block(blk, h, config, tp_axis, sp_axis, side["mask"],
                         alibi_pos=side["apos"])

    stage_fn = _stage_fn(block_call, config, params["blocks"], pipe_axis, None)
    outs = gpipe(stage_fn, params["blocks"], h0, side_inputs=side,
                 axis_name=pipe_axis, remat=config.remat)
    if axis_index(pipe_axis) != axis_size(pipe_axis) - 1:
        return last_stage_value(outs.float().sum() * 0, pipe_axis)
    tot = cnt = 0.0
    for i in range(n_microbatches):
        t, c = _sp_head_sums(params, outs[i], mbs["mask"][i], mbs["labels"][i],
                             config, tp_axis, sp_axis)
        tot, cnt = tot + t, cnt + c
    count = all_reduce(cnt, sp_axis)
    loss_local = reduce_from_tensor_group(tot / torch.clamp_min(count, 1), sp_axis)
    return last_stage_value(loss_local, pipe_axis)


# -- TP policy -------------------------------------------------------------------


def pad_for_tp(params: dict, config: BloomConfig, tp: int):
    """Pad the tied embedding so that the vocabulary divides the tensor
    axis: (params, config) with ``valid_vocab_size`` the true vocabulary,
    so the cross entropy and the picks mask the padded slots. ``params``
    is the port's tree or the JAX numpy tree alike (only ``embed`` is
    read)."""
    v = params["embed"]["weight"].shape[0]
    padded = pad_vocab(params["embed"]["weight"], tp)
    if padded.shape[0] == v:
        return params, config
    params = dict(params)
    params["embed"] = {"weight": padded}
    config = dataclasses.replace(config, vocab_size=padded.shape[0],
                                 valid_vocab_size=config.valid_vocab_size or v)
    return params, config


def tp_mapping(axis: str = "tensor") -> ParallelMapping:
    """The BLOOM partition policy: qkv and up column-parallel, out and down
    row-parallel, the embedding vocab-sharded (BLOOM's per-head qkv layout
    keeps whole heads per shard; n_head % tp == 0). A block path may carry
    the port's layer index (``blocks/3/attn/qkv``) or not (the JAX tree's
    stacked ``blocks/attn/qkv``)."""
    return ParallelMapping([
        (r"blocks/(\d+/)?attn/qkv", Column(axis)),
        (r"blocks/(\d+/)?attn/out", Row(axis)),
        (r"blocks/(\d+/)?mlp/up", Column(axis)),
        (r"blocks/(\d+/)?mlp/down", Row(axis)),
        (r"embed/weight", Vocab(axis)),
    ])


def tp_specs(params: dict, axis: str = "tensor") -> dict:
    """The spec tree of a BLOOM tree. On the port's tree (``blocks`` a list
    of per-layer dicts) each layer's leaves get their own specs; on the JAX
    numpy tree (``blocks`` stacked on a leading ``n_layer`` dim) every block
    spec gains a leading None, as the JAX ``tp_specs`` gives it."""
    mapping = tp_mapping(axis)
    stacked = isinstance(params["blocks"], dict)

    def spec_fn(path, x):
        if stacked and path.startswith("blocks/"):
            return (None, *mapping.spec_for(path, x.ndim - 1))
        return mapping.spec_for(path, x.ndim)

    return spec_tree(params, spec_fn)
