"""ALBERT in PyTorch: the encoder (bidirectional) model family.

The counterpart of ``pipegoose_tpu/models/albert.py``, with its tree: one
``layer`` (cross-layer parameter sharing, no stacked layer dim) applied
``n_layer`` times, a factorized embedding (vocab x E, then the E -> H
projection ``map_in``), post-LN residuals, and the MLM head (dense H -> E,
gelu_new, LN, the decoder tied to the word embedding plus a vocab bias).

- Attention is bidirectional: only the key-padding bias. With ``use_flash``
  it runs the flash kernels B1-B3 (``ops.flash_attention``) with
  ``causal=False``, the padding through ``kv_neg`` and no ALiBi slopes;
  else the dense einsum with the additive (B, 1, 1, S) key bias.
- ``loss_fn`` is the MLM cross entropy with no shift: a ``label_mask``
  picks the scored positions (the analog of HF's ``labels != -100``),
  through ``vocab_parallel_cross_entropy`` with ``valid_vocab_size``.
- Tensor parallel (``tp_specs``): q/k/v and ffn up column-parallel, the
  attention dense and ffn down row-parallel, the word embedding (and the
  tied decoder) and the vocab bias vocab-sharded.
- The pipeline losses (``loss_fn_pp``: GPipe; ``loss_fn_1f1b``): every
  parameter is pipe-replicated and the stages share out repetition counts
  of the one layer (``uniform_stage_counts``, or ``stage_layer_counts``);
  the gradients are completed by ``grad_sync_axes=(("pipe", "sum"),)``.
- Sequence parallel (``loss_fn_sp``, ``loss_fn_pp_sp``): the bidirectional
  ring (``ring_attention`` with ``make_bidirectional_bias_fn``) or Ulysses
  (with flash inside under ``use_flash``); positions read the global window
  through ``pos_offset``.
- ``fill_mask``: the argmax over the valid vocabulary at every mask slot,
  under TP a local argmax and max, then the global winner (ties to the
  lower rank, as ``jnp.argmax``).

Where this parts from the JAX model (ROADMAP.md § C): in a bf16 run the two
head products (H -> E and the tied decoder) round to bf16 once before the
float32 cast, as ``bloom.logits_fn`` does; ``init_params_numpy`` and
``init_params`` draw from a numpy seed and a ``torch.Generator`` in place
of a PRNG key.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from pipegoose_tpu_torch._device import resolve_device
from pipegoose_tpu_torch.distributed.functional import (
    all_gather,
    axis_index,
    axis_size,
    copy_to_tensor_group,
    reduce_from_tensor_group,
)
from pipegoose_tpu_torch.models.mixtral import _default_mask, _walk, remat_wrap
from pipegoose_tpu_torch.nn.parallel import spec_tree
from pipegoose_tpu_torch.nn.parallel_mapping import Column, ParallelMapping, Row, Vocab
from pipegoose_tpu_torch.nn.pipeline_parallel.partitioner import stage_n_valid
from pipegoose_tpu_torch.nn.tensor_parallel.layers import (
    column_parallel_linear,
    layer_norm,
    row_parallel_linear,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)

NEG_INF = -1e9   # finite, as in the JAX package


@dataclasses.dataclass(frozen=True)
class AlbertConfig:
    vocab_size: int = 30000
    embedding_size: int = 128
    hidden_size: int = 768
    n_layer: int = 12
    n_head: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    dtype: torch.dtype = torch.float32
    remat: bool = False
    # the flash kernels B1-B3 with causal=False: no (S, S) scores
    use_flash: bool = False
    # the true vocabulary when the embedding was padded for TP
    valid_vocab_size: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_head

    @classmethod
    def albert_base(cls, **kw) -> "AlbertConfig":
        """albert-base-v2 (the defaults)."""
        return cls(**kw)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """HF ``gelu_new``: the tanh approximation with the full-precision
    sqrt(2/pi) (BLOOM's gelu truncates it)."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


# -- init ------------------------------------------------------------------------


def _shapes(config: AlbertConfig) -> dict:
    """Every leaf's shape; ``layer`` is the ONE shared layer."""
    h, e, i = config.hidden_size, config.embedding_size, config.intermediate_size

    def dense(din, dout):
        return {"kernel": (din, dout), "bias": (dout,)}

    def ln(d):
        return {"scale": (d,), "bias": (d,)}

    return {
        "embed": {"word": {"weight": (config.vocab_size, e)},
                  "pos": (config.max_position_embeddings, e),
                  "type": (config.type_vocab_size, e), "ln": ln(e)},
        "map_in": dense(e, h),
        "layer": {"attn": {"q": dense(h, h), "k": dense(h, h), "v": dense(h, h),
                           "dense": dense(h, h), "ln": ln(h)},
                  "ffn": {"up": dense(h, i), "down": dense(i, h), "ln": ln(h)}},
        "mlm": {"dense": dense(h, e), "ln": ln(e), "bias": (config.vocab_size,)},
    }


def _kind(path: str) -> str:
    """"ones" (a LayerNorm scale), "zeros" (every bias) or "normal"."""
    if path.endswith("scale"):
        return "ones"
    return "zeros" if path.endswith("bias") else "normal"


def init_params_numpy(config: AlbertConfig, seed: int) -> dict:
    """Random weights in the JAX parameter layout, as float32 numpy arrays:
    the JAX ``init_params`` scheme (HF's: normal(0, initializer_range)
    kernels and embeddings, zero biases, ones/zeros LayerNorms) drawn from
    ``numpy.random.default_rng(seed)``. Feed the tree to
    ``weights.params_from_jax``."""
    std = np.float32(config.initializer_range)
    rng = np.random.default_rng(seed)

    def draw(path, shape):
        kind = _kind(path)
        if kind != "normal":
            return (np.ones if kind == "ones" else np.zeros)(shape, np.float32)
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= std
        return w

    return _walk(_shapes(config), draw)


def init_params(config: AlbertConfig, seed: int, device="cuda") -> dict:
    """The same scheme drawn straight into the port's tree on ``device``
    (the card by default) from a ``torch.Generator`` seeded ``seed``, in
    ``config.dtype``. Its values are not :func:`init_params_numpy`'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(path, shape):
        kind = _kind(path)
        if kind != "normal":
            fill = torch.ones if kind == "ones" else torch.zeros
            return fill(shape, dtype=config.dtype, device=dev)
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        w.normal_(0.0, config.initializer_range, generator=gen)
        return w.to(config.dtype)

    return _walk(_shapes(config), draw)


# -- forward ---------------------------------------------------------------------


def attention_bias(attention_mask: torch.Tensor, config: AlbertConfig) -> dict:
    """What the configured attention branch consumes: for flash the per-key
    validity ``kv_neg`` (B, S), 0 / NEG_INF; else the additive key bias
    (B, 1, 1, S)."""
    kv_neg = (1.0 - attention_mask.float()) * NEG_INF
    if config.use_flash:
        return {"kv_neg": kv_neg}
    return {"key_bias": kv_neg[:, None, None, :]}


def _local_heads(config: AlbertConfig, tp_axis: Optional[str]) -> int:
    tp = axis_size(tp_axis)
    if config.n_head % tp:
        raise ValueError(f"n_head={config.n_head} not divisible by tp={tp}")
    return config.n_head // tp


def _qkv(blk: dict, x: torch.Tensor, config: AlbertConfig, tp_axis: Optional[str]):
    """q, k, v (B, S, nh/tp, hd), column-parallel with their biases."""
    b, s, _ = x.shape
    nh = _local_heads(config, tp_axis)
    return tuple(column_parallel_linear(blk[n], x, tp_axis).reshape(b, s, nh, config.head_dim)
                 for n in ("q", "k", "v"))


def _attn_out(blk: dict, x: torch.Tensor, ctx: torch.Tensor, config: AlbertConfig,
              tp_axis: Optional[str]) -> torch.Tensor:
    """The row-parallel output projection and the post-LN residual."""
    b, s, _ = x.shape
    ctx = ctx.to(x.dtype).reshape(b, s, ctx.shape[2] * config.head_dim)
    proj = row_parallel_linear(blk["dense"], ctx, tp_axis)
    return layer_norm(blk["ln"], x + proj, config.layer_norm_eps)


def _attention(blk: dict, x: torch.Tensor, bias: dict, config: AlbertConfig,
               tp_axis: Optional[str]) -> torch.Tensor:
    """Bidirectional self-attention, heads sharded over ``tp_axis``, then
    the post-LN residual; ``bias`` is the dict from :func:`attention_bias`."""
    q, k, v = _qkv(blk, x, config, tp_axis)
    if config.use_flash:
        from pipegoose_tpu_torch.ops.flash_attention import flash_attention

        ctx = flash_attention(q, k, v, causal=False, kv_neg=bias["kv_neg"])
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores * (1.0 / math.sqrt(config.head_dim)) + bias["key_bias"]
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return _attn_out(blk, x, ctx, config, tp_axis)


def _ffn(ffn: dict, a: torch.Tensor, config: AlbertConfig,
         tp_axis: Optional[str]) -> torch.Tensor:
    """Column up, gelu_new, row down, post-LN residual."""
    h = column_parallel_linear(ffn["up"], a, tp_axis)
    down = row_parallel_linear(ffn["down"], gelu_new(h), tp_axis)
    return layer_norm(ffn["ln"], a + down, config.layer_norm_eps)


def _layer(layer: dict, x: torch.Tensor, bias: dict, config: AlbertConfig,
           tp_axis: Optional[str]) -> torch.Tensor:
    """One ALBERT layer (HF AlbertLayer): post-LN attention, post-LN FFN."""
    return _ffn(layer["ffn"], _attention(layer["attn"], x, bias, config, tp_axis),
                config, tp_axis)


def embed_tokens(params: dict, input_ids: torch.Tensor, config: AlbertConfig,
                 tp_axis: Optional[str] = None,
                 token_type_ids: Optional[torch.Tensor] = None,
                 pos_offset: int = 0) -> torch.Tensor:
    """Word (vocab-sharded) + position + token-type embeddings -> LN -> the
    E -> H projection; ``input_ids`` (..., S) -> (..., S, H). ``pos_offset``
    shifts the absolute-position window (sequence sharding passes ``rank x
    s_local`` so each chunk reads its global positions)."""
    s = input_ids.shape[-1]
    emb = params["embed"]
    x = vocab_parallel_embedding(emb["word"], input_ids, tp_axis)
    x = x + emb["pos"][pos_offset:pos_offset + s]
    tt = token_type_ids if token_type_ids is not None else torch.zeros_like(input_ids)
    x = x + emb["type"][tt]
    x = layer_norm(emb["ln"], x.to(config.dtype), config.layer_norm_eps)
    return column_parallel_linear(params["map_in"], x, None)


def forward_hidden(params: dict, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor], config: AlbertConfig,
                   tp_axis: Optional[str] = None,
                   token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embeddings -> ``n_layer`` applications of the SHARED layer, each
    recomputed in backward with ``remat``. Returns (B, S, H)."""
    attention_mask = _default_mask(input_ids, attention_mask)
    bias = attention_bias(attention_mask, config)
    x = embed_tokens(params, input_ids, config, tp_axis, token_type_ids)

    def apply(layer, h):
        return _layer(layer, h, bias, config, tp_axis)

    apply = remat_wrap(apply, config)
    for _ in range(config.n_layer):
        x = apply(params["layer"], x)
    return x


def logits_fn(params: dict, hidden: torch.Tensor, tp_axis: Optional[str] = None,
              eps: float = 1e-12) -> torch.Tensor:
    """The MLM head: dense H -> E, gelu_new, LN, then the decoder tied to
    the word embedding plus the vocab bias; float32 logits, vocab-sharded
    under TP. The f-operator on the LN output is load-bearing: each rank's
    cotangent of it is only its vocab shard's part."""
    mlm = params["mlm"]
    e = torch.matmul(hidden, mlm["dense"]["kernel"]).float()
    e = gelu_new(e + mlm["dense"]["bias"].float())
    e = layer_norm(mlm["ln"], e.to(hidden.dtype), eps)
    if tp_axis is not None:
        e = copy_to_tensor_group(e, tp_axis)
    logits = torch.matmul(e, params["embed"]["word"]["weight"].t()).float()
    return logits + mlm["bias"].float()


def forward(params: dict, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor], config: AlbertConfig,
            tp_axis: Optional[str] = None,
            token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S) ids -> (B, S, V/tp) float32 MLM logits."""
    hidden = forward_hidden(params, input_ids, attention_mask, config, tp_axis,
                            token_type_ids)
    return logits_fn(params, hidden, tp_axis, eps=config.layer_norm_eps)


def _head_sums(params: dict, hidden: torch.Tensor, labels: torch.Tensor,
               label_mask: torch.Tensor, config: AlbertConfig,
               tp_axis: Optional[str]):
    """(weighted CE sum, weight sum) of the MLM head on ``hidden``."""
    logits = logits_fn(params, hidden, tp_axis, eps=config.layer_norm_eps)
    per_tok = vocab_parallel_cross_entropy(logits, labels, tp_axis,
                                           valid_size=config.valid_vocab_size)
    w = label_mask.to(per_tok.dtype)
    return (per_tok * w).sum(), w.sum()


def _label_mask(attention_mask, label_mask, labels):
    if label_mask is not None:
        return label_mask
    return attention_mask if attention_mask is not None else torch.ones_like(labels)


def loss_fn(params: dict, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
            config: AlbertConfig, tp_axis: Optional[str] = None,
            label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-LM cross entropy (NO shift): the mean CE over the positions
    ``label_mask`` scores (by default every valid position)."""
    label_mask = _label_mask(attention_mask, label_mask, labels)
    hidden = forward_hidden(params, input_ids, attention_mask, config, tp_axis)
    tot, cnt = _head_sums(params, hidden, labels, label_mask, config, tp_axis)
    return tot / torch.clamp_min(cnt, 1)


# -- TP policy -------------------------------------------------------------------


def tp_mapping(axis: str = "tensor") -> ParallelMapping:
    """q/k/v and ffn up Column, attention dense and ffn down Row, the word
    embedding (and its tied decoder) and the vocab bias Vocab."""
    return ParallelMapping([
        ("layer/attn/q", Column(axis)),
        ("layer/attn/k", Column(axis)),
        ("layer/attn/v", Column(axis)),
        ("layer/attn/dense", Row(axis)),
        ("layer/ffn/up", Column(axis)),
        ("layer/ffn/down", Row(axis)),
        ("embed/word", Vocab(axis)),
        ("mlm/bias", Vocab(axis)),
    ])


def tp_specs(params: dict, axis: str = "tensor") -> dict:
    """The spec tree (no stacked layer dim: the layer is shared), the same
    on the JAX numpy tree and the port's."""
    mapping = tp_mapping(axis)
    return spec_tree(params, lambda path, x: mapping.spec_for(path, x.ndim))


def pp_specs(params: dict, tp_axis: str = "tensor", pipe_axis: str = "pipe") -> dict:
    """:func:`tp_specs`: the shared layer has no stacked dim to shard over
    ``pipe``, so every parameter is pipe-replicated and the stages share
    out repetition counts (:func:`loss_fn_pp`)."""
    del pipe_axis
    return tp_specs(params, tp_axis)


# -- pipeline parallel -------------------------------------------------------------


def uniform_stage_counts(n_layer: int, n_stages: int) -> tuple:
    """Per-stage application counts of the shared layer: every application
    costs the same, so the even split, the remainder to the earliest
    stages."""
    base, rem = divmod(n_layer, n_stages)
    return tuple(base + (1 if i < rem else 0) for i in range(n_stages))


def _resolve_stage_counts(config: AlbertConfig, pipe_axis: str, stage_layer_counts) -> int:
    """This stage's count of applications, the counts checked against the
    pipe axis and ``n_layer`` (ValueError)."""
    counts = (tuple(int(c) for c in stage_layer_counts) if stage_layer_counts is not None
              else uniform_stage_counts(config.n_layer, axis_size(pipe_axis)))
    return stage_n_valid(counts, config.n_layer, pipe_axis)


def _repeat_stage_fn(n_valid: int, config: AlbertConfig, tp_axis: Optional[str],
                     layer_apply=None):
    """``stage_fn(layer, h, side)``: the shared layer applied ``n_valid``
    times (this stage's count). ``layer_apply(layer, h, side)`` replaces the
    dense layer (the sequence-parallel one)."""
    if layer_apply is None:
        def layer_apply(layer, h, side):
            return _layer(layer, h, side, config, tp_axis)

    def stage_fn(layer, h, side):
        for _ in range(n_valid):
            h = layer_apply(layer, h, side)
        return h

    return stage_fn


def _split(input_ids, attention_mask, labels, label_mask, n_microbatches):
    from pipegoose_tpu_torch.nn.pipeline_parallel import microbatch as mb

    attention_mask = _default_mask(input_ids, attention_mask)
    label_mask = attention_mask if label_mask is None else label_mask
    return label_mask, mb.split({"ids": input_ids, "mask": attention_mask,
                                 "labels": labels, "lmask": label_mask}, n_microbatches)


def _stacked_bias(masks: torch.Tensor, config: AlbertConfig) -> dict:
    per = [attention_bias(m, config) for m in masks]
    return {k: torch.stack([b[k] for b in per]) for k in per[0]}


def _entry(params: dict, ids: torch.Tensor, config: AlbertConfig, tp_axis, pipe_axis,
           pos_offset: int = 0) -> torch.Tensor:
    """The pipeline-entry activations (M, mb, S, H): the embeddings on stage
    0, a storage-free tensor of that shape elsewhere."""
    if axis_index(pipe_axis) == 0:
        return embed_tokens(params, ids, config, tp_axis, pos_offset=pos_offset)
    shape = (*ids.shape, config.hidden_size)
    return torch.empty((), dtype=config.dtype, device=ids.device).expand(shape)


def _mlm_head_sums_pp(params, outs, mbs, config, tp_axis):
    tot = cnt = 0.0
    for i in range(outs.shape[0]):
        t, c = _head_sums(params, outs[i], mbs["labels"][i], mbs["lmask"][i], config,
                          tp_axis)
        tot, cnt = tot + t, cnt + c
    return tot, cnt


def loss_fn_pp(params: dict, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
               config: AlbertConfig, n_microbatches: int,
               tp_axis: Optional[str] = None, pipe_axis: str = "pipe",
               stage_layer_counts=None,
               label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pipeline-parallel (GPipe) MLM loss for the SHARED-layer encoder:
    every stage holds the same (pipe-replicated) params and applies the
    layer its count of times (``uniform_stage_counts`` or
    ``stage_layer_counts``), so the pipeline ships activations only. Stage 0
    embeds, the last stage takes the head; the loss equals
    :func:`loss_fn`'s, and the gradients once summed over the pipe axis
    (``grad_sync_axes=(("pipe", "sum"),)``)."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import gpipe, last_stage_value

    _, mbs = _split(input_ids, attention_mask, labels, label_mask, n_microbatches)
    n_valid = _resolve_stage_counts(config, pipe_axis, stage_layer_counts)
    h0 = _entry(params, mbs["ids"], config, tp_axis, pipe_axis)
    stage_fn = _repeat_stage_fn(n_valid, config, tp_axis)
    outs = gpipe(stage_fn, params["layer"], h0,
                 side_inputs=_stacked_bias(mbs["mask"], config),
                 axis_name=pipe_axis, remat=config.remat)
    if axis_index(pipe_axis) != axis_size(pipe_axis) - 1:
        return last_stage_value(outs.float().sum() * 0, pipe_axis)
    tot, cnt = _mlm_head_sums_pp(params, outs, mbs, config, tp_axis)
    return last_stage_value(tot / torch.clamp_min(cnt, 1), pipe_axis)


def loss_fn_1f1b(params: dict, input_ids: torch.Tensor,
                 attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
                 config: AlbertConfig, n_microbatches: int,
                 tp_axis: Optional[str] = None, pipe_axis: str = "pipe",
                 stage_layer_counts=None,
                 label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 1F1B (PipeDream-flush) MLM loss: the loss and gradients of
    :func:`loss_fn_pp` with a stage's live activations bounded by the stage
    count. The tied word embedding gets the entry's gradient on stage 0 and
    the decoder's on the last stage, completed, like every replicated
    parameter, by ``grad_sync_axes=(("pipe", "sum"),)``."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import one_f_one_b_loss

    lmask, mbs = _split(input_ids, attention_mask, labels, label_mask, n_microbatches)
    n_valid = _resolve_stage_counts(config, pipe_axis, stage_layer_counts)
    apply = remat_wrap(lambda layer, h, side: _layer(layer, h, side, config, tp_axis),
                       config)
    stage_fn = _repeat_stage_fn(n_valid, config, tp_axis, apply)
    side = {"bias": _stacked_bias(mbs["mask"], config), "labels": mbs["labels"],
            "lmask": mbs["lmask"]}
    # per-microbatch head losses over the GLOBAL scored count, so that
    # their plain sum is loss_fn_pp's tot / cnt
    count = torch.clamp_min(lmask.sum().float(), 1)

    def stage(layer, h, side):
        return stage_fn(layer, h, side["bias"])

    def head_fn(hp, h, side):
        tot, _ = _head_sums(hp, h, side["labels"], side["lmask"], config, tp_axis)
        return (tot / count).float()

    return one_f_one_b_loss(
        params, stage, head_fn, ("embed", "map_in"), ("mlm", "embed"),
        lambda ep: _entry(ep, mbs["ids"], config, tp_axis, pipe_axis), side, pipe_axis,
        stage_key="layer")


# -- sequence parallel -------------------------------------------------------------


def _attention_sp(blk: dict, x: torch.Tensor, config: AlbertConfig,
                  tp_axis: Optional[str], sp_axis: str, pad_mask_local: torch.Tensor,
                  variant: str = "ring") -> torch.Tensor:
    """Bidirectional attention with the sequence sharded over ``sp_axis``,
    heads over ``tp_axis``. ``"ring"``: K/V and the pad mask (``kv_side``)
    rotate around the ring under the padding-only block bias;
    ``"ulysses"``: the all_to_all head/sequence exchange around
    full-sequence attention, the flash kernels inside with ``use_flash``."""
    from pipegoose_tpu_torch.nn.sequence_parallel.ring_attention import (
        make_bidirectional_bias_fn,
        ring_attention,
    )
    from pipegoose_tpu_torch.nn.sequence_parallel.ulysses import (
        ulysses_bidirectional_attention,
    )

    q, k, v = _qkv(blk, x, config, tp_axis)
    if variant == "ulysses":
        ctx = ulysses_bidirectional_attention(q, k, v, sp_axis, pad_mask_local,
                                              use_flash=config.use_flash)
    elif variant == "ring":
        ctx = ring_attention(q, k, v, sp_axis, make_bidirectional_bias_fn(),
                             kv_side=pad_mask_local, scale=1.0 / math.sqrt(config.head_dim))
    else:
        raise ValueError(f"unknown SP variant {variant!r} (ring, ulysses)")
    return _attn_out(blk, x, ctx, config, tp_axis)


def _layer_sp(layer: dict, h: torch.Tensor, config: AlbertConfig, tp_axis, sp_axis,
              pad_mask_local: torch.Tensor, variant: str = "ring") -> torch.Tensor:
    a = _attention_sp(layer["attn"], h, config, tp_axis, sp_axis, pad_mask_local, variant)
    return _ffn(layer["ffn"], a, config, tp_axis)


def _check_sp_positions(config: AlbertConfig, sp_axis: str, s_local: int) -> None:
    """A global sequence past the position table would read a short slice
    (the JAX dynamic slice would clamp): refuse it."""
    sp = axis_size(sp_axis)
    if sp * s_local > config.max_position_embeddings:
        raise ValueError(f"global sequence {sp}x{s_local}={sp * s_local} exceeds "
                         f"max_position_embeddings={config.max_position_embeddings}")


def _sp_mean(tot: torch.Tensor, cnt, sp_axis: str) -> torch.Tensor:
    """The global mean from this shard's (loss sum, weight sum): ONE sum of
    the pair over ``sp_axis`` with an identity backward, so each rank's
    gradients stay its own (the train step sums them over the axis)."""
    pair = reduce_from_tensor_group(torch.stack([tot.float(), torch.as_tensor(
        cnt, dtype=torch.float32, device=tot.device)]), sp_axis)
    return pair[0] / torch.clamp_min(pair[1].detach(), 1)


def loss_fn_sp(params: dict, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
               config: AlbertConfig, tp_axis: Optional[str] = None,
               sp_axis: str = "seq", label_mask: Optional[torch.Tensor] = None,
               variant: str = "ring") -> torch.Tensor:
    """Sequence-parallel MLM loss: ``input_ids``, ``attention_mask``,
    ``labels`` and ``label_mask`` are this rank's (B, S_local) chunk. The
    activations stay sequence-sharded end to end, positions read the global
    window (``pos_offset = rank x S_local``), and with no target shift the
    head is local, then one sum of the (loss sum, count) pair. Replicated
    gradients are summed over ``sp_axis`` by the train step
    (``grad_sync_axes=(("seq", "sum"),)``)."""
    s_local = input_ids.shape[1]
    attention_mask = _default_mask(input_ids, attention_mask)
    label_mask = attention_mask if label_mask is None else label_mask
    _check_sp_positions(config, sp_axis, s_local)
    x = embed_tokens(params, input_ids, config, tp_axis,
                     pos_offset=axis_index(sp_axis) * s_local)

    def apply(layer, h):
        return _layer_sp(layer, h, config, tp_axis, sp_axis, attention_mask, variant)

    apply = remat_wrap(apply, config)
    for _ in range(config.n_layer):
        x = apply(params["layer"], x)
    tot, cnt = _head_sums(params, x, labels, label_mask, config, tp_axis)
    return _sp_mean(tot, cnt, sp_axis)


def loss_fn_pp_sp(params: dict, input_ids: torch.Tensor,
                  attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
                  config: AlbertConfig, n_microbatches: int,
                  tp_axis: Optional[str] = None, pipe_axis: str = "pipe",
                  sp_axis: str = "seq", stage_layer_counts=None,
                  label_mask: Optional[torch.Tensor] = None,
                  variant: str = "ring") -> torch.Tensor:
    """Pipeline x sequence parallel: sequence-sharded activations through
    GPipe, each stage repeating the shared layer with the bidirectional
    ring (or Ulysses) inside. Gradients synced with
    ``grad_sync_axes=(("pipe", "sum"), ("seq", "sum"))``."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import gpipe, last_stage_value

    s_local = input_ids.shape[1]
    _check_sp_positions(config, sp_axis, s_local)
    _, mbs = _split(input_ids, attention_mask, labels, label_mask, n_microbatches)
    n_valid = _resolve_stage_counts(config, pipe_axis, stage_layer_counts)
    h0 = _entry(params, mbs["ids"], config, tp_axis, pipe_axis,
                pos_offset=axis_index(sp_axis) * s_local)
    stage_fn = _repeat_stage_fn(
        n_valid, config, tp_axis,
        lambda layer, h, side: _layer_sp(layer, h, config, tp_axis, sp_axis, side["mask"],
                                         variant))
    outs = gpipe(stage_fn, params["layer"], h0, side_inputs={"mask": mbs["mask"]},
                 axis_name=pipe_axis, remat=config.remat)
    if axis_index(pipe_axis) != axis_size(pipe_axis) - 1:
        return last_stage_value(outs.float().sum() * 0, pipe_axis)
    tot, cnt = _mlm_head_sums_pp(params, outs, mbs, config, tp_axis)
    return last_stage_value(_sp_mean(tot, cnt, sp_axis), pipe_axis)


# -- MLM-fill inference --------------------------------------------------------------


@torch.no_grad()
def fill_mask(params: dict, input_ids: torch.Tensor, mask_token_id: int,
              config: AlbertConfig, attention_mask: Optional[torch.Tensor] = None,
              token_type_ids: Optional[torch.Tensor] = None,
              tp_axis: Optional[str] = None) -> torch.Tensor:
    """The encoder's inference path (HF's fill-mask pipeline): one
    bidirectional forward, the argmax of the MLM logits over the valid
    vocabulary at every ``mask_token_id`` slot, every other id untouched.
    Under TP the argmax runs over the vocab-sharded logits: a local argmax
    and max, then the global winner over the gathered pairs (ties to the
    lower rank, as ``jnp.argmax`` picks)."""
    logits = forward(params, input_ids, attention_mask, config, tp_axis, token_type_ids)
    valid = config.valid_vocab_size or config.vocab_size
    v_local = logits.shape[-1]
    offset = axis_index(tp_axis) * v_local
    cols = offset + torch.arange(v_local, device=logits.device)
    logits = torch.where(cols < valid, logits, NEG_INF)
    if tp_axis is not None:
        best = torch.argmax(logits, -1) + offset
        maxes = all_gather(logits.amax(-1)[None], tp_axis, dim=0)   # (tp, B, S)
        bests = all_gather(best[None], tp_axis, dim=0)
        pred = torch.gather(bests, 0, torch.argmax(maxes, 0)[None])[0]
    else:
        pred = torch.argmax(logits, -1)
    return torch.where(input_ids == mask_token_id, pred, input_ids)


__all__ = [
    "AlbertConfig", "gelu_new", "init_params_numpy", "init_params", "attention_bias",
    "embed_tokens", "forward_hidden", "logits_fn", "forward", "loss_fn", "tp_mapping",
    "tp_specs", "pp_specs", "uniform_stage_counts", "loss_fn_pp", "loss_fn_1f1b",
    "loss_fn_sp", "loss_fn_pp_sp", "fill_mask",
]
