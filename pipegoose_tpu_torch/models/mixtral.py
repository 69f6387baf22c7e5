"""Mixtral in PyTorch: the sparse-MoE decoder (RMSNorm, RoPE, GQA, SwiGLU
experts) and the RoPE/GQA attention stack that Llama shares.

The counterpart of ``pipegoose_tpu/models/mixtral.py``, over the port's
per-layer list of blocks (``models.weights.params_from_jax``):

- the shared stack: ``rms_norm`` (float32 statistics), ``RopeScaling``
  (HF's linear / dynamic / llama3 ``rope_scaling``), ``rope_cos_sin``,
  ``apply_rope``, ``causal_mask_bias`` and ``rope_attention_bias``, and
  ``_attention``: with ``use_flash`` the flash kernels B1-B3
  (``ops.flash_attention``) on the nkv-headed K/V (native GQA, no repeat),
  no ALiBi slopes and the sliding window inside the kernel; else the dense
  branch, which repeats the K/V heads;
- the model: ``MixtralConfig``, ``init_params_numpy`` / ``init_params``,
  ``forward_hidden``, ``forward`` and ``loss_fn`` (task loss plus the
  routers' aux and z losses through ``ExpertLoss``; with ``fused_ce`` the
  fused kernels B4-B6 on the untied (H, V) head, layout "hv");
- the pipeline losses ``loss_fn_pp`` (GPipe, the routers' losses riding its
  aux) and ``loss_fn_1f1b`` (``one_f_one_b(with_aux=True)``), even or uneven
  (``stage_layer_counts``); the sequence-parallel ``loss_fn_sp`` (ring
  through the chunk kernels B7-B9 with flash and no window, the dense ring
  with a window or without flash, or Ulysses) and ``loss_fn_pp_sp``;
- KV-cache generation (``init_cache``, ``forward_cached``, ``generate``)
  and ``upcycle_from_llama``.

Where this parts from the JAX model (ROADMAP.md § C):

- after RoPE, q and k are cast back to the model's dtype (JAX leaves a bf16
  model's q and k in float32, which the flash wrapper refuses); float32
  runs are untouched;
- the router's rng is an integer seed: layer l routes with
  ``core.accumulation.fold_in(rng, l)`` (JAX splits a PRNG key over the
  layers), drawn inside the block so that a rematerialized block draws it
  again;
- ``init_params_numpy`` draws from a numpy seed in place of ``init_params``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from pipegoose_tpu_torch._device import resolve_device
from pipegoose_tpu_torch.core.accumulation import fold_in
from pipegoose_tpu_torch.distributed.functional import (
    all_reduce,
    axis_index,
    axis_size,
    copy_to_tensor_group,
    reduce_from_tensor_group,
)
from pipegoose_tpu_torch.models.bloom import _remat_wrap, _split_batch
from pipegoose_tpu_torch.nn.expert_parallel.experts import moe_layer
from pipegoose_tpu_torch.nn.expert_parallel.loss import ExpertLoss
from pipegoose_tpu_torch.nn.expert_parallel.routers import SwitchNoisePolicy, TopKRouter
from pipegoose_tpu_torch.nn.parallel import spec_tree
from pipegoose_tpu_torch.nn.pipeline_parallel.partitioner import stage_layers
from pipegoose_tpu_torch.nn.tensor_parallel.layers import (
    column_parallel_linear,
    row_parallel_linear,
    vocab_parallel_cross_entropy,
    vocab_parallel_embedding,
)

NEG_INF = -1e9   # finite, as in the JAX package


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 8
    num_experts: int = 8
    top_k: int = 2
    rope_theta: float = 1e6
    rms_eps: float = 1e-5
    initializer_range: float = 0.02
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.001   # HF MixtralConfig router_aux_loss_coef default
    z_loss_weight: float = 0.0
    # None -> no-drop capacity (num_experts / top_k, C = n_tokens), as HF's
    # MixtralSparseMoeBlock never drops; a real factor for capacity-bound runs
    capacity_factor: Optional[float] = None
    dtype: torch.dtype = torch.float32
    remat: bool = False
    # the flash kernels (ops/flash_attention.py) after RoPE: no ALiBi
    # slopes, padding through kv_neg, GQA on the nkv-headed K/V
    use_flash: bool = False
    # the fused cross-entropy kernels (ops/fused_ce.py) on the (H, V) head
    fused_ce: bool = False
    # the true vocabulary when the embedding and head were padded for TP
    valid_vocab_size: Optional[int] = None
    # Mistral-style sliding window: a query sees the keys less than
    # ``sliding_window`` positions behind it (None = full causal)
    sliding_window: Optional[int] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.n_head

    @classmethod
    def mixtral_8x7b(cls, **kw) -> "MixtralConfig":
        return cls(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                   n_layer=32, n_head=32, n_kv_head=8, **kw)

    def router(self) -> TopKRouter:
        noise = SwitchNoisePolicy(self.router_jitter) if self.router_jitter else None
        cf = (self.capacity_factor if self.capacity_factor is not None
              else self.num_experts / self.top_k)   # C = n_tokens: no drops
        return TopKRouter(num_experts=self.num_experts, top_k=self.top_k,
                          capacity_factor=cf, noise=noise, normalize_gates=True)


# -- init ------------------------------------------------------------------------


def _shapes(config: MixtralConfig) -> dict:
    """The stacked JAX layout's leaf shapes: a dense kernel (in, out), an
    expert stack (L, E, in, out), a RMSNorm scale."""
    h, v, L = config.hidden_size, config.vocab_size, config.n_layer
    hd, nh, nkv = config.head_dim, config.n_head, config.n_kv_head
    f, E = config.intermediate_size, config.num_experts
    return {
        "embed": {"weight": (v, h)},
        "blocks": {
            "ln_1": {"scale": (L, h)},
            "attn": {"q": {"kernel": (L, h, nh * hd)}, "k": {"kernel": (L, h, nkv * hd)},
                     "v": {"kernel": (L, h, nkv * hd)}, "o": {"kernel": (L, nh * hd, h)}},
            "ln_2": {"scale": (L, h)},
            "router": {"gate": {"kernel": (L, h, E)}},
            "moe": {"w1": {"kernel": (L, E, h, f)}, "w3": {"kernel": (L, E, h, f)},
                    "w2": {"kernel": (L, E, f, h)}},
        },
        "ln_f": {"scale": (h,)},
        "lm_head": {"kernel": (h, v)},
    }


def _is_scale(path: str) -> bool:
    return path.endswith("scale")


def init_params_numpy(config, seed: int, shapes: Optional[dict] = None) -> dict:
    """Random weights in the JAX parameter layout, as float32 numpy arrays:
    the JAX ``init_params`` scheme (normal(0, initializer_range) kernels and
    embedding, ones RMSNorm scales, per-layer leaves stacked on a leading
    ``n_layer`` axis) drawn from ``numpy.random.default_rng(seed)``. Feed the
    tree to ``weights.params_from_jax``."""
    std = np.float32(config.initializer_range)
    rng = np.random.default_rng(seed)

    def draw(path, shape):
        if _is_scale(path):
            return np.ones(shape, np.float32)
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= std
        return w

    return _walk(shapes or _shapes(config), draw)


def _walk(shapes: dict, fn, path: str = "") -> dict:
    return {k: (_walk(v, fn, f"{path}{k}/") if isinstance(v, dict) else fn(path + k, v))
            for k, v in shapes.items()}


def init_params(config, seed: int, device="cuda", shapes: Optional[dict] = None) -> dict:
    """The same scheme drawn straight into the port's per-layer tree on
    ``device`` (the card by default) from a ``torch.Generator`` seeded
    ``seed``, in ``config.dtype``: for full-width weights that a host numpy
    tree would take long to draw and move. Its values are not
    :func:`init_params_numpy`'s."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(path, shape):
        if _is_scale(path):
            return torch.ones(shape, dtype=config.dtype, device=dev)
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        w.normal_(0.0, config.initializer_range, generator=gen)
        return w.to(config.dtype)

    shapes = dict(shapes or _shapes(config))
    layer = _strip_layer(shapes.pop("blocks"))
    out = _walk(shapes, draw)
    out["blocks"] = [_walk(layer, draw) for _ in range(config.n_layer)]
    return {k: out[k] for k in ("embed", "blocks", "ln_f", "lm_head") if k in out}


def _strip_layer(shapes: dict) -> dict:
    return {k: (_strip_layer(v) if isinstance(v, dict) else tuple(v[1:]))
            for k, v in shapes.items()}


# -- the shared RoPE / GQA stack ---------------------------------------------------


def rms_norm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with float32 statistics, the result in ``x``'s dtype."""
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * params["scale"]).to(dt)


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """HF ``rope_scaling`` semantics (transformers modeling_rope_utils):
    ``linear`` divides positions by ``factor``; ``dynamic`` is NTK theta
    rescaling past the original context; ``llama3`` is the per-frequency
    interpolation of Llama-3.1+ checkpoints."""

    rope_type: str  # "linear" | "dynamic" | "llama3"
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192

    @classmethod
    def from_hf(cls, d, default_original_max: int = 8192) -> Optional["RopeScaling"]:
        if d is None:
            return None
        rope_type = d.get("rope_type", d.get("type", "default"))
        if rope_type == "default":
            return None
        if rope_type not in ("linear", "dynamic", "llama3"):
            raise NotImplementedError(
                f"rope_scaling type {rope_type!r} not supported "
                "(linear, dynamic, llama3 are)")
        return cls(
            rope_type=rope_type,
            factor=float(d.get("factor", 1.0)),
            low_freq_factor=float(d.get("low_freq_factor", 1.0)),
            high_freq_factor=float(d.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                d.get("original_max_position_embeddings", default_original_max)),
        )


def _base_inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def _scaled_inv_freq(inv: torch.Tensor, seq: int, head_dim: int, theta: float,
                     scaling: RopeScaling) -> torch.Tensor:
    """Apply one RopeScaling variant to the base inverse frequencies."""
    if scaling.rope_type == "linear":
        return inv / scaling.factor
    if scaling.rope_type == "dynamic":
        orig = scaling.original_max_position_embeddings
        if seq <= orig:
            return inv
        theta = theta * ((scaling.factor * seq / orig) - (scaling.factor - 1)) ** (
            head_dim / (head_dim - 2))
        return _base_inv_freq(head_dim, theta, inv.device)
    if scaling.rope_type == "llama3":
        orig = scaling.original_max_position_embeddings
        low_wl = orig / scaling.low_freq_factor
        high_wl = orig / scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv
        inv_lo = torch.where(wavelen > low_wl, inv / scaling.factor, inv)
        smooth = (orig / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor)
        smoothed = (1.0 - smooth) * inv / scaling.factor + smooth * inv
        mid = (wavelen >= high_wl) & (wavelen <= low_wl)
        return torch.where(mid, smoothed, inv_lo)
    raise NotImplementedError(scaling.rope_type)


def rope_cos_sin(seq: int, head_dim: int, theta: float,
                 scaling: Optional[RopeScaling] = None, device="cpu"):
    """float32 (cos, sin), each (seq, head_dim), of positions 0..seq-1."""
    inv = _base_inv_freq(head_dim, theta, device)
    if scaling is not None:
        inv = _scaled_inv_freq(inv, seq, head_dim, theta, scaling)
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: (B, S, h, hd); cos/sin: (S, hd). Rotated in float32 and cast
    back to the inputs' dtype (the JAX function leaves a bf16 model's q and
    k in float32)."""
    c, s = cos[None, :, None, :], sin[None, :, None, :]

    def rot(x):
        xf = x.float()
        return (xf * c + _rotate_half(xf) * s).to(x.dtype)

    return rot(q), rot(k)


def causal_mask_bias(attention_mask: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Combined causal + padding (+ sliding window) additive float32 bias
    (B, 1, S, S), shared by the Mixtral and Llama families."""
    s = attention_mask.shape[-1]
    dev = attention_mask.device
    keep = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    if window is not None:
        pos = torch.arange(s, device=dev)
        keep = keep & (pos[:, None] - pos[None, :] < window)
    keep = keep[None, None] & (attention_mask[:, None, None, :] > 0)
    return torch.where(keep, 0.0, NEG_INF).float()


def rope_attention_bias(attention_mask: torch.Tensor, config) -> dict:
    """What the configured attention branch consumes: for flash the per-key
    validity bias ``kv_neg`` (the causal mask and the window live in the
    kernels), else the dense (B, 1, S, S) ``mask_bias``."""
    if config.use_flash:
        from pipegoose_tpu_torch.ops.flash_attention import mask_to_kv_bias

        return {"kv_neg": mask_to_kv_bias(attention_mask)[1]}
    return {"mask_bias": causal_mask_bias(attention_mask,
                                          getattr(config, "sliding_window", None))}


def _local_heads(config, tp_axis: Optional[str]):
    tp = axis_size(tp_axis)
    if config.n_head % tp or config.n_kv_head % tp:
        raise ValueError(f"n_head={config.n_head}/n_kv_head={config.n_kv_head} must "
                         f"divide by the tensor axis size {tp}")
    return config.n_head // tp, config.n_kv_head // tp


def _qkv(blk: dict, x: torch.Tensor, config, tp_axis: Optional[str]):
    """q (B, S, nh/tp, hd), k and v (B, S, nkv/tp, hd), column-parallel."""
    b, s, _ = x.shape
    nh_l, nkv_l = _local_heads(config, tp_axis)
    hd = config.head_dim
    q = column_parallel_linear(blk["q"], x, tp_axis).reshape(b, s, nh_l, hd)
    k = column_parallel_linear(blk["k"], x, tp_axis).reshape(b, s, nkv_l, hd)
    v = column_parallel_linear(blk["v"], x, tp_axis).reshape(b, s, nkv_l, hd)
    return q, k, v


def _attention(blk: dict, x: torch.Tensor, cos, sin, bias: dict, config,
               tp_axis: Optional[str] = None) -> torch.Tensor:
    """RoPE + GQA attention of one block, heads over ``tp_axis``; ``bias`` is
    the dict from :func:`rope_attention_bias`."""
    b, s, _ = x.shape
    hd = config.head_dim
    q, k, v = _qkv(blk, x, config, tp_axis)
    q, k = apply_rope(q, k, cos, sin)
    nh_l, nkv_l = q.shape[2], k.shape[2]
    if config.use_flash:
        from pipegoose_tpu_torch.ops.flash_attention import flash_attention

        ctx = flash_attention(q, k, v, alibi_slopes=None, kv_neg=bias["kv_neg"],
                              causal=True, window=getattr(config, "sliding_window", None))
        ctx = ctx.to(x.dtype).reshape(b, s, nh_l * hd)
        return row_parallel_linear(blk["o"], ctx, tp_axis)
    g = nh_l // nkv_l
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (hd ** -0.5) + bias["mask_bias"]
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    ctx = ctx.to(x.dtype).reshape(b, s, nh_l * hd)
    return row_parallel_linear(blk["o"], ctx, tp_axis)


def embed(params: dict, input_ids: torch.Tensor, config,
          tp_axis: Optional[str] = None) -> torch.Tensor:
    """The vocab-parallel embedding lookup in ``config.dtype``."""
    return vocab_parallel_embedding(params["embed"], input_ids, tp_axis).to(config.dtype)


def _default_mask(input_ids: torch.Tensor, attention_mask):
    if attention_mask is None:
        return torch.ones(input_ids.shape, dtype=torch.int32, device=input_ids.device)
    return attention_mask


def _rope_tables(config, s: int, device, scaling=None):
    return rope_cos_sin(s, config.head_dim, config.rope_theta, scaling, device)


def remat_wrap(fn: Callable, config) -> Callable:
    """``fn`` checkpointed whole when ``config.remat`` (the JAX scan step
    under ``jax.checkpoint``), else ``fn``."""
    return _remat_wrap(fn, config) if config.remat else fn


# -- the model ----------------------------------------------------------------------


def _swiglu_experts(moe_params: dict, x: torch.Tensor,
                    tp_axis: Optional[str]) -> torch.Tensor:
    """(E_local, C, H) -> (E_local, C, H): w2(silu(w1 x) * w3 x), the FFN
    dim Megatron-sharded over tensor (w1/w3 column, w2 row + reduce)."""
    if tp_axis is not None:
        x = copy_to_tensor_group(x, tp_axis)
    g = torch.bmm(x, moe_params["w1"]["kernel"]).to(x.dtype)
    u = torch.bmm(x, moe_params["w3"]["kernel"]).to(x.dtype)
    out = torch.bmm(torch.nn.functional.silu(g) * u, moe_params["w2"]["kernel"]).to(x.dtype)
    if tp_axis is not None:
        out = reduce_from_tensor_group(out, tp_axis)
    return out


def _moe(blk: dict, h: torch.Tensor, seed: int, config, tp_axis, ep_axis, train):
    """The routed SwiGLU experts of one block: (y, aux, z)."""
    flat = h.reshape(-1, h.shape[-1])
    routing = config.router()(blk["router"], flat, key=seed, train=train)
    y = moe_layer(blk["moe"], h, routing, axis_name=ep_axis, tp_axis=tp_axis,
                  act=None, mlp_fn=_swiglu_experts)
    return y, routing.aux_loss, routing.z_loss


def _block(blk: dict, x: torch.Tensor, cos, sin, bias: dict, seed: int, config,
           tp_axis: Optional[str], ep_axis: Optional[str], train: bool):
    h = rms_norm(blk["ln_1"], x, config.rms_eps)
    x = x + _attention(blk["attn"], h, cos, sin, bias, config, tp_axis)
    h = rms_norm(blk["ln_2"], x, config.rms_eps)
    y, aux, z = _moe(blk, h, seed, config, tp_axis, ep_axis, train)
    return x + y, aux, z


def _check_rng(rng, train: bool, config) -> int:
    if rng is None:
        if train and config.router_jitter:
            raise ValueError("train=True with router jitter needs an explicit rng")
        return 0   # inert: no noise on this path
    return rng


def forward_hidden(params: dict, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor], config: MixtralConfig,
                   tp_axis: Optional[str] = None, ep_axis: Optional[str] = None,
                   rng: Optional[int] = None, train: bool = False):
    """Returns (hidden (B, S, H), aux_losses (L,), z_losses (L,)). ``rng``:
    the integer seed of the router noise (needed with ``train`` and
    jitter). With ``config.remat`` each whole block is recomputed in
    backward, the router included."""
    attention_mask = _default_mask(input_ids, attention_mask)
    x = embed(params, input_ids, config, tp_axis)
    cos, sin = _rope_tables(config, input_ids.shape[1], x.device)
    bias = rope_attention_bias(attention_mask, config)
    rng = _check_rng(rng, train, config)

    def block(blk, h, seed):
        return _block(blk, h, cos, sin, bias, seed, config, tp_axis, ep_axis, train)

    block = remat_wrap(block, config)
    aux, z = [], []
    for layer, blk in enumerate(params["blocks"]):
        x, a, zl = block(blk, x, fold_in(rng, layer))
        aux.append(a)
        z.append(zl)
    return rms_norm(params["ln_f"], x, config.rms_eps), torch.stack(aux), torch.stack(z)


def forward(params, input_ids, attention_mask, config, tp_axis=None, ep_axis=None,
            rng=None, train=False):
    """(logits (B, S, V/tp), aux (L,), z (L,)): the head is column-parallel."""
    hidden, aux, z = forward_hidden(params, input_ids, attention_mask, config,
                                    tp_axis, ep_axis, rng, train)
    return column_parallel_linear(params["lm_head"], hidden, tp_axis), aux, z


def _shifted_sums(hidden, weight_fn, layout_weight, labels, mask, config, tp_axis):
    """The next-token cross entropy's (weighted loss sum, weight sum) of
    ``hidden`` (B, S, H): fused (``layout_weight`` = (weight, layout)) with
    ``config.fused_ce``, else over the logits of ``weight_fn(hidden)``."""
    if config.fused_ce:
        from pipegoose_tpu_torch.ops.fused_ce import fused_ce_shifted_sums

        weight, layout = layout_weight
        return fused_ce_shifted_sums(hidden, weight, labels, mask, tp_axis,
                                     config.valid_vocab_size, weight_layout=layout)
    per_tok = vocab_parallel_cross_entropy(weight_fn(hidden)[:, :-1], labels[:, 1:],
                                           tp_axis, valid_size=config.valid_vocab_size)
    w = (mask[:, 1:] if mask is not None else torch.ones_like(labels[:, 1:])).to(per_tok.dtype)
    return (per_tok * w).sum(), w.sum()


def _masked_sums(hidden, weight_fn, layout_weight, labels, weights, config, tp_axis):
    """As :func:`_shifted_sums` on targets already aligned (no shift)."""
    if config.fused_ce:
        from pipegoose_tpu_torch.ops.fused_ce import fused_ce_masked_sums

        weight, layout = layout_weight
        return fused_ce_masked_sums(hidden, weight, labels, weights, tp_axis,
                                    config.valid_vocab_size, weight_layout=layout)
    per_tok = vocab_parallel_cross_entropy(weight_fn(hidden), labels, tp_axis,
                                           valid_size=config.valid_vocab_size)
    w = weights.to(per_tok.dtype)
    return (per_tok * w).sum(), w.sum()


def _head(params, config, tp_axis):
    """(logits function, (weight, fused-CE layout)) of the untied head."""
    return ((lambda h: column_parallel_linear(params["lm_head"], h, tp_axis)),
            (params["lm_head"]["kernel"], "hv"))


def _expert_loss(config) -> ExpertLoss:
    return ExpertLoss(config.aux_loss_weight, config.z_loss_weight)


def loss_fn(params: dict, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
            config: MixtralConfig, tp_axis: Optional[str] = None,
            ep_axis: Optional[str] = None, rng: Optional[int] = None,
            train: bool = True) -> torch.Tensor:
    """Next-token cross entropy (weighted by ``attention_mask[:, 1:]``), with
    ``fused_ce`` through the fused kernels on the (H, V/tp) head ("hv"),
    plus the layer means of the routers' aux and z losses (``ExpertLoss``;
    HF computes one load-balancing loss over all layers, ~O(1), so the mean
    keeps ``router_aux_loss_coef`` on its scale)."""
    hidden, aux, z = forward_hidden(params, input_ids, attention_mask, config,
                                    tp_axis, ep_axis, rng, train)
    fn, lw = _head(params, config, tp_axis)
    tot, cnt = _shifted_sums(hidden, fn, lw, labels, attention_mask, config, tp_axis)
    return _expert_loss(config)(tot / torch.clamp_min(cnt, 1), aux.mean(), z.mean())


def specs(params: dict, tp_axis: str = "tensor", ep_axis: str = "expert") -> dict:
    """Specs: q/k/v column and o row over tensor, experts over expert with
    their FFN over tensor, the router replicated, the embedding
    vocab-sharded and the head column-parallel. On the JAX numpy tree
    (``blocks`` stacked) every block spec has a leading None for the layer
    dim, as the JAX ``specs`` gives it; on the port's per-layer tree none."""
    t, e = tp_axis, ep_axis
    lead = (None,) if isinstance(params["blocks"], dict) else ()

    def spec_fn(path, x):
        if "attn/q" in path or "attn/k" in path or "attn/v" in path:
            return (*lead, None, t)
        if "attn/o" in path:
            return (*lead, t, None)
        if "moe/w1" in path or "moe/w3" in path:
            return (*lead, e, None, t)
        if "moe/w2" in path:
            return (*lead, e, t, None)
        if "router" in path:
            return ()
        if "embed/weight" in path:
            return (t, None)
        if "lm_head" in path:
            return (None, t)
        return ()

    return spec_tree(params, spec_fn)


def pp_specs(params: dict, tp_axis: str = "tensor", ep_axis: str = "expert",
             pipe_axis: str = "pipe") -> dict:
    """:func:`specs` with every block leaf marked with the pipe axis."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import pipe_stage_specs

    sp = specs(params, tp_axis, ep_axis)
    sp["blocks"] = pipe_stage_specs(sp["blocks"], pipe_axis)
    return sp


# -- pipeline-parallel compositions (shared with Llama) ------------------------------


def stacked_bias(masks: torch.Tensor, config) -> dict:
    """:func:`rope_attention_bias` of each microbatch's mask, on a leading M
    dim: the pipeline's per-microbatch side inputs."""
    per = [rope_attention_bias(m, config) for m in masks]
    return {k: torch.stack([b[k] for b in per]) for k in per[0]}


def pipe_entry(params: dict, ids: torch.Tensor, config, tp_axis, pipe_axis):
    """The pipeline-entry activations (M, mb, S, H): the embedding on stage
    0, a storage-free tensor of that shape elsewhere."""
    if axis_index(pipe_axis) == 0:
        return embed(params, ids, config, tp_axis)
    shape = (*ids.shape, config.hidden_size)
    return torch.empty((), dtype=config.dtype, device=ids.device).expand(shape)


def _stage_moe_fn(config, offset: int, n_valid: int, rng: int, cos, sin, tp_axis,
                  ep_axis, train, per_block=None):
    """``stage_fn(blocks, h, side) -> (h, stacked (aux sum, z sum))`` over
    this stage's ``n_valid`` live blocks, layer i routing with
    ``fold_in(rng, offset + i)``. ``per_block(blk, h, seed, side)`` replaces
    the block (the sequence-parallel one)."""
    def one(blk, h, seed, side):
        if per_block is not None:
            return per_block(blk, h, seed, side)
        return _block(blk, h, cos, sin, side["bias"], seed, config, tp_axis, ep_axis,
                      train)

    def stage_fn(blocks, h, side):
        aux = h.new_zeros((), dtype=torch.float32)
        z = h.new_zeros((), dtype=torch.float32)
        for i, blk in enumerate(blocks[:n_valid]):
            h, a, zl = one(blk, h, fold_in(rng, offset + i), side)
            aux, z = aux + a.float(), z + zl.float()
        return h, torch.stack([aux, z])

    return stage_fn


def loss_fn_pp(params: dict, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
               config: MixtralConfig, n_microbatches: int,
               tp_axis: Optional[str] = None, pipe_axis: str = "pipe",
               ep_axis: Optional[str] = None, rng: Optional[int] = None,
               train: bool = True, stage_layer_counts=None) -> torch.Tensor:
    """Pipeline-parallel (GPipe) Mixtral loss over the "pipe" axis: stage 0
    embeds, :func:`gpipe` runs this stage's blocks with the routers' aux
    and z sums riding its aux, the last stage takes the head and the cross
    entropy, the task value comes from the last stage
    (``last_stage_value``) and the aux/z sums are combined over the pipe
    axis with an identity backward, each averaged over layers x
    microbatches. Layer l routes with ``fold_in(rng, l)`` on whichever
    stage holds it. ``stage_layer_counts``: uneven stages, as
    ``bloom.loss_fn_pp``."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import gpipe, last_stage_value

    M = n_microbatches
    _, mbs = _split_batch(input_ids, attention_mask, labels, M)
    rng = _check_rng(rng, train, config)
    n_valid, offset = stage_layers(config.n_layer, params["blocks"], stage_layer_counts,
                                   pipe_axis)
    h0 = pipe_entry(params, mbs["ids"], config, tp_axis, pipe_axis)
    cos, sin = _rope_tables(config, input_ids.shape[1], input_ids.device)
    side = {"bias": stacked_bias(mbs["mask"], config)}
    stage_fn = _stage_moe_fn(config, offset, n_valid, rng, cos, sin, tp_axis, ep_axis,
                             train)
    outs, aux_z = gpipe(stage_fn, params["blocks"], h0, side_inputs=side,
                        axis_name=pipe_axis, remat=config.remat, with_aux=True)
    if axis_index(pipe_axis) != axis_size(pipe_axis) - 1:
        task = last_stage_value(outs.float().sum() * 0, pipe_axis)
    else:
        fn, lw = _head(params, config, tp_axis)
        tot = cnt = 0.0
        for i in range(M):
            h = rms_norm(params["ln_f"], outs[i], config.rms_eps)
            t, c = _shifted_sums(h, fn, lw, mbs["labels"][i], mbs["mask"][i], config,
                                 tp_axis)
            tot, cnt = tot + t, cnt + c
        task = last_stage_value(tot / torch.clamp_min(cnt, 1), pipe_axis)
    aux_z = reduce_from_tensor_group(aux_z, pipe_axis) / (config.n_layer * M)
    return _expert_loss(config)(task, aux_z[0], aux_z[1])


def loss_fn_1f1b(params: dict, input_ids: torch.Tensor,
                 attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
                 config: MixtralConfig, n_microbatches: int,
                 tp_axis: Optional[str] = None, pipe_axis: str = "pipe",
                 ep_axis: Optional[str] = None, rng: Optional[int] = None,
                 train: bool = True, stage_layer_counts=None) -> torch.Tensor:
    """Mixtral on the 1F1B runtime: the loss and gradients of
    :func:`loss_fn_pp`, the routers' losses riding ``one_f_one_b``'s
    ``with_aux``: each stage's pre-weighted aux scalar (its layers' aux and z
    sums times their weights over L x M) seeds its own backward, so router
    gradients never cross stages, and one sum over the pipe axis combines
    the per-rank loss sums."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import one_f_one_b_loss

    M = n_microbatches
    mask, mbs = _split_batch(input_ids, attention_mask, labels, M)
    rng = _check_rng(rng, train, config)
    n_valid, offset = stage_layers(config.n_layer, params["blocks"], stage_layer_counts,
                                   pipe_axis)
    cos, sin = _rope_tables(config, input_ids.shape[1], input_ids.device)
    side = {"bias": stacked_bias(mbs["mask"], config), "labels": mbs["labels"],
            "mask": mbs["mask"]}
    count = torch.clamp_min(mask[:, 1:].sum().float(), 1)
    inner = _stage_moe_fn(config, offset, n_valid, rng, cos, sin, tp_axis, ep_axis, train)
    weights = torch.tensor([config.aux_loss_weight, config.z_loss_weight],
                           dtype=torch.float32, device=input_ids.device)
    L = config.n_layer

    def stage_fn(blocks, h, side):
        h, aux_z = inner(blocks, h, side)
        return h, (weights * aux_z).sum() / (L * M)

    def head_fn(hp, h, side):
        h = rms_norm(hp["ln_f"], h, config.rms_eps)
        fn, lw = _head(hp, config, tp_axis)
        tot, _ = _shifted_sums(h, fn, lw, side["labels"], side["mask"], config, tp_axis)
        return (tot / count).float()

    return one_f_one_b_loss(
        params, stage_fn, head_fn, ("embed",), ("ln_f", "lm_head"),
        lambda ep: pipe_entry(ep, mbs["ids"], config, tp_axis, pipe_axis), side,
        pipe_axis, with_aux=True)


# -- sequence-parallel compositions (shared with Llama) ----------------------------


def _attention_sp(blk: dict, x: torch.Tensor, config, tp_axis: Optional[str],
                  sp_axis: str, pad_mask_local: torch.Tensor,
                  variant: str = "ring") -> torch.Tensor:
    """RoPE/GQA attention with the sequence sharded over ``sp_axis``, heads
    over ``tp_axis``. RoPE is applied at GLOBAL positions (each rank slices
    the full tables at its chunk's offset, ``rope_scaling`` honoured) before
    any exchange. ``variant="ring"``: the nkv-headed K/V ride the ring,
    through the chunk kernels B7-B9 with ``use_flash`` and no window
    (``ring_flash_attention``), else in dense math with the window in the
    block bias (``ring_attention``); ``"ulysses"``: all_to_all re-sharding
    on heads around full-sequence attention (both head counts must divide
    by the sp size)."""
    from pipegoose_tpu_torch.nn.sequence_parallel.ring_attention import (
        make_causal_alibi_bias_fn,
        ring_attention,
        ring_flash_attention,
    )

    if variant not in ("ring", "ulysses"):
        raise ValueError(f"unknown SP variant {variant!r} (ring, ulysses)")
    b, s_local, _ = x.shape
    hd = config.head_dim
    q, k, v = _qkv(blk, x, config, tp_axis)
    sp, rank = axis_size(sp_axis), axis_index(sp_axis)
    cos_f, sin_f = rope_cos_sin(sp * s_local, hd, config.rope_theta,
                                getattr(config, "rope_scaling", None), x.device)
    cos = cos_f[rank * s_local:(rank + 1) * s_local]
    sin = sin_f[rank * s_local:(rank + 1) * s_local]
    q, k = apply_rope(q, k, cos, sin)
    window = getattr(config, "sliding_window", None)
    if variant == "ulysses":
        from pipegoose_tpu_torch.nn.sequence_parallel.ulysses import (
            ulysses_causal_attention,
        )

        ctx = ulysses_causal_attention(q, k, v, sp_axis, pad_mask_local, window=window,
                                       use_flash=config.use_flash)
    elif config.use_flash and window is None:
        ctx = ring_flash_attention(q, k, v, sp_axis, alibi_slopes=None,
                                   kv_side=pad_mask_local)
    else:
        bias_fn = make_causal_alibi_bias_fn(s_local, sp_axis, window=window)
        ctx = ring_attention(q, k, v, sp_axis, bias_fn, kv_side=pad_mask_local)
    ctx = ctx.to(x.dtype).reshape(b, s_local, q.shape[2] * hd)
    return row_parallel_linear(blk["o"], ctx, tp_axis)


def _sp_block(blk, x, seed, config, tp_axis, ep_axis, sp_axis, pad_mask_local, train,
              variant="ring"):
    h = rms_norm(blk["ln_1"], x, config.rms_eps)
    x = x + _attention_sp(blk["attn"], h, config, tp_axis, sp_axis, pad_mask_local,
                          variant)
    h = rms_norm(blk["ln_2"], x, config.rms_eps)
    y, aux, z = _moe(blk, h, seed, config, tp_axis, ep_axis, train)
    return x + y, aux, z


def sp_task(tot, cnt, sp_axis):
    """The global mean from this shard's (loss sum, weight sum): values
    become global means, gradients stay local (the train step sums them
    over ``sp_axis``)."""
    count = all_reduce(cnt, sp_axis)
    return reduce_from_tensor_group(tot / torch.clamp_min(count, 1), sp_axis)


def loss_fn_sp(params: dict, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
               config: MixtralConfig, tp_axis: Optional[str] = None,
               ep_axis: Optional[str] = None, sp_axis: str = "seq",
               rng: Optional[int] = None, train: bool = True,
               variant: str = "ring") -> torch.Tensor:
    """Sequence-parallel Mixtral loss: ``input_ids``, ``attention_mask`` and
    ``labels`` are this rank's (B, S_local) chunk; ring (or Ulysses)
    attention with RoPE at global positions, routing on each rank's local
    tokens; the task CE over the cross-chunk shifted targets. z is a
    per-token mean, so the rank average is the dense value; aux is the
    Megatron-style rank average. Replicated gradients are summed over
    ``sp_axis`` by the train step."""
    from pipegoose_tpu_torch.nn.sequence_parallel.targets import sp_shifted_targets

    attention_mask = _default_mask(input_ids, attention_mask)
    x = embed(params, input_ids, config, tp_axis)
    rng = _check_rng(rng, train, config)

    def block(blk, h, seed):
        return _sp_block(blk, h, seed, config, tp_axis, ep_axis, sp_axis,
                         attention_mask, train, variant)

    block = remat_wrap(block, config)
    aux, z = [], []
    for layer, blk in enumerate(params["blocks"]):
        x, a, zl = block(blk, x, fold_in(rng, layer))
        aux.append(a)
        z.append(zl)
    x = rms_norm(params["ln_f"], x, config.rms_eps)
    sl, sw = sp_shifted_targets(labels, attention_mask, sp_axis)
    fn, lw = _head(params, config, tp_axis)
    tot, cnt = _masked_sums(x, fn, lw, sl, sw, config, tp_axis)
    sp = axis_size(sp_axis)
    aux_t = reduce_from_tensor_group(torch.stack(aux).mean() / sp, sp_axis)
    z_t = reduce_from_tensor_group(torch.stack(z).mean() / sp, sp_axis)
    return _expert_loss(config)(sp_task(tot, cnt, sp_axis), aux_t, z_t)


def loss_fn_pp_sp(params: dict, input_ids: torch.Tensor,
                  attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
                  config: MixtralConfig, n_microbatches: int,
                  tp_axis: Optional[str] = None, ep_axis: Optional[str] = None,
                  pipe_axis: str = "pipe", sp_axis: str = "seq",
                  rng: Optional[int] = None, train: bool = True) -> torch.Tensor:
    """Pipeline x sequence parallel Mixtral: ring attention (RoPE at global
    positions) inside GPipe stages, routing on each rank's local tokens.
    Loss terms as :func:`loss_fn_sp`; gradients synced with
    ``grad_sync_axes=(("pipe", "sum"), ("seq", "sum"))``."""
    from pipegoose_tpu_torch.nn.pipeline_parallel.pipeline import gpipe, last_stage_value
    from pipegoose_tpu_torch.nn.sequence_parallel.targets import sp_shifted_targets

    M = n_microbatches
    _, mbs = _split_batch(input_ids, attention_mask, labels, M)
    rng = _check_rng(rng, train, config)
    n_valid, offset = stage_layers(config.n_layer, params["blocks"], None, pipe_axis)
    h0 = pipe_entry(params, mbs["ids"], config, tp_axis, pipe_axis)
    side = {"mask": mbs["mask"]}

    def per_block(blk, h, seed, side):
        return _sp_block(blk, h, seed, config, tp_axis, ep_axis, sp_axis, side["mask"],
                         train)

    stage_fn = _stage_moe_fn(config, offset, n_valid, rng, None, None, tp_axis, ep_axis,
                             train, per_block=per_block)
    outs, aux_z = gpipe(stage_fn, params["blocks"], h0, side_inputs=side,
                        axis_name=pipe_axis, remat=config.remat, with_aux=True)
    if axis_index(pipe_axis) != axis_size(pipe_axis) - 1:
        task = last_stage_value(outs.float().sum() * 0, pipe_axis)
    else:
        fn, lw = _head(params, config, tp_axis)
        tot = cnt = 0.0
        for i in range(M):
            h = rms_norm(params["ln_f"], outs[i], config.rms_eps)
            sl, sw = sp_shifted_targets(mbs["labels"][i], mbs["mask"][i], sp_axis)
            t, c = _masked_sums(h, fn, lw, sl, sw, config, tp_axis)
            tot, cnt = tot + t, cnt + c
        task = last_stage_value(sp_task(tot, cnt, sp_axis), pipe_axis)
    sp = axis_size(sp_axis)
    aux_z = reduce_from_tensor_group(reduce_from_tensor_group(aux_z, pipe_axis), sp_axis)
    aux_z = aux_z / (config.n_layer * M * sp)
    return _expert_loss(config)(task, aux_z[0], aux_z[1])


# -- generation (KV cache) ------------------------------------------------------------


def init_cache(config, batch: int, max_len: int, device="cuda") -> dict:
    """Zero KV cache ``{"k", "v"}``, each (n_layer, batch, max_len, nkv, hd)
    of ``config.dtype`` on ``device``: the nkv-wide GQA cache."""
    dev = resolve_device(device)
    shape = (config.n_layer, batch, max_len, config.n_kv_head, config.head_dim)
    return {"k": torch.zeros(shape, dtype=config.dtype, device=dev),
            "v": torch.zeros(shape, dtype=config.dtype, device=dev)}


def _attn_cached(blk: dict, x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, start: int, cos_full, sin_full, config):
    """S new tokens against cache[:start] + themselves (RoPE at absolute
    positions, the sliding window if any): a grouped einsum against the
    nkv-wide cache, no repeated K/V. Writes the new k/v into the layer's
    cache (B, max_len, nkv, hd) in place; returns the block's output."""
    b, s, _ = x.shape
    hd, nh, nkv = config.head_dim, config.n_head, config.n_kv_head
    groups = nh // nkv
    max_len = k_cache.shape[1]
    q, k, v = _qkv(blk, x, config, None)
    q, k = apply_rope(q, k, cos_full[start:start + s], sin_full[start:start + s])
    k_cache[:, start:start + s] = k.to(k_cache.dtype)
    v_cache[:, start:start + s] = v.to(v_cache.dtype)
    key_pos = torch.arange(max_len, device=x.device)
    q_pos = start + torch.arange(s, device=x.device)
    keep = key_pos[None, :] <= q_pos[:, None]
    window = getattr(config, "sliding_window", None)
    if window is not None:
        keep = keep & (q_pos[:, None] - key_pos[None, :] < window)
    bias = torch.where(keep, 0.0, NEG_INF)[None, None, None]   # (1, 1, 1, S, max_len)
    qg = q.reshape(b, s, nkv, groups, hd)
    scores = torch.einsum("bqkgd,bmkd->bkgqm", qg.float(), k_cache.float())
    probs = torch.softmax(scores * (hd ** -0.5) + bias, dim=-1).to(x.dtype)
    ctx = torch.einsum("bkgqm,bmkd->bqkgd", probs.float(), v_cache.float())
    ctx = ctx.to(x.dtype).reshape(b, s, nh * hd)
    return row_parallel_linear(blk["o"], ctx, None)


def decode_layers(params: dict, ids: torch.Tensor, cache: dict, start: int, config,
                  mlp: Callable, scaling=None) -> torch.Tensor:
    """Embedding -> every block over the cache (``mlp(blk, h)`` the block's
    MLP half on the normed stream) -> final norm; (B, S, H)."""
    x = embed(params, ids, config)
    max_len = cache["k"].shape[2]
    cos_full, sin_full = rope_cos_sin(max_len, config.head_dim, config.rope_theta,
                                      scaling, x.device)
    start = int(start)
    for i, blk in enumerate(params["blocks"]):
        ln1 = rms_norm(blk["ln_1"], x, config.rms_eps)
        x = x + _attn_cached(blk["attn"], ln1, cache["k"][i], cache["v"][i], start,
                             cos_full, sin_full, config)
        x = x + mlp(blk, rms_norm(blk["ln_2"], x, config.rms_eps))
    return rms_norm(params["ln_f"], x, config.rms_eps)


def forward_cached(params: dict, ids: torch.Tensor, cache: dict, start: int,
                   config: MixtralConfig):
    """(logits of the last position (B, V), the cache written in place);
    deterministic routing (no jitter: inference)."""
    def mlp(blk, h):
        return _moe(blk, h, 0, config, None, None, False)[0]

    x = decode_layers(params, ids, cache, start, config, mlp)
    return column_parallel_linear(params["lm_head"], x[:, -1:], None)[:, 0], cache


def _generate(forward_cached_fn, params, input_ids, config, max_new_tokens,
              temperature, eos_token_id, device, generator):
    from pipegoose_tpu_torch.models._decode import autoregressive_generate, vocab_mask_for
    from pipegoose_tpu_torch.models.generate import _as_ids, _params_device

    dev = _params_device(params, device)
    ids = _as_ids(input_ids, dev)
    return autoregressive_generate(
        forward_cached_fn, init_cache, params, ids, config, max_new_tokens,
        temperature, eos_token_id, logits_mask=vocab_mask_for(config),
        generator=generator)


def generate(params: dict, input_ids, config: MixtralConfig, max_new_tokens: int,
             temperature: float = 0.0, eos_token_id: Optional[int] = None,
             device="cuda", generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (``temperature=0``) or sampled decoding with the GQA KV cache
    through the shared loop (``_decode.autoregressive_generate``): (B, S)
    prompt ids -> (B, S + max_new_tokens) int64 on ``device``, where the
    params must be. EOS as BLOOM's ``generate``."""
    return _generate(forward_cached, params, input_ids, config, max_new_tokens,
                     temperature, eos_token_id, device, generator)


# -- upcycling ------------------------------------------------------------------------


def upcycle_from_llama(llama_params: dict, llama_config, num_experts: int,
                       top_k: int = 2, key: Optional[int] = None,
                       jitter: float = 0.0, **config_overrides):
    """Sparse-upcycle a dense Llama (the port's per-layer tree) into a
    Mixtral: every expert starts as a copy of the layer's SwiGLU MLP
    (gate/up/down -> w1/w3/w2), plus a fresh router gate drawn normal(0,
    0.02) from ``key`` (an integer seed, 0 when None). A tied Llama gets
    its head materialized as the embedding's transpose. With ``jitter=0``
    the forward equals the dense Llama's (identical experts, normalized
    top-k gates); ``jitter`` perturbs each expert leaf by ``1 + jitter x
    normal``. Returns (MixtralConfig, params)."""
    cfg = MixtralConfig(
        vocab_size=llama_config.vocab_size, hidden_size=llama_config.hidden_size,
        intermediate_size=llama_config.intermediate_size, n_layer=llama_config.n_layer,
        n_head=llama_config.n_head, n_kv_head=llama_config.n_kv_head,
        rope_theta=llama_config.rope_theta, rms_eps=llama_config.rms_eps,
        num_experts=num_experts, top_k=top_k, dtype=llama_config.dtype,
        remat=llama_config.remat, use_flash=llama_config.use_flash,
        valid_vocab_size=llama_config.valid_vocab_size, **config_overrides)
    key = 0 if key is None else key
    E = num_experts
    blocks = []
    for i, blk in enumerate(llama_params["blocks"]):
        dev = blk["mlp"]["gate"]["kernel"].device
        gen = torch.Generator(device=dev).manual_seed(fold_in(key, 2 * i))
        moe = {name: {"kernel": blk["mlp"][src]["kernel"].detach()[None].repeat(
                   E, *([1] * blk["mlp"][src]["kernel"].dim()))}
               for name, src in (("w1", "gate"), ("w3", "up"), ("w2", "down"))}
        if jitter:
            for leaf in moe.values():
                w = leaf["kernel"]
                noise = torch.randn(w.shape, generator=gen, device=dev,
                                    dtype=torch.float32)
                leaf["kernel"] = (w * (1 + jitter * noise).to(w.dtype))
        rgen = torch.Generator(device=dev).manual_seed(fold_in(key, 2 * i + 1))
        gate = torch.randn((cfg.hidden_size, E), generator=rgen, device=dev,
                           dtype=torch.float32) * 0.02
        new = {k: v for k, v in blk.items() if k != "mlp"}
        new["moe"] = moe
        new["router"] = {"gate": {"kernel": gate.to(cfg.dtype)}}
        blocks.append(new)
    lm_head = llama_params.get("lm_head")
    if lm_head is None:   # tied checkpoint: materialize the head
        lm_head = {"kernel": llama_params["embed"]["weight"].detach().t().contiguous()}
    return cfg, {"embed": llama_params["embed"], "blocks": blocks,
                 "ln_f": llama_params["ln_f"], "lm_head": lm_head}


__all__ = [
    "MixtralConfig", "RopeScaling", "init_params_numpy", "init_params", "rms_norm",
    "rope_cos_sin", "apply_rope", "causal_mask_bias", "rope_attention_bias",
    "forward_hidden", "forward", "loss_fn", "specs", "pp_specs", "loss_fn_pp",
    "loss_fn_1f1b", "loss_fn_sp", "loss_fn_pp_sp", "init_cache", "forward_cached",
    "generate", "upcycle_from_llama",
]
