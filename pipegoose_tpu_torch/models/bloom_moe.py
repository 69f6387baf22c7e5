"""BLOOM-MoE: BLOOM with Switch/Mixtral-style MoE MLPs.

The counterpart of ``pipegoose_tpu/models/bloom_moe.py``: every block's MLP
is a routed expert layer (``nn.expert_parallel.moe_layer``), dispatched with
static shapes over the ``expert`` axis and optionally Megatron-sharded over
``tensor`` inside each expert; attention, the embedding, the LayerNorms and
the tied head are BLOOM's (``models.bloom``), so ``use_flash`` runs every
block's attention through the flash kernels. The router's aux and z losses
are returned per layer and folded into the loss by ``ExpertLoss``.

Where this parts from the JAX model (ROADMAP.md § C):

- the rng is an integer seed: layer ``l`` routes with the noise of
  ``core.accumulation.fold_in(rng, l)`` (JAX splits a PRNG key over the
  layers), drawn inside the block so that a rematerialized block draws it
  again;
- the loss always takes the full logits, as JAX's does, but a config asking
  for ``fused_ce`` or ``ce_chunks`` raises instead of being ignored;
- ``init_params_numpy`` draws from a numpy seed in place of ``init_params``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pipegoose_tpu_torch.core.accumulation import fold_in
from pipegoose_tpu_torch.models import bloom as _bloom
from pipegoose_tpu_torch.models.bloom import (
    BloomConfig,
    attention_bias,
    embed_tokens,
    logits_fn,
)
from pipegoose_tpu_torch.nn.expert_parallel.experts import expert_mlp_specs, moe_layer
from pipegoose_tpu_torch.nn.expert_parallel.loss import ExpertLoss
from pipegoose_tpu_torch.nn.expert_parallel.routers import SwitchNoisePolicy, TopKRouter
from pipegoose_tpu_torch.nn.parallel import spec_tree
from pipegoose_tpu_torch.nn.tensor_parallel.layers import (
    layer_norm,
    vocab_parallel_cross_entropy,
)


@dataclasses.dataclass(frozen=True)
class BloomMoEConfig(BloomConfig):
    num_experts: int = 8
    top_k: int = 1
    capacity_factor: float = 1.25
    router_noise_eps: float = 0.1
    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.001
    ffn_mult: int = 4

    def router(self) -> TopKRouter:
        noise = SwitchNoisePolicy(self.router_noise_eps) if self.router_noise_eps else None
        return TopKRouter(num_experts=self.num_experts, top_k=self.top_k,
                          capacity_factor=self.capacity_factor, noise=noise)


def init_params_numpy(config: BloomMoEConfig, seed: int) -> dict:
    """A fresh MoE init in the JAX parameter layout, as float32 numpy arrays:
    BLOOM's trunk (``bloom.init_params_numpy(config, seed)``) without its
    MLP, expert stacks ``blocks/moe/{up,down}`` of shape (L, E, H, F) and
    (L, E, F, H) (normal(0, initializer_range) kernels, zero biases) and a
    router gate ``blocks/router/gate/kernel`` (L, H, E), from
    ``numpy.random.default_rng((seed, 1))``. Feed it to
    ``weights.params_from_jax``. (To upcycle a dense model, with the dense
    MLP as every expert's template, use ``ExpertParallel.from_dense``.)"""
    params = _bloom.init_params_numpy(config, seed)
    h, L, E = config.hidden_size, config.n_layer, config.num_experts
    F = config.ffn_mult * h
    std = np.float32(config.initializer_range)
    rng = np.random.default_rng((seed, 1))

    def normal(shape):
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= std
        return w

    del params["blocks"]["mlp"]
    params["blocks"]["moe"] = {
        "up": {"kernel": normal((L, E, h, F)), "bias": np.zeros((L, E, F), np.float32)},
        "down": {"kernel": normal((L, E, F, h)), "bias": np.zeros((L, E, h), np.float32)},
    }
    params["blocks"]["router"] = {"gate": {"kernel": normal((L, h, E))}}
    return params


def _moe_block(blk: dict, x: torch.Tensor, bias: dict, seed: int,
               config: BloomMoEConfig, tp_axis: Optional[str], ep_axis: Optional[str],
               train: bool):
    """One block: BLOOM attention, then the routed MLP. Returns (x, aux, z)."""
    eps = config.layer_norm_epsilon
    ln1 = layer_norm(blk["ln_1"], x, eps)
    x = x + _bloom._attention(blk["attn"], ln1, bias, config, tp_axis)
    ln2 = layer_norm(blk["ln_2"], x, eps)

    # every flat token routes, the pads of a right-padded row included: a
    # pad takes capacity as in JAX, so no later token's slot moves
    flat = ln2.reshape(-1, ln2.shape[-1])
    routing = config.router()(blk["router"], flat, key=seed, train=train)
    y = moe_layer(blk["moe"], ln2, routing, axis_name=ep_axis, act=_bloom.bloom_gelu,
                  tp_axis=tp_axis)
    return x + y, routing.aux_loss, routing.z_loss


def forward_hidden(params: dict, input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor], config: BloomMoEConfig,
                   tp_axis: Optional[str] = None, ep_axis: Optional[str] = None,
                   rng: Optional[int] = None, train: bool = False):
    """Returns (hidden (B, S, H), aux_losses (L,), z_losses (L,)). ``rng``:
    the integer seed of the router noise (needed with ``train`` and noise;
    fold in the step and the data/expert coordinates so that every step and
    rank draws its own). With ``config.remat`` each whole block is
    recomputed in backward, the router included."""
    b, s = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=torch.int32, device=input_ids.device)
    x = embed_tokens(params, input_ids, config, tp_axis)
    bias = attention_bias(attention_mask, config)

    if rng is None:
        if train and config.router_noise_eps:
            raise ValueError(
                "train=True with router noise needs an explicit rng (fold in the "
                "step count and data/expert axis indices); a fixed default seed "
                "would apply the SAME perturbation every step")
        rng = 0   # inert: noise disabled on this path

    def block(blk, h, seed):
        return _moe_block(blk, h, bias, seed, config, tp_axis, ep_axis, train)

    if config.remat:
        # the whole block, whatever remat_policy says, as the JAX model's
        # jax.checkpoint of its scan step
        from torch.utils.checkpoint import checkpoint

        plain = block

        def block(blk, h, seed):
            return checkpoint(plain, blk, h, seed, use_reentrant=False)

    aux, z = [], []
    for layer, blk in enumerate(params["blocks"]):
        x, a, zl = block(blk, x, fold_in(rng, layer))
        aux.append(a)
        z.append(zl)
    hidden = layer_norm(params["ln_f"], x, config.layer_norm_epsilon)
    return hidden, torch.stack(aux), torch.stack(z)


def loss_fn(params: dict, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor], labels: torch.Tensor,
            config: BloomMoEConfig, tp_axis: Optional[str] = None,
            ep_axis: Optional[str] = None, rng: Optional[int] = None,
            train: bool = True) -> torch.Tensor:
    """Next-token cross entropy over the full logits (weighted by
    ``attention_mask[:, 1:]``) plus the routers' aux and z losses
    (``ExpertLoss``). ``fused_ce`` or ``ce_chunks`` on the config raise
    ValueError: this loss has no such path."""
    if config.fused_ce or config.ce_chunks:
        raise ValueError(
            "bloom_moe.loss_fn takes the full logits only: fused_ce and ce_chunks "
            "are not supported (unset them on the BloomMoEConfig)")
    hidden, aux, z = forward_hidden(params, input_ids, attention_mask, config,
                                    tp_axis, ep_axis, rng, train)
    logits = logits_fn(params, hidden, tp_axis)
    per_tok = vocab_parallel_cross_entropy(logits[:, :-1], labels[:, 1:], tp_axis,
                                           valid_size=config.valid_vocab_size)
    if attention_mask is not None:
        w = attention_mask[:, 1:].to(per_tok.dtype)
        task = (per_tok * w).sum() / torch.clamp_min(w.sum(), 1)
    else:
        task = per_tok.mean()
    return ExpertLoss(config.aux_loss_weight, config.z_loss_weight)(task, aux, z)


def moe_specs(params: dict, tp_axis: str = "tensor", ep_axis: str = "expert") -> dict:
    """``bloom.tp_specs`` for the shared trunk plus the expert and router
    specs: experts over the expert axis, the expert FFN over tensor, the
    router gate replicated. On the JAX numpy tree (``blocks`` stacked) every
    block spec has a leading None, as the JAX ``moe_specs`` gives it; on the
    port's per-layer tree each layer's leaves get their own specs."""
    base_mapping = _bloom.tp_mapping(tp_axis)
    especs = expert_mlp_specs(ep_axis, tp_axis)
    stacked = isinstance(params["blocks"], dict)
    lead = 0 if stacked else 1   # the per-layer leaves have no layer dim

    def spec_fn(path, x):
        if "blocks/" in path and "/moe/" in path:
            proj = "up" if "/up/" in path else "down"
            kind = "kernel" if path.endswith("kernel") else "bias"
            return especs[proj][kind][lead:]
        if "blocks/" in path and "/router/" in path:
            return ()
        if path.startswith("blocks/"):
            base = base_mapping.spec_for(path, x.ndim - 1 + lead)
            return (None, *base) if stacked else base
        return base_mapping.spec_for(path, x.ndim)

    return spec_tree(params, spec_fn)
