"""The shared decode loops and their token picks (the counterpart of
``pipegoose_tpu/models/_decode.py``), used by the serving engine's decode
step and prefills and by ``models.generate.generate``: greedy, or sampled
at ``temperature > 0`` from a ``torch.Generator``. The JAX package draws
with ``jax.random.categorical``; its draws cannot be matched bit for bit,
so the port's sampled tokens follow the same distribution, not the same
sequence (ROADMAP.md § C). Under a tensor axis the logits are vocab
shards: :func:`global_greedy_pick` is the greedy pick over them and
:func:`autoregressive_generate_sharded` the loop of
``models.generate.generate_tp``. The loops open the JAX loops' telemetry
spans (``generate.prefill`` and ``generate.decode``, or one
``generate.sharded``), each fenced on its tokens so its wall time covers
the card's work; no-ops while the registry is disabled."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from pipegoose_tpu_torch.distributed.functional import all_gather, axis_index, axis_size
from pipegoose_tpu_torch.models.bloom import NEG_INF
from pipegoose_tpu_torch.telemetry.spans import span


def vocab_mask_for(config) -> Optional[Callable]:
    """Padded-vocab logits mask: None when the config has no
    ``valid_vocab_size``, else a function that sets every column at or
    beyond it to -1e9 (``mask_padded_vocab``) so padded slots never win
    a greedy pick."""
    valid = getattr(config, "valid_vocab_size", None)
    if valid is None:
        return None

    def mask(logits: torch.Tensor) -> torch.Tensor:
        col = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(col < valid, logits, NEG_INF)

    return mask


def greedy_token(logits: torch.Tensor,
                 logits_mask: Optional[Callable] = None) -> torch.Tensor:
    """Optional padded-vocab mask, then argmax. ``torch.argmax`` returns
    the first maximum, as ``jnp.argmax`` does, so ties break alike."""
    if logits_mask is not None:
        logits = logits_mask(logits)
    return torch.argmax(logits, dim=-1)


def default_generator(device) -> torch.Generator:
    """A generator on ``device`` seeded 0, as the JAX loop defaults to
    ``PRNGKey(0)``."""
    return torch.Generator(device=device).manual_seed(0)


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: torch.Generator,
                 logits_mask: Optional[Callable] = None) -> torch.Tensor:
    """The sampled pick: optional padded-vocab mask, then one draw per row
    from ``softmax(logits / temperature)`` in float32 with ``generator``."""
    if logits_mask is not None:
        logits = logits_mask(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def autoregressive_generate(forward_cached: Callable, init_cache: Callable,
                            params, input_ids: torch.Tensor, config,
                            max_new_tokens: int, temperature: float = 0.0,
                            eos_token_id: Optional[int] = None,
                            logits_mask: Optional[Callable] = None,
                            extras=None,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (``temperature=0``) or sampled decoding with a KV cache: one
    prefill of the whole prompt, then one ``forward_cached`` call per new
    token.

    - ``eos_token_id``: finished rows emit eos from then on (HF generate's
      pad-with-eos);
    - ``logits_mask(logits) -> logits``: e.g. padded-vocab masking;
    - ``extras``: side inputs forwarded to ``forward_cached(...,
      extras=extras)``, e.g. the extended mask of ragged prompts.

    ``forward_cached(params, ids, cache, start, config[, extras=])``
    returns (logits, cache); ``init_cache(config, batch, max_len,
    device=)`` the empty cache. ``temperature > 0`` samples each token with
    :func:`sample_token` from ``generator`` (one on the ids' device seeded
    0 when None). The JAX loop's jit cache has no counterpart."""
    if max_new_tokens <= 0:
        return input_ids
    if temperature > 0.0 and generator is None:
        generator = default_generator(input_ids.device)

    def pick(logits):
        if temperature <= 0.0:
            return greedy_token(logits, logits_mask)
        return sample_token(logits, temperature, generator, logits_mask)

    b, s = input_ids.shape
    cache = init_cache(config, b, s + max_new_tokens, device=input_ids.device)
    eos = -1 if eos_token_id is None else int(eos_token_id)

    def fwd(ids, cache, pos):
        if extras is None:
            return forward_cached(params, ids, cache, pos, config)
        return forward_cached(params, ids, cache, pos, config, extras=extras)

    with span("generate.prefill", attrs={"prompt_len": s, "batch": b}) as sp:
        logits, cache = fwd(input_ids, cache, 0)
        tok = pick(logits)
        sp.fence(tok)
    done = tok == eos
    out = [tok]
    if max_new_tokens > 1:
        with span("generate.decode",
                  attrs={"new_tokens": max_new_tokens, "batch": b}) as sp:
            for pos in range(s, s + max_new_tokens - 1):
                logits, cache = fwd(tok[:, None], cache, pos)
                tok = torch.where(done, eos, pick(logits))
                done = done | (tok == eos)
                out.append(tok)
            sp.fence(tok)
    return torch.cat([input_ids, torch.stack(out, dim=1).to(input_ids.dtype)], dim=1)


def global_greedy_pick(logits_local: torch.Tensor, tp_axis: Optional[str],
                       valid_size: Optional[int] = None) -> torch.Tensor:
    """Greedy argmax over a VOCAB-SHARDED logits row (B, V/tp): each rank
    takes its local argmax and maximum in float32, one all-gather over
    ``tp_axis`` brings every shard's pair, and the winner is the first
    shard holding the largest maximum, its index offset to the global id
    ``shard * V/tp + local``. ``torch.argmax`` returns the first maximum,
    as ``jnp.argmax`` does, so a tie goes to the lowest global id on every
    rank. Padded slots (global column >= ``valid_size``) are masked to
    -1e30 by their GLOBAL column. Returns (B,) int64, the same on every
    rank."""
    vloc = logits_local.shape[-1]
    x = logits_local.float()
    if valid_size is not None:
        gcol = axis_index(tp_axis) * vloc + torch.arange(vloc, device=x.device)
        x = torch.where(gcol[None, :] < valid_size, x, -1e30)
    local_idx = torch.argmax(x, dim=-1)
    local_max = torch.gather(x, -1, local_idx[:, None])[:, 0]
    # one collective: a float32 maximum and an index below 2^53 are exact
    # in float64
    pair = torch.stack([local_max.double(), local_idx.double()], dim=-1)
    every = all_gather(pair[None], tp_axis, dim=0)           # (tp, B, 2)
    best = torch.argmax(every[..., 0], dim=0)                # (B,)
    widx = torch.gather(every[..., 1], 0, best[None, :])[0].long()
    return best * vloc + widx


def autoregressive_generate_sharded(forward_cached: Callable, init_cache: Callable,
                                    params, input_ids: torch.Tensor, config,
                                    max_new_tokens: int, tp_axis: str = "tensor",
                                    eos_token_id: Optional[int] = None,
                                    extras=None) -> torch.Tensor:
    """Tensor-parallel greedy decoding on this rank: ``params`` is this
    rank's shard, ``forward_cached(params, ids, cache, start, config,
    tp_axis[, extras=])`` returns this rank's vocab shard of the logits,
    ``init_cache(config, batch, max_len, tp, device=)`` the cache of its
    ``n_head / tp`` heads. Every pick is :func:`global_greedy_pick`, so
    every rank emits the same tokens; eos as :func:`autoregressive_generate`.
    Greedy only: a sampled pick over a sharded vocabulary needs a global
    categorical (use the single-device path for ``temperature > 0``).
    Returns (B, S + max_new_tokens)."""
    if max_new_tokens <= 0:
        return input_ids
    b, s = input_ids.shape
    tp = axis_size(tp_axis)
    cache = init_cache(config, b, s + max_new_tokens, tp, device=input_ids.device)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    valid = getattr(config, "valid_vocab_size", None)

    def fwd(ids, cache, pos):
        if extras is None:
            return forward_cached(params, ids, cache, pos, config, tp_axis)
        return forward_cached(params, ids, cache, pos, config, tp_axis, extras=extras)

    # prefill and decode under one span, as the JAX loop runs them as one
    # program
    with span("generate.sharded",
              attrs={"prompt_len": s, "new_tokens": max_new_tokens,
                     "batch": b, "tp": tp}) as sp:
        logits, cache = fwd(input_ids, cache, 0)
        tok = global_greedy_pick(logits, tp_axis, valid)
        done = tok == eos
        out = [tok]
        for pos in range(s, s + max_new_tokens - 1):
            logits, cache = fwd(tok[:, None], cache, pos)
            tok = torch.where(done, eos, global_greedy_pick(logits, tp_axis, valid))
            done = done | (tok == eos)
            out.append(tok)
        sp.fence(tok)
    return torch.cat([input_ids, torch.stack(out, dim=1).to(input_ids.dtype)], dim=1)
