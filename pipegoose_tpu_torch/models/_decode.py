"""The shared decode loop and greedy token pick (the counterpart of
``pipegoose_tpu/models/_decode.py``), used by the serving engine's decode
step and prefills and by ``models.generate.generate``."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from pipegoose_tpu_torch.models.bloom import NEG_INF


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


def autoregressive_generate(forward_cached: Callable, init_cache: Callable,
                            params, input_ids: torch.Tensor, config,
                            max_new_tokens: int, temperature: float = 0.0,
                            eos_token_id: Optional[int] = None,
                            logits_mask: Optional[Callable] = None,
                            extras=None) -> torch.Tensor:
    """Greedy decoding with a KV cache: one prefill of the whole prompt,
    then one ``forward_cached`` call per new token.

    - ``eos_token_id``: finished rows emit eos from then on (HF generate's
      pad-with-eos);
    - ``logits_mask(logits) -> logits``: e.g. padded-vocab masking;
    - ``extras``: side inputs forwarded to ``forward_cached(...,
      extras=extras)``, e.g. the extended mask of ragged prompts.

    ``forward_cached(params, ids, cache, start, config[, extras=])``
    returns (logits, cache); ``init_cache(config, batch, max_len,
    device=)`` the empty cache. The JAX loop's jit cache and telemetry
    spans have no counterpart. Sampling (``temperature > 0``) raises
    ``NotImplementedError``: ``jax.random``'s draws cannot be matched, and
    the serving path is greedy."""
    if max_new_tokens <= 0:
        return input_ids
    if temperature > 0.0:
        raise NotImplementedError(
            "sampling (temperature > 0) is not ported yet (ROADMAP.md queue "
            "A); generate is greedy")
    b, s = input_ids.shape
    cache = init_cache(config, b, s + max_new_tokens, device=input_ids.device)
    eos = -1 if eos_token_id is None else int(eos_token_id)

    def fwd(ids, cache, pos):
        if extras is None:
            return forward_cached(params, ids, cache, pos, config)
        return forward_cached(params, ids, cache, pos, config, extras=extras)

    logits, cache = fwd(input_ids, cache, 0)
    tok = greedy_token(logits, logits_mask)
    done = tok == eos
    out = [tok]
    for pos in range(s, s + max_new_tokens - 1):
        logits, cache = fwd(tok[:, None], cache, pos)
        tok = torch.where(done, eos, greedy_token(logits, logits_mask))
        done = done | (tok == eos)
        out.append(tok)
    return torch.cat([input_ids, torch.stack(out, dim=1).to(input_ids.dtype)], dim=1)
