"""Greedy token pick shared by the serving engine's decode step and chunked
prefill (the counterpart of ``pipegoose_tpu/models/_decode.py``)."""
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
