"""The single-device BLOOM training step: forward, backward, one Adam
update. The counterpart of the loop body of ``bench.py``'s measured step
(``jax.value_and_grad(bloom.loss_fn)`` then ``optax.adam``).

The params are the port's tree (``models.weights.params_from_jax``);
Adam updates its leaves in place, so a ``ServingEngine`` built on the
same tree serves the trained values with no copy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pipegoose_tpu_torch._device import resolve_device
from pipegoose_tpu_torch.models.bloom import loss_fn
from pipegoose_tpu_torch.models.weights import param_leaves

# optax.adam's defaults; eps is added outside the square root, after the
# bias correction, in both: update = m_hat / (sqrt(v_hat) + eps)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def make_optimizer(params: dict, lr: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` over every leaf of ``params`` with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8). Marks each leaf as requiring
    grad."""
    leaves = list(param_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    return torch.optim.Adam(leaves, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def _as_ids(x, dev) -> Optional[torch.Tensor]:
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=dev, dtype=torch.int64)


def train_step(params: dict, optimizer: torch.optim.Optimizer, input_ids,
               attention_mask, labels, config, device="cuda") -> torch.Tensor:
    """One step: loss, its gradients, one optimizer update. The batch
    (``input_ids``, ``attention_mask`` or None, ``labels``; (B, S) numpy
    arrays or tensors) moves to ``device``, which must be where the params
    are: the card unless the caller asks for the CPU. Returns the loss
    before the update, a detached 0-d float32 tensor on the device (no
    host sync)."""
    dev = resolve_device(device)
    if params["embed"]["weight"].device.type != dev.type:
        raise ValueError(
            f"params are on {params['embed']['weight'].device}, the step on "
            f"{dev}: build them with params_from_jax(..., device={str(dev)!r})")
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, _as_ids(input_ids, dev), _as_ids(attention_mask, dev),
                   _as_ids(labels, dev), config)
    loss.backward()
    optimizer.step()
    return loss.detach()
