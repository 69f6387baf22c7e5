"""The BLOOM training steps: forward, backward, one Adam update.
``train_step`` is the counterpart of the loop body of ``bench.py``'s
measured step (``jax.value_and_grad(bloom.loss_fn)`` then ``optax.adam``);
``sp_train_step`` that of the hybrid step at sequence parallelism only.

The params are the port's tree (``models.weights.params_from_jax``);
Adam updates its leaves in place, so a ``ServingEngine`` built on the
same tree serves the trained values with no copy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pipegoose_tpu_torch._device import resolve_device
from pipegoose_tpu_torch.distributed.functional import axis_index, axis_size
from pipegoose_tpu_torch.models.bloom import loss_fn, loss_fn_sp
from pipegoose_tpu_torch.models.weights import param_leaves
from pipegoose_tpu_torch.optim.zero import ADAM_BETAS, ADAM_EPS
from pipegoose_tpu_torch.parallel.hybrid import sync_replicated_grads


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


def _step_device(params: dict, device) -> torch.device:
    """The step's device (``resolve_device``), which must be the params'."""
    dev = resolve_device(device)
    if params["embed"]["weight"].device.type != dev.type:
        raise ValueError(
            f"params are on {params['embed']['weight'].device}, the step on "
            f"{dev}: build them with params_from_jax(..., device={str(dev)!r})")
    return dev


def train_step(params: dict, optimizer: torch.optim.Optimizer, input_ids,
               attention_mask, labels, config, device="cuda") -> torch.Tensor:
    """One step: loss, its gradients, one optimizer update. The batch
    (``input_ids``, ``attention_mask`` or None, ``labels``; (B, S) numpy
    arrays or tensors) moves to ``device``, which must be where the params
    are: the card unless the caller asks for the CPU. Returns the loss
    before the update, a detached 0-d float32 tensor on the device (no
    host sync)."""
    dev = _step_device(params, device)
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, _as_ids(input_ids, dev), _as_ids(attention_mask, dev),
                   _as_ids(labels, dev), config)
    loss.backward()
    optimizer.step()
    return loss.detach()


def sp_train_step(params: dict, optimizer: torch.optim.Optimizer, input_ids,
                  attention_mask, labels, config, sp_axis: str = "seq",
                  variant: str = "ring", device="cuda") -> torch.Tensor:
    """One sequence-parallel step on this rank: the body of the JAX
    ``make_hybrid_train_step`` at dp = tp = 1 with
    ``grad_sync_axes=(("seq", "sum"),)``.

    ``input_ids``, ``attention_mask`` (or None) and ``labels`` are the full
    (B, S) batch, the same on every rank (numpy arrays or tensors); the step
    takes this rank's chunk of S along ``sp_axis`` (S must divide by the
    axis size), runs ``loss_fn_sp`` and its backward, sums every gradient
    over the axis (every parameter is replicated over it) and takes one
    optimizer step. A ``ParallelContext`` with the axis must be current.
    Returns the global loss before the update, detached, on the device."""
    dev = _step_device(params, device)
    sp, rank = axis_size(sp_axis), axis_index(sp_axis)
    s = np.shape(input_ids)[1]
    if s % sp:
        raise ValueError(f"sequence length {s} does not divide by the "
                         f"{sp_axis!r} axis size {sp}")

    def chunk(x):
        x = _as_ids(x, dev)
        return None if x is None else x[:, rank * (s // sp):(rank + 1) * (s // sp)]

    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn_sp(params, chunk(input_ids), chunk(attention_mask),
                      chunk(labels), config, sp_axis=sp_axis, variant=variant)
    loss.backward()
    leaves = list(param_leaves(params))
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
    for t, g in zip(leaves, sync_replicated_grads(grads, None, ((sp_axis, "sum"),))):
        t.grad = g
    optimizer.step()
    return loss.detach()
