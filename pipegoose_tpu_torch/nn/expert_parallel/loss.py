"""MoE auxiliary-loss combination.

The counterpart of ``pipegoose_tpu/nn/expert_parallel/loss.py``: model
forwards RETURN their router losses (a tensor, or a tree of them) and
:class:`ExpertLoss` folds them into the task loss.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from pipegoose_tpu_torch.nn.parallel import tree_leaves


@dataclasses.dataclass(frozen=True)
class ExpertLoss:
    """``loss = task_loss + aux_weight * sum(aux) + z_weight * sum(z)``,
    each sum over every element of every leaf of a tree of dicts and lists
    (layers, ranks' tensors)."""

    aux_loss_weight: float = 0.01
    z_loss_weight: float = 0.001

    def __call__(self, task_loss: torch.Tensor, aux_losses: Any,
                 z_losses: Any) -> torch.Tensor:
        aux = sum(torch.as_tensor(a).sum() for a in tree_leaves(aux_losses))
        z = sum(torch.as_tensor(a).sum() for a in tree_leaves(z_losses))
        return task_loss + self.aux_loss_weight * aux + self.z_loss_weight * z
