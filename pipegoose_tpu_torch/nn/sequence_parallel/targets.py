"""Next-token targets on a sequence-sharded axis: the counterpart of
``pipegoose_tpu/nn/sequence_parallel/targets.py``. Each rank's last target
is the first label of the next rank's chunk, one ``shift_left`` away; the
last rank's trailing target gets weight 0."""
from __future__ import annotations

import torch

from pipegoose_tpu_torch.distributed.functional import axis_index, axis_size, shift_left


def sp_shifted_targets(labels: torch.Tensor, attention_mask: torch.Tensor,
                       sp_axis: str):
    """(labels, mask) of shape (B, S_local) -> (shifted_labels,
    shifted_weights), aligned to next-token prediction across the shards."""
    next_label, next_w = shift_left((labels[:, :1], attention_mask[:, :1]), sp_axis)
    shifted_labels = torch.cat([labels[:, 1:], next_label], dim=1)
    shifted_w = torch.cat([attention_mask[:, 1:], next_w], dim=1)
    if axis_index(sp_axis) == axis_size(sp_axis) - 1:
        shifted_w[:, -1] *= 0
    return shifted_labels, shifted_w
