"""TensorParallel: shard a parameter tree along the tensor axis.

The counterpart of ``pipegoose_tpu/nn/tensor_parallel/tensor_parallel.py``:
``parallelize`` maps the tree through the policy table to specs and keeps
this rank's slice of every leaf; ``pad_vocab`` pads an embedding so that
its vocabulary divides the axis.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.nn.parallel import Parallel, shard_tree, spec_tree
from pipegoose_tpu_torch.nn.parallel_mapping import ParallelMapping


class TensorParallel(Parallel):
    def __init__(self, mapping: ParallelMapping,
                 parallel_context: Optional[ParallelContext] = None):
        super().__init__(parallel_context)
        self.mapping = mapping

    def specs(self, params: Any) -> Any:
        """The spec tree of ``params`` (first policy match wins; unmatched
        leaves replicate; biases by ``ParallelMapping.spec_for``)."""
        return spec_tree(params, lambda path, x: self.mapping.spec_for(path, x.ndim))

    def parallelize(self, params: Any):
        specs = self.specs(params)
        return shard_tree(params, specs, self.parallel_context), specs


def pad_vocab(weight, multiple: int):
    """Pad an embedding's rows with zeros so that its vocabulary divides
    ``multiple`` (a tensor or a numpy array). With a tied head every padded
    slot gets logit 0: pass the true vocabulary as ``valid_size`` to the
    cross entropy, or mask it before a pick."""
    vocab = weight.shape[0]
    rem = (-vocab) % multiple
    if rem == 0:
        return weight
    if isinstance(weight, torch.Tensor):
        return torch.nn.functional.pad(weight, (0, 0) * (weight.dim() - 1) + (0, rem))
    return np.pad(weight, ((0, rem),) + ((0, 0),) * (weight.ndim - 1))
