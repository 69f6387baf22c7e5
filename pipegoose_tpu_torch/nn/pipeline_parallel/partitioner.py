"""Pipeline stage partitioning.

The counterpart of ``pipegoose_tpu/nn/pipeline_parallel/partitioner.py``.
A partition is a contiguous LAYER RANGE; given per-layer costs (parameter
counts, or FLOPs), :func:`partition_costs` finds the contiguous split that
minimizes the bottleneck stage's cost (the exact interval DP).

How uneven stages run: the JAX package compiles one program for every
pipe rank, so it pads every stage to ``L_max = max_p n_p`` layer slots and
skips the pad slots at run time with ``lax.cond``. Here every rank runs
its own process, so a stage simply holds and loops over its own ``n_p``
blocks: :func:`repartition_blocks` hands each stage its list of blocks,
with no padded slot, and :func:`masked_stage_scan` loops over the first
``n_valid`` of them (which also reads the JAX package's padded layout, as
``models.weights.params_from_jax`` carries it over).
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence

import numpy as np

from pipegoose_tpu_torch.distributed.functional import axis_index, axis_size
from pipegoose_tpu_torch.nn.parallel import tree_leaves


def layer_param_counts(blocks: Any) -> np.ndarray:
    """Per-layer parameter counts: of the port's per-layer list of blocks
    (each layer's leaves counted), or of a stacked tree whose every leaf
    has a leading ``n_layer`` dim (the JAX layout)."""
    if isinstance(blocks, list):
        return np.asarray([sum(int(np.prod(x.shape)) for x in tree_leaves(b))
                           for b in blocks], dtype=np.int64)
    leaves = tree_leaves(blocks)
    n_layer = leaves[0].shape[0]
    per_layer = sum(int(np.prod(x.shape[1:])) for x in leaves)
    return np.full(n_layer, per_layer, dtype=np.int64)


def partition_costs(costs: Sequence[float], n_partitions: int) -> List[range]:
    """Contiguous ranges minimizing the largest per-partition cost (exact
    DP over the split points)."""
    costs = list(costs)
    L, P = len(costs), n_partitions
    if P < 1 or P > L:
        raise ValueError(f"need 1 <= n_partitions <= n_layers, got {P} of {L}")
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    # dp[p][i] = the smallest bottleneck of the first i layers in p parts
    dp = np.full((P + 1, L + 1), np.inf)
    cut = np.zeros((P + 1, L + 1), dtype=int)
    dp[0][0] = 0.0
    for p in range(1, P + 1):
        for i in range(p, L + 1):
            for j in range(p - 1, i):
                cand = max(dp[p - 1][j], prefix[i] - prefix[j])
                if cand < dp[p][i]:
                    dp[p][i] = cand
                    cut[p][i] = j
    bounds = [L]
    for p in range(P, 0, -1):
        bounds.append(cut[p][bounds[-1]])
    bounds.reverse()
    return [range(bounds[i], bounds[i + 1]) for i in range(P)]


def repartition_blocks(blocks: list, ranges: Sequence[range]):
    """The port's per-layer list of blocks -> ``(stages, counts)``:
    ``stages[p]`` the blocks of stage p (``ranges[p]``, the contiguous
    sorted output of :func:`partition_costs`, so the layer order is kept),
    ``counts[p]`` their number (pass ``counts`` as the pipeline loss's
    ``stage_layer_counts``). Stage p's rank keeps ``stages[p]`` as its
    ``params["blocks"]``."""
    counts = np.asarray([len(r) for r in ranges], dtype=np.int32)
    return [[blocks[i] for i in r] for r in ranges], counts


def stage_n_valid(stage_layer_counts, n_layer: int, axis_name: str = "pipe") -> int:
    """Check ``stage_layer_counts`` against the pipe axis (one entry per
    stage, summing to ``n_layer``; ValueError otherwise) and return THIS
    stage's count of layers."""
    P = axis_size(axis_name)
    counts = np.asarray(stage_layer_counts, np.int64)
    if len(counts) != P or counts.sum() != n_layer:
        raise ValueError(
            f"stage_layer_counts {tuple(int(c) for c in counts)} must have "
            f"{P} entries (pipe axis size) summing to n_layer={n_layer}")
    return int(counts[axis_index(axis_name)])


def stage_layers(n_layer: int, blocks: list, stage_layer_counts=None,
                 axis_name: str = "pipe"):
    """(n_valid, offset) of this stage: how many of its ``blocks`` are live
    layers and the global index of the first. Even stages (no counts) hold
    ``n_layer / P`` blocks each; uneven ones the first
    ``stage_layer_counts[stage]`` of theirs. ValueError otherwise."""
    stage = axis_index(axis_name)
    if stage_layer_counts is not None:
        n_valid = stage_n_valid(stage_layer_counts, n_layer, axis_name)
        if len(blocks) < n_valid:
            raise ValueError(f"this stage holds {len(blocks)} blocks, its "
                             f"stage_layer_counts entry is {n_valid}")
        return n_valid, int(sum(int(c) for c in stage_layer_counts[:stage]))
    P = axis_size(axis_name)
    if n_layer % P or len(blocks) != n_layer // P:
        raise ValueError(
            f"this stage holds {len(blocks)} blocks; even stages hold "
            f"n_layer / P = {n_layer} / {P} (pass stage_layer_counts "
            f"for uneven stages, and each rank only its stage's blocks)")
    return len(blocks), stage * len(blocks)


def masked_stage_scan(block_fn: Callable, blocks_local: list, h: Any, n_valid: int):
    """``block_fn(blk, h) -> h`` over the first ``n_valid`` of this stage's
    blocks; any slot past them (a padded layout's) is never run."""
    for blk in blocks_local[:n_valid]:
        h = block_fn(blk, h)
    return h


class UniformPartitioner:
    """Split a model of ``n_layer`` layers into ``n_partitions``
    contiguous stages by cost."""

    def __init__(self, n_partitions: int):
        self.n_partitions = n_partitions

    def split(self, costs: Sequence[float]) -> List[range]:
        return partition_costs(costs, self.n_partitions)

    def split_even(self, n_layer: int) -> List[range]:
        if n_layer % self.n_partitions != 0:
            return self.split([1.0] * n_layer)
        k = n_layer // self.n_partitions
        return [range(i * k, (i + 1) * k) for i in range(self.n_partitions)]
