"""Parallelization policy: param-path regexes to declarative roles.

The counterpart of ``pipegoose_tpu/nn/parallel_mapping.py``. A policy maps
'/'-joined parameter paths to roles, and a role to a spec: a tuple with one
entry per dimension, each an axis name, a tuple of axis names, or None (the
JAX ``PartitionSpec``; the port's convention, ``parallel/hybrid.py``).
Kernels are laid out ``(in_features, out_features)``, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ParallelInfo:
    """Role of one parameter tensor and its spec."""

    role: str   # "column" | "row" | "vocab" | "replicate" | "expert" | custom
    spec: tuple


def Column(axis: str = "tensor") -> ParallelInfo:
    """Shard the OUT dim of an (in, out) kernel."""
    return ParallelInfo("column", (None, axis))


def Row(axis: str = "tensor") -> ParallelInfo:
    """Shard the IN dim of an (in, out) kernel."""
    return ParallelInfo("row", (axis, None))


def Vocab(axis: str = "tensor") -> ParallelInfo:
    """Shard the vocabulary (dim 0) of an embedding table."""
    return ParallelInfo("vocab", (axis, None))


def Replicate() -> ParallelInfo:
    return ParallelInfo("replicate", ())


def Expert(axis: str = "expert") -> ParallelInfo:
    """Shard the leading num_experts dim over the expert axis."""
    return ParallelInfo("expert", (axis, None, None))


class ParallelMapping:
    """Ordered (pattern -> ParallelInfo) table; the first match wins and
    unmatched params replicate. Patterns are regexes searched in the
    '/'-joined parameter path."""

    def __init__(self, rules: Sequence[tuple]):
        self.rules = [(re.compile(pat), info) for pat, info in rules]

    def search(self, path: str) -> Optional[ParallelInfo]:
        for pat, info in self.rules:
            if pat.search(path):
                return info
        return None

    def spec_for(self, path: str, ndim: Optional[int] = None) -> tuple:
        """The spec of a parameter. With ``ndim``, a column layer shards its
        1-d bias (which lies on the OUT dim) and a row layer replicates its
        bias (added once, after the all-reduce)."""
        info = self.search(path)
        if info is None:
            return ()
        if ndim is None:
            return info.spec
        is_1d = ndim == 1
        if info.role == "column":
            return (info.spec[1],) if is_1d else info.spec
        if info.role == "row":
            return () if is_1d else info.spec
        if is_1d and len(info.spec) > 1:
            return tuple(info.spec[:1])
        return info.spec

    def _role(self, path: str) -> Optional[str]:
        info = self.search(path)
        return info.role if info else None

    def is_column_parallel(self, path: str) -> bool:
        return self._role(path) == "column"

    def is_row_parallel(self, path: str) -> bool:
        return self._role(path) == "row"

    def is_vocab_parallel(self, path: str) -> bool:
        return self._role(path) == "vocab"

    def is_expert(self, path: str) -> bool:
        return self._role(path) == "expert"
