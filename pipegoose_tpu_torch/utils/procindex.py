"""Shared, lazily cached "is this the emitting process?" check.

The counterpart of ``pipegoose_tpu/utils/procindex.py``. Used by
``trainer.logger.DistributedLogger`` (rank-filtered logging), so the
caching lives in one place.

The rank is ``torch.distributed.get_rank()`` once a default process group
is up, and 0 before. Caching the first rank read from a process group is
safe: a process keeps its rank for the group's life, as a JAX process keeps
``jax.process_index()``. Before a group is up nothing is cached, so a
filter built early still sees the rank the group gives later; and
constructing a filter touches no process group.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist


class RankFilter:
    __slots__ = ("rank", "_idx")

    def __init__(self, rank: Optional[int]):
        """``rank``: only this process's rank passes; None = all do."""
        self.rank = rank
        self._idx: Optional[int] = None

    def __call__(self) -> bool:
        if self.rank is None:
            return True
        if self._idx is None:
            if not (dist.is_available() and dist.is_initialized()):
                return self.rank == 0
            self._idx = dist.get_rank()
        return self._idx == self.rank
