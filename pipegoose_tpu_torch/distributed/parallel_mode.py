"""Parallel axis names: the counterpart of
``pipegoose_tpu/distributed/parallel_mode.py``, with the same names and
axis strings. On the card each axis names a ``torch.distributed`` process
group of ``parallel_context.ParallelContext``; GLOBAL is the whole world.
"""
from __future__ import annotations

import enum


class ParallelMode(str, enum.Enum):
    GLOBAL = "global"
    TENSOR = "tensor"
    PIPELINE = "pipe"
    DATA = "data"
    EXPERT = "expert"
    DILOCO = "diloco"
    SEQUENCE = "seq"

    @property
    def axis_name(self) -> str:
        return self.value


# Axis order, outermost first: the rank layout of ParallelContext. ``pipe``
# is outermost and ``tensor`` innermost, so a tensor group is a block of
# consecutive ranks (on one host, over NVLink) and a pipeline group is
# strided by world // pp.
MESH_AXIS_ORDER = ("diloco", "pipe", "data", "seq", "expert", "tensor")
