"""ParallelContext: one ``torch.distributed`` process group per parallel
axis, and the axis queries.

The counterpart of ``pipegoose_tpu/distributed/parallel_context.py``. The
JAX context lays the devices out as one mesh; here each process is one
rank, and the context builds, for every axis of size > 1, the process
group of the ranks that share every other coordinate. The rank layout is
the JAX docstring's, within one DiLoCo worker block:

    r = pipe*(dp*sp*ep*tp) + data*(sp*ep*tp) + seq*(ep*tp) + expert*tp + tensor

(``arange(world).reshape(diloco, pp, dp, sp, ep, tp)`` over the axes of
``MESH_AXIS_ORDER``). The "diloco" axis is the outermost: its group is the
DiLoCo workers' ranks that share every other coordinate, and only the
outer loop's sync step communicates over it (``optim.diloco``). The
queries answer for THIS process's rank where the JAX ones take a
``jax.Device``.

The backend follows the device: NCCL for ``"cuda"`` (the default), one
card per rank (``cuda:LOCAL_RANK``), and gloo for ``"cpu"``, which is how
the CPU tests run several ranks in one machine (``testing.dist``). A
context on ``"cuda"`` never runs over gloo: it raises instead.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from pipegoose_tpu_torch.distributed.parallel_mode import MESH_AXIS_ORDER, ParallelMode

_GLOBAL_CONTEXT: Optional["ParallelContext"] = None
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def local_rank() -> int:
    """This process's card: ``LOCAL_RANK`` as torchrun sets it, else the
    global rank modulo the cards of the host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


@dataclasses.dataclass
class ParallelContext:
    """This rank's process groups and coordinates. The default process
    group must exist (``init_multihost``, or the caller's own
    ``torch.distributed.init_process_group``) with a world size equal to
    the product of the sizes. Constructing the context makes it the
    current one (``get_context``), which the collectives of
    ``functional`` resolve their ``axis_name`` through."""

    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    data_parallel_size: int = 1
    expert_parallel_size: int = 1
    sequence_parallel_size: int = 1
    diloco_parallel_size: int = 1
    device: str = "cuda"

    def __post_init__(self) -> None:
        sizes = {"tensor": self.tensor_parallel_size,
                 "pipe": self.pipeline_parallel_size,
                 "data": self.data_parallel_size,
                 "expert": self.expert_parallel_size,
                 "seq": self.sequence_parallel_size,
                 "diloco": self.diloco_parallel_size}
        for name, size in sizes.items():
            if size < 1:
                raise ValueError(f"{name} parallel size must be >= 1, got {size}")
        if self.device not in BACKENDS:
            raise ValueError(f"device must be 'cuda' or 'cpu', got {self.device!r}")
        if not dist.is_initialized():
            raise RuntimeError(
                "no default process group: call ParallelContext.init_multihost "
                "or torch.distributed.init_process_group first")
        self.backend = BACKENDS[self.device]
        if dist.get_backend() != self.backend:
            raise RuntimeError(
                f"device={self.device!r} needs the {self.backend} backend, the "
                f"default process group runs {dist.get_backend()}")
        shape = tuple(sizes[ax] for ax in MESH_AXIS_ORDER)
        world, want = dist.get_world_size(), int(np.prod(shape))
        if world != want:
            raise ValueError(
                f"world size {world} is not diloco*pp*dp*sp*ep*tp = "
                f"{sizes['diloco']}*{sizes['pipe']}*{sizes['data']}*"
                f"{sizes['seq']}*{sizes['expert']}*{sizes['tensor']} = {want}")
        self.sizes = sizes
        self.layout = np.arange(want).reshape(shape)   # layout[coords] = rank
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in np.argwhere(self.layout == self.rank)[0])
        if self.device == "cuda":
            torch.cuda.set_device(local_rank())
        # every rank creates every group, in the same order, as new_group
        # requires; an axis of size 1 gets none (its collectives are no-ops)
        self._groups = {}
        for i, axis in enumerate(MESH_AXIS_ORDER):
            if sizes[axis] == 1:
                continue
            lines = np.moveaxis(self.layout, i, -1).reshape(-1, sizes[axis])
            for line in lines:
                group = dist.new_group(line.tolist(), backend=self.backend)
                if self.rank in line:
                    self._groups[axis] = group
        self._owns_world = False
        _set_context(self)

    # -- constructors -------------------------------------------------------

    @classmethod
    def init_multihost(cls, init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       store: Optional[dist.Store] = None,
                       device: str = "cuda", **sizes) -> "ParallelContext":
        """Bring up the default process group (NCCL on ``"cuda"``, gloo on
        ``"cpu"``) unless it exists, then build the context over it. With
        no arguments ``init_process_group`` reads torchrun's environment
        (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``);
        otherwise pass ``init_method`` (such as ``tcp://localhost:<port>``)
        or a ``store``, with ``world_size`` and ``rank``. The context's
        ``destroy`` then tears the default group down too."""
        if device not in BACKENDS:
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' needs a CUDA card and none is available")
        owns = not dist.is_initialized()
        if owns:
            kw = {k: v for k, v in dict(init_method=init_method,
                                        world_size=world_size, rank=rank,
                                        store=store).items() if v is not None}
            dist.init_process_group(BACKENDS[device], **kw)
        try:
            ctx = cls(device=device, **sizes)
        except BaseException:
            if owns:
                dist.destroy_process_group()
            raise
        ctx._owns_world = owns
        return ctx

    @classmethod
    def get_context(cls) -> Optional["ParallelContext"]:
        """The current context, or None."""
        return _GLOBAL_CONTEXT

    # -- axis queries -------------------------------------------------------

    def get_world_size(self, mode: ParallelMode = ParallelMode.GLOBAL) -> int:
        if mode == ParallelMode.GLOBAL:
            return int(self.layout.size)
        return self.sizes[mode.axis_name]

    def axis_size(self, axis: str) -> int:
        return self.get_world_size(ParallelMode(axis))

    def get_local_rank(self, mode: ParallelMode) -> int:
        """This rank's coordinate along the mode's axis (its global rank
        for GLOBAL)."""
        if mode == ParallelMode.GLOBAL:
            return self.rank
        return self.coords[MESH_AXIS_ORDER.index(mode.axis_name)]

    def get_global_rank(self) -> int:
        return self.rank

    def get_ranks_in_group(self, mode: ParallelMode) -> List[int]:
        """Global ranks sharing every coordinate with this rank except the
        mode's axis, in the order of that axis."""
        if mode == ParallelMode.GLOBAL:
            return list(range(self.get_world_size()))
        coords = list(self.coords)
        coords[MESH_AXIS_ORDER.index(mode.axis_name)] = slice(None)
        return [int(r) for r in self.layout[tuple(coords)]]

    def is_first_rank(self, mode: ParallelMode) -> bool:
        return self.get_local_rank(mode) == 0

    def is_last_rank(self, mode: ParallelMode) -> bool:
        return self.get_local_rank(mode) == self.get_world_size(mode) - 1

    def group(self, axis: str):
        """The process group of this rank along ``axis`` ("global" is the
        whole world); None for an axis of size 1."""
        if axis == ParallelMode.GLOBAL.value:
            return dist.group.WORLD
        if axis not in self.sizes:
            raise ValueError(f"unknown axis {axis!r}; axes are {MESH_AXIS_ORDER}")
        return self._groups.get(axis)

    # -- lifecycle ----------------------------------------------------------

    def destroy(self) -> None:
        """Destroy this context's process groups (and the default group if
        ``init_multihost`` created it) and clear the current context."""
        global _GLOBAL_CONTEXT
        for group in self._groups.values():
            dist.destroy_process_group(group)
        self._groups = {}
        if self._owns_world and dist.is_initialized():
            dist.destroy_process_group()
        if _GLOBAL_CONTEXT is self:
            _GLOBAL_CONTEXT = None


def _set_context(ctx: ParallelContext) -> None:
    global _GLOBAL_CONTEXT
    _GLOBAL_CONTEXT = ctx
