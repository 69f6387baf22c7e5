"""Auto-parallel train step over ``torch.distributed.tensor`` (DTensor).

The counterpart of ``pipegoose_tpu/parallel/auto.py``. The manual path
(``parallel/hybrid.py``) writes every collective of the tensor-parallel
loss by hand; for plain tensor x data parallelism the JAX package also
offers the GSPMD front end, where the model is SINGLE-DEVICE code
(``tp_axis=None``), the parameters and the batch carry shardings, and the
partitioner derives the collectives. Here DTensor plays the partitioner:
every parameter is a DTensor on a ``DeviceMesh`` built from the current
``ParallelContext`` (its spec's axes become ``Shard`` placements, the rest
``Replicate``), the batch is ``Shard(0)`` over "data", and each operator's
sharding propagation inserts the all-reduces and gathers. It doubles as an
oracle for the manual step: the tests hold both to the same trajectory.

The single-device code runs under ``implicit_replication``, so the
constants it builds as plain tensors (ALiBi slopes, causal masks) count as
replicated. The hand-written kernels take plain tensors, not DTensors: the
loss must run its plain paths (``use_flash`` and ``fused_ce`` off), as the
JAX auto step runs XLA's.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.distributed.parallel_mode import MESH_AXIS_ORDER
from pipegoose_tpu_torch.nn.parallel import shard_leaf, tree_leaves, tree_map


def device_mesh(ctx: ParallelContext):
    """The ``DeviceMesh`` of ``ctx``'s ranks over its axes of size > 1, in
    the context's rank layout (one "data" dim of size 1 on one rank)."""
    from torch.distributed.device_mesh import DeviceMesh

    names = [ax for ax in MESH_AXIS_ORDER if ctx.sizes[ax] > 1] or ["data"]
    ranks = torch.from_numpy(np.ascontiguousarray(ctx.layout)).reshape(
        [ctx.sizes[ax] for ax in names])
    return DeviceMesh(ctx.device, ranks, mesh_dim_names=tuple(names))


def placements(spec: tuple, mesh) -> list:
    """One placement per mesh dim: ``Shard(d)`` where ``spec`` names that
    axis at dimension d, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for ax in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if entry == ax
                or (isinstance(entry, (tuple, list)) and ax in entry)]
        if len(dims) > 1 or (dims and isinstance(spec[dims[0]], (tuple, list))):
            raise ValueError(f"spec {spec!r}: one axis a dimension, one dimension "
                             f"an axis")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _distribute(x, spec: tuple, mesh, ctx: ParallelContext):
    """This rank's shard of ``x`` (a tensor or a numpy array) as a DTensor:
    the port's ``shard_leaf`` cuts what ``Shard`` placements hold, so no
    data moves between ranks."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    local = shard_leaf(x.detach(), spec, ctx)
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=x.shape, stride=x.contiguous().stride())


def make_auto_train_step(loss_fn: Callable[[Any, Any], torch.Tensor], param_specs: Any,
                         optimizer: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                         parallel_context: Optional[ParallelContext] = None,
                         batch_spec: tuple = ("data",)):
    """(init_fn, step_fn) with the collectives derived by DTensor.

    ``loss_fn(params, batch) -> scalar`` is plain single-device model code
    (no axis names, e.g. ``bloom.loss_fn(..., tp_axis=None)`` on its plain
    paths); ``param_specs`` the spec tree of the parameters
    (``bloom.tp_specs``); ``optimizer`` a factory over a list of tensors
    (``optim.adam(lr)``). The optimizer's state follows each parameter's
    sharding (replicated over "data": ZeRO is the manual path's job).

    ``init_fn(params)`` takes the WHOLE tree on every rank and returns
    (DTensor params, optimizer). ``step_fn(params, opt, batch)`` takes the
    GLOBAL batch (a tensor or numpy array, the same on every rank), places
    it by ``batch_spec``, runs the loss and its backward and the
    optimizer's step, and returns (params, opt, the loss as a plain
    tensor). ``nn.parallel.tree_map(lambda p: p.full_tensor(), params)``
    gathers the parameters whole."""
    ctx = parallel_context or ParallelContext.get_context()
    if ctx is None:
        raise ValueError("no ParallelContext; construct one first")
    mesh = device_mesh(ctx)

    def init_fn(params):
        dparams = tree_map(lambda x, s: _distribute(x, s, mesh, ctx).requires_grad_(True),
                           params, param_specs)
        return dparams, optimizer(tree_leaves(dparams))

    def step_fn(params, opt, batch):
        from torch.distributed.tensor.experimental import implicit_replication

        device = tree_leaves(params)[0].device
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.ascontiguousarray(batch))
        batch = _distribute(batch.to(device), batch_spec, mesh, ctx)
        opt.zero_grad(set_to_none=True)
        with implicit_replication():
            loss = loss_fn(params, batch)
            loss.backward()
        opt.step()
        return params, opt, loss.detach().full_tensor()

    return init_fn, step_fn
