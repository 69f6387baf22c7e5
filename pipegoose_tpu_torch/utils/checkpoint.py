"""Sharded, layout-free, crash-atomic checkpointing.

The counterpart of ``pipegoose_tpu/utils/checkpoint.py``, on
``torch.distributed.checkpoint`` (DCP) where the JAX module writes orbax.
Every rank writes the part of each tensor it holds, once: a parameter's
tensor-parallel shard, a ZeRO-1 optimizer state's rows. The files record
each part by its offset in the whole tensor, not by the layout that wrote
it, so a restore RESHARDS onto whatever tensor x data layout the current
run uses (a TP2 x DP2 save restores at tp = 1, dp = 4, or on one rank).

A part is handed to DCP as a ``DTensor`` over a ``DeviceMesh`` of the
context's axes, "tensor" first: a spec entry that names the tensor axis
and then the data axis on one dimension (the row-parallel kernels and the
vocab-sharded embedding under ZeRO-1) is DTensor's nested ``Shard(d),
Shard(d)``. A ZeRO-1 shard is ``ceil(d0 / dp)`` rows of dim 0 of the
rank's tensor shard, padded to that size (``optim.zero._pad_to``); without
its padding that is ``torch.chunk``'s layout, which is what a DTensor
``Shard`` means, so the rows go to DCP as they are and no collective runs
to save or restore them.

Crash-atomicity contract (the recovery callbacks depend on it):

- every save writes to a ``<final>.tmp`` SIBLING; after every rank has
  written (a barrier), rank 0 ``os.rename``s it to the final name, and a
  second barrier holds every rank until the rename is done. A kill at any
  point leaves either the previous state or a ``.tmp`` directory, never a
  torn directory under a valid ``step_N`` name;
- transient I/O errors (``OSError``) are retried with exponential backoff
  up to ``retries`` times before surfacing;
- :func:`latest_step` / :func:`available_steps` list only COMPLETE
  checkpoints: ``.tmp`` siblings and empty directories are skipped. Rank
  0 lists and broadcasts its listing, so every rank restores the same step;
- a save onto an existing checkpoint raises.

Fault injection: :func:`set_io_fault_hook` installs a callable invoked at
the start of every save ATTEMPT; raising ``OSError`` from it simulates a
transient storage failure and exercises the retry path.

A ZeRO-1 ``ZeroState`` with error feedback saves its residuals
(``ZeroState.ef``) with the rest, each rank's own, and restores them bit
for bit at the same layout; a restore at another data-parallel size, or of
a checkpoint whose residuals the restoring state lacks (or the reverse),
raises a ValueError that names ``ef``, instead of dropping them.

Pipeline stages: where a spec marks the blocks with the "pipe" axis
(``bloom.pp_specs``), each stage's per-layer blocks are saved under their
GLOBAL layer index (the stage's offset is the sum of the earlier stages'
counts), with the pipe axis taken off their specs; so a checkpoint holds
the whole model once and restores onto another pipeline split.

Where this parts from the JAX module: the format is DCP's, not orbax's
(ROADMAP.md § C), and a ZeRO-1 ``ZeroState`` restores in place
(``inplace=True``): into the live parameters and into the live inner
optimizer, whose state is keyed by those very tensors.
"""
from __future__ import annotations

import os
import pickle
import shutil
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.distributed.parallel_mode import MESH_AXIS_ORDER
from pipegoose_tpu_torch.nn.parallel import path_str, tree_leaves, tree_map_with_path
from pipegoose_tpu_torch.optim.zero import ZeroState, ef_param_spec, zero_param_spec

PIPE = "pipe"

#: suffix of the in-progress sibling a save writes before the atomic
#: rename; anything carrying it is by definition incomplete
TMP_SUFFIX = ".tmp"

# test seam: called at the start of every save attempt; raising OSError
# simulates a transient storage failure
_IO_FAULT_HOOK: Optional[Callable[[], None]] = None


def set_io_fault_hook(
    hook: Optional[Callable[[], None]]
) -> Optional[Callable[[], None]]:
    """Install (or clear, with None) the save-attempt fault hook; returns
    the previous hook so tests can restore it."""
    global _IO_FAULT_HOOK
    prev, _IO_FAULT_HOOK = _IO_FAULT_HOOK, hook
    return prev


# -- ranks and layouts ---------------------------------------------------------------


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _distributed() else 0


def _barrier() -> None:
    if _distributed() and dist.get_world_size() > 1:
        dist.barrier()


def _context(parallel_context: Optional[ParallelContext]) -> Optional[ParallelContext]:
    ctx = parallel_context or ParallelContext.get_context()
    return ctx if ctx is not None and _distributed() else None


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _mentions_pipe(spec) -> bool:
    return any(PIPE in _axes(e) for e in (spec or ()))


def _drop_pipe(spec: tuple) -> tuple:
    def entry(e):
        rest = tuple(a for a in _axes(e) if a != PIPE)
        return None if not rest else (rest[0] if len(rest) == 1 else rest)
    return tuple(entry(e) for e in spec)


def _global_blocks(tree: Any, specs: Any, ctx: Optional[ParallelContext]):
    """(tree, specs) with a pipeline stage's blocks keyed by their global
    layer index and the pipe axis dropped from their specs, where the specs
    mark the blocks with it; else as they are. Every rank of the context
    calls it (an all-gather of the stages' block counts)."""
    if (specs is None or not isinstance(tree, dict)
            or not isinstance(tree.get("blocks"), list)
            or not any(_mentions_pipe(sp) for sp in tree_leaves(specs["blocks"]))):
        return tree, specs
    from pipegoose_tpu_torch.distributed.functional import all_gather, axis_index

    blocks = tree["blocks"]
    device = "cuda" if ctx is not None and ctx.device == "cuda" else "cpu"
    counts = all_gather(torch.tensor([len(blocks)], device=device), PIPE, dim=0)
    offset = int(counts[:axis_index(PIPE)].sum())
    tree, specs = dict(tree), dict(specs)
    tree["blocks"] = {str(offset + i): b for i, b in enumerate(blocks)}
    specs["blocks"] = {str(offset + i): tree_map_with_path(lambda _p, sp: _drop_pipe(sp), b)
                       for i, b in enumerate(specs["blocks"])}
    return tree, specs


def _local_blocks(tree: Any, like: Any) -> Any:
    """A tree that :func:`_global_blocks` re-keyed, its blocks a list again."""
    if isinstance(like, dict) and isinstance(like.get("blocks"), list) \
            and isinstance(tree.get("blocks"), dict):
        tree = dict(tree)
        tree["blocks"] = list(tree["blocks"].values())
    return tree


class _Layout:
    """The DeviceMesh of a context's axes, "tensor" first and then every
    other axis of more than one rank in the context's order: an entry that
    shards one dimension over the tensor axis and then another (a ZeRO
    shard of a row-parallel kernel) nests in mesh order."""

    def __init__(self, ctx: ParallelContext):
        from torch.distributed.device_mesh import DeviceMesh

        self.ctx = ctx
        self.axes = ["tensor"] + [a for a in MESH_AXIS_ORDER
                                  if a != "tensor" and ctx.sizes[a] > 1]
        order = [MESH_AXIS_ORDER.index(a) for a in self.axes]
        rest = [i for i in range(len(MESH_AXIS_ORDER)) if i not in order]
        ranks = np.transpose(ctx.layout, order + rest).reshape(
            [ctx.sizes[a] for a in self.axes])
        device = "cuda" if ctx.device == "cuda" else "cpu"
        # no process group of its own: DCP talks over the default group,
        # and a DTensor needs the mesh only to place this rank's part
        self.mesh = DeviceMesh(device, torch.from_numpy(np.ascontiguousarray(ranks)),
                               mesh_dim_names=tuple(self.axes), _init_backend=False)

    def placements(self, spec: tuple) -> list:
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(self.axes)
        for dim, entry in enumerate(spec):
            idx = [self.axes.index(a) for a in _axes(entry) if a in self.axes]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry!r} nests its axes against the "
                                 f"checkpoint mesh's order {self.axes}")
            for i in idx:
                out[i] = Shard(dim)
        return out

    def global_shape(self, local_shape, spec: tuple) -> tuple:
        shape = list(local_shape)
        for dim, entry in enumerate(spec):
            for ax in _axes(entry):
                shape[dim] *= self.ctx.axis_size(ax)
        return tuple(shape)

    def dtensor(self, local: torch.Tensor, spec: tuple, global_shape: tuple):
        from torch.distributed.tensor import DTensor

        stride = [1] * len(global_shape)
        for d in range(len(global_shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * global_shape[d + 1]
        return DTensor.from_local(local.detach(), self.mesh, self.placements(spec),
                                  run_check=False, shape=torch.Size(global_shape),
                                  stride=tuple(stride))


def _as_saved(x: torch.Tensor, spec, layout: Optional[_Layout]):
    """A tensor leaf as DCP takes it: a DTensor of its spec under a layout,
    the leaf itself (a replicated tensor) without one."""
    if layout is None:
        return x.detach()
    spec = tuple(spec) if spec is not None else ()
    return layout.dtensor(x, spec, layout.global_shape(x.shape, spec))


def _leaf_entries(tree: Any, specs: Any, layout: Optional[_Layout], prefix: str):
    """(key, tensor as DCP takes it) for every leaf of a tree of tensors."""
    out = []

    def visit(path, x, spec=None):
        out.append((prefix + path_str(path), _as_saved(x, spec, layout)))
        return x

    tree_map_with_path(visit, tree, *(() if specs is None else (specs,)))
    return out


def _zero_rows(d0: int, axis: Optional[str], ctx: Optional[ParallelContext]):
    """The rows [lo, hi) of a leaf's dim 0 that this rank's ZeRO shard
    holds, its padding cut off."""
    if axis is None or ctx is None or ctx.axis_size(axis) == 1:
        return 0, d0
    n = ctx.axis_size(axis)
    chunk = -(-d0 // n)
    lo = min(ctx.coords[MESH_AXIS_ORDER.index(axis)] * chunk, d0)
    return lo, min(lo + chunk, d0)


def _zero_layouts(state: ZeroState, params: Any, specs: Any, layout: Optional[_Layout]):
    """Per parameter leaf: (key, the tensor the inner optimizer updates,
    the rows [lo, hi) of the rank's parameter shard it holds (its first hi
    - lo rows; the rest is padding), its spec in the checkpoint, its global
    shape)."""
    ctx = layout.ctx if layout is not None else None
    out = []

    def visit(path, p, spec=None):
        spec = tuple(spec) if spec is not None else ()
        pshape = tuple(p.shape) if p.dim() else (1,)
        gshape = layout.global_shape(pshape, spec) if layout is not None else pshape
        if state.axis_name is not None:
            spec = zero_param_spec(spec, p.dim(), state.axis_name)
        lo, hi = _zero_rows(pshape[0], state.axis_name, ctx)
        out.append((path_str(path), p, lo, hi, spec, gshape))
        return p

    tree_map_with_path(visit, params, *(() if specs is None else (specs,)))
    shards = state.shards if state.shards is not None else [p for _, p, *_ in out]
    return [(key, sh, lo, hi, spec, gshape)
            for (key, _, lo, hi, spec, gshape), sh in zip(out, shards)]


def _zero_entries(state: ZeroState, params: Any, specs: Any, layout: Optional[_Layout],
                  prefix: str):
    """(key, value) of every entry of the inner optimizer's per-parameter
    state: a tensor shaped like its shard (Adam's moments) as the rows this
    rank holds, any other (Adam's step count, the same on every rank) as it
    is."""
    out = []
    for key, sh, lo, hi, spec, gshape in _zero_layouts(state, params, specs, layout):
        for name, v in state.inner.state.get(sh, {}).items():
            k = f"{prefix}{key}/{name}"
            if isinstance(v, torch.Tensor) and v.shape == sh.shape:
                rows = (v if v.dim() else v[None]).narrow(0, 0, hi - lo)
                out.append((k, rows.detach() if layout is None
                            else layout.dtensor(rows, spec, gshape)))
            else:
                out.append((k, v.detach()))
    return out


def _ef_layouts(state: ZeroState, params: Any, specs: Any, layout: Optional[_Layout]):
    """Per parameter leaf with a residual: (key, the residual, its spec in
    the checkpoint, its global shape)."""
    ef = iter(state.ef)
    out = []

    def visit(path, p, spec=None):
        e = next(ef)
        spec = ef_param_spec(tuple(spec) if spec is not None else (), p.dim(),
                             state.axis_name)
        gshape = (layout.global_shape(e.shape, spec) if layout is not None
                  else tuple(e.shape))
        out.append((path_str(path), e, spec, gshape))
        return p

    tree_map_with_path(visit, params, *(() if specs is None else (specs,)))
    return out


def _ef_entries(state: ZeroState, params: Any, specs: Any, layout: Optional[_Layout],
                prefix: str):
    """(key, residual as DCP takes it) of every error-feedback residual."""
    return [(f"{prefix}{key}", e.detach() if layout is None
             else layout.dtensor(e, spec, gshape))
            for key, e, spec, gshape in _ef_layouts(state, params, specs, layout)]


def _ef_targets(state: ZeroState, params: Any, specs: Any, layout: Optional[_Layout],
                prefix: str, metadata) -> dict:
    """Load targets for the residuals, in place; a checkpoint whose
    residuals were saved at another data-parallel size (another global
    shape), or that holds none where the state has them, or the reverse,
    raises ValueError: a residual is never dropped."""
    saved = metadata.state_dict_metadata
    has = sorted(k for k in saved if k.startswith(prefix))
    if state.ef is None:
        if has:
            raise ValueError(f"the checkpoint holds error-feedback residuals (ef, "
                             f"{len(has)} leaves) and the restoring ZeroState has "
                             f"none: build its optimizer with error_feedback=True")
        return {}
    targets = {}
    for key, e, spec, gshape in _ef_layouts(state, params, specs, layout):
        k = prefix + key
        if k not in saved:
            raise ValueError(f"ZeroState.ef: the checkpoint holds no residual {k!r} "
                             f"(saved without error feedback)")
        if tuple(saved[k].size) != tuple(gshape):
            raise ValueError(
                f"ZeroState.ef: residual {k!r} was saved with global shape "
                f"{tuple(saved[k].size)}, this layout's is {tuple(gshape)}: each "
                f"data rank's residual is its own, so ef restores only at the "
                f"data-parallel size that saved it")
        targets[k] = e if layout is None else layout.dtensor(e, spec, gshape)
    return targets


# -- writes ----------------------------------------------------------------------------


def _commit(entries: list, path: str, retries: int, backoff_s: float) -> str:
    """Write ``entries`` as one DCP checkpoint at ``path``, crash-atomic."""
    import torch.distributed.checkpoint as dcp

    if os.path.exists(path):
        # before the tmp write, so a doomed save burns no I/O and the
        # rename can never clobber a checkpoint
        raise ValueError(f"checkpoint already exists: {path}")
    state_dict = dict(entries)
    tmp = path + TMP_SUFFIX
    for attempt in range(retries + 1):
        try:
            if _IO_FAULT_HOOK is not None:
                _IO_FAULT_HOOK()
            if _rank() == 0 and os.path.isdir(tmp):
                shutil.rmtree(tmp)   # a stale sibling of a failed attempt
            _barrier()
            dcp.save(state_dict, checkpoint_id=tmp, no_dist=not _distributed())
            _barrier()   # every rank has written its part
            if _rank() == 0:
                os.rename(tmp, path)   # the commit point: atomic on one filesystem
            _barrier()   # no rank returns before the rename
            return path
        except OSError:
            if attempt >= retries:
                raise
            time.sleep(backoff_s * (2 ** attempt))
    raise AssertionError("unreachable")  # pragma: no cover


def save_pretrained(
    params: Any,
    path: str,
    step: Optional[int] = None,
    retries: int = 3,
    backoff_s: float = 0.05,
    specs: Any = None,
    parallel_context: Optional[ParallelContext] = None,
) -> str:
    """Write a tree of tensors (this rank's shards under ``specs``, the
    tree's spec tree; every leaf whole without it) as one checkpoint;
    ``step`` creates a numbered subdirectory. Every rank of the context
    calls it. Crash-atomic, transient ``OSError``s retried with exponential
    backoff (``retries`` attempts beyond the first)."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    ctx = _context(parallel_context)
    layout = _Layout(ctx) if ctx is not None else None
    params, specs = _global_blocks(params, specs, ctx)
    return _commit(_leaf_entries(params, specs, layout, ""), path, retries, backoff_s)


def save_train_state(
    path: str, step: int, params: Any, opt_state: Any = None, extra: Any = None,
    specs: Any = None, parallel_context: Optional[ParallelContext] = None,
) -> str:
    """Checkpoint the full training state: the parameters (``specs``: their
    spec tree), the optimizer state (a ZeRO-1 ``ZeroState``, whose inner
    optimizer's state is written in the layout its shards give it, or any
    tree of tensors) and ``extra`` (any picklable object), under
    ``path/step_N``. Crash-atomic, as :func:`save_pretrained`."""
    ctx = _context(parallel_context)
    layout = _Layout(ctx) if ctx is not None else None
    params, specs = _global_blocks(params, specs, ctx)
    entries = _leaf_entries(params, specs, layout, "params/")
    if isinstance(opt_state, ZeroState):
        entries += _zero_entries(opt_state, params, specs, layout, "opt_state/")
        if opt_state.ef is not None:
            entries += _ef_entries(opt_state, params, specs, layout, "opt_state/ef/")
    elif opt_state is not None:
        entries += _leaf_entries(opt_state, None, None, "opt_state/")
    if extra is not None:
        entries.append(("extra", pickle.dumps(extra)))
    final = os.path.join(os.path.abspath(path), f"step_{step}")
    return _commit(entries, final, 3, 0.05)


# -- reads -----------------------------------------------------------------------------


def _targets(like: Any, specs: Any, layout: Optional[_Layout], prefix: str,
             inplace: bool):
    """(the tree to return, {key: load target}) of a tree of tensors: the
    tree's own tensors with ``inplace``, else fresh ones shaped like them."""
    targets = {}

    def visit(path, x, spec=None):
        t = x if inplace else torch.empty_like(x)
        targets[prefix + path_str(path)] = _as_saved(t, spec, layout)
        return t

    tree = tree_map_with_path(visit, like, *(() if specs is None else (specs,)))
    return tree, targets


def _zero_targets(state: ZeroState, params: Any, specs: Any, layout: Optional[_Layout],
                  prefix: str, metadata) -> tuple:
    """Load targets for a ZeRO state's inner optimizer, from the saved
    entries: a tensor saved at the parameter's global shape (a moment)
    into zeros shaped like this rank's shard, through the rows it holds;
    any other tensor into one of the saved shape and dtype. Returns the
    targets and the per-parameter state dicts they fill."""
    targets, states = {}, []
    saved = metadata.state_dict_metadata
    for key, sh, lo, hi, spec, gshape in _zero_layouts(state, params, specs, layout):
        base = f"{prefix}{key}/"
        st = {}
        for k in (k for k in saved if k.startswith(base) and "/" not in k[len(base):]):
            meta, name = saved[k], k[len(base):]
            if tuple(meta.size) == tuple(gshape):
                full = torch.zeros(sh.shape, dtype=meta.properties.dtype, device=sh.device)
                rows = (full if full.dim() else full[None]).narrow(0, 0, hi - lo)
                targets[k] = rows if layout is None else layout.dtensor(rows, spec, gshape)
                st[name] = full
            else:
                t = torch.empty(tuple(meta.size), dtype=meta.properties.dtype)
                targets[k] = t
                st[name] = t
        states.append(st)
    return targets, states


def _finish_zero(state: ZeroState, states: list) -> None:
    """Hand the loaded per-parameter states to the inner optimizer, keyed
    by its own tensors (its param groups are kept)."""
    inner = state.inner
    inner.load_state_dict({"state": {i: st for i, st in enumerate(states) if st},
                           "param_groups": inner.state_dict()["param_groups"]})


def from_pretrained(
    path: str,
    like: Any,
    specs: Any = None,
    parallel_context: Optional[ParallelContext] = None,
) -> Any:
    """Restore a :func:`save_pretrained` tree onto the CURRENT layout,
    resharding as needed, in new tensors. ``like``: a tree of tensors
    shaped as this rank's shards under ``specs`` (every leaf whole without
    it), whose dtypes and devices the result takes."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    ctx = _context(parallel_context)
    layout = _Layout(ctx) if ctx is not None else None
    keyed, specs = _global_blocks(like, specs, ctx)
    tree, targets = _targets(keyed, specs, layout, "", False)
    dcp.load(targets, checkpoint_id=path, no_dist=not _distributed())
    return _local_blocks(tree, like)


def _complete_step(path: str, name: str) -> Optional[int]:
    """``step_N`` -> N for a COMPLETE checkpoint directory, else None:
    the canonical name (no ``.tmp`` suffix), a parseable step number, a
    real directory, and non-empty."""
    if not name.startswith("step_") or name.endswith(TMP_SUFFIX):
        return None
    try:
        n = int(name.split("_", 1)[1])
    except ValueError:
        return None
    full = os.path.join(path, name)
    if not os.path.isdir(full):
        return None
    try:
        if not os.listdir(full):
            return None
    except OSError:
        return None
    return n


def _list_steps(path: str) -> List[int]:
    if not os.path.isdir(path):
        return []
    steps = [n for n in (_complete_step(path, name) for name in os.listdir(path))
             if n is not None]
    return sorted(steps, reverse=True)


def available_steps(path: str) -> List[int]:
    """Steps of every COMPLETE ``step_N`` checkpoint under ``path``, newest
    first. Under a process group of more than one rank, rank 0's listing,
    broadcast (every rank calls it): all ranks restore the same step."""
    path = os.path.abspath(path)
    if not (_distributed() and dist.get_world_size() > 1):
        return _list_steps(path)
    box = [_list_steps(path) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def latest_step(path: str) -> Optional[int]:
    """Largest COMPLETE ``step_N`` subdirectory, for resume."""
    steps = available_steps(path)
    return steps[0] if steps else None


def restore_train_state(
    path: str,
    step: Optional[int],
    like: Any,
    specs: Any = None,
    parallel_context: Optional[ParallelContext] = None,
    inplace: bool = False,
) -> Any:
    """Restore a :func:`save_train_state` checkpoint (the newest with
    ``step=None``) onto the current layout. ``like``: ``{"params": tree,
    "opt_state": ..., "extra": ...}`` (any subset but params), ``specs``
    the params' spec tree. A ``ZeroState`` restores only ``inplace``: its
    parameters in the live tensors and its inner optimizer's state through
    ``load_state_dict``, so the optimizer keeps updating the very tensors
    the step trains. Returns the restored dict."""
    import torch.distributed.checkpoint as dcp

    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no step_N checkpoints under {path}")
    full = os.path.join(os.path.abspath(path), f"step_{step}")
    zero = like.get("opt_state")
    if isinstance(zero, ZeroState) and not inplace:
        raise ValueError("a ZeroState restores in place: pass inplace=True")
    ctx = _context(parallel_context)
    layout = _Layout(ctx) if ctx is not None else None
    out = {}
    keyed, specs = _global_blocks(like["params"], specs, ctx)
    params, targets = _targets(keyed, specs, layout, "params/", inplace)
    out["params"] = _local_blocks(params, like["params"])
    states = None
    if isinstance(zero, ZeroState):
        metadata = dcp.FileSystemReader(full).read_metadata()
        zt, states = _zero_targets(zero, params, specs, layout, "opt_state/",
                                   metadata)
        targets.update(zt)
        targets.update(_ef_targets(zero, params, specs, layout, "opt_state/ef/",
                                   metadata))
        out["opt_state"] = zero
    elif zero is not None:
        out["opt_state"], ot = _targets(zero, None, None, "opt_state/", inplace)
        targets.update(ot)
    if "extra" in like:
        targets["extra"] = b""
    dcp.load(targets, checkpoint_id=full, no_dist=not _distributed())
    if states is not None:
        _finish_zero(zero, states)
    if "extra" in like:
        out["extra"] = pickle.loads(targets["extra"])
    return out
