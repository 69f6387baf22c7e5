"""Trainer: the end-user training loop.

The counterpart of ``pipegoose_tpu/trainer/trainer.py``. One object wires
together the hybrid tensor x data parallel step with its ZeRO-1 optimizer
(``parallel.hybrid``), callbacks, logging, evaluation, and checkpoint and
resume. Every rank of the context runs its own Trainer over the same
global batches, as it runs the step.

The fit loop opens the ``train.data`` span around each batch pull and the
``train.step`` span around each step, as the JAX loop does: no-ops while
the telemetry registry is disabled (``telemetry.TelemetryCallback``
enables it). Where this parts from the JAX Trainer (ROADMAP.md § C):
``rng`` is an integer seed, and step i gets
``core.accumulation.fold_in(rng, i)``. Not ported yet (ROADMAP.md queue A,
item A13b): ``doctor``, ``profile`` and ``with_health``; they raise.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from pipegoose_tpu_torch.core.accumulation import _map_batch, fold_in
from pipegoose_tpu_torch.distributed.functional import all_reduce
from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.nn.parallel import shard_tree, tree_leaves, tree_map
from pipegoose_tpu_torch.optim.zero import DistributedOptimizer
from pipegoose_tpu_torch.telemetry.spans import span
from pipegoose_tpu_torch.trainer.callback import Callback
from pipegoose_tpu_torch.trainer.logger import DistributedLogger
from pipegoose_tpu_torch.trainer.state import TrainerState, TrainerStatus

_A13B = "is not ported yet (ROADMAP.md queue A, item 13, its half A13b)"


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


class Trainer:
    def __init__(
        self,
        loss_fn: Callable[..., torch.Tensor],
        params: Any,
        param_specs: Any,
        optimizer: DistributedOptimizer,
        parallel_context: Optional[ParallelContext] = None,
        batch_spec: Any = ("data",),
        loss_axis: Any = "data",
        grad_sync_axes: tuple = (),
        with_rng: bool = False,
        n_accum: int = 1,
        with_health: bool = False,
        callbacks: Sequence[Callback] = (),
        logger: Optional[DistributedLogger] = None,
        resume_dir: Optional[str] = None,
    ):
        """``params``: the WHOLE parameter tree (tensors, on the device the
        run takes: the card, or the CPU when the caller puts them there);
        ``param_specs`` its spec tree (``bloom.tp_specs``). The Trainer
        keeps this rank's shard of every leaf in fresh tensors: the step
        updates its parameters in place, and the caller's stay as they
        were. ``batch_spec`` cuts each global batch (a spec, or a tree of
        specs like the batch)."""
        if with_health:
            raise NotImplementedError(f"with_health=True: the in-graph health statistics "
                                      f"{_A13B}")
        self.parallel_context = parallel_context or ParallelContext.get_context()
        if self.parallel_context is None:
            raise ValueError("no ParallelContext; construct one first")
        self.logger = logger or DistributedLogger()
        self.callbacks = sorted(callbacks, key=lambda c: c.order)
        self.state = TrainerState()
        self.with_rng = with_rng
        self.tokens_per_step = 0  # updated from batch shapes each step
        self.last_batch = None    # the batch of the latest step

        from pipegoose_tpu_torch.parallel.hybrid import (
            build_hybrid_train_step,
            hybrid_build_config,
        )

        # everything the step was built from but the context: rebuild()
        # builds the same step on a new one
        self._hybrid_config = hybrid_build_config(
            loss_fn, param_specs, optimizer, batch_spec=batch_spec,
            loss_axis=loss_axis, grad_sync_axes=grad_sync_axes,
            with_rng=with_rng, n_accum=n_accum)
        init_fn, make_step = build_hybrid_train_step(self._hybrid_config,
                                                     self.parallel_context)
        self._init_fn = init_fn
        self.param_specs = param_specs
        self.optimizer = optimizer
        # this rank's shard of every leaf in FRESH tensors, on the caller's
        # device: the step trains them in place
        with torch.no_grad():
            self.params = shard_tree(params, param_specs, self.parallel_context)
        self._step_fn = make_step(self.params)
        self.opt_state = init_fn(self.params)

        # evaluate() runs the SAME accumulated loss as training, with no
        # backward: n_accum exists because the whole batch's forward may
        # not fit
        if n_accum > 1:
            from pipegoose_tpu_torch.core.accumulation import make_accumulated_loss

            self._loss_fn = make_accumulated_loss(loss_fn, n_accum)
        else:
            self._loss_fn = loss_fn
        self._batch_spec = batch_spec
        self._loss_axis = loss_axis

        if resume_dir is not None:
            self._try_resume(resume_dir)

    def _try_resume(self, directory: str) -> bool:
        from pipegoose_tpu_torch.utils.checkpoint import latest_step

        step = latest_step(directory)
        if step is None:
            self.logger.info(f"no checkpoint under {directory}; starting fresh")
            return False
        self._restore(directory, step)
        self.logger.info(f"resumed from {directory} at step {step}")
        return True

    def restore_from(self, directory: str, step: Optional[int] = None) -> int:
        """Restore params + optimizer state from a checkpoint into the LIVE
        trainer (``AutoRecovery`` rolls a diverged run back with it mid-fit).
        Rewinds ``state.step``; returns the restored step. Raises
        ``FileNotFoundError`` when the directory holds no checkpoint."""
        from pipegoose_tpu_torch.utils.checkpoint import latest_step

        if step is None:
            step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory!r}")
        self._restore(directory, step)
        return step

    def _restore(self, directory: str, step: int) -> None:
        """Load the checkpoint IN PLACE: into the parameters the step trains
        and into the optimizer that updates them (at dp = 1 its ZeRO shards
        are those very tensors), resharded onto this trainer's layout."""
        from pipegoose_tpu_torch.utils.checkpoint import restore_train_state

        restore_train_state(directory, step,
                            {"params": self.params, "opt_state": self.opt_state},
                            self.param_specs, self.parallel_context, inplace=True)
        self.state.step = step

    def rebuild(self, parallel_context: ParallelContext) -> None:
        """Build the same step on a NEW ``ParallelContext`` (another tensor
        x data layout over the same or another world). The parameters and
        the optimizer state are not migrated: this rank's parameters are
        allocated at the new layout's shard shapes, uninitialized, with a
        fresh optimizer over them; follow with :meth:`restore_from`, whose
        restore reshards the checkpoint onto the new layout."""
        from pipegoose_tpu_torch.parallel.hybrid import build_hybrid_train_step

        old = self.parallel_context

        def reshape(p, spec):
            shape = list(p.shape)
            for dim, entry in enumerate(spec):
                for ax in (entry if isinstance(entry, (tuple, list)) else (entry,)):
                    if ax is not None:
                        shape[dim] = (shape[dim] * old.axis_size(ax)
                                      // parallel_context.axis_size(ax))
            return torch.empty(shape, dtype=p.dtype, device=p.device)

        self.parallel_context = parallel_context
        init_fn, make_step = build_hybrid_train_step(self._hybrid_config, parallel_context)
        self._init_fn = init_fn
        self.params = tree_map(reshape, self.params, self.param_specs)
        self._step_fn = make_step(self.params)
        self.opt_state = init_fn(self.params)

    def evaluate(
        self,
        batches: Iterable[Any],
        rng: Optional[int] = None,
        weight_fn: Optional[Any] = None,
    ) -> float:
        """Mean loss over ``batches`` with the CURRENT params: no gradients,
        no optimizer update. Runs the same sharded loss as training (the
        equal-weight microbatch mean with ``n_accum > 1``), averaged over
        the loss axes, and reads one scalar a batch.

        ``weight_fn(batch) -> float`` weights each batch's (internally
        normalized) loss in the running mean; pass the batch's valid-token
        count for the corpus TOKEN-weighted mean of a ragged eval set.
        Default: equal batch weights. With ``with_rng``, batch i gets
        ``fold_in(rng, i)`` (``rng`` 0 by default)."""
        from pipegoose_tpu_torch.parallel.hybrid import _local_batch

        rng = 0 if rng is None else rng
        axes = self._loss_axis if isinstance(self._loss_axis, tuple) else (self._loss_axis,)
        device = tree_leaves(self.params)[0].device
        total, n = 0.0, 0.0
        for i, batch in enumerate(batches):
            extra = (fold_in(rng, i),) if self.with_rng else ()
            with torch.no_grad():
                local = _local_batch(batch, self._batch_spec, self.parallel_context, device)
                loss = self._loss_fn(self.params, local, *extra)
                for ax in axes:
                    loss = all_reduce(loss, ax, "mean")
            w = float(weight_fn(batch)) if weight_fn is not None else 1.0
            total += w * float(loss.item())
            n += w
        if n == 0:
            raise ValueError(
                "evaluate() received no batches (an exhausted generator?) or "
                "all batch weights were zero — 0.0 would be "
                "indistinguishable from perfect convergence")
        return total / n

    def doctor(self, *args, **kwargs):
        """The mesh doctor of the JAX Trainer reads XLA's compiled HLO."""
        raise NotImplementedError(f"Trainer.doctor (telemetry/doctor.py) {_A13B}")

    def profile(self, *args, **kwargs):
        """The JAX Trainer's measured step attribution (telemetry/xprof.py)."""
        raise NotImplementedError(f"Trainer.profile (telemetry/xprof.py) {_A13B}")

    def fit(
        self,
        batches: Iterable[Any],
        max_steps: Optional[int] = None,
        rng: Optional[int] = None,
        profiler_trace_dir: Optional[str] = None,
    ) -> TrainerState:
        """Run the training loop. ``batches`` yields GLOBAL batches (numpy
        arrays or tensors, alone or in dicts and lists) that ``batch_spec``
        cuts; with ``with_rng`` step i gets ``fold_in(rng, i)`` (``rng`` 0
        by default). ``profiler_trace_dir``: profile the whole fit with
        ``torch.profiler`` and write its Chrome trace there
        (``utils.profiler.trace``)."""
        if profiler_trace_dir is not None:
            from pipegoose_tpu_torch.utils.profiler import trace

            with trace(profiler_trace_dir):
                return self._fit(batches, max_steps, rng)
        return self._fit(batches, max_steps, rng)

    def _fire_fit_abort(self, exc: BaseException) -> None:
        """Teardown hooks of the failure path: best-effort, getattr-guarded
        (duck-typed callbacks keep working), and a teardown error never
        masks the original."""
        for cb in self.callbacks:
            hook = getattr(cb, "on_fit_abort", None)
            if hook is None:
                continue
            try:
                hook(self, exc)
            except Exception as cleanup_err:  # noqa: BLE001
                self.logger.warning(
                    f"on_fit_abort of {type(cb).__name__} raised "
                    f"{type(cleanup_err).__name__}: {cleanup_err} "
                    "(suppressed; original error propagates)")

    def _fit(
        self,
        batches: Iterable[Any],
        max_steps: Optional[int] = None,
        rng: Optional[int] = None,
    ) -> TrainerState:
        self.state.status = TrainerStatus.RUNNING
        for cb in self.callbacks:
            cb.on_fit_start(self)
        rng = 0 if rng is None else rng
        it = iter(batches)
        try:
            while True:
                # check BEFORE pulling: a pull consumes the caller's
                # iterator for nothing
                if max_steps is not None and self.state.step >= max_steps:
                    break
                try:
                    # disabled-registry spans are one branch; enabled,
                    # they split host data time from the step's launches
                    with span("train.data"):
                        batch = next(it)
                except StopIteration:
                    break
                step = self.state.step
                for cb in self.callbacks:
                    cb.on_step_start(self, step)
                leaves = []
                _map_batch(leaves.append, batch)
                self.tokens_per_step = _numel(leaves[0]) if leaves else 0
                self.last_batch = batch
                extra = (fold_in(rng, step),) if self.with_rng else ()
                # UNFENCED: measures the launches; in steady state the
                # queue backpressures to the card's step time.
                # TelemetryCallback(fence=True) gives exact step times.
                with span("train.step"):
                    self.params, self.opt_state, loss = self._step_fn(
                        self.params, self.opt_state, batch, *extra)
                # the loss stays a device tensor: reading it here would make
                # the host wait for the card every step; callbacks read it
                # only when they look
                self.state.step = step + 1
                self.state.last_loss = loss
                self.state.losses.append(loss)
                for cb in self.callbacks:
                    cb.on_step_end(self, self.state.step, loss)
        except KeyboardInterrupt as e:
            self.state.status = TrainerStatus.INTERRUPTED
            self.logger.warning("interrupted")
            self._fire_fit_abort(e)
            raise
        except Exception as e:
            # callers inspect trainer.state after fit() raises
            self.state.status = TrainerStatus.FAILED
            self._fire_fit_abort(e)
            raise
        self.state.status = TrainerStatus.FINISHED
        for cb in self.callbacks:
            cb.on_fit_end(self)
        return self.state
