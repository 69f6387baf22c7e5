"""Trainer callbacks.

The counterpart of ``pipegoose_tpu/trainer/callback.py``: the hook surface
(fit start, end and abort, step start and end, checkpoint), periodic loss
logging, and periodic checkpointing of the full train state.
"""
from __future__ import annotations

import math
import time
from typing import Any, Optional

import torch
import torch.distributed as dist


def _host_scalar(x: Any) -> float:
    """A scalar (a device tensor or a number) as a Python float. Every rank
    holds the same averaged loss after the step's all-reduce, so no
    gather is needed."""
    return float(x.item()) if isinstance(x, torch.Tensor) else float(x)


def _float_leaves(tree: Any) -> list:
    """Every floating tensor of a tree of dicts, lists and tuples, or of a
    ZeRO-1 state (its inner optimizer's state)."""
    from pipegoose_tpu_torch.optim.zero import ZeroState

    if isinstance(tree, ZeroState):
        tree = list(tree.inner.state.values())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _float_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _float_leaves(v)]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point() and tree.numel():
        return [tree]
    return []


def all_finite(*trees: Any) -> bool:
    """Whether every floating leaf of the trees is finite on every rank:
    one largest-magnitude reduction per device (``_foreach_norm`` of order
    inf, which is NaN or inf exactly where a leaf holds one), one
    all-reduce under a process group, one scalar read."""
    leaves = [t for tree in trees for t in _float_leaves(tree)]
    if not leaves:
        return True
    by_device: dict = {}
    for t in leaves:
        by_device.setdefault(t.device, []).append(t.detach())
    main = leaves[0].device
    flags = [torch.stack(torch._foreach_norm(ts, float("inf"))).isfinite().all().to(main)
             for ts in by_device.values()]
    flag = torch.stack(flags).all().to(torch.int32)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


class Callback:
    order: int = 0

    def on_fit_start(self, trainer: Any) -> None: ...

    def on_fit_end(self, trainer: Any) -> None: ...

    # teardown on the FAILURE path: on_fit_end only runs when fit
    # finishes. Called best-effort; exceptions here never mask the
    # original one.
    def on_fit_abort(self, trainer: Any, exc: BaseException) -> None: ...

    def on_step_start(self, trainer: Any, step: int) -> None: ...

    def on_step_end(self, trainer: Any, step: int, loss: Any) -> None: ...

    def on_checkpoint(self, trainer: Any, step: int, path: str) -> None: ...


class LossLoggerCallback(Callback):
    """Periodic loss/throughput logging via the trainer's logger; it reads
    the loss from the card only on the steps it logs."""

    def __init__(self, every: int = 10):
        self.every = every
        self._t0: Optional[float] = None
        self._tokens = 0

    def on_step_end(self, trainer: Any, step: int, loss: Any) -> None:
        self._tokens += trainer.tokens_per_step
        if self._t0 is None:
            self._t0 = time.perf_counter()
            self._tokens = 0
            return
        if step % self.every == 0:
            value = _host_scalar(loss)   # waits for the step: the clock reads it done
            dt = time.perf_counter() - self._t0
            tps = self._tokens / dt if dt > 0 else float("nan")
            trainer.logger.info(f"step {step} loss {value:.4f} tokens/s {tps:,.0f}")
            self._t0 = time.perf_counter()
            self._tokens = 0


class CheckpointCallback(Callback):
    """Periodic sharded checkpointing of the full train state (every rank
    writes its part)."""

    def __init__(self, directory: str, every: int = 1000, save_final: bool = True):
        self.directory = directory
        self.every = every
        self.save_final = save_final
        self._last_saved = -1

    def _save(self, trainer: Any, step: int) -> None:
        from pipegoose_tpu_torch.utils.checkpoint import available_steps, save_train_state

        # a COMPLETE checkpoint for this step already on disk means the
        # state came FROM it (recovery rolled back and restored it, the
        # only path that revisits a step number): re-saving would hit
        # the exists-check and kill the run
        if step in available_steps(self.directory):
            self._last_saved = max(self._last_saved, step)
            return
        # persisting non-finite state would poison every later restore.
        # 1. the last recorded loss: divergence that slipped past a
        #    FailureDetector with check_every > 1, at no device work;
        if trainer.state.last_loss is not None:
            last_loss = _host_scalar(trainer.state.last_loss)
            if not math.isfinite(last_loss):
                trainer.logger.warning(
                    f"step {step}: refusing to checkpoint non-finite state "
                    f"(loss {last_loss})")
                return
        # 2. the params AND the optimizer state: a step whose update itself
        #    overflowed has a finite loss (computed before the update), and a
        #    poisoned moment would re-poison training on resume
        if not all_finite(trainer.params, trainer.opt_state):
            trainer.logger.warning(
                f"step {step}: refusing to checkpoint non-finite params/opt_state")
            return
        path = save_train_state(self.directory, step, trainer.params, trainer.opt_state,
                                specs=getattr(trainer, "param_specs", None),
                                parallel_context=getattr(trainer, "parallel_context", None))
        self._last_saved = step
        trainer.logger.info(f"checkpointed step {step} -> {path}")
        for cb in trainer.callbacks:
            cb.on_checkpoint(trainer, step, path)

    def on_step_end(self, trainer: Any, step: int, loss: Any) -> None:
        # trust the TRAINER's step, not the argument: AutoRecovery (earlier
        # in this callback round, order -10) may have rolled state.step back;
        # saving the restored old state under the failing step's label would
        # poison later restores
        step = trainer.state.step
        if step > 0 and step % self.every == 0 and step > self._last_saved:
            self._save(trainer, step)

    def on_fit_end(self, trainer: Any) -> None:
        # short runs would otherwise end with NO checkpoint
        from pipegoose_tpu_torch.utils.checkpoint import latest_step

        existing = latest_step(self.directory)
        already = max(self._last_saved, existing if existing is not None else -1)
        if self.save_final and trainer.state.step > already:
            self._save(trainer, trainer.state.step)
