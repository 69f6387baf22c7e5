"""Failure detection and automatic recovery for the training loop.

The counterpart of ``pipegoose_tpu/trainer/recovery.py``: the failure mode
that ends large runs is numerical divergence (NaN/Inf loss, loss spikes).

- :class:`FailureDetector` watches the per-step loss and raises
  :class:`TrainingDiverged` on non-finite values or spikes beyond
  ``spike_factor`` x the running median. Detection reads the loss from the
  card once per checked step (``check_every`` > 1 keeps the host queueing
  steps between checks).
- :class:`AutoRecovery` restores params and optimizer state from the newest
  checkpoint in ``directory`` (pair it with ``CheckpointCallback`` writing
  there), rewinds ``trainer.state.step``, and lets ``fit`` continue with the
  incoming data: the diverging update never reaches the surviving state,
  and the batches that triggered it are skipped (the iterator has moved
  past them). After ``max_restores`` restores it re-raises.

Every rank holds the same averaged loss after the step's all-reduce, so
every rank takes the same decision at the same step, and the restore, a
collective, runs on all of them together.

Both accept ``recorder=`` (a ``telemetry.FlightRecorder``, listed among
the Trainer's callbacks): a trigger it fired this step (non-finite loss,
loss spike; the gradient-health triggers wait for the in-graph health
statistics, ROADMAP.md queue A, item A13b) is consumed in the same
callback round and handled like a divergence, and the reason names the
black box already on disk.
"""
from __future__ import annotations

import math
import os
from collections import deque
from typing import Any, Optional

import torch.distributed as dist

from pipegoose_tpu_torch.trainer.callback import Callback, _host_scalar


class TrainingDiverged(RuntimeError):
    """Loss went non-finite (or spiked) and recovery was impossible or
    exhausted."""


class FailureDetector(Callback):
    """Detect numerical divergence from the loss stream.

    ``spike_factor``: optional; flag loss > spike_factor * median of the
    last ``window`` finite losses (armed after ``window // 2`` of them, so
    the drop of the first steps does not trip it)."""

    order = -10  # run before logging/checkpoint callbacks see the step

    def __init__(
        self,
        check_every: int = 1,
        spike_factor: Optional[float] = None,
        window: int = 50,
        recorder: Optional[Any] = None,
    ):
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.check_every = check_every
        self.spike_factor = spike_factor
        self.window = window
        self.recorder = recorder
        self._history: deque = deque(maxlen=window)
        # the structured trigger being handled right now (set for the
        # length of a handle_failure call driven by the recorder)
        self.active_trigger: Optional[Any] = None

    def _is_divergent(self, loss: float) -> Optional[str]:
        if not math.isfinite(loss):
            return f"non-finite loss {loss}"
        if self.spike_factor is not None and len(self._history) >= max(1, self.window // 2):
            med = sorted(self._history)[len(self._history) // 2]
            if loss > self.spike_factor * med:
                return (f"loss spike {loss:.4g} > {self.spike_factor} x "
                        f"median {med:.4g}")
        self._history.append(loss)
        return None

    def on_step_end(self, trainer: Any, step: int, loss: Any) -> None:
        if self.recorder is not None:
            trig = self.recorder.take_trigger()
            if trig is not None:
                where = f" (black box: {trig.dump_path})" if trig.dump_path else ""
                self.active_trigger = trig
                try:
                    self.handle_failure(trainer, step, f"{trig.name}: {trig.reason}{where}")
                finally:
                    self.active_trigger = None
                return
        if step % self.check_every:
            return
        reason = self._is_divergent(_host_scalar(loss))
        if reason is not None:
            self.handle_failure(trainer, step, reason)

    def handle_failure(self, trainer: Any, step: int, reason: str) -> None:
        raise TrainingDiverged(f"step {step}: {reason}")


class AutoRecovery(FailureDetector):
    """FailureDetector that restores the last checkpoint instead of
    aborting. ``directory`` must be the ``CheckpointCallback`` target (or
    any directory ``save_train_state`` wrote). If no checkpoint exists yet
    when divergence hits, there is nothing to restore: it raises.

    A newest checkpoint that FAILS to restore is quarantined and the
    next-older one tried; every attempt, failed or not, consumes one of
    ``max_restores``, so a directory of corrupt checkpoints exhausts
    loudly instead of looping."""

    def __init__(
        self,
        directory: str,
        max_restores: int = 3,
        check_every: int = 1,
        spike_factor: Optional[float] = None,
        window: int = 50,
        recorder: Optional[Any] = None,
    ):
        super().__init__(check_every, spike_factor, window, recorder)
        self.directory = directory
        self.max_restores = max_restores
        self.restores = 0

    def handle_failure(self, trainer: Any, step: int, reason: str) -> None:
        if self.restores >= self.max_restores:
            raise TrainingDiverged(
                f"step {step}: {reason} — {self.restores} restores already "
                "spent; divergence is persistent (check lr/data), aborting")
        trainer.logger.warning(f"step {step}: {reason} — restoring last checkpoint")
        restored_step = self._restore_with_fallback(trainer, step, reason)
        self._after_restore(trainer, step, restored_step)

    def _restore_with_fallback(self, trainer: Any, step: int, reason: str) -> int:
        """Restore the newest COMPLETE checkpoint, falling back to the
        next-older one when a restore fails. A checkpoint that failed to
        restore is quarantined (renamed ``step_N.corrupt`` by rank 0) so
        that it stops shadowing the step, which training replays and must
        be able to save again. Returns the restored step."""
        from pipegoose_tpu_torch.utils.checkpoint import available_steps

        steps = available_steps(self.directory)
        if not steps:
            raise TrainingDiverged(
                f"step {step}: {reason} — and no checkpoint under "
                f"{self.directory!r} to restore from")
        for cand in steps:  # newest -> oldest
            if self.restores >= self.max_restores:
                raise TrainingDiverged(
                    f"step {step}: {reason} — {self.restores} restores "
                    "already spent; divergence is persistent (check "
                    "lr/data), aborting")
            try:
                restored_step = trainer.restore_from(self.directory, cand)
            except Exception as e:  # noqa: BLE001 - any restore failure falls back
                self.restores += 1
                where = _quarantine(os.path.join(self.directory, f"step_{cand}"))
                trainer.logger.warning(
                    f"checkpoint step_{cand} under {self.directory!r} failed to restore "
                    f"({type(e).__name__}: {e}) — {where}; falling back to the "
                    f"next-older checkpoint ({self.restores}/{self.max_restores} "
                    f"budget spent)")
                continue
            self.restores += 1
            return restored_step
        raise TrainingDiverged(
            f"step {step}: {reason} — every checkpoint under "
            f"{self.directory!r} failed to restore")

    def _after_restore(self, trainer: Any, step: int, restored_step: int) -> None:
        self._history.clear()
        if self.recorder is not None:
            # the spike baselines span the rolled-back steps; this also
            # drops a pending trigger, so the next round does not fire
            # again on the evidence from before the restore
            self.recorder.reset_after_restore(restored_step)
        # drop the rolled-back tail of the loss record; it counts entries
        # since THIS trainer started, so truncate by the steps rolled back
        rolled_back = step - restored_step
        keep = max(len(trainer.state.losses) - rolled_back, 0)
        del trainer.state.losses[keep:]
        trainer.state.last_loss = (
            trainer.state.losses[-1] if trainer.state.losses else None)
        trainer.logger.info(
            f"restored step {restored_step} ({self.restores}/{self.max_restores})")


def _quarantine(skipped: str) -> str:
    """Rename a checkpoint that failed to restore out of the step
    namespace (rank 0, every rank waiting for it)."""
    multi = dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
    where = ""
    if not multi or dist.get_rank() == 0:
        quarantine = skipped + ".corrupt"
        n = 1
        while os.path.exists(quarantine):
            quarantine = f"{skipped}.corrupt{n}"
            n += 1
        try:
            os.replace(skipped, quarantine)
            where = f"quarantined to {quarantine!r}"
        except OSError:
            where = "quarantine rename failed; left in place"
    if multi:
        dist.barrier()
    return where or "quarantined by rank 0"
