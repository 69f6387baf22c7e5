"""Trainer lifecycle state.

The counterpart of ``pipegoose_tpu/trainer/state.py``: the status enum and
the mutable run state (step, last loss, loss history).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class TrainerStatus(str, enum.Enum):
    INITIALIZING = "initializing"
    RUNNING = "running"
    FINISHED = "finished"
    INTERRUPTED = "interrupted"
    FAILED = "failed"


class LossHistory(list):
    """Bounded per-step loss record.

    ``fit`` appends the step's loss as a DEVICE tensor: reading it would
    make the host wait for the card every step, where it should be queueing
    the next step's kernels. This list keeps the plain-list API its
    consumers rely on (``losses[-1]``, ``del losses[k:]`` in AutoRecovery's
    rollback, iteration) while

    - keeping at most ``maxlen`` entries (ring semantics: the oldest
      dropped on append), and
    - turning the entry ``sync_lag`` steps behind the head into a Python
      float on each append (``.item()``): by then the card has long
      finished that step, so the read does not stall the host, and the
      ring holds device tensors for the newest ``sync_lag`` steps only.
    """

    def __init__(self, iterable=(), maxlen: int = 4096, sync_lag: int = 16):
        super().__init__(iterable)
        if maxlen < 1:
            raise ValueError(f"maxlen must be >= 1, got {maxlen}")
        self.maxlen = maxlen
        self.sync_lag = max(int(sync_lag), 0)

    def append(self, value) -> None:
        super().append(value)
        if len(self) > self.maxlen:
            del self[: len(self) - self.maxlen]
        i = len(self) - 1 - self.sync_lag
        if i >= 0 and not isinstance(self[i], float):
            try:
                self[i] = float(self[i].item() if hasattr(self[i], "item") else self[i])
            except (TypeError, ValueError, RuntimeError):
                pass   # a non-numeric entry stays as it is


@dataclasses.dataclass
class TrainerState:
    status: TrainerStatus = TrainerStatus.INITIALIZING
    step: int = 0
    last_loss: Optional[Any] = None
    losses: LossHistory = dataclasses.field(default_factory=LossHistory)
