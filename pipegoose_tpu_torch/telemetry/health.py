"""The host half of ``pipegoose_tpu/telemetry/health.py``: ``host_health``,
the flight recorder's record format. The in-graph health statistics
(``health_stats``, ``make_hybrid_train_step(with_health=True)``) wait for
ROADMAP.md queue A, item A13b."""
from __future__ import annotations

from typing import Any


def host_health(health: Any) -> Any:
    """A health tree (nested dicts of 0-d tensors or numbers) as a plain
    nested dict of Python floats: one read from the card per leaf."""
    if health is None:
        return None
    if isinstance(health, dict):
        return {k: host_health(v) for k, v in health.items()}
    return float(health)
