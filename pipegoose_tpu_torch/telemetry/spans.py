"""Span tracing: named, nestable wall-time regions with device fencing.

The counterpart of ``pipegoose_tpu/telemetry/spans.py``.
``with span("decode_step") as sp: ...`` records the region's wall time
into the active registry as a histogram (``span.<dotted.path>.seconds``)
and a ``"span"`` event for the JSONL stream. Spans nest through a
thread-local stack: a span opened inside another records under the
joined path (``step.forward``).

**Fencing.** CUDA launches are asynchronous: the host returns from a
kernel launch long before the card finishes, so a wall-time span around
launches measures enqueue cost. ``sp.fence(x)`` registers tensors whose
producing work must finish inside this span: at span exit, for each card
a fenced tensor lives on, an event is recorded on that card's current
stream and waited for (the JAX span blocks on the arrays instead). A
tensor on the CPU is ready when its op returns; anything that is not a
tensor (or a list, tuple or dict of them) is skipped. A CUDA error raised
by the wait propagates. Fencing happens only while the span is live
(registry enabled), so disabled runs keep the launch queue full.

**Capture safety.** ``span()`` returns a shared no-op when the registry is
disabled or a CUDA-graph capture is in progress (see ``registry``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Optional

import torch

from pipegoose_tpu_torch.telemetry.registry import (
    MetricsRegistry,
    _capturing,
    get_registry,
)

_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _cuda_devices(x: Any, out: set) -> None:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)


def fence_wait(*targets: Any) -> None:
    """Wait for the work queued, so far, on the current stream of every
    card that a tensor among ``targets`` lives on."""
    devices: set = set()
    _cuda_devices(targets, devices)
    for d in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        ev.synchronize()


class _NoopSpan:
    """Shared disabled / capture-time span: every operation is a no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def fence(self, *tensors: Any) -> None:
        pass


_NOOP = _NoopSpan()


class Span:
    __slots__ = ("name", "path", "_registry", "_attrs", "_t0", "_fences")

    def __init__(self, name: str, registry: MetricsRegistry,
                 attrs: Optional[dict] = None):
        self.name = name
        self.path = name  # finalized on __enter__ (nesting)
        self._registry = registry
        self._attrs = attrs
        self._t0 = 0.0
        self._fences: list = []

    def fence(self, *tensors: Any) -> None:
        """Wait at span exit for the work that produces these tensors, so
        it lands in this span's duration."""
        self._fences.extend(tensors)

    def __enter__(self) -> "Span":
        stack = _stack()
        self.path = ".".join([s.path for s in stack[-1:]] + [self.name])
        stack.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        stack = _stack()
        try:
            if self._fences:
                fence_wait(*self._fences)
        finally:
            dur = time.perf_counter() - self._t0
            if stack and stack[-1] is self:
                stack.pop()
        if exc_type is StopIteration:
            # iterator control flow, not work: a span around `next(it)`
            # (the Trainer's data span) would otherwise log a phantom
            # near-zero sample for the final exhausted pull
            return False
        reg = self._registry
        reg.histogram(f"span.{self.path}.seconds").observe(dur)
        reg.event("span", span=self.path, dur_s=dur, **(self._attrs or {}))
        return False


def span(name: str, *, registry: Optional[MetricsRegistry] = None,
         attrs: Optional[dict] = None):
    """Context manager timing a named region (see the module docstring).
    Returns a shared no-op when telemetry is disabled or a CUDA-graph
    capture is in progress: the disabled cost is one branch."""
    reg = registry if registry is not None else get_registry()
    if not reg._enabled or _capturing():
        return _NOOP
    return Span(name, reg, attrs)


def current_span_path() -> Optional[str]:
    """Dotted path of the innermost live span on this thread, or None."""
    stack = _stack()
    return stack[-1].path if stack else None
