"""Telemetry exporters: JSONL event stream + Prometheus textfile.

The counterpart of ``pipegoose_tpu/telemetry/exporters.py``. Two plain
files, no daemon:

- ``JSONLExporter``: an append-only event stream, one JSON object per
  line. Attached to a registry, every ``registry.event(...)`` and span
  exit lands as a line; ``export_snapshot`` adds a full metrics snapshot
  as a ``"snapshot"`` event.
- ``PrometheusTextfileExporter``: the node-exporter textfile-collector
  convention, one snapshot file written through tmp + rename so a
  concurrent scrape never sees a torn file.

Both write only on the process whose ``torch.distributed`` rank is
``rank`` (``rank=None``: every process, each with its own path), through
``utils.procindex.RankFilter``; building an exporter touches no process
group.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import threading
import time
from typing import IO, Optional

import torch

from pipegoose_tpu_torch.telemetry.registry import MetricsRegistry
from pipegoose_tpu_torch.utils.procindex import RankFilter as _RankFilter


def atomic_write_text(path: str, text: str, suffix: str = ".tmp") -> None:
    """tmp + rename, so a concurrent reader never sees a torn file: the one
    atomic writer of every telemetry file (Prometheus textfile, black-box
    dumps)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=suffix)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class JSONLExporter:
    """Append-only JSONL event sink: callable (the registry's sink
    protocol), and attached to ``registry`` when one is given."""

    def __init__(self, path: str, registry: Optional[MetricsRegistry] = None,
                 rank: Optional[int] = 0, mode: str = "a"):
        """``mode="a"`` appends across exporter lifetimes (one long-lived
        stream); ``mode="w"`` truncates on the first write (a per-run
        file, where stale events of an earlier attempt must not mix in)."""
        if mode not in ("a", "w"):
            raise ValueError(f"mode must be 'a' or 'w', got {mode!r}")
        self.path = path
        self._mode = mode
        self._rank_ok = _RankFilter(rank)
        self._file: Optional[IO[str]] = None
        self._lock = threading.Lock()
        self._registry = registry
        if registry is not None:
            registry.attach(self)

    def _handle(self) -> Optional[IO[str]]:
        if not self._rank_ok():
            return None
        if self._file is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._file = open(self.path, self._mode)
        return self._file

    def __call__(self, event: dict) -> None:
        # serialize outside the lock, then one locked write + flush: two
        # threads sharing this sink must not interleave torn lines
        line = safe_json_dumps(event) + "\n"
        with self._lock:
            f = self._handle()
            if f is None:
                return
            f.write(line)
            f.flush()

    def export_snapshot(self, registry: Optional[MetricsRegistry] = None) -> None:
        """Write the full metrics snapshot as one ``"snapshot"`` event."""
        reg = registry or self._registry
        if reg is None:
            raise ValueError("no registry to snapshot")
        self({"ts": time.time(), "kind": "snapshot", **reg.snapshot()})

    def close(self) -> None:
        if self._registry is not None:
            self._registry.detach(self)
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "JSONLExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PrometheusTextfileExporter:
    """Atomic Prometheus text-exposition snapshot writer."""

    def __init__(self, path: str, rank: Optional[int] = 0):
        self.path = path
        self._rank_ok = _RankFilter(rank)

    def write(self, registry: MetricsRegistry) -> Optional[str]:
        """Render ``registry`` and atomically replace ``self.path``;
        returns the path written, or None when rank-filtered out."""
        if not self._rank_ok():
            return None
        atomic_write_text(self.path, registry.to_prometheus(), suffix=".prom.tmp")
        return self.path


def _jsonable(x):
    """Best-effort conversion for a 0-d tensor or a numpy scalar reaching
    the stream. Non-finite values become strings: ``json.dumps`` would
    otherwise write bare ``Infinity`` / ``NaN``, which is not JSON."""
    if isinstance(x, torch.Tensor) and x.numel() == 1:
        x = x.item()
    try:
        f = float(x)
    except (TypeError, ValueError, RuntimeError):
        return repr(x)
    return f if math.isfinite(f) else repr(f)


def _sanitize(obj):
    """Recursively stringify non-finite floats (see ``_jsonable``): plain
    Python floats never reach a ``default=`` hook."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else repr(obj)
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def safe_json_dumps(obj, **kwargs) -> str:
    """``json.dumps`` that writes strictly valid (RFC 8259) JSON: every
    non-finite float, nested or a tensor / numpy scalar, lands as the
    string ``'inf'`` / ``'-inf'`` / ``'nan'``."""
    return json.dumps(_sanitize(obj), default=_jsonable, **kwargs)
