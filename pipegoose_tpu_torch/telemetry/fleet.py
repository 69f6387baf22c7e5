"""Fleet-level metric aggregation: N replica registries, one view.

The counterpart of ``pipegoose_tpu/telemetry/fleet.py``, host logic only.
Every serving replica owns its own ``MetricsRegistry``, but SLO verdicts
and dashboards want the fleet. :class:`FleetRegistry` is a real
``MetricsRegistry`` whose :meth:`metrics` view overlays its own metrics on
a merge of every member registry:

- **Counters** sum.
- **Histograms** merge exactly: per-bucket counts, total count and sum
  add, so a burn rate on the merged histogram equals one on a single
  registry that saw every observation. Reservoirs concatenate in member
  order, then truncate to the cap. Mismatched buckets raise.
- **Gauges** sum (the fleet gauges that matter are capacities: free
  pages, queue depth); read intensive gauges per member.

The fleet registry's OWN metrics win name collisions: that is where an
``SLOMonitor`` over the fleet writes its ``slo.*`` gauges. Merging reads
each member metric under its own lock.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from pipegoose_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)


def merge_counters(name: str, counters: List[Counter]) -> Counter:
    out = Counter(name, help=counters[0].help if counters else "")
    total = 0.0
    for c in counters:
        with c._lock:
            total += c._value
    out._value = total
    return out


def merge_gauges(name: str, gauges: List[Gauge]) -> Gauge:
    out = Gauge(name, help=gauges[0].help if gauges else "")
    vals = []
    for g in gauges:
        with g._lock:
            v = g._value
        if v == v:             # skip NaN (never-set members)
            vals.append(v)
    out._value = sum(vals) if vals else float("nan")
    return out


def merge_histograms(name: str, hists: List[Histogram]) -> Histogram:
    """Exact bucket/count/sum merge (module docstring). The merged
    object is a real ``Histogram`` — everything that reads bucket
    counts (Prometheus export, ``SLOMonitor._read``) works on it
    unchanged."""
    buckets = hists[0].buckets
    for h in hists[1:]:
        if h.buckets != buckets:
            raise ValueError(
                f"histogram {name!r}: cannot merge mismatched buckets "
                f"{h.buckets} vs {buckets}"
            )
    out = Histogram(name, help=hists[0].help, buckets=buckets)
    counts = [0] * (len(buckets) + 1)
    total = 0
    sum_ = 0.0
    lo, hi = float("inf"), float("-inf")
    reservoir: List[float] = []
    for h in hists:
        with h._lock:
            h_counts = list(h._counts)
            h_count, h_sum = h._count, h._sum
            h_min, h_max = h._min, h._max
            h_res = list(h._reservoir)
        for i, c in enumerate(h_counts):
            counts[i] += c
        total += h_count
        sum_ += h_sum
        lo, hi = min(lo, h_min), max(hi, h_max)
        reservoir.extend(h_res)
    out._counts = counts
    out._count = total
    out._sum = sum_
    out._min = lo
    out._max = hi
    out._reservoir = reservoir[:out._cap]
    return out


def merge_metrics(members: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge the ``metrics()`` dicts of several registries into fresh
    metric objects (same-name metrics must share a type)."""
    by_name: Dict[str, List[Any]] = {}
    for metrics in members:
        for name, m in metrics.items():
            by_name.setdefault(name, []).append(m)
    out: Dict[str, Any] = {}
    for name, ms in by_name.items():
        kinds = {type(m) for m in ms}
        if len(kinds) != 1:
            raise TypeError(
                f"metric {name!r} has conflicting types across members: "
                f"{sorted(k.__name__ for k in kinds)}"
            )
        if isinstance(ms[0], Counter):
            out[name] = merge_counters(name, ms)
        elif isinstance(ms[0], Gauge):
            out[name] = merge_gauges(name, ms)
        elif isinstance(ms[0], Histogram):
            out[name] = merge_histograms(name, ms)
        else:  # unknown metric kind: pass the first through untouched
            out[name] = ms[0]
    return out


class FleetRegistry(MetricsRegistry):
    """A ``MetricsRegistry`` whose read view merges member registries
    (module docstring). Writes (``counter()``/``gauge()``/
    ``histogram()`` handles, ``event()``) land on the fleet registry
    itself — e.g. the fleet ``SLOMonitor``'s gauges — and overlay the
    merged member metrics on name collision."""

    def __init__(self, members: Optional[List[Tuple[str, MetricsRegistry]]]
                 = None, enabled: bool = True):
        super().__init__(enabled=enabled)
        self._members: List[Tuple[str, MetricsRegistry]] = []
        for name, reg in members or []:
            self.add_member(name, reg)

    def add_member(self, name: str, registry: MetricsRegistry) -> None:
        if any(n == name for n, _ in self._members):
            raise ValueError(f"fleet member {name!r} already registered")
        self._members.append((name, registry))

    def remove_member(self, name: str) -> None:
        before = len(self._members)
        self._members = [(n, r) for n, r in self._members if n != name]
        if len(self._members) == before:
            raise ValueError(f"no fleet member named {name!r}")

    @property
    def member_names(self) -> List[str]:
        return [n for n, _ in self._members]

    def metrics(self) -> Dict[str, Any]:
        merged = merge_metrics(
            [reg.metrics() for _, reg in self._members]
        )
        merged.update(super().metrics())   # own metrics win collisions
        return merged

    def member_snapshots(self) -> Dict[str, dict]:
        """Per-member plain-dict snapshots (the per-replica
        breakdown next to the merged view)."""
        return {name: reg.snapshot() for name, reg in self._members}
