"""Declarative SLOs with multi-window burn-rate alerting.

The counterpart of ``pipegoose_tpu/telemetry/slo.py``, host logic only.
An :class:`SLOTarget` names a registry metric, a per-observation objective
(e.g. TTFT <= 250 ms) and the fraction of observations that must meet it
(e.g. 99%); the :class:`SLOMonitor` evaluates every target over a FAST
and a SLOW trailing window and alerts on the error-budget burn rate:

    burn = (bad fraction over the window) / (1 - target)

A burn of 1.0 spends the budget exactly at the sustainable rate;
``burn_threshold`` (default 2.0) pages when it burns faster. Both windows
must breach: the fast one catches a fresh regression, the slow one keeps
a brief blip from paging.

Registry histograms are cumulative, so the monitor keeps a bounded ring
of ``(t, bad, total)`` samples per target, one per :meth:`~SLOMonitor.
evaluate`, and a windowed rate is the delta against the newest sample at
least ``window`` old. An observation is good only when it lands in a
bucket whose upper bound is <= the objective, so an objective between
bucket bounds over-counts bad, never under-counts. ``kind="ratio"``
targets two counters instead (bad / total).

A target that starts breaching fires a structured ``slo_burn`` trigger
through ``FlightRecorder.fire_trigger`` (a black-box dump, once per
breach episode). Burn rates are exported as ``slo.<name>.burn_fast`` /
``burn_slow`` gauges. Evaluation is pull-driven: no background thread.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from pipegoose_tpu_torch.telemetry.registry import (
    Counter,
    Histogram,
    MetricsRegistry,
    get_registry,
)


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One declarative objective over a registry metric.

    ``kind="latency"``: ``metric`` is a histogram; an observation is
    good when <= ``objective`` (seconds). ``kind="ratio"``:
    ``bad_metric``/``total_metric`` are counters (objective unused).
    ``target`` is the required good fraction (0.99 = 1% error budget).
    """

    name: str
    metric: str = ""
    objective: float = 0.0
    target: float = 0.99
    kind: str = "latency"          # "latency" | "ratio"
    bad_metric: Optional[str] = None
    total_metric: Optional[str] = None

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: target must be in (0, 1), "
                f"got {self.target}"
            )
        if self.kind == "latency":
            if not self.metric:
                raise ValueError(f"SLO {self.name!r}: latency kind needs "
                                 f"a histogram metric name")
        elif self.kind == "ratio":
            if not (self.bad_metric and self.total_metric):
                raise ValueError(f"SLO {self.name!r}: ratio kind needs "
                                 f"bad_metric and total_metric")
        else:
            raise ValueError(
                f"SLO {self.name!r}: unknown kind {self.kind!r} "
                f"(expected 'latency' or 'ratio')"
            )


class _TargetState:
    __slots__ = ("samples", "breaching", "alerts", "last")

    def __init__(self, history: int):
        self.samples: deque = deque(maxlen=history)  # (t, bad, total)
        self.breaching = False
        self.alerts = 0
        self.last: Dict[str, Any] = {}


class SLOMonitor:
    """Evaluate :class:`SLOTarget` burn rates over fast+slow windows.

    ``recorder``: optional ``telemetry.FlightRecorder``; a breach
    transition fires a structured ``slo_burn`` trigger (black-box dump)
    through it. ``exemplars``: optional zero-argument callable whose
    result the trigger's details embed as ``exemplar`` (e.g.
    ``telemetry.FleetTracer.exemplar``: the slowest stitched trace, its
    dominant hop named; the control plane that wires it waits for
    ROADMAP.md queue A, A12). ``clock`` is injectable for
    tests (default ``time.monotonic``; only deltas are used).
    """

    def __init__(
        self,
        targets: Sequence[SLOTarget],
        registry: Optional[MetricsRegistry] = None,
        *,
        fast_window_s: float = 60.0,
        slow_window_s: float = 600.0,
        burn_threshold: float = 2.0,
        recorder: Optional[Any] = None,
        clock: Callable[[], float] = time.monotonic,
        history: int = 1024,
        exemplars: Optional[Callable[[], Any]] = None,
    ):
        if not targets:
            raise ValueError("SLOMonitor needs at least one target")
        if fast_window_s <= 0 or slow_window_s <= fast_window_s:
            raise ValueError(
                f"windows must satisfy 0 < fast ({fast_window_s}) < slow "
                f"({slow_window_s})"
            )
        if burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {burn_threshold}"
            )
        names = [t.name for t in targets]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO target names: {names}")
        self.targets = list(targets)
        self.registry = registry if registry is not None else get_registry()
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.recorder = recorder
        self.clock = clock
        # zero-argument provider of a tail exemplar: a breach black box
        # then names the slowest trace behind the burn
        self.exemplars = exemplars
        self._state = {t.name: _TargetState(history) for t in self.targets}
        self._evals = 0

    # -- cumulative (bad, total) reads -------------------------------------

    def _read(self, target: SLOTarget) -> Tuple[float, float]:
        metrics = self.registry.metrics()
        if target.kind == "ratio":
            bad = metrics.get(target.bad_metric)
            tot = metrics.get(target.total_metric)
            bad_v = bad.value if isinstance(bad, Counter) else 0.0
            tot_v = tot.value if isinstance(tot, Counter) else 0.0
            return float(bad_v), float(tot_v)
        h = metrics.get(target.metric)
        if not isinstance(h, Histogram):
            return 0.0, 0.0  # metric not observed yet: no data, no burn
        with h._lock:  # consistent counts vs a concurrent observe()
            counts = list(h._counts)
            total = h._count
        good = sum(
            c for b, c in zip(h.buckets, counts) if b <= target.objective
        )
        return float(total - good), float(total)

    # -- evaluation --------------------------------------------------------

    @staticmethod
    def _window_rate(samples, now: float, window: float,
                     bad: float, total: float) -> Tuple[float, float]:
        """Bad fraction + event count over ``[now - window, now]``:
        delta of the cumulative (bad, total) vs the newest sample at
        least ``window`` old (falling back to the oldest sample when
        history is shorter than the window).

        The fallback means a monitor younger than ``slow_window_s``
        computes its slow rate over whatever history exists, so fast
        and slow agree and a sustained burn right after startup CAN
        page before a full slow window has elapsed. That is deliberate:
        startup is when serving stalls are most likely, and a health
        check must see a burn within one evaluation of the data showing
        it; full multi-window blip suppression starts once history spans
        the slow window."""
        base_bad = base_total = None
        for t, b, n in samples:          # oldest -> newest
            if t <= now - window:
                base_bad, base_total = b, n
            else:
                break
        if base_bad is None:
            if not samples:
                return 0.0, 0.0
            t, base_bad, base_total = samples[0]
        d_total = total - base_total
        d_bad = bad - base_bad
        if d_total <= 0:
            return 0.0, 0.0
        return d_bad / d_total, d_total

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation pass: sample every target, compute fast/slow
        burn rates, fire/clear breach state, export gauges. Returns the
        status dict (also available via :meth:`status`)."""
        if now is None:
            now = self.clock()
        self._evals += 1
        reg = self.registry
        out: Dict[str, Any] = {"ok": True, "targets": {}}
        for target in self.targets:
            st = self._state[target.name]
            bad, total = self._read(target)
            rate_fast, n_fast = self._window_rate(
                st.samples, now, self.fast_window_s, bad, total
            )
            rate_slow, n_slow = self._window_rate(
                st.samples, now, self.slow_window_s, bad, total
            )
            st.samples.append((now, bad, total))
            budget = 1.0 - target.target
            burn_fast = rate_fast / budget
            burn_slow = rate_slow / budget
            breaching = (
                n_fast > 0
                and burn_fast >= self.burn_threshold
                and burn_slow >= self.burn_threshold
            )
            if breaching and not st.breaching:
                st.alerts += 1
                reg.counter("slo.alerts_total").inc()
                if self.recorder is not None:
                    exemplar = None
                    if self.exemplars is not None:
                        try:
                            exemplar = self.exemplars()
                        except Exception:  # noqa: BLE001 - an exemplar
                            pass  # provider bug must not eat the page
                    self.recorder.fire_trigger(
                        "slo_burn",
                        f"SLO {target.name!r} burning at "
                        f"{burn_fast:.2f}x budget (fast "
                        f"{self.fast_window_s:.0f}s) and "
                        f"{burn_slow:.2f}x (slow "
                        f"{self.slow_window_s:.0f}s), threshold "
                        f"{self.burn_threshold}x",
                        self._evals,
                        details={
                            "target": dataclasses.asdict(target),
                            "burn_fast": burn_fast,
                            "burn_slow": burn_slow,
                            "bad_fraction_fast": rate_fast,
                            "events_fast": n_fast,
                            "exemplar": exemplar,
                        },
                    )
            st.breaching = breaching
            st.last = {
                "kind": target.kind,
                "metric": target.metric or target.bad_metric,
                "objective": target.objective,
                "target": target.target,
                "burn_fast": burn_fast,
                "burn_slow": burn_slow,
                "bad_fraction_fast": rate_fast,
                "events_fast": n_fast,
                "events_slow": n_slow,
                "cumulative_bad": bad,
                "cumulative_total": total,
                "breaching": breaching,
                "alerts": st.alerts,
            }
            reg.gauge(f"slo.{target.name}.burn_fast").set(burn_fast)
            reg.gauge(f"slo.{target.name}.burn_slow").set(burn_slow)
            out["targets"][target.name] = st.last
            if breaching:
                out["ok"] = False
        reg.gauge("slo.breaching").set(
            float(sum(1 for s in self._state.values() if s.breaching))
        )
        return out

    def status(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Evaluate now and return the status dict: the pull-driven entry
        point of a health check, so a blown burn rate is visible within
        one evaluation of the data showing it."""
        return self.evaluate(now)

    @property
    def breaching(self) -> List[str]:
        return sorted(
            name for name, st in self._state.items() if st.breaching
        )


def default_serving_slos(
    *,
    ttft_p: float = 0.95,
    ttft_objective_s: float = 0.5,
    decode_gap_objective_s: float = 0.25,
    decode_gap_p: float = 0.99,
    shed_target: float = 0.95,
) -> List[SLOTarget]:
    """A reasonable starting set over the engine's existing metrics:
    TTFT, the inter-decode-step gap (the stall smell the watchdog
    catches only at full livelock), and the deadline-shed fraction.
    Shedding is the DESIGNED degraded mode (a health check stays green
    while it happens), so the shed target is what turns "degraded" into
    "page someone": with ``shed_target=0.95``, sustained shedding of
    more than 5% of submitted requests burns the budget and breaches."""
    return [
        SLOTarget(name="ttft", metric="serving.ttft_seconds",
                  objective=ttft_objective_s, target=ttft_p),
        SLOTarget(name="decode_gap", metric="serving.decode_gap_seconds",
                  objective=decode_gap_objective_s, target=decode_gap_p),
        SLOTarget(name="shed_fraction", kind="ratio",
                  bad_metric="serving.shed_total",
                  total_metric="serving.requests_total",
                  target=shed_target),
    ]
