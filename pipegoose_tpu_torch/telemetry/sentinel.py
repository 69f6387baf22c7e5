"""Perf-regression sentinel: a rolling-baseline watch over measured runs.

The counterpart of ``pipegoose_tpu/telemetry/sentinel.py`` (its flat-dict
path; a ``StepProfile`` from the profiler attribution waits for ROADMAP.md
queue A, A13b).

- :meth:`PerfSentinel.observe` takes one run's measurement, a flat
  component dict (``tokens_per_s`` plus ``*_s`` time components, such as
  the serving engine's per-run decode-step / idle split, and optionally a
  ``profile`` sub-dict), and compares each component with the rolling
  median of the last ``window`` healthy runs;
- a component at ``>= ratio_threshold`` x its baseline (or tokens/s at
  ``<= drop_threshold`` x) fires ONE ``perf_regression`` black box through
  the attached ``FlightRecorder`` whose reason NAMES the regressed
  component, with every component's ratio in the details;
- regressed runs do NOT enter the baseline;
- every observation sets the ``perf.tokens_per_s`` gauge, and the
  ``perf.{compute,comm,idle}_fraction`` gauges when the run carries a
  profile.

A baseline can be seeded from a JSONL history, one row per run, via
:func:`read_bench_history` / :meth:`PerfSentinel.from_history`, filtered
by the device name. Opt-in and host-side: nothing observes unless a
caller passes a sentinel (``ServingEngine(sentinel=...)``).
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, List, Optional

# component key -> human label for the trigger reason
_LABELS = {
    "tokens_per_s": "tokens/s",
    "compute_s": "compute time",
    "idle_s": "idle time",
    "decode_step_s": "decode-step time",
    "wall_step_s": "step wall time",
}


def _label(key: str) -> str:
    if key in _LABELS:
        return _LABELS[key]
    if key.startswith("comm[") and key.endswith("]_s"):
        return f"{key[5:-3]}-axis collective time"
    return key


def _components_of(run: Any) -> Dict[str, float]:
    """Flatten one observation (a flat dict) into comparable
    components; a ``profile`` sub-dict is flattened into ``compute_s``,
    ``idle_s`` and one ``comm[<axes>]_s`` per axis group."""
    out: Dict[str, float] = {}
    for k, v in dict(run).items():
        if k == "profile" and isinstance(v, dict):
            out["compute_s"] = float(v.get("compute_s", 0.0))
            out["idle_s"] = float(v.get("idle_s", 0.0))
            for axes, t in (v.get("comm_by_axes") or {}).items():
                out[f"comm[{axes}]_s"] = float(t)
            continue
        if isinstance(v, (int, float)) and (k.endswith("_s")
                                            or k == "tokens_per_s"):
            out[k] = float(v)
    return out


def read_bench_history(
    path: str, tail: Optional[int] = None
) -> List[Dict[str, Any]]:
    """Parse a run-history JSONL (one JSON object per line; malformed
    lines skipped — an interrupted append must not poison the reader).
    ``tail`` keeps only the newest N rows — the sentinel's baseline
    window."""
    rows: List[Dict[str, Any]] = []
    if not path or not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError:
                continue
    return rows[-tail:] if tail else rows


class PerfSentinel:
    """Rolling-baseline perf-regression watch (module docstring).

    ``recorder``: optional ``FlightRecorder`` — regressions dump a
    ``perf_regression`` black box through it (without one they are
    still returned + counted). ``window``: healthy runs the rolling
    median spans. ``min_baseline``: observations required before any
    verdict (a 1-run "baseline" would page on startup noise).
    ``ratio_threshold``: a time component this many times its baseline
    median regresses. ``drop_threshold``: tokens/s at or below this
    fraction of its baseline regresses.
    """

    def __init__(
        self,
        recorder: Any = None,
        registry: Any = None,
        window: int = 8,
        min_baseline: int = 2,
        ratio_threshold: float = 1.5,
        drop_threshold: float = 0.7,
    ):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if min_baseline < 1:
            raise ValueError(f"min_baseline must be >= 1, got {min_baseline}")
        if ratio_threshold <= 1.0:
            raise ValueError(
                f"ratio_threshold must be > 1, got {ratio_threshold}")
        if not 0.0 < drop_threshold < 1.0:
            raise ValueError(
                f"drop_threshold must be in (0, 1), got {drop_threshold}")
        self.recorder = recorder
        self.registry = registry
        self.window = window
        self.min_baseline = min_baseline
        self.ratio_threshold = ratio_threshold
        self.drop_threshold = drop_threshold
        self._hist: deque = deque(maxlen=window)
        self.regressions = 0
        self.last_verdict: Optional[Dict[str, Any]] = None

    @classmethod
    def from_history(
        cls, path: str, device: Optional[str] = None, **kwargs: Any
    ) -> "PerfSentinel":
        """A sentinel whose baseline window is seeded from the tail of
        a run-history JSONL, one row per measured run (a benchmark's
        perf trajectory).

        Rows carrying a ``perf_regression`` stamp are SKIPPED (the
        regressed-runs-never-enter-the-baseline invariant holds across
        processes, not just within one sentinel's lifetime — otherwise
        a persistent regression fires once, poisons the next process's
        median, and goes quiet). ``device`` (when given) keeps only
        rows whose ``device`` field matches, such as the card's name
        (``torch.cuda.get_device_name``) — a CPU run must not be judged
        against (or drag down) a card's baseline."""
        s = cls(**kwargs)
        rows = [
            r for r in read_bench_history(path)
            if not r.get("perf_regression")
            and (device is None or r.get("device") == device)
        ]
        for row in rows[-s.window:]:
            comps = _components_of(row)
            if comps:
                s._hist.append(comps)
        return s

    @property
    def baseline_size(self) -> int:
        return len(self._hist)

    def baseline(self) -> Dict[str, float]:
        """{component -> rolling median} over the healthy window."""
        import statistics

        keys = set()
        for comps in self._hist:
            keys.update(comps)
        out = {}
        for k in keys:
            vals = [c[k] for c in self._hist if k in c]
            if vals:
                out[k] = statistics.median(vals)
        return out

    def _gauges(self, run: Any, comps: Dict[str, float]) -> None:
        from pipegoose_tpu_torch.telemetry.registry import get_registry

        reg = self.registry if self.registry is not None else get_registry()
        if not reg.enabled:
            return
        if isinstance(run.get("profile"), dict):
            p = run["profile"]
            wall = float(p.get("wall_step_s") or 0.0)
            if wall > 0:
                reg.gauge("perf.compute_fraction").set(
                    float(p.get("compute_s", 0.0)) / wall)
                reg.gauge("perf.comm_fraction").set(
                    float(p.get("comm_s", 0.0)) / wall)
                reg.gauge("perf.idle_fraction").set(
                    float(p.get("idle_s", 0.0)) / wall)
        if "tokens_per_s" in comps:
            reg.gauge(
                "perf.tokens_per_s",
                help="last observed run throughput (perf sentinel)",
            ).set(comps["tokens_per_s"])
        reg.gauge(
            "perf.regressions_total",
            help="perf_regression verdicts fired by the sentinel",
        ).set(float(self.regressions))

    def observe(
        self,
        run: Any,
        step: int = 0,
        tokens_per_s: Optional[float] = None,
        context: Optional[dict] = None,
    ) -> Optional[Any]:
        """Compare one run against the rolling baseline; returns the
        fired ``TriggerEvent`` (or a verdict dict when no recorder is
        attached) on regression, else None. ``run``: a flat component
        dict; ``tokens_per_s`` merges into the components when the dict
        does not carry one."""
        comps = _components_of(run)
        if tokens_per_s is not None:
            comps["tokens_per_s"] = float(tokens_per_s)
        self._gauges(run, comps)
        if not comps:
            return None
        regressions: List[Dict[str, Any]] = []
        if len(self._hist) >= self.min_baseline:
            base = self.baseline()
            for k, v in comps.items():
                b = base.get(k)
                if b is None or b <= 0:
                    continue
                ratio = v / b
                if k == "tokens_per_s":
                    if ratio <= self.drop_threshold:
                        regressions.append(
                            {"component": k, "ratio": ratio, "baseline": b,
                             "value": v,
                             "reason": f"{_label(k)} {ratio:.2f}x baseline "
                                       f"({v:.1f} vs {b:.1f})"})
                elif ratio >= self.ratio_threshold:
                    regressions.append(
                        {"component": k, "ratio": ratio, "baseline": b,
                         "value": v,
                         "reason": f"{_label(k)} {ratio:.1f}x baseline "
                                   f"({v * 1e3:.2f}ms vs {b * 1e3:.2f}ms)"})
        if not regressions:
            self._hist.append(comps)
            self.last_verdict = None
            return None
        # worst offender names the trigger; tokens/s drops sort by
        # severity of the drop, time components by the blowup
        def severity(r: Dict[str, Any]) -> float:
            return (1.0 / r["ratio"] if r["component"] == "tokens_per_s"
                    else r["ratio"])

        regressions.sort(key=severity, reverse=True)
        worst = regressions[0]
        self.regressions += 1
        verdict = {
            "reason": worst["reason"],
            "regressions": regressions,
            "components": comps,
            "baseline_size": len(self._hist),
        }
        self.last_verdict = verdict
        self._gauges(run, comps)  # refresh the regressions_total gauge
        if self.recorder is not None:
            return self.recorder.fire_trigger(
                "perf_regression", worst["reason"], step,
                context=context,
                details={
                    "regressions": regressions,
                    "components": comps,
                    "baseline": self.baseline(),
                },
            )
        return verdict
