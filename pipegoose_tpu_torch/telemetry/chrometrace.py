"""Perfetto / Chrome ``trace_event`` timeline export.

The counterpart of ``pipegoose_tpu/telemetry/chrometrace.py``. The span
stream (``telemetry/spans.py``) is a flat JSONL of named durations; this
module renders it as the Trace Event JSON that https://ui.perfetto.dev and
chrome://tracing open: every ``span`` event becomes a complete ("ph": "X")
slice on its thread's row, so a ``Trainer.fit`` run reads as a timeline
(data pulls between step launches, serving prefills against decode steps).

:func:`pipeline_trace_events` renders a pipeline scheduler's clock
timetable (``nn/pipeline_parallel/scheduler.py``) as one row per stage,
and :func:`register_pipeline_gauges` sets the bubble fraction, the idle
share of that timetable, as a gauge; with a measured step time it also
sets the seconds that share costs. Request timelines, router decisions,
the memory ledger's counter tracks and the goodput ledger's state bands
render beside them.

Format notes (the subset Perfetto accepts strictly): timestamps and
durations are MICROSECONDS; ``pid``/``tid`` are ints, named via
``"M"``-phase ``process_name``/``thread_name`` metadata events; the
file is one JSON object ``{"traceEvents": [...]}``.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from pipegoose_tpu_torch.telemetry.registry import MetricsRegistry, get_registry
from pipegoose_tpu_torch.utils.procindex import RankFilter as _RankFilter

# fixed pid per row family so multiple writers agree
PID_HOST = 1        # host-side spans (trainer/serving/decode loops)
PID_PIPELINE = 2    # theoretical pipeline clock timeline
PID_REQUESTS = 3    # per-request serving timelines (telemetry/reqtrace.py)
PID_FLEET = 4       # control-plane router decisions (one track per replica)
PID_PLANE = 5       # control-plane hop slices (telemetry/fleettrace.py)
PID_MEMORY = 6      # memory-ledger counter tracks (telemetry/memledger.py)
PID_GOODPUT = 7     # goodput state bands + incidents (telemetry/goodput.py)
# multi-replica request timelines get one process EACH, allocated from
# here up (the first tracer keeps PID_REQUESTS for backward compat)
REPLICA_PID_BASE = 10


def span_events_to_trace(
    events: Iterable[dict], *, pid: int = PID_HOST
) -> List[dict]:
    """``"span"`` event dicts (JSONL schema: ``ts`` = exit wall-clock
    seconds, ``dur_s``) -> complete trace events. Non-span events pass
    through as instant events so step markers stay visible."""
    out: List[dict] = []
    for ev in events:
        kind = ev.get("kind")
        extra = {
            k: v for k, v in ev.items()
            if k not in ("kind", "span", "ts", "dur_s", "tid")
        }
        if kind == "span":
            dur = float(ev.get("dur_s", 0.0))
            end = float(ev.get("ts", 0.0))
            out.append({
                "name": ev.get("span", "?"),
                "cat": "span",
                "ph": "X",
                "ts": (end - dur) * 1e6,
                "dur": dur * 1e6,
                "pid": pid,
                "tid": int(ev.get("tid", 0)),
                "args": extra,
            })
        elif kind is not None:
            out.append({
                "name": str(kind),
                "cat": "event",
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": float(ev.get("ts", 0.0)) * 1e6,
                "pid": pid,
                "tid": int(ev.get("tid", 0)),
                "args": extra,
            })
    return out


def pipeline_trace_events(
    scheduler: Any,
    *,
    clock_s: float = 1e-3,
    t0_s: float = 0.0,
    include_backward: bool = True,
    pid: int = PID_PIPELINE,
) -> List[dict]:
    """Render a ``GPipeScheduler`` (or subclass) clock timetable as one
    trace row PER PIPELINE STAGE: task (m, p) becomes an ``F{m}`` slice
    at clock ``m + p`` on stage p's row, backwards follow as ``B{m}``
    after the forward clocks — the microbatch/clock diagram torchgpipe
    §3.2.1 draws, loadable next to the measured spans. ``clock_s`` is
    the nominal seconds per clock (pure visualization scale).

    A ``OneFOneBScheduler`` renders from its ACTUAL interleaved
    timetable (``tables()``): F and B slices of different microbatches
    share the steady-state clocks instead of the GPipe two-phase
    layout."""
    events: List[dict] = [
        {
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": "pipeline (theoretical clock timeline)"},
        }
    ]
    for p in range(scheduler.n_partitions):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": p,
            "args": {"name": f"stage {p}"},
        })

    def emit_slice(label, m, p, clock):
        events.append({
            "name": f"{label}{m}",
            "cat": f"pipeline.{'forward' if label == 'F' else 'backward'}",
            "ph": "X",
            "ts": (t0_s + clock * clock_s) * 1e6,
            "dur": clock_s * 1e6,
            "pid": pid,
            "tid": p,
            "args": {"microbatch": m, "stage": p, "clock": clock},
        })

    from pipegoose_tpu_torch.nn.pipeline_parallel.scheduler import OneFOneBScheduler

    if isinstance(scheduler, OneFOneBScheduler):
        fwd, bwd, _, n_clock = scheduler.tables()
        for c in range(n_clock):
            for p in range(scheduler.n_partitions):
                if fwd[c][p] >= 0:
                    emit_slice("F", int(fwd[c][p]), p, c)
                if include_backward and bwd[c][p] >= 0:
                    emit_slice("B", int(bwd[c][p]), p, c)
        return events

    def emit(tasks_by_clock, label, clock_offset):
        for c, tasks in enumerate(tasks_by_clock):
            for t in tasks:
                events.append({
                    "name": f"{label}{t.microbatch_idx}",
                    "cat": f"pipeline.{'forward' if label == 'F' else 'backward'}",
                    "ph": "X",
                    "ts": (t0_s + (clock_offset + c) * clock_s) * 1e6,
                    "dur": clock_s * 1e6,
                    "pid": pid,
                    "tid": t.partition_idx,
                    "args": {
                        "microbatch": t.microbatch_idx,
                        "stage": t.partition_idx,
                        "clock": clock_offset + c,
                    },
                })

    emit(scheduler.get_forward_schedules(), "F", 0)
    if include_backward:
        emit(
            scheduler.get_backward_schedules(), "B",
            scheduler.total_forward_clocks,
        )
    return events


def register_pipeline_gauges(
    scheduler: Any,
    registry: Optional[MetricsRegistry] = None,
    step_seconds: Optional[float] = None,
) -> float:
    """Set ``pipeline.bubble_fraction`` (theoretical idle share of the
    scheduler's own clock timeline — ``(P-1)/(M+P-1)`` for GPipe, the
    measured-timetable share for ``OneFOneBScheduler``) alongside the
    PR-2 ``train.mfu`` gauge; with a measured step time (e.g. the
    ``span.train.step.seconds`` p50) also ``pipeline.bubble_seconds`` —
    the wall-clock that fraction costs per step. Returns the fraction."""
    reg = registry if registry is not None else get_registry()
    frac = scheduler.bubble_fraction
    reg.gauge(
        "pipeline.bubble_fraction",
        help="theoretical pipeline idle fraction of the scheduler's "
             "clock timetable",
    ).set(frac)
    reg.gauge("pipeline.n_microbatches").set(float(scheduler.n_microbatches))
    reg.gauge("pipeline.n_partitions").set(float(scheduler.n_partitions))
    if step_seconds is not None:
        reg.gauge(
            "pipeline.bubble_seconds",
            help="measured step seconds x theoretical bubble fraction",
        ).set(frac * step_seconds)
    return frac


def router_trace_events(decisions: Iterable[dict], *,
                        pid: int = PID_FLEET,
                        wall_offset: float = 0.0) -> List[dict]:
    """Render a control-plane router's decision log
    (a ``Router.decisions``-shaped list of dicts) as
    Perfetto rows: ONE TRACK PER REPLICA, an instant marker per routing
    decision carrying the tenant, the matched cached-prefix tokens, and
    the candidate count — loadable next to the per-slot request
    timelines, so "why did this request land here" sits one track above
    "what happened to it". ``wall_offset`` aligns the decisions' clock
    domain with the span rows (pass the owning tracer's
    ``wall_offset`` when combining)."""
    decisions = list(decisions)
    replicas: List[str] = []
    for d in decisions:
        if d["replica"] not in replicas:
            replicas.append(d["replica"])
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": "serving fleet (router decisions)"},
    }]
    for tid, name in enumerate(replicas):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name},
        })
    for d in decisions:
        tenant = d.get("tenant") or "default"
        events.append({
            "name": f"route {tenant}"
                    + (f" +{d['matched_tokens']}tok"
                       if d.get("matched_tokens") else ""),
            "cat": "router.decision", "ph": "i", "s": "t",
            "ts": (d["t"] + wall_offset) * 1e6,
            "pid": pid, "tid": replicas.index(d["replica"]),
            "args": {k: v for k, v in d.items() if k != "t"},
        })
    return events


def memory_trace_events(ledger: Any, *,
                        pid: int = PID_MEMORY,
                        wall_offset: float = 0.0) -> List[dict]:
    """Render a ``MemoryLedger``'s per-tick occupancy samples
    (telemetry/memledger.py) as Perfetto COUNTER tracks: one stacked
    ``kv bytes`` counter with the per-owner-class split (request /
    staged / cow / cached / reserved / free), plus scalar tracks for
    fragmentation, the steps-to-exhaustion forecast, and — when a host
    tier is bound — host-DRAM resident bytes. Loadable next to the
    request timelines, so "who owned the pool when this request
    queued" is one track group away. Samples without a wall clock
    (``t is None`` — replay without a ``now``) fall back to 1ms per
    engine tick."""
    samples = list(ledger.samples)
    bpp = int(getattr(ledger, "bytes_per_page", 1))
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": "serving memory (ledger counter tracks)"},
    }]
    for s in samples:
        t = s.get("t")
        ts = ((t + wall_offset) * 1e6 if t is not None
              else (wall_offset * 1e6 + s.get("step", 0) * 1e3))
        events.append({
            "name": "kv bytes", "cat": "memory", "ph": "C",
            "ts": ts, "pid": pid,
            "args": {
                "request": s.get("request", 0) * bpp,
                "staged": s.get("staged", 0) * bpp,
                "cow": s.get("cow", 0) * bpp,
                "cached": s.get("cached", 0) * bpp,
                "reserved": s.get("reserved_unmaterialized", 0) * bpp,
                "free": s.get("free", 0) * bpp,
            },
        })
        events.append({
            "name": "fragmentation", "cat": "memory", "ph": "C",
            "ts": ts, "pid": pid,
            "args": {"fragmentation": s.get("fragmentation", 0.0)},
        })
        ste = s.get("steps_to_exhaustion")
        if ste is not None:
            events.append({
                "name": "steps_to_exhaustion", "cat": "memory",
                "ph": "C", "ts": ts, "pid": pid,
                "args": {"steps": ste},
            })
        if "host_tier_bytes" in s:
            events.append({
                "name": "host tier bytes", "cat": "memory", "ph": "C",
                "ts": ts, "pid": pid,
                "args": {"resident": s["host_tier_bytes"]},
            })
    return events


def goodput_trace_events(ledger: Any, *,
                         pid: int = PID_GOODPUT,
                         wall_offset: float = 0.0) -> List[dict]:
    """Render a ``GoodputLedger``'s per-replica state bands
    (telemetry/goodput.py) as Perfetto rows: ONE TRACK PER REPLICA, one
    colored slice per class episode (the color keys off the slice name,
    so productive / stall / failed_quarantine bands read apart at a
    glance), plus an instant marker at every incident's detection
    (named by kind, args carrying MTTR + capacity-gap integral).
    Loadable next to the request timelines and router decisions, so
    "the fleet lost this replica HERE" lines up with the requests that
    ate the latency. ``wall_offset`` aligns the clock domain with the
    span rows (pass the owning tracer's ``wall_offset``)."""
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": "fleet goodput (state bands + incidents)"},
    }]
    names = sorted(ledger.replicas)
    for tid, name in enumerate(names):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name},
        })
        acct = ledger.replicas[name]
        for ep in acct.episodes:
            dur = max(ep["t1"] - ep["t0"], 0.0)
            events.append({
                "name": ep["class"], "cat": "goodput.state", "ph": "X",
                "ts": (ep["t0"] + wall_offset) * 1e6, "dur": dur * 1e6,
                "pid": pid, "tid": tid,
                "args": {"state": ep["state"], "ticks": ep["ticks"],
                         "tick0": ep["tick0"], "tick1": ep["tick1"]},
            })
    for inc in ledger.incidents:
        tid = names.index(inc.replica) if inc.replica in names else 0
        events.append({
            "name": f"incident {inc.kind}",
            "cat": "goodput.incident", "ph": "i", "s": "t",
            "ts": (inc.t_detected + wall_offset) * 1e6,
            "pid": pid, "tid": tid,
            "args": {
                "id": inc.id,
                "reason": inc.reason,
                "detection_latency_ticks": inc.detection_latency_ticks,
                "mttr_s": inc.mttr_s,
                "resolved_by": inc.resolved_by,
                "capacity_gap_integral_s": round(
                    inc.capacity_gap_integral_s, 9),
            },
        })
    return events


class ChromeTraceExporter:
    """Registry sink accumulating span/step events as trace events;
    ``write()`` emits one Perfetto-loadable JSON file atomically.

    Same conventions as ``JSONLExporter``: callable (the sink
    protocol), attaches itself when constructed with ``registry=``,
    rank-0 filtered file writes. Events are buffered in memory (one
    small dict per span — bound a long run with ``max_events``, which
    keeps the NEWEST events) and annotated with the capturing thread so
    serving-engine and trainer rows separate naturally. Rows beyond the
    live capture (the pipeline clock timeline) are added with
    :meth:`add_events` / :meth:`add_pipeline_timeline`."""

    def __init__(
        self,
        path: str,
        registry: Optional[MetricsRegistry] = None,
        rank: Optional[int] = 0,
        max_events: int = 100_000,
    ):
        self.path = path
        self._rank_ok = _RankFilter(rank)
        self._lock = threading.Lock()
        # deque(maxlen): O(1) append-with-drop — a list would memmove
        # the whole buffer per event once the cap is hit, on the
        # instrumented hot path of exactly the longest runs
        self.max_events = int(max_events)
        self._events: deque = deque(maxlen=self.max_events)
        self._extra: List[dict] = []        # pre-rendered trace events
        self._tids: Dict[int, int] = {}     # thread ident -> compact tid
        # tracer identity -> pid for add_request_timelines: the FIRST
        # tracer keeps the historical PID_REQUESTS; every further
        # tracer (a second replica sharing this exporter) gets its own
        # process from REPLICA_PID_BASE up, so multi-replica exports
        # never interleave slot tracks on one pid
        self._request_pids: Dict[int, int] = {}
        self._dropped = 0
        self._registry = registry
        if registry is not None:
            registry.attach(self)

    def __call__(self, event: dict) -> None:
        # rank-filter at CAPTURE, not just at write: non-emitting ranks
        # must not spend memory/copies buffering events they will never
        # render (JSONLExporter drops per-event the same way)
        if not self._rank_ok():
            return
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.setdefault(ident, len(self._tids))
            ev = dict(event)
            ev["tid"] = tid
            if len(self._events) == self.max_events:
                self._dropped += 1  # deque drops the oldest on append
            self._events.append(ev)

    def add_events(self, trace_events: Iterable[dict]) -> None:
        with self._lock:
            self._extra.extend(trace_events)

    def add_pipeline_timeline(self, scheduler: Any, **kwargs: Any) -> None:
        """Attach a ``GPipeScheduler`` clock timeline's rows (see
        :func:`pipeline_trace_events`)."""
        self.add_events(pipeline_trace_events(scheduler, **kwargs))

    def add_request_timelines(self, tracer: Any, **kwargs: Any) -> None:
        """Attach a ``RequestTracer``'s per-slot request timelines (see
        ``telemetry.reqtrace.request_trace_events``) as their own
        process group next to the host spans and pipeline rows. Each
        DISTINCT tracer gets its own pid (named after ``tracer.name``
        when set), so a fleet's replicas render as separate processes
        instead of interleaving slot tracks; pass ``pid=`` to pin one
        explicitly."""
        from pipegoose_tpu_torch.telemetry.reqtrace import request_trace_events

        if "pid" not in kwargs:
            with self._lock:
                pid = self._request_pids.get(id(tracer))
                if pid is None:
                    pid = (PID_REQUESTS if not self._request_pids
                           else REPLICA_PID_BASE
                           + len(self._request_pids) - 1)
                    self._request_pids[id(tracer)] = pid
            kwargs["pid"] = pid
        self.add_events(request_trace_events(tracer, **kwargs))

    def add_fleet_trace(self, fleet: Any) -> None:
        """Attach a ``FleetTracer``'s merged cross-replica export (see
        ``telemetry.fleettrace.fleet_trace_events``): the plane hop
        track plus one process per registered replica with flow arrows
        binding dispatch->admit, handoff transfers, and peer pulls."""
        from pipegoose_tpu_torch.telemetry.fleettrace import fleet_trace_events

        self.add_events(fleet_trace_events(fleet))

    def add_router_decisions(self, decisions: Iterable[dict],
                             **kwargs: Any) -> None:
        """Attach a control-plane router's decision log (see
        :func:`router_trace_events`) — one track per replica in the
        fleet process group."""
        self.add_events(router_trace_events(decisions, **kwargs))

    def add_goodput(self, ledger: Any, **kwargs: Any) -> None:
        """Attach a ``GoodputLedger``'s per-replica state bands and
        incident markers (see :func:`goodput_trace_events`)."""
        self.add_events(goodput_trace_events(ledger, **kwargs))

    def write(self, path: Optional[str] = None) -> Optional[str]:
        """Render and atomically write the trace JSON; returns the path
        (None when rank-filtered out)."""
        if not self._rank_ok():
            return None
        path = path or self.path
        with self._lock:
            events = list(self._events)
            extra = list(self._extra)
            tids = dict(self._tids)
            dropped = self._dropped
        trace: List[dict] = [
            {
                "name": "process_name", "ph": "M", "pid": PID_HOST,
                "args": {"name": "pipegoose_tpu_torch host spans"},
            }
        ]
        for ident, tid in tids.items():
            trace.append({
                "name": "thread_name", "ph": "M", "pid": PID_HOST,
                "tid": tid, "args": {"name": f"thread {ident}"},
            })
        trace.extend(span_events_to_trace(events))
        trace.extend(extra)
        payload = {
            "traceEvents": trace,
            "displayTimeUnit": "ms",
            "otherData": {
                "exporter": "pipegoose_tpu_torch.telemetry.chrometrace",
                "created_ts": time.time(),
                "dropped_events": dropped,
            },
        }
        from pipegoose_tpu_torch.telemetry.exporters import (
            atomic_write_text,
            safe_json_dumps,
        )

        atomic_write_text(path, safe_json_dumps(payload), suffix=".trace.tmp")
        return path

    def close(self) -> None:
        if self._registry is not None:
            self._registry.detach(self)
            self._registry = None

    def __enter__(self) -> "ChromeTraceExporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def trace_from_jsonl(jsonl_path: str, trace_path: str) -> str:
    """Offline conversion: a ``JSONLExporter`` stream (e.g. a run's
    ``telemetry.jsonl`` artifact) -> Perfetto trace JSON. Snapshot
    lines are skipped; malformed lines are ignored (a truncated last
    line from a killed run must not block the post-mortem)."""
    events: List[dict] = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if ev.get("kind") == "snapshot":
                continue
            events.append(ev)
    exp = ChromeTraceExporter(trace_path, rank=None)
    for ev in events:
        exp(ev)
    out = exp.write()
    assert out is not None  # rank=None never filters
    return out
