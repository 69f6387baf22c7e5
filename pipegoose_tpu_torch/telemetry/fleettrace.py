"""Fleet-wide distributed request tracing.

The counterpart of ``pipegoose_tpu/telemetry/fleettrace.py``. A
``RequestTracer`` stops at the replica boundary: each engine holds a
uid-keyed timeline fragment, and a request that crosses replicas leaves
one fragment per replica. ``FleetTracer`` joins them:

- ``on_ingress`` mints a monotonic ``trace_id`` onto the ``Request``, the
  one identity that survives every re-submission;
- the caller (the control plane, ROADMAP.md queue A, A12; until then a
  caller marking hops by hand) marks each hand-over in order: ``ingress``,
  ``pass``, ``pop``, ``route``, ``dispatch`` (its time IS the replica
  fragment's ``t_submit``, read back from the tracer), ``leave`` (drain or
  salvage seals the fragment), and terminally ``done`` / ``shed`` /
  ``lost``;
- stitching telescopes: consecutive marks bound the plane-side hops
  (``ingress_s``, ``ledger_s``, ``route_s``, ``dispatch_s``,
  ``salvage_s``), and each dispatch -> leave/done interval is covered by
  that leg's replica components, which sum to exactly the interval. With
  one clock everywhere, plane hops plus replica shares equal the fleet
  end-to-end time to 1e-6 by construction.

On top: ``fleet.attrib.*`` histograms, a :class:`TailSampler` keeping the
top-K slowest completed traces per objective (ttft, e2e) for black-box
exemplars, :func:`fleet_trace_events` (one merged Perfetto export with
flow arrows), and the ``/debug/trace`` / ``/debug/tail`` endpoints.
Host-side only.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from pipegoose_tpu_torch.telemetry.registry import MetricsRegistry, get_registry

#: plane-side hop taxonomy (additive with the replica components):
#: ``ingress_s``  submitted into the tenant ledger -> first dispatch
#:                pass (the plane had not yet looked)
#: ``ledger_s``   first pass -> DRR pop (tenant fair-share wait)
#: ``route_s``    pop -> routing decision (includes requeue_front
#:                retries when no replica could admit)
#: ``dispatch_s`` routing decision -> replica scheduler accept
#: ``salvage_s``  left a replica (drain migration or crash salvage)
#:                -> re-routed (the re-dispatch gap)
PLANE_HOPS = ("ingress_s", "ledger_s", "route_s", "dispatch_s",
              "salvage_s")

_MARK_TO_HOP = {
    "ingress": "ingress_s",
    "pass": "ledger_s",
    "pop": "route_s",
    "route": "dispatch_s",
    "leave": "salvage_s",
}

#: tail objectives the sampler keys on (None values are skipped — a
#: shed request has no TTFT and must not pollute the tail)
OBJECTIVES = ("ttft", "e2e")


class _Trace:
    """One request's fleet-level record: the ordered plane-side mark
    list plus one leg per replica visit (sealed fragments ride on the
    legs)."""

    __slots__ = ("trace_id", "tenant", "t0", "marks", "legs", "uid",
                 "t_done", "e2e_s", "ttft_s", "finish_reason", "lost")

    def __init__(self, trace_id: int, t0: float,
                 tenant: Optional[str]) -> None:
        self.trace_id = trace_id
        self.tenant = tenant
        self.t0 = t0
        self.marks: List[tuple] = [("ingress", t0, None)]
        self.legs: List[Dict[str, Any]] = []
        self.uid: Optional[int] = None    # final replica-side uid
        self.t_done: Optional[float] = None
        self.e2e_s: Optional[float] = None
        self.ttft_s: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.lost = False

    def hops(self) -> Dict[str, float]:
        """Plane-side hop durations from the telescoping mark walk.
        Each dispatch->next-mark interval belongs to the replica
        fragment (its components sum to exactly that interval), so it
        is deliberately NOT booked here."""
        out = {h: 0.0 for h in PLANE_HOPS}
        for (kind, t, _arg), (_nk, nt, _na) in zip(self.marks,
                                                   self.marks[1:]):
            hop = _MARK_TO_HOP.get(kind)
            if hop is not None:
                out[hop] += max(nt - t, 0.0)
        return out

    def replica_s(self) -> float:
        return sum(sum(leg["components"].values()) for leg in self.legs
                   if leg.get("components"))

    def dominant(self) -> tuple:
        """(label, seconds) of the single largest hop — plane hops by
        name, replica components as ``<replica>:<component>`` — the
        exemplar's one-line verdict."""
        best, best_s = "ingress_s", 0.0
        for hop, s in self.hops().items():
            if s > best_s:
                best, best_s = hop, s
        for leg in self.legs:
            for comp, s in (leg.get("components") or {}).items():
                if s > best_s:
                    best, best_s = f"{leg['replica']}:{comp}", s
        return best, best_s

    def attribution(self) -> Dict[str, Any]:
        """JSON-able stitched record (the ``/debug/trace`` row)."""
        hops = self.hops()
        rep_s = self.replica_s()
        dom, dom_s = self.dominant()
        total = sum(hops.values()) + rep_s
        return {
            "trace_id": self.trace_id,
            "uid": self.uid,
            "tenant": self.tenant,
            "t0": self.t0,
            "t_done": self.t_done,
            "e2e_s": self.e2e_s,
            "ttft_s": self.ttft_s,
            "finish_reason": self.finish_reason,
            "lost": self.lost,
            "hops": hops,
            "replica_s": rep_s,
            "stitched_total_s": total,
            "legs": [
                {
                    "replica": leg["replica"],
                    "uid": leg.get("uid"),
                    "t_route": leg.get("t_route"),
                    "t_dispatch": leg.get("t_dispatch"),
                    "t_leave": leg.get("t_leave"),
                    "leave_reason": leg.get("leave_reason"),
                    "components": dict(leg.get("components") or {}),
                }
                for leg in self.legs
            ],
            "dominant_hop": dom,
            "dominant_s": dom_s,
            "dominant_share": (dom_s / total if total > 0 else 0.0),
        }


class TailSampler:
    """Top-K slowest completed fleet traces per objective. Bounded and
    cheap: insertion keeps a small sorted list per objective, so the
    black-box embed is O(K) regardless of traffic."""

    def __init__(self, k: int = 8):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self._tails: Dict[str, List[tuple]] = {o: [] for o in OBJECTIVES}

    def offer(self, trace: "_Trace") -> None:
        for obj in OBJECTIVES:
            value = trace.ttft_s if obj == "ttft" else trace.e2e_s
            if value is None:
                continue
            tail = self._tails[obj]
            tail.append((float(value), trace))
            tail.sort(key=lambda pair: -pair[0])
            del tail[self.k:]

    def top(self, objective: str, n: Optional[int] = None) -> List[tuple]:
        if objective not in self._tails:
            raise ValueError(
                f"unknown objective {objective!r} (have {OBJECTIVES})"
            )
        tail = self._tails[objective]
        return tail[: (len(tail) if n is None else n)]

    def payload(self, top_n: Optional[int] = None) -> Dict[str, Any]:
        return {
            obj: [
                {"value_s": v, **tr.attribution()}
                for v, tr in self.top(obj, top_n)
            ]
            for obj in OBJECTIVES
        }


class FleetTracer:
    """Cross-replica trace stitcher (module docstring). The control
    plane drives the ``on_*`` hooks single-threaded from its run loop;
    the lock exists for the ops-server read path.

    ``registry``: the ``fleet.attrib.*`` histograms land here (default
    the global registry). ``keep_completed`` bounds the stitched-trace
    history the debug endpoints read; ``tail_k`` sizes the per-
    objective tail sampler.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 keep_completed: int = 256, tail_k: int = 8,
                 clock: Callable[[], float] = time.perf_counter):
        if keep_completed < 1:
            raise ValueError(
                f"keep_completed must be >= 1, got {keep_completed}"
            )
        self.registry = registry if registry is not None else get_registry()
        self.clock = clock
        self.tail = TailSampler(tail_k)
        self.active: Dict[int, _Trace] = {}
        self.completed: deque = deque(maxlen=int(keep_completed))
        self.tracers: Dict[str, Any] = {}     # replica name -> RequestTracer
        self._next_trace_id = 1
        self._uid_to_trace: Dict[int, int] = {}   # last dispatch wins
        self._awaiting_pass: set = set()
        self._wall_offset = time.time() - clock()
        self._lock = threading.Lock()
        reg = self.registry
        self._h_ingress = reg.histogram("fleet.attrib.ingress_seconds")
        self._h_ledger = reg.histogram("fleet.attrib.ledger_seconds")
        self._h_route = reg.histogram("fleet.attrib.route_seconds")
        self._h_dispatch = reg.histogram("fleet.attrib.dispatch_seconds")
        self._h_replica = reg.histogram("fleet.attrib.replica_seconds")
        self._h_salvage = reg.histogram("fleet.attrib.salvage_seconds")
        self._c_traces = reg.counter("fleet.attrib.traces_total")
        self._c_legs = reg.counter("fleet.attrib.legs_total")
        self._c_lost = reg.counter("fleet.attrib.lost_total")

    # -- plumbing ----------------------------------------------------------

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Re-point at the plane's run clock (one time domain fleet-
        wide) and re-anchor the Perfetto wall offset."""
        if clock is self.clock:
            return
        self.clock = clock
        self._wall_offset = time.time() - clock()

    @property
    def wall_offset(self) -> float:
        return self._wall_offset

    def register_replica(self, name: str, tracer: Any) -> None:
        """Bind a replica's ``RequestTracer`` — dispatch marks read the
        fragment's ``t_submit`` from it and leave marks seal fragments
        out of it."""
        with self._lock:
            self.tracers[name] = tracer

    def reset(self) -> None:
        """Drop every stitched trace (active, completed ring, tail,
        uid index) but keep replica registrations and the trace-id
        sequence — a benchmark's traced arm resets between the
        warmup and the measured replay so warmup traces never land in
        the reported attribution."""
        with self._lock:
            self.active.clear()
            self.completed.clear()
            self.tail = TailSampler(self.tail.k)
            self._uid_to_trace.clear()
            self._awaiting_pass.clear()

    # -- plane hooks (ControlPlane drives these, in causal order) ----------

    def on_ingress(self, req: Any, t: float) -> int:
        """Mint the trace at the fleet front door. ``t`` must be the
        same float the plane stamps into ``req.t_submit`` — the trace's
        t0 IS the user-visible clock start."""
        with self._lock:
            trace_id = self._next_trace_id
            self._next_trace_id += 1
            req.trace_id = trace_id
            self.active[trace_id] = _Trace(
                trace_id, t, getattr(req, "tenant", None)
            )
            self._awaiting_pass.add(trace_id)
            return trace_id

    def on_dispatch_pass(self, t: float) -> None:
        """Top of a dispatch pass: every trace not yet popped closes
        its ingress hop here (first pass wins)."""
        with self._lock:
            for trace_id in self._awaiting_pass:
                trace = self.active.get(trace_id)
                if trace is not None:
                    trace.marks.append(("pass", t, None))
            self._awaiting_pass.clear()

    def on_ledger_pop(self, req: Any, t: float) -> None:
        """DRR batch popped the request off its tenant FIFO (first pop
        wins — a requeue_front retry books as route_s, the wait it
        actually is)."""
        trace = self.active.get(getattr(req, "trace_id", None))
        if trace is None:
            return
        with self._lock:
            if not any(kind == "pop" for kind, _t, _a in trace.marks):
                trace.marks.append(("pop", t, None))

    def on_routed(self, req: Any, t: float, replica: str) -> None:
        """Router picked a replica: opens a new leg (and, after a
        leave, closes the salvage hop)."""
        trace = self.active.get(getattr(req, "trace_id", None))
        if trace is None:
            return
        with self._lock:
            trace.marks.append(("route", t, replica))
            trace.legs.append({"replica": replica, "t_route": t})
            self._c_legs.inc()

    def on_dispatched(self, req: Any, replica: str) -> None:
        """Replica scheduler accepted the request: close the dispatch
        hop at the FRAGMENT's ``t_submit`` (read back from the replica
        tracer, never re-sampled — the mark and the fragment share one
        float, which is what makes the stitched sum exact)."""
        trace = self.active.get(getattr(req, "trace_id", None))
        if trace is None:
            return
        with self._lock:
            tracer = self.tracers.get(replica)
            t = None
            if tracer is not None:
                tl = tracer.in_flight.get(
                    (trace.trace_id, req.uid)
                )
                if tl is not None:
                    t = tl.t_submit
            if t is None and trace.legs:         # untraced replica
                t = trace.legs[-1]["t_route"]
            trace.marks.append(("dispatch", t, replica))
            if trace.legs and trace.legs[-1]["replica"] == replica:
                trace.legs[-1]["uid"] = req.uid
                trace.legs[-1]["t_dispatch"] = t
            trace.uid = req.uid
            self._uid_to_trace[req.uid] = trace.trace_id

    def on_leave(self, req: Any, replica: str, t: float,
                 reason: str) -> None:
        """The request left ``replica`` without finishing (drain
        migration or crash salvage): SEAL the fragment at ``t`` — its
        open phase (stall after a preempt, queue after a withdraw, or
        whatever a degraded harvest left) closes into its component, so
        the leg's components sum to exactly t_leave - t_dispatch."""
        trace = self.active.get(getattr(req, "trace_id", None))
        if trace is None:
            return
        with self._lock:
            components = None
            tracer = self.tracers.get(replica)
            if tracer is not None:
                tl = tracer.in_flight.pop(
                    (trace.trace_id, req.uid), None
                )
                if tl is not None:
                    tl.transition(None, t)
                    components = dict(tl.components)
                    for leg in reversed(trace.legs):
                        if (leg["replica"] == replica
                                and leg.get("components") is None):
                            leg["timeline"] = tl
                            break
            for leg in reversed(trace.legs):
                if (leg["replica"] == replica
                        and leg.get("components") is None):
                    leg["components"] = components or {}
                    leg["t_leave"] = t
                    leg["leave_reason"] = reason
                    break
            trace.marks.append(("leave", t, reason))

    def _final_fragment(self, trace: "_Trace") -> Optional[Any]:
        """The finishing leg's completed timeline, from its replica
        tracer's completed ring (``on_done``/``on_shed`` moved it there
        during the tick that finished the request)."""
        if not trace.legs:
            return None
        leg = trace.legs[-1]
        tracer = self.tracers.get(leg["replica"])
        if tracer is None:
            return None
        tl = tracer.in_flight.get((trace.trace_id, leg.get("uid")))
        if tl is not None:
            return tl
        for tl in reversed(tracer.completed):
            if (getattr(tl, "trace_id", None) == trace.trace_id
                    and tl.uid == leg.get("uid")):
                return tl
        return None

    def on_finished(self, req: Any, out: Any) -> None:
        """Terminal stitch: attach the final fragment, walk the marks
        into hops, observe the fleet histograms, offer the trace to the
        tail sampler."""
        with self._lock:
            trace = self.active.pop(getattr(req, "trace_id", None), None)
            if trace is None:
                return
            self._awaiting_pass.discard(trace.trace_id)
            tl = self._final_fragment(trace)
            if tl is not None and trace.legs:
                leg = trace.legs[-1]
                if leg.get("components") is None:
                    leg["components"] = dict(tl.components)
                    leg["timeline"] = tl
            t_done = getattr(tl, "t_done", None)
            if t_done is None:
                t_done = getattr(req, "t_done", None)
            if t_done is None:                # no fragment, no stamp
                t_done = self.clock()
            trace.t_done = t_done
            trace.marks.append(("done", t_done, None))
            trace.finish_reason = (getattr(out, "finish_reason", None)
                                   or getattr(req, "finish_reason", None))
            trace.e2e_s = getattr(out, "e2e_latency_s", None)
            if trace.e2e_s is None:
                trace.e2e_s = t_done - trace.t0
            trace.ttft_s = getattr(out, "ttft_s", None)
            self.completed.append(trace)
            if trace.finish_reason != "shed":
                self.tail.offer(trace)
            if len(self._uid_to_trace) > 8 * (self.completed.maxlen or 1):
                # bounded debug index: keep only uids whose trace is
                # still reachable (active, completed ring, or tail)
                live = {t.trace_id for t in self.active.values()}
                live.update(t.trace_id for t in self.completed)
                self._uid_to_trace = {
                    u: tid for u, tid in self._uid_to_trace.items()
                    if tid in live
                }
            hops = trace.hops()
        self._h_ingress.observe(hops["ingress_s"])
        self._h_ledger.observe(hops["ledger_s"])
        self._h_route.observe(hops["route_s"])
        self._h_dispatch.observe(hops["dispatch_s"])
        self._h_salvage.observe(hops["salvage_s"])
        self._h_replica.observe(trace.replica_s())
        self._c_traces.inc()

    def on_plane_shed(self, req: Any, t: float) -> None:
        """Ledger-level shed (never dispatched): the trace finalizes
        with its whole life in plane hops; the tail sampler never sees
        it (a shed has no serving latency to exemplify)."""
        with self._lock:
            trace = self.active.pop(getattr(req, "trace_id", None), None)
            if trace is None:
                return
            self._awaiting_pass.discard(trace.trace_id)
            trace.marks.append(("shed", t, None))
            trace.t_done = t
            trace.finish_reason = "shed"
            trace.e2e_s = t - trace.t0
            self.completed.append(trace)
        self._c_traces.inc()

    def on_lost(self, req: Any, t: float) -> None:
        """Salvage could not recover the request (the degraded path's
        terminal failure): the trace completes flagged ``lost`` so the
        black box can still show where it had gotten to."""
        with self._lock:
            trace = self.active.pop(getattr(req, "trace_id", None), None)
            if trace is None:
                return
            self._awaiting_pass.discard(trace.trace_id)
            trace.marks.append(("lost", t, None))
            trace.t_done = t
            trace.lost = True
            self.completed.append(trace)
        self._c_lost.inc()

    # -- views -------------------------------------------------------------

    def trace_json(self, uid: Optional[int] = None,
                   trace_id: Optional[int] = None) -> Optional[Dict]:
        """One stitched trace by uid (any leg's) or trace_id — the
        ``/debug/trace`` payload; None when unknown."""
        with self._lock:
            if trace_id is None and uid is not None:
                trace_id = self._uid_to_trace.get(uid)
                if trace_id is None:
                    for trace in list(self.completed) + list(
                            self.active.values()):
                        if any(leg.get("uid") == uid
                               for leg in trace.legs):
                            trace_id = trace.trace_id
                            break
            if trace_id is None:
                return None
            trace = self.active.get(trace_id)
            if trace is None:
                for done in reversed(self.completed):
                    if done.trace_id == trace_id:
                        trace = done
                        break
            return trace.attribution() if trace is not None else None

    def tail_payload(self, top_n: Optional[int] = None) -> Dict[str, Any]:
        """Top-K slowest stitched traces per objective (the
        ``/debug/tail`` payload)."""
        with self._lock:
            return self.tail.payload(top_n)

    def exemplar(self, objective: str = "e2e") -> Optional[Dict[str, Any]]:
        """THE exemplar for a black box: the single slowest completed
        trace on ``objective``, its dominant hop named up front."""
        with self._lock:
            top = self.tail.top(objective, 1)
            if not top:
                return None
            value, trace = top[0]
            row = trace.attribution()
            return {
                "objective": objective,
                "value_s": value,
                "dominant_hop": row["dominant_hop"],
                "dominant_s": row["dominant_s"],
                "dominant_share": row["dominant_share"],
                "trace": row,
            }

    def blackbox_payload(self, top_n: int = 3) -> Dict[str, Any]:
        """The flight-recorder embed: every still-active trace (a stuck
        dump must name where each in-flight request IS) plus the tail
        exemplars."""
        with self._lock:
            return {
                "active": [t.attribution() for t in self.active.values()],
                "tail": self.tail.payload(top_n),
            }

    def summary_payload(self, top_n: int = 3) -> Dict[str, Any]:
        """Per-hop p50/p99 over the completed ring + top-N exemplars
        per objective — a benchmark's fleet-trace block."""
        with self._lock:
            done = [t for t in self.completed if not t.lost]
            rows = [(t.hops(), t.replica_s()) for t in done]
            tail = self.tail.payload(top_n)
        per_hop: Dict[str, Dict[str, float]] = {}
        for hop in PLANE_HOPS + ("replica_s",):
            values = sorted(
                (h[hop] if hop != "replica_s" else rep)
                for h, rep in rows
            )
            if values:
                per_hop[hop] = {
                    "p50": values[int(0.50 * (len(values) - 1))],
                    "p99": values[int(0.99 * (len(values) - 1))],
                    "mean": sum(values) / len(values),
                }
            else:
                per_hop[hop] = {"p50": 0.0, "p99": 0.0, "mean": 0.0}
        return {
            "traces": len(rows),
            "per_hop": per_hop,
            "tail_exemplars": tail,
        }


# -- merged Perfetto export -------------------------------------------------


def fleet_trace_events(fleet: FleetTracer) -> List[dict]:
    """Render the whole fleet as one Perfetto trace: a plane process
    (one track of plane-side hop slices per trace), one process per
    registered replica (their full per-slot timelines, via
    :func:`request_trace_events` at disjoint pids), and flow arrows
    binding each dispatch slice to the fragment it started
    (dispatch->admit), each handoff's transfer_start->transfer_done,
    and each kv-tier pull's hinted source to its destination import."""
    from pipegoose_tpu_torch.telemetry.chrometrace import (
        PID_PLANE,
        REPLICA_PID_BASE,
    )
    from pipegoose_tpu_torch.telemetry.reqtrace import request_trace_events

    off = fleet.wall_offset
    hops_tid = 1

    def us(t: float) -> float:
        return (t + off) * 1e6

    events: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": PID_PLANE,
         "args": {"name": "control plane (fleet hops)"}},
        {"name": "thread_name", "ph": "M", "pid": PID_PLANE,
         "tid": hops_tid, "args": {"name": "plane hops"}},
    ]
    with fleet._lock:
        replica_pids = {name: REPLICA_PID_BASE + i
                        for i, name in enumerate(sorted(fleet.tracers))}
        traces = list(fleet.completed) + list(fleet.active.values())
        tracers = dict(fleet.tracers)
    _HOP_LABEL = {
        "ingress": "ingress", "pass": "ledger", "pop": "route",
        "route": "dispatch", "dispatch": "replica", "leave": "salvage",
    }
    flow_id = 0
    for trace in traces:
        tid = trace.trace_id
        leg_i = 0
        for (kind, t, arg), (_nk, nt, _na) in zip(trace.marks,
                                                  trace.marks[1:]):
            label = _HOP_LABEL.get(kind)
            if label is None or t is None or nt is None:
                continue
            events.append({
                "name": f"trace{tid} {label}",
                "cat": f"fleet.{label}", "ph": "X", "ts": us(t),
                "dur": max(nt - t, 0.0) * 1e6, "pid": PID_PLANE,
                "tid": hops_tid,
                "args": {"trace_id": tid, "replica": arg}
                if isinstance(arg, str) else {"trace_id": tid},
            })
            if kind == "dispatch" and isinstance(arg, str):
                # dispatch -> admit flow arrow into the replica process
                pid_to = replica_pids.get(arg)
                leg = (trace.legs[leg_i]
                       if leg_i < len(trace.legs) else None)
                leg_i += 1
                if pid_to is None:
                    continue
                flow_id += 1
                common = {"cat": "fleet.flow",
                          "name": f"trace{tid} dispatch",
                          "id": flow_id}
                events.append({**common, "ph": "s", "pid": PID_PLANE,
                               "tid": hops_tid, "ts": us(t)})
                events.append({**common, "ph": "f", "bp": "e",
                               "pid": pid_to, "tid": 1_000,
                               "ts": us(t)})
                if leg is not None:
                    tl = leg.get("timeline")
                    if tl is None:
                        tl = _completed_fragment(tracers.get(arg),
                                                 tid, leg.get("uid"))
                    if tl is not None:
                        events.extend(_fragment_flows(
                            tl, tid, pid_to, replica_pids, us,
                            start_id=flow_id * 1_000))
    for name, pid in replica_pids.items():
        tracer = tracers[name]
        events.extend(request_trace_events(
            tracer, pid=pid, process_name=f"replica {name}"
        ))
    return events


def _completed_fragment(tracer, trace_id, uid):
    if tracer is None:
        return None
    for tl in reversed(tracer.completed):
        if getattr(tl, "trace_id", None) == trace_id and tl.uid == uid:
            return tl
    return None


def _fragment_flows(tl, trace_id, pid, replica_pids, us, *,
                    start_id: int) -> List[dict]:
    """Flow arrows INSIDE one replica fragment: disagg/pull
    transfer_start -> transfer_done (handoff->transfer->admit), and
    pull_hint's named peer -> the destination's import completion
    (pull source -> destination)."""
    events: List[dict] = []
    t_start = None
    hint_peer = None
    t_hint = None
    fid = start_id
    for ev in tl.events:
        kind = ev.get("kind")
        if kind == "transfer_start":
            t_start = ev["t"]
        elif kind == "pull_hint":
            hint_peer, t_hint = ev.get("peer"), ev["t"]
        elif kind in ("transfer_done", "restore_done"):
            t = ev["t"]
            if t_start is not None and kind == "transfer_done":
                fid += 1
                common = {"cat": "fleet.flow",
                          "name": f"trace{trace_id} transfer",
                          "id": fid}
                events.append({**common, "ph": "s", "pid": pid,
                               "tid": 2_000, "ts": us(t_start)})
                events.append({**common, "ph": "f", "bp": "e",
                               "pid": pid, "tid": 2_000, "ts": us(t)})
                t_start = None
            if hint_peer is not None:
                pid_src = replica_pids.get(hint_peer)
                if pid_src is not None:
                    fid += 1
                    common = {"cat": "fleet.flow",
                              "name": f"trace{trace_id} pull "
                                      f"{hint_peer}",
                              "id": fid}
                    events.append({**common, "ph": "s", "pid": pid_src,
                                   "tid": 1_000, "ts": us(t_hint)})
                    events.append({**common, "ph": "f", "bp": "e",
                                   "pid": pid, "tid": 2_000,
                                   "ts": us(t)})
                hint_peer = None
    return events
