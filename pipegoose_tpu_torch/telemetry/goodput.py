"""Goodput and incident ledgers: wall-clock attribution and MTTR.

The counterpart of ``pipegoose_tpu/telemetry/goodput.py``. A
:class:`GoodputLedger` attributes every replica-second of a serving fleet
to an exhaustive taxonomy:

==================  ====================================================
class               meaning
==================  ====================================================
productive          the tick made decode/prefill progress (goodput)
compile_warmup      progress, but a program family x width ran for the
                    FIRST time this tick (on the card: its first launch,
                    and at a process's first use the kernel build)
idle                SERVING, no work queued
probation           post-rejoin cooldown with no work (not yet routed)
admission_blocked   work queued but admission deferred (memory/capacity
                    — the ``Scheduler.admission_deferrals`` seam)
stall               work queued, no progress, no deferral (wedge-like)
suspect_probing     SUSPECT: heartbeat missed, probe backoff running
failed_quarantine   FAILED: quarantined until rejoin/scale-up
draining            DRAINING/STOPPED: planned migration wall
==================  ====================================================

Conservation: per replica, class-seconds sum to that replica's alive wall
within 1e-6, by construction (each replica carries ONE monotone
``last_mark`` and every attribution books ``t - last_mark`` into exactly
one class). :class:`Incident` records (crash, wedge, transfer flap, or an
explicitly opened episode) carry the detection latency (joined to the
flight recorder's ``chaos.injection`` records), MTTR, the capacity-gap
integral and the availability over the incident window.

It is driven from the control plane's tick loop (ROADMAP.md queue A, A12);
until the port has one the ledger is driven by hand, or reads a replica's
engine through :meth:`GoodputLedger.pre_tick` / :meth:`GoodputLedger.
classify`, which use the engine's ``programs_run`` and the scheduler's
``admission_deferrals``.

The trainer mirror is :class:`TrainerGoodput`: a callback partitioning
``fit`` wall into step compute, the first step, checkpoint save, restore
rewind and recovery replay, with the same conservation contract and an
incident per rewind. On the card the step class books the step's
launches: the callback runs before ``TelemetryCallback(fence=True)`` waits
for the card, so that wait lands in the next gap, booked as ``other``.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: the exhaustive taxonomy (order is the report/doc order)
CLASSES: Tuple[str, ...] = (
    "productive", "compile_warmup", "idle", "probation",
    "admission_blocked", "stall", "suspect_probing",
    "failed_quarantine", "draining",
)
#: classes counted as goodput; everything else is badput
GOOD_CLASSES: Tuple[str, ...] = ("productive",)

#: replica-state -> class used when booking wall OUTSIDE the tick loop
#: (between runs, at rejoin): the state the replica sat in IS the class
_STATE_CLASS = {
    "serving": "idle",
    "suspect": "suspect_probing",
    "failed": "failed_quarantine",
    "draining": "draining",
    "stopped": "draining",
}

#: episode ring bound per replica (newest kept; Perfetto export reads
#: these — a week-long fleet must not grow the band unboundedly)
MAX_EPISODES = 4096


class Incident:
    """One failure episode: detection -> capacity restored.

    ``detection_latency_ticks`` is the ring distance to the matching
    ``chaos.injection`` record (None when the failure was organic or no
    recorder is attached). ``mttr_s``/``mttr_ticks`` close at rejoin or
    scale-up; ``capacity_gap_integral_s`` accrues one replica-second
    per second the lost capacity stays uncompensated. ``slo_burn``
    snapshots the ledger's own availability ratio over the window.
    """

    def __init__(self, incident_id: int, kind: str, replica: str,
                 tick: int, t: float, reason: str = "",
                 detection_latency_ticks: Optional[int] = None,
                 injection_step: Optional[int] = None,
                 salvaged_uids: Iterable[int] = (),
                 resubmitted_uids: Iterable[int] = (),
                 completed_uids: Iterable[int] = (),
                 lost_uids: Iterable[int] = (),
                 capacity_gap: int = 0):
        self.id = incident_id
        self.kind = kind
        self.replica = replica
        self.tick_detected = tick
        self.t_detected = t
        self.reason = reason
        self.detection_latency_ticks = detection_latency_ticks
        self.injection_step = injection_step
        self.salvaged_uids = list(salvaged_uids)
        self.resubmitted_uids = list(resubmitted_uids)
        self.completed_uids = list(completed_uids)
        self.lost_uids = list(lost_uids)
        self.capacity_gap_at_open = capacity_gap
        self.capacity_gap_integral_s = 0.0
        self.open = True
        self.resolved_by: Optional[str] = None
        self.tick_resolved: Optional[int] = None
        self.mttr_s: Optional[float] = None
        self.mttr_ticks: Optional[int] = None
        self.events = 1                      # flap-burst merge counter
        self._burn_open: Tuple[float, float] = (0.0, 0.0)
        self.slo_burn: Optional[Dict[str, float]] = None

    def resolve(self, tick: int, t: float, resolved_by: str,
                burn_close: Tuple[float, float]) -> None:
        self.open = False
        self.resolved_by = resolved_by
        self.tick_resolved = tick
        self.mttr_s = max(t - self.t_detected, 0.0)
        self.mttr_ticks = max(tick - self.tick_detected, 0)
        bad0, wall0 = self._burn_open
        bad1, wall1 = burn_close
        dbad, dwall = bad1 - bad0, wall1 - wall0
        self.slo_burn = {
            "badput_s": round(dbad, 9),
            "wall_s": round(dwall, 9),
            "availability": (round(1.0 - dbad / dwall, 6)
                             if dwall > 0 else 1.0),
        }

    def as_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "kind": self.kind,
            "replica": self.replica,
            "tick_detected": self.tick_detected,
            "t_detected": self.t_detected,
            "reason": self.reason,
            "detection_latency_ticks": self.detection_latency_ticks,
            "injection_step": self.injection_step,
            "salvaged_uids": self.salvaged_uids,
            "resubmitted_uids": self.resubmitted_uids,
            "completed_uids": self.completed_uids,
            "lost_uids": self.lost_uids,
            "capacity_gap_at_open": self.capacity_gap_at_open,
            "capacity_gap_integral_s": round(
                self.capacity_gap_integral_s, 9),
            "open": self.open,
            "resolved_by": self.resolved_by,
            "tick_resolved": self.tick_resolved,
            "mttr_s": (None if self.mttr_s is None
                       else round(self.mttr_s, 9)),
            "mttr_ticks": self.mttr_ticks,
            "events": self.events,
            "slo_burn": self.slo_burn,
        }


class _ReplicaAccount:
    """One replica's wall account: a single monotone mark plus the
    per-class / per-state second buckets and the episode band."""

    __slots__ = ("name", "t0", "tick0", "last_mark", "classes",
                 "states", "episodes", "episodes_dropped", "closed")

    def __init__(self, name: str, t: float, tick: int):
        self.name = name
        self.t0 = t
        self.tick0 = tick
        self.last_mark = t
        self.classes: Dict[str, float] = {}
        self.states: Dict[str, float] = {}
        self.episodes: List[Dict[str, Any]] = []
        self.episodes_dropped = 0
        self.closed = False

    @property
    def alive_wall_s(self) -> float:
        return self.last_mark - self.t0

    def account(self, t: float, klass: str, state: str,
                tick: int) -> None:
        dt = t - self.last_mark
        self.classes[klass] = self.classes.get(klass, 0.0) + dt
        self.states[state] = self.states.get(state, 0.0) + dt
        eps = self.episodes
        if eps and eps[-1]["class"] == klass and eps[-1]["state"] == state:
            eps[-1]["t1"] = t
            eps[-1]["tick1"] = tick
            eps[-1]["ticks"] += 1
        else:
            eps.append({"class": klass, "state": state,
                        "t0": self.last_mark, "t1": t,
                        "tick0": tick, "tick1": tick, "ticks": 1})
            if len(eps) > MAX_EPISODES:
                del eps[0]
                self.episodes_dropped += 1
        self.last_mark = t

    def conservation(self) -> Dict[str, Any]:
        total = sum(self.classes.values())
        err = abs(total - self.alive_wall_s)
        return {"ok": err <= 1e-6, "error_s": err,
                "class_sum_s": total, "alive_wall_s": self.alive_wall_s}


class GoodputLedger:
    """The fleet wall-clock account + incident ledger (module
    docstring). Drive it from a control plane (A12) or by
    hand: :meth:`touch` opens/extends a replica account outside the
    tick loop, :meth:`account` books one tick's classification,
    :meth:`on_tick` accrues open incidents and publishes gauges."""

    def __init__(self, *, registry: Any = None,
                 max_incidents: int = 256):
        self.registry = registry
        self.replicas: Dict[str, _ReplicaAccount] = {}
        self.incidents: List[Incident] = []
        self.max_incidents = int(max_incidents)
        self.incidents_dropped = 0
        self._open: List[Incident] = []
        self._next_id = 0
        self._last_tick_t: Optional[float] = None
        self._flap_last_tick: Dict[str, int] = {}
        self._flap_last_inc: Dict[str, Incident] = {}
        self._claimed: set = set()          # id(ring record) already joined
        self._pub_bad = 0.0                 # counter high-water marks
        self._pub_wall = 0.0

    # -- wall attribution --------------------------------------------------

    def touch(self, name: str, t: float, state: str,
              tick: int = 0) -> None:
        """Open a replica account (run start, scale-up) or book the
        wall since its last mark into the class its CURRENT state
        implies (between-runs gaps, the moment before a rejoin flips
        FAILED back to SERVING) — conservation stays exact across every
        lifecycle path because the gap is booked, never skipped."""
        acct = self.replicas.get(name)
        if acct is None:
            self.replicas[name] = _ReplicaAccount(name, t, tick)
            return
        if t > acct.last_mark:
            acct.account(t, _STATE_CLASS.get(state, "idle"), state, tick)

    def account(self, name: str, t: float, klass: str, state: str,
                tick: int) -> None:
        """Book ``t - last_mark`` seconds of ``name``'s wall into
        ``klass`` (one call per replica per control-plane tick)."""
        acct = self.replicas.get(name)
        if acct is None:
            acct = self.replicas[name] = _ReplicaAccount(name, t, tick)
        acct.account(t, klass, state, tick)

    def classify(self, rep: Any, pre: Optional[Tuple[int, int, int]],
                 had_work: bool, ticked: bool, took: bool) -> str:
        """One tick's class for ``rep`` (a control-plane ``Replica``),
        priority-ordered; ``pre`` is the (programs_run,
        admission_deferrals, kv_fallbacks) snapshot taken before the
        tick so first-compiles and admission deferrals are deltas, not
        absolutes."""
        state = rep.state.value
        if state == "failed":
            return "failed_quarantine"
        if state in ("draining", "stopped"):
            return "draining"
        eng = rep.engine
        if ticked or took:
            if (pre is not None
                    and getattr(eng, "programs_run", 0) > pre[0]):
                return "compile_warmup"
            return "productive"
        if had_work:
            if state == "suspect":
                return "suspect_probing"
            if (pre is not None
                    and getattr(eng.sched, "admission_deferrals", 0)
                    > pre[1]):
                return "admission_blocked"
            return "stall"
        if rep.probation_ticks_left > 0:
            return "probation"
        if state == "suspect":
            return "suspect_probing"
        return "idle"

    def pre_tick(self, rep: Any) -> Tuple[int, int, int]:
        """Snapshot the per-tick delta sources before a replica
        ticks: programs run (compile detection), admission deferrals
        (memory/capacity blockage), KV-tier fallbacks (transfer
        flaps)."""
        eng = rep.engine
        kvt = getattr(eng, "kv_tier", None)
        return (getattr(eng, "programs_run", 0),
                getattr(eng.sched, "admission_deferrals", 0),
                getattr(kvt, "fallbacks", 0) if kvt is not None else 0)

    def on_tick(self, tick: int, t: float) -> None:
        """End-of-tick accrual: every open incident's capacity-gap
        integral grows by the tick wall, gauges refresh."""
        if self._open and self._last_tick_t is not None:
            dt = max(t - self._last_tick_t, 0.0)
            for inc in self._open:
                inc.capacity_gap_integral_s += dt
        self._last_tick_t = t
        self.publish()

    # -- incidents ---------------------------------------------------------

    def _join_injection(self, recorder: Any, victim: Optional[str],
                        kinds: Tuple[str, ...],
                        tick: int) -> Tuple[Optional[int], Optional[int]]:
        """Claim the newest UNCLAIMED ``chaos.injection`` ring record
        matching ``kinds`` (and ``victim`` when the record names one);
        returns (detection_latency_ticks, injection_step). The latency
        is the ring distance in ticks: detection tick minus the
        injection's own step."""
        if recorder is None:
            return None, None
        try:
            records = list(recorder.records)
        except Exception:  # noqa: BLE001 - forensics must not raise
            return None, None
        for rec in reversed(records):
            if not isinstance(rec, dict):
                continue
            if rec.get("kind") != "chaos.injection":
                continue
            if rec.get("injection") not in kinds:
                continue
            if (victim is not None and rec.get("victim") is not None
                    and rec.get("victim") != victim):
                continue
            if id(rec) in self._claimed:
                continue
            self._claimed.add(id(rec))
            step = rec.get("step")
            if step is None:
                return None, None
            return max(tick - int(step), 0), int(step)
        return None, None

    def open_incident(self, kind: str, replica: str, tick: int,
                      t: float, *, reason: str = "",
                      recorder: Any = None,
                      injection_kinds: Tuple[str, ...] = (),
                      salvaged_uids: Iterable[int] = (),
                      resubmitted_uids: Iterable[int] = (),
                      completed_uids: Iterable[int] = (),
                      lost_uids: Iterable[int] = (),
                      capacity_gap: int = 0) -> Incident:
        latency, inj_step = self._join_injection(
            recorder, replica, injection_kinds or (kind,), tick)
        inc = Incident(
            self._next_id, kind, replica, tick, t, reason=reason,
            detection_latency_ticks=latency, injection_step=inj_step,
            salvaged_uids=salvaged_uids, resubmitted_uids=resubmitted_uids,
            completed_uids=completed_uids, lost_uids=lost_uids,
            capacity_gap=capacity_gap,
        )
        self._next_id += 1
        inc._burn_open = self._burn_point()
        self.incidents.append(inc)
        if len(self.incidents) > self.max_incidents:
            dropped = self.incidents.pop(0)
            self.incidents_dropped += 1
            if dropped in self._open:      # pathological but bounded
                self._open.remove(dropped)
        self._open.append(inc)
        return inc

    def note_transfer_flap(self, replica: str, tick: int, t: float,
                           fallbacks: int,
                           recorder: Any = None) -> Optional[Incident]:
        """A KV transfer flap surfaced as ``fallbacks`` new restore
        fallbacks on ``replica`` this tick. Consecutive-tick bursts
        merge into ONE incident (a fail_times=3 fault is one flap, not
        three); the incident closes at detection — a fallback IS the
        recovery (the replica recomputed instead of pulling), so MTTR
        is zero and no capacity was lost."""
        last = self._flap_last_tick.get(replica)
        self._flap_last_tick[replica] = tick
        if last is not None and tick - last <= 1:
            prev = self._flap_last_inc.get(replica)
            if prev is not None:
                prev.events += fallbacks
                return None
        inc = self.open_incident(
            "transfer_flap", replica, tick, t,
            reason=f"{fallbacks} KV transfer fallback(s)",
            recorder=recorder, injection_kinds=("transfer_flap",),
        )
        inc.events = fallbacks
        self._open.remove(inc)
        inc.resolve(tick, t, "fallback", self._burn_point())
        self._flap_last_inc[replica] = inc
        return inc

    def resolve_incident(self, replica: Optional[str], tick: int,
                         t: float, resolved_by: str) -> Optional[Incident]:
        """Close the open incident for ``replica`` (rejoin), or the
        OLDEST open one (scale-up replaces capacity, not a specific
        replica). No-op when nothing is open."""
        inc = None
        if replica is not None:
            for cand in self._open:
                if cand.replica == replica:
                    inc = cand
                    break
        if inc is None and self._open:
            inc = self._open[0]
        if inc is None:
            return None
        self._open.remove(inc)
        inc.resolve(tick, t, resolved_by, self._burn_point())
        return inc

    @property
    def open_incidents(self) -> List[Incident]:
        return list(self._open)

    # -- rollups -----------------------------------------------------------

    def _burn_point(self) -> Tuple[float, float]:
        tot = self.totals()
        return tot["badput_seconds"], tot["wall_seconds"]

    def totals(self) -> Dict[str, Any]:
        classes: Dict[str, float] = {}
        wall = 0.0
        for acct in self.replicas.values():
            wall += sum(acct.classes.values())
            for k, v in acct.classes.items():
                classes[k] = classes.get(k, 0.0) + v
        good = sum(classes.get(k, 0.0) for k in GOOD_CLASSES)
        return {
            "wall_seconds": wall,
            "productive_seconds": good,
            "badput_seconds": wall - good,
            "fraction": good / wall if wall > 0 else 1.0,
            "classes": classes,
        }

    def state_seconds(self, name: str) -> Dict[str, float]:
        """Per-state dwell for one replica (``/debug/fleet`` rows)."""
        acct = self.replicas.get(name)
        if acct is None:
            return {}
        return {k: round(v, 9) for k, v in acct.states.items()}

    def conservation(self) -> Dict[str, Any]:
        per = {n: a.conservation() for n, a in self.replicas.items()}
        return {"ok": all(c["ok"] for c in per.values()),
                "max_error_s": max(
                    (c["error_s"] for c in per.values()), default=0.0),
                "replicas": per}

    def summary(self) -> Dict[str, Any]:
        """The compact rollup ``fleet_status()["goodput"]`` carries."""
        tot = self.totals()
        return {
            "goodput_fraction": round(tot["fraction"], 6),
            "productive_seconds": round(tot["productive_seconds"], 9),
            "wall_seconds": round(tot["wall_seconds"], 9),
            "badput_seconds": round(tot["badput_seconds"], 9),
            "classes": {k: round(v, 9)
                        for k, v in sorted(tot["classes"].items())},
            "conservation_ok": self.conservation()["ok"],
            "incidents": len(self.incidents),
            "open_incidents": len(self._open),
        }

    def report(self) -> Dict[str, Any]:
        """The full ``/debug/goodput`` payload: fleet rollup,
        per-replica class/state seconds + conservation verdicts, and
        every incident."""
        out = self.summary()
        out["replicas"] = {
            n: {
                "alive_wall_s": round(a.alive_wall_s, 9),
                "classes": {k: round(v, 9)
                            for k, v in sorted(a.classes.items())},
                "states": {k: round(v, 9)
                           for k, v in sorted(a.states.items())},
                "conservation": a.conservation(),
                "episodes": len(a.episodes),
                "episodes_dropped": a.episodes_dropped,
            }
            for n, a in self.replicas.items()
        }
        out["incident_log"] = [i.as_dict() for i in self.incidents]
        out["incidents_dropped"] = self.incidents_dropped
        return out

    def publish(self) -> None:
        """Refresh the registry surface: ``goodput.fraction`` /
        ``goodput.productive_seconds`` gauges, per-class badput gauges,
        and the MONOTONE ``goodput.{badput,wall}_seconds_total``
        counters the availability ratio SLO reads."""
        reg = self.registry
        if reg is None or not getattr(reg, "enabled", False):
            return
        tot = self.totals()
        reg.gauge("goodput.fraction").set(tot["fraction"])
        reg.gauge("goodput.productive_seconds").set(
            tot["productive_seconds"])
        reg.gauge("goodput.open_incidents").set(float(len(self._open)))
        reg.gauge("goodput.incidents_total").set(
            float(len(self.incidents)))
        for k in CLASSES:
            if k in GOOD_CLASSES:
                continue
            reg.gauge(f"goodput.badput.{k}_seconds").set(
                tot["classes"].get(k, 0.0))
        # counters only ever move forward: publish the delta since the
        # last publish (both sums are monotone in real time)
        dbad = tot["badput_seconds"] - self._pub_bad
        dwall = tot["wall_seconds"] - self._pub_wall
        if dbad > 0:
            reg.counter("goodput.badput_seconds_total").inc(dbad)
            self._pub_bad = tot["badput_seconds"]
        if dwall > 0:
            reg.counter("goodput.wall_seconds_total").inc(dwall)
            self._pub_wall = tot["wall_seconds"]


def availability_slo_target(target: float = 0.95) -> Any:
    """The availability ratio SLO over the ledger's counters: good =
    wall that wasn't badput. Feed it to an ``SLOMonitor`` over the
    registry the ledger publishes into (the control plane's own)."""
    from pipegoose_tpu_torch.telemetry.slo import SLOTarget

    return SLOTarget(
        name="fleet_availability", kind="ratio",
        bad_metric="goodput.badput_seconds_total",
        total_metric="goodput.wall_seconds_total",
        target=target,
    )


class TrainerGoodput:
    """The training-side mirror: partition ``fit`` wall into step
    compute vs compile, checkpoint save, restore rewind, and recovery
    replay — with the serving ledger's conservation contract over the
    fit wall and one incident per recovery rewind (MTTR = rewind
    detection -> the step counter re-reaching its pre-rewind
    high-water; every replayed step is badput).

    Order -100: its ``on_step_end`` stamps the step wall BEFORE
    ``AutoRecovery`` (order -10) can roll the step counter back and
    before ``CheckpointCallback`` (order 0) spends save wall — so the
    between-step gap that follows is attributable to them.
    """

    order = -100

    #: trainer-side taxonomy (conservation: these sum to fit wall)
    CLASSES: Tuple[str, ...] = (
        "step_compute", "compile_warmup", "rewind_replay",
        "checkpoint_save", "restore", "other",
    )
    GOOD: Tuple[str, ...] = ("step_compute",)

    def __init__(self, *, clock=time.perf_counter, registry: Any = None):
        self.clock = clock
        self.registry = registry
        self.classes: Dict[str, float] = {}
        self.incidents: List[Dict[str, Any]] = []
        self.replayed_steps = 0
        self._t_fit0: Optional[float] = None
        self._last: Optional[float] = None
        self._t_step0: Optional[float] = None
        self._high_water = 0
        self._next_expected: Optional[int] = None
        self._first_step_done = False
        self._ckpt_pending = False
        self._open: Optional[Dict[str, Any]] = None
        self._fit_wall: Optional[float] = None

    def _book(self, klass: str, dt: float) -> None:
        self.classes[klass] = self.classes.get(klass, 0.0) + dt

    # -- Callback protocol (duck-typed; order attribute sorts it) ----------

    def on_fit_start(self, trainer: Any) -> None:
        t = self.clock()
        self._t_fit0 = t
        self._last = t
        step = int(getattr(getattr(trainer, "state", None), "step", 0) or 0)
        self._high_water = step
        self._next_expected = None
        self._fit_wall = None

    def on_step_start(self, trainer: Any, step: int) -> None:
        t = self.clock()
        gap = max(t - (self._last if self._last is not None else t), 0.0)
        if (self._next_expected is not None
                and step < self._next_expected):
            # the step counter went BACKWARD between steps: recovery
            # restored an older checkpoint — the gap is restore wall,
            # and an incident opens with the pre-rewind high-water as
            # its recovery target
            self._book("restore", gap)
            if self._open is None:
                self._open = {
                    "kind": "recovery_rewind",
                    "step_detected": self._high_water,
                    "rewound_to": step,
                    "t_detected": t,
                    "replayed_steps": 0,
                    "open": True,
                    "mttr_s": None,
                }
                self.incidents.append(self._open)
        elif self._ckpt_pending:
            self._book("checkpoint_save", gap)
        else:
            self._book("other", gap)
        self._ckpt_pending = False
        self._t_step0 = t
        self._last = t

    def on_step_end(self, trainer: Any, step: int, loss: Any) -> None:
        t = self.clock()
        dt = max(t - (self._t_step0 if self._t_step0 is not None else t),
                 0.0)
        if step <= self._high_water and self._next_expected is not None:
            # re-running a step number already passed: rewind replay
            self._book("rewind_replay", dt)
            self.replayed_steps += 1
            if self._open is not None:
                self._open["replayed_steps"] += 1
        elif not self._first_step_done:
            self._book("compile_warmup", dt)
            self._first_step_done = True
        else:
            self._book("step_compute", dt)
        if (self._open is not None and step >= self._high_water):
            # recovered: the counter re-reached its pre-rewind mark
            self._open["open"] = False
            self._open["mttr_s"] = max(
                t - self._open["t_detected"], 0.0)
            self._open = None
        self._high_water = max(self._high_water, step)
        self._next_expected = step
        self._last = t

    def on_checkpoint(self, trainer: Any, step: int, path: str) -> None:
        self._ckpt_pending = True

    def _finish(self, trainer: Any) -> None:
        t = self.clock()
        if self._last is not None:
            self._book("other", max(t - self._last, 0.0))
            self._last = t
        if self._t_fit0 is not None:
            self._fit_wall = t - self._t_fit0
        reg = self.registry
        if reg is not None and getattr(reg, "enabled", False):
            rep = self.report()
            reg.gauge("train.goodput.fraction").set(
                rep["goodput_fraction"])
            for k, v in rep["classes"].items():
                reg.gauge(f"train.goodput.{k}_seconds").set(v)

    def on_fit_end(self, trainer: Any) -> None:
        self._finish(trainer)

    def on_fit_abort(self, trainer: Any, exc: BaseException) -> None:
        self._finish(trainer)

    # -- rollup ------------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        total = sum(self.classes.values())
        good = sum(self.classes.get(k, 0.0) for k in self.GOOD)
        wall = (self._fit_wall if self._fit_wall is not None
                else total)
        return {
            "fit_wall_s": round(wall, 9),
            "goodput_fraction": round(good / total, 6) if total else 1.0,
            "classes": {k: round(v, 9)
                        for k, v in sorted(self.classes.items())},
            "conservation_ok": abs(total - wall) <= 1e-6,
            "conservation_error_s": abs(total - wall),
            "replayed_steps": self.replayed_steps,
            "incidents": [dict(i) for i in self.incidents],
        }
