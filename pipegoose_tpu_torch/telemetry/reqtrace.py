"""Request-scoped tracing and tail-latency attribution for serving.

The counterpart of ``pipegoose_tpu/telemetry/reqtrace.py``.
``RequestTracer`` keeps a bounded event timeline per request, fed by the
engine's tick path (submit, admit, each prefill chunk with its cache-hit
token count, copy-on-write copies, first token, decode ticks, speculative
cycles, preempt and re-admit, done), and attributes each request's latency
to additive wall-clock components:

- ``queue_s``     submit -> first admission
- ``prefill_s``   admitted, prefill in flight (a re-prefill after a
                  preemption included)
- ``decode_s``    first token (or resume) -> done or preempt
- ``stall_s``     preempted, waiting to be re-admitted
- ``restore_s`` / ``transfer_s``  the KV-tier and disaggregation phases
                  (always present, 0.0 until those layers drive them)

The components are contiguous lifecycle segments, closed at each phase
transition, so they sum to the measured submit -> done time by
construction. ``ttft_components`` snapshots them at the first token, so
"was this request's TTFT queueing or compute" is a field lookup. The cache
saving is estimated from the per-token prefill rate this request paid:
``cache_saved_est_s = prefill_s * hit_tokens / forwarded_tokens``.

Completed timelines land in ``serving.attrib.*`` histograms, a bounded
``completed`` ring (the flight recorder embeds the newest in black boxes,
so a ``decode_stall`` box names the stuck request) and
:func:`request_trace_events`, which renders them as Perfetto rows: one
track per decode slot, with markers for preempt, copy-on-write and
speculative rejects.

Off by default: the engine holds ``tracer=None`` and its hot path then
pays one attribute read and branch per site. The per-request event ring is
bounded (``max_events``; drops are counted, the attribution never reads
the ring). Host-side only: no hook launches work on the device. The
engine reads a traced ``t1`` after the token read that ends each prefill
and decode span, so ``dur_s`` covers the card's work, not the launches.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from pipegoose_tpu_torch.telemetry.registry import MetricsRegistry, get_registry

#: lifecycle phases a request's wall clock is attributed to (additive).
#: ``transfer_s`` is the disaggregated-serving phase (serving/disagg/):
#: prefill handed off on one pool, decode not yet admitted on the other
#: — the critical-path share of the cross-pool KV page streaming.
#: ``restore_s`` is the kv_tier phase (serving/kv_tier/): host-tier
#: slabs scattering back into pool pages before admission (a
#: cross-replica pull books as ``transfer_s`` — it rides the same
#: staging path as disagg). Both are always present (0.0 when unused)
#: so the sum-to-e2e contract is one invariant everywhere.
COMPONENTS = ("queue_s", "prefill_s", "restore_s", "transfer_s",
              "decode_s", "stall_s")

_PHASE_TO_COMPONENT = {
    "queue": "queue_s",
    "prefill": "prefill_s",
    "restore": "restore_s",
    "transfer": "transfer_s",
    "decode": "decode_s",
    "stall": "stall_s",
}


class RequestTimeline:
    """One request's bounded event ring + phase-attribution accumulators.

    Events are forensics (rendered by :func:`request_trace_events`,
    embedded in black boxes); the ``components`` dict is accounting and
    is updated incrementally at every phase transition, so it stays
    exact even after the ring drops old events.
    """

    __slots__ = (
        "uid", "trace_id", "tenant", "prompt_len", "max_new_tokens",
        "slot", "events", "dropped",
        "t_submit", "t_first_token", "t_done", "finish_reason",
        "components", "ttft_s", "ttft_components", "e2e_s",
        "hit_tokens", "prefill_tokens", "prefill_chunks", "cow_copies",
        "decode_ticks", "decode_compute_s", "prefill_compute_s",
        "spec_drafted", "spec_accepted", "preemptions",
        "transfer_chunks", "transfer_pages", "transfer_bytes",
        "transfer_compute_s",
        "restore_pages", "restore_bytes", "restore_compute_s",
        "cache_saved_est_s", "_phase", "_t_phase",
    )

    def __init__(self, uid: int, max_events: int,
                 trace_id: Optional[int] = None):
        self.uid = uid
        # fleet-trace join key (telemetry/fleettrace.py): None outside
        # a control plane. uids are replica-local AND deliberately
        # reused on salvage, so cross-replica stitching keys on this.
        self.trace_id = trace_id
        self.tenant: Optional[str] = None
        self.prompt_len = 0
        self.max_new_tokens = 0
        self.slot: Optional[int] = None
        self.events: deque = deque(maxlen=max_events)
        self.dropped = 0
        self.t_submit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        self.finish_reason: Optional[str] = None
        self.components: Dict[str, float] = {c: 0.0 for c in COMPONENTS}
        self.ttft_s: Optional[float] = None
        self.ttft_components: Optional[Dict[str, float]] = None
        self.e2e_s: Optional[float] = None
        self.hit_tokens = 0
        self.prefill_tokens = 0        # tokens actually forwarded
        self.prefill_chunks = 0
        self.cow_copies = 0
        self.decode_ticks = 0
        self.decode_compute_s = 0.0    # measured device-work share
        self.prefill_compute_s = 0.0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.preemptions = 0
        self.transfer_chunks = 0       # cross-pool page shipments
        self.transfer_pages = 0
        self.transfer_bytes = 0        # wire bytes (q+scale / bf16 / fp)
        self.transfer_compute_s = 0.0  # measured export+import share
        self.restore_pages = 0         # host-tier pages scattered back
        self.restore_bytes = 0
        self.restore_compute_s = 0.0
        self.cache_saved_est_s = 0.0
        self._phase: Optional[str] = None
        self._t_phase: Optional[float] = None

    # -- recording ---------------------------------------------------------

    def add_event(self, kind: str, t: float, **fields: Any) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1  # deque drops the oldest on append
        self.events.append({"t": t, "kind": kind, **fields})

    def transition(self, phase: Optional[str], t: float) -> None:
        """Close the current phase into its component and open ``phase``."""
        if self._phase is not None and self._t_phase is not None:
            self.components[_PHASE_TO_COMPONENT[self._phase]] += max(
                t - self._t_phase, 0.0
            )
        self._phase, self._t_phase = phase, t

    @property
    def phase(self) -> Optional[str]:
        return self._phase

    # -- views -------------------------------------------------------------

    def attribution(self) -> Dict[str, Any]:
        """JSON-able attribution record (the ``serving.attrib.*`` shape)."""
        out: Dict[str, Any] = {
            "uid": self.uid,
            "trace_id": self.trace_id,
            "tenant": self.tenant,
            "prompt_len": self.prompt_len,
            "components": dict(self.components),
            "ttft_s": self.ttft_s,
            "ttft_components": (
                dict(self.ttft_components) if self.ttft_components else None
            ),
            "e2e_s": self.e2e_s,
            "hit_tokens": self.hit_tokens,
            "prefill_tokens": self.prefill_tokens,
            "cache_saved_est_s": self.cache_saved_est_s,
            "preemptions": self.preemptions,
            "finish_reason": self.finish_reason,
        }
        return out

    def to_json(self) -> Dict[str, Any]:
        return {
            **self.attribution(),
            "max_new_tokens": self.max_new_tokens,
            "slot": self.slot,
            "phase": self._phase,
            "t_submit": self.t_submit,
            "t_first_token": self.t_first_token,
            "t_done": self.t_done,
            "prefill_chunks": self.prefill_chunks,
            "cow_copies": self.cow_copies,
            "transfer_chunks": self.transfer_chunks,
            "transfer_pages": self.transfer_pages,
            "transfer_bytes": self.transfer_bytes,
            "transfer_compute_s": self.transfer_compute_s,
            "restore_pages": self.restore_pages,
            "restore_bytes": self.restore_bytes,
            "restore_compute_s": self.restore_compute_s,
            "decode_ticks": self.decode_ticks,
            "prefill_compute_s": self.prefill_compute_s,
            "decode_compute_s": self.decode_compute_s,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "events_dropped": self.dropped,
            "events": list(self.events),
        }


class NullRequestTracer:
    """The hook contract, as a no-op base class: subclass this (or
    :class:`RequestTracer`) to build a custom tracer and override only
    the hooks you need. The engine itself holds ``None`` when tracing
    is off and branch-guards every call site, so the disabled cost is
    one attribute read + branch — the same budget as a disabled
    registry metric (guard-tested in tests/telemetry/
    test_reqtrace.py)."""

    __slots__ = ()

    enabled = False

    def set_clock(self, clock: Callable[[], float]) -> None:
        pass

    def on_submit(self, req: Any, t: float) -> None:
        pass

    def on_admit(self, req: Any, t: float) -> None:
        pass

    def on_preempt(self, req: Any, t: Optional[float] = None) -> None:
        pass

    def on_cow(self, req: Any, t: float) -> None:
        pass

    def on_prefill_chunk(self, req: Any, t: float, dur_s: float,
                         tokens: int) -> None:
        pass

    def on_first_token(self, req: Any, t: float) -> None:
        pass

    def on_resume(self, req: Any, t: float) -> None:
        pass

    def on_decode_tick(self, req: Any, t: float, dur_s: float,
                       tokens: int = 1) -> None:
        pass

    def on_spec(self, req: Any, t: float, dur_s: float, drafted: int,
                accepted: int) -> None:
        pass

    def on_transfer_start(self, req: Any, t: float) -> None:
        pass

    def on_transfer_chunk(self, req: Any, t: float, dur_s: float,
                          tokens: int, pages: int, nbytes: int) -> None:
        pass

    def on_transfer_done(self, req: Any, t: float,
                         resume: str = "decode") -> None:
        pass

    def on_restore_start(self, req: Any, t: float) -> None:
        pass

    def on_restore_chunk(self, req: Any, t: float, dur_s: float,
                         tokens: int, pages: int, nbytes: int) -> None:
        pass

    def on_restore_done(self, req: Any, t: float) -> None:
        pass

    def on_done(self, req: Any, t: float) -> None:
        pass

    def on_shed(self, req: Any, t: float) -> None:
        pass

    def annotate(self, req: Any, kind: str, t: Optional[float] = None,
                 **fields: Any) -> None:
        """Free-form forensic marker (no phase change, no accounting) —
        the fleet paths use it to stamp routing context onto the
        replica-side timeline: ``pull_hint`` (peer a kv-tier pull was
        hinted from), ``disagg_fallback`` (shipment failed, local
        re-prefill), ``tier_fallback`` (host-tier read failed,
        recompute)."""
        pass


#: Shared no-op instance — handy where an always-callable tracer is
#: wanted instead of a ``None`` guard (the engine itself guards).
NULL_TRACER = NullRequestTracer()


class RequestTracer(NullRequestTracer):
    """Per-request lifecycle recorder + latency attributor.

    Hooks are driven by ``Scheduler`` (submit/admit/preempt/first-token/
    done — the lifecycle authority) and ``ServingEngine`` (prefill
    chunks, COW copies, decode ticks, speculative cycles — the work
    authority); see the module docstring for the component semantics.

    ``registry``: attribution histograms land here (default: the global
    registry — disabled unless enabled, like every other instrument).
    ``max_events`` bounds each request's event ring; ``keep_completed``
    bounds the completed-timeline history the ops endpoint and black
    boxes read. ``clock`` must match the engine's ``now`` (the engine
    re-points it at run start) so components and the engine's own
    ``t_*`` fields share one time domain.
    """

    __slots__ = (
        "registry", "clock", "max_events", "keep_completed", "name",
        "in_flight", "completed", "_wall_offset", "_lock",
        "_h_queue", "_h_prefill", "_h_restore", "_h_transfer",
        "_h_decode", "_h_stall",
        "_h_saved", "_c_requests", "_c_preempts", "_c_saved",
    )

    enabled = True

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 max_events: int = 256, keep_completed: int = 64,
                 clock: Callable[[], float] = time.perf_counter,
                 name: Optional[str] = None):
        if max_events < 8:
            raise ValueError(f"max_events must be >= 8, got {max_events}")
        if keep_completed < 1:
            raise ValueError(
                f"keep_completed must be >= 1, got {keep_completed}"
            )
        self.registry = registry if registry is not None else get_registry()
        self.clock = clock
        self.max_events = int(max_events)
        self.keep_completed = int(keep_completed)
        # display identity for multi-tracer exports: the control plane
        # names each replica's tracer after the replica so the merged
        # Perfetto export gets one labelled process per replica
        self.name = name
        # keyed by (trace_id, uid), NOT bare uid: a salvaged reuse_uid
        # request keeps its uid across replicas by design, so two
        # replicas sharing one tracer would otherwise silently merge
        # two half-timelines into one record (regression-pinned in
        # tests/telemetry/test_fleettrace.py)
        self.in_flight: Dict[Any, RequestTimeline] = {}
        self.completed: deque = deque(maxlen=self.keep_completed)
        # wall-clock anchor so Perfetto rows line up with the span rows
        # (which timestamp with time.time()) despite the perf_counter
        # event domain
        self._wall_offset = time.time() - clock()
        self._lock = threading.Lock()
        reg = self.registry
        self._h_queue = reg.histogram("serving.attrib.queue_seconds")
        self._h_prefill = reg.histogram("serving.attrib.prefill_seconds")
        self._h_restore = reg.histogram("serving.attrib.restore_seconds")
        self._h_transfer = reg.histogram("serving.attrib.transfer_seconds")
        self._h_decode = reg.histogram("serving.attrib.decode_seconds")
        self._h_stall = reg.histogram("serving.attrib.stall_seconds")
        self._h_saved = reg.histogram("serving.attrib.cache_saved_seconds")
        self._c_requests = reg.counter("serving.attrib.requests_total")
        self._c_preempts = reg.counter("serving.attrib.preemptions_total")
        self._c_saved = reg.counter(
            "serving.attrib.cache_saved_seconds_total"
        )

    # -- plumbing ----------------------------------------------------------

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Re-point the tracer's clock (the engine passes its ``now``)
        and re-anchor the wall-clock offset for Perfetto alignment."""
        if clock is self.clock:
            return
        self.clock = clock
        self._wall_offset = time.time() - clock()

    @property
    def wall_offset(self) -> float:
        return self._wall_offset

    @staticmethod
    def _key(req: Any) -> Any:
        """In-flight map key: (trace_id, uid). For untraced requests
        (trace_id None — any engine outside a control plane) this
        degrades to the historical bare-uid keying; for fleet requests
        it keeps a salvaged reuse_uid request's second-replica fragment
        distinct from any same-uid stranger on a shared tracer."""
        return (getattr(req, "trace_id", None), req.uid)

    def _get(self, req: Any, t: float) -> RequestTimeline:
        """Timeline for ``req`` (created lazily: a tracer attached
        mid-flight starts accounting from the first event it sees)."""
        key = self._key(req)
        tl = self.in_flight.get(key)
        if tl is None:
            tl = RequestTimeline(req.uid, self.max_events,
                                 trace_id=key[0])
            tl.tenant = getattr(req, "tenant", None)
            tl.prompt_len = int(req.prompt_len)
            tl.max_new_tokens = int(req.max_new_tokens)
            tl.t_submit = t
            self.in_flight[key] = tl
        return tl

    # -- lifecycle hooks (Scheduler) ---------------------------------------

    def on_submit(self, req: Any, t: float) -> None:
        with self._lock:
            tl = self._get(req, t)
            tl.transition("queue", t)
            tl.add_event("submit", t, prompt_len=tl.prompt_len,
                         max_new_tokens=tl.max_new_tokens,
                         tenant=tl.tenant)

    def on_admit(self, req: Any, t: float) -> None:
        with self._lock:
            tl = self._get(req, t)
            readmit = tl.phase == "stall"
            tl.transition("prefill", t)
            tl.slot = req.slot
            hit = int(getattr(req, "hit_tokens", 0) or 0)
            # First admission only: a re-admission re-prefills the
            # request's OWN prompt+generated tokens, so its hits are
            # self-hits, not cross-request sharing — counting them would
            # inflate the user-visible cache benefit. (The engine's
            # run-level hit counter does include them, which is why the
            # cache_hit_share == prefill_token_reduction pin lives on
            # the preemption-free replay arms.)
            if not readmit:
                tl.hit_tokens = hit
            tl.add_event("admit", t, slot=req.slot, hit_tokens=hit,
                         readmit=readmit)

    def on_preempt(self, req: Any, t: Optional[float] = None) -> None:
        if t is None:
            t = self.clock()
        with self._lock:
            tl = self._get(req, t)
            tl.transition("stall", t)
            tl.preemptions += 1
            tl.add_event("preempt", t, generated=len(req.generated))
            self._c_preempts.inc()

    def on_first_token(self, req: Any, t: float) -> None:
        with self._lock:
            tl = self._get(req, t)
            tl.transition("decode", t)
            tl.t_first_token = t
            if tl.t_submit is not None:
                tl.ttft_s = t - tl.t_submit
            tl.ttft_components = dict(tl.components)
            tl.add_event("first_token", t)

    def on_done(self, req: Any, t: float) -> None:
        with self._lock:
            tl = self.in_flight.pop(self._key(req), None)
            if tl is None:
                return
            tl.transition(None, t)
            tl.t_done = t
            tl.finish_reason = req.finish_reason
            if tl.t_submit is not None:
                tl.e2e_s = t - tl.t_submit
            tl.add_event("done", t, finish_reason=req.finish_reason)
            fwd = max(tl.prefill_tokens, 1)
            tl.cache_saved_est_s = (
                tl.components["prefill_s"] * tl.hit_tokens / fwd
            )
            self.completed.append(tl)
        c = tl.components
        self._h_queue.observe(c["queue_s"])
        self._h_prefill.observe(c["prefill_s"])
        self._h_restore.observe(c["restore_s"])
        self._h_transfer.observe(c["transfer_s"])
        self._h_decode.observe(c["decode_s"])
        self._h_stall.observe(c["stall_s"])
        self._h_saved.observe(tl.cache_saved_est_s)
        self._c_saved.inc(tl.cache_saved_est_s)
        self._c_requests.inc()

    def on_shed(self, req: Any, t: float) -> None:
        """Deadline shed: the OTHER terminal transition (scheduler
        dropped a queued request past its ``deadline_s``). The timeline
        completes with ``finish_reason="shed"`` and its (entirely
        queue-side) wall time books normally — so shed requests are
        visible in ``/debug/requests``, black boxes, and the
        attribution rows, distinguishable by finish reason rather than
        silently absent. No latency histograms are observed: a shed
        request has no serving latency, and polluting the TTFT/e2e
        distributions with it would mask exactly the degradation
        shedding is supposed to make visible."""
        with self._lock:
            tl = self.in_flight.pop(self._key(req), None)
            if tl is None:
                return
            tl.transition(None, t)
            tl.t_done = t
            tl.finish_reason = "shed"
            if tl.t_submit is not None:
                tl.e2e_s = t - tl.t_submit
            tl.add_event("shed", t)
            self.completed.append(tl)
        self._c_requests.inc()

    # -- work hooks (ServingEngine) ----------------------------------------

    def on_cow(self, req: Any, t: float) -> None:
        with self._lock:
            tl = self._get(req, t)
            tl.cow_copies += 1
            tl.add_event("cow", t)

    def on_prefill_chunk(self, req: Any, t: float, dur_s: float,
                         tokens: int) -> None:
        with self._lock:
            tl = self._get(req, t)
            tl.prefill_chunks += 1
            tl.prefill_tokens += int(tokens)
            tl.prefill_compute_s += dur_s
            tl.add_event("prefill_chunk", t, dur_s=dur_s, tokens=int(tokens))

    def on_resume(self, req: Any, t: float) -> None:
        """Re-admitted request finished its re-prefill: decoding resumes
        on the already-pending token (no new first token)."""
        with self._lock:
            tl = self._get(req, t)
            tl.transition("decode", t)
            tl.add_event("resume", t)

    def on_decode_tick(self, req: Any, t: float, dur_s: float,
                       tokens: int = 1) -> None:
        with self._lock:
            tl = self._get(req, t)
            tl.decode_ticks += 1
            tl.decode_compute_s += dur_s
            tl.add_event("decode", t, dur_s=dur_s, tokens=int(tokens))

    def on_spec(self, req: Any, t: float, dur_s: float, drafted: int,
                accepted: int) -> None:
        with self._lock:
            tl = self._get(req, t)
            tl.decode_ticks += 1
            tl.decode_compute_s += dur_s
            tl.spec_drafted += int(drafted)
            tl.spec_accepted += int(accepted)
            tl.add_event("spec", t, dur_s=dur_s, drafted=int(drafted),
                         accepted=int(accepted))

    def annotate(self, req: Any, kind: str, t: Optional[float] = None,
                 **fields: Any) -> None:
        """Forensic marker on the request's timeline: one ring event,
        no phase transition, no component accounting — so fleet paths
        (pull hints, fallback verdicts) can stamp context without ever
        perturbing the sum-to-e2e contract."""
        if t is None:
            t = self.clock()
        with self._lock:
            tl = self._get(req, t)
            tl.add_event(kind, t, **fields)

    # -- disagg transfer hooks (serving/disagg/) ---------------------------

    def on_transfer_start(self, req: Any, t: float) -> None:
        """Prefill handed off: the request's wall clock now belongs to
        the cross-pool transfer until the decode pool admits it. Fired
        by the PREFILL scheduler's ``finish_handoff`` right after the
        first-token hook (so TTFT = queue + prefill, and transfer time
        is its own additive component)."""
        with self._lock:
            tl = self._get(req, t)
            tl.transition("transfer", t)
            tl.add_event("transfer_start", t)

    def on_transfer_chunk(self, req: Any, t: float, dur_s: float,
                          tokens: int, pages: int, nbytes: int) -> None:
        """One page shipment imported on the decode pool. Streamed
        chunks land while the phase is still ``prefill`` (they overlap
        it off the critical path); only the counters accumulate —
        phases stay exclusive so the sum-to-e2e contract holds."""
        with self._lock:
            tl = self._get(req, t)
            tl.transfer_chunks += 1
            tl.transfer_pages += int(pages)
            tl.transfer_bytes += int(nbytes)
            tl.transfer_compute_s += dur_s
            tl.add_event("transfer_chunk", t, dur_s=dur_s,
                         tokens=int(tokens), pages=int(pages),
                         nbytes=int(nbytes))

    def on_transfer_done(self, req: Any, t: float,
                         resume: str = "decode") -> None:
        """Decode pool admitted the transferred pages: the transfer
        phase closes and ``resume`` opens — ``"decode"`` for the disagg
        handoff (fired by ``admit_with_pages`` just before the handoff
        token is recorded), ``"prefill"`` for a partial kv_tier pull
        (the request resumes chunked prefill at the pulled length)."""
        with self._lock:
            tl = self._get(req, t)
            tl.transition(resume, t)
            tl.add_event("transfer_done", t, resume=resume)

    # -- kv_tier restore hooks (serving/kv_tier/) --------------------------

    def on_restore_start(self, req: Any, t: float) -> None:
        """Host-tier restore opened for a still-QUEUED request (the
        engine's pre-admission intercept): its wall clock belongs to
        the restore until the pages are back in device memory."""
        with self._lock:
            tl = self._get(req, t)
            tl.transition("restore", t)
            tl.add_event("restore_start", t)

    def on_restore_chunk(self, req: Any, t: float, dur_s: float,
                         tokens: int, pages: int, nbytes: int) -> None:
        """One page scattered back from the host tier (local restore),
        or one peer TIER entry imported during a pull (the phase is
        whatever the surrounding path opened — only counters move)."""
        with self._lock:
            tl = self._get(req, t)
            tl.restore_pages += int(pages)
            tl.restore_bytes += int(nbytes)
            tl.restore_compute_s += dur_s
            tl.add_event("restore_chunk", t, dur_s=dur_s,
                         tokens=int(tokens), pages=int(pages),
                         nbytes=int(nbytes))

    def on_restore_done(self, req: Any, t: float) -> None:
        """Restore finished (fully or degraded): the request goes back
        to waiting for ordinary admission — the restored pages are
        cache hits now, so what follows books as queue time again."""
        with self._lock:
            tl = self._get(req, t)
            tl.transition("queue", t)
            tl.add_event("restore_done", t)

    # -- views -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view of in-flight + recent completed timelines (the
        ``/debug/requests`` payload). Snapshot-under-lock: the engine
        thread may be mutating while the ops server reads."""
        with self._lock:
            return {
                "in_flight": [
                    tl.to_json() for tl in self.in_flight.values()
                ],
                "completed": [tl.to_json() for tl in self.completed],
            }

    def blackbox_payload(self, last_n: int = 8) -> Dict[str, Any]:
        """The flight-recorder embed: in-flight timelines (a stuck dump
        must name the stuck request) + the last ``last_n`` completed."""
        with self._lock:
            done = list(self.completed)[-last_n:]
            return {
                "in_flight": [
                    tl.to_json() for tl in self.in_flight.values()
                ],
                "last_completed": [tl.to_json() for tl in done],
            }

    def attribution_summary(self) -> Dict[str, Any]:
        """Aggregate attribution over the completed ring: per-request
        rows plus component means and the cache-hit share — the per-arm
        block ``prefix_replay_benchmark(trace=True)`` returns per arm."""
        with self._lock:
            done = list(self.completed)
        rows = [tl.attribution() for tl in done]
        n = len(rows)
        mean: Dict[str, float] = {c: 0.0 for c in COMPONENTS}
        mean_ttft_c: Dict[str, float] = {c: 0.0 for c in COMPONENTS}
        hit = fwd = 0
        ttfts: List[float] = []
        for tl in done:
            for c in COMPONENTS:
                mean[c] += tl.components[c]
                if tl.ttft_components is not None:
                    mean_ttft_c[c] += tl.ttft_components[c]
            hit += tl.hit_tokens
            fwd += tl.prefill_tokens
            if tl.ttft_s is not None:
                ttfts.append(tl.ttft_s)
        if n:
            for c in COMPONENTS:
                mean[c] = mean[c] / n
                mean_ttft_c[c] = mean_ttft_c[c] / n
        return {
            "requests": rows,
            "n": n,
            "mean_components": mean,
            "mean_ttft_components": mean_ttft_c,
            "mean_ttft_s": sum(ttfts) / len(ttfts) if ttfts else None,
            "hit_tokens": hit,
            "prefill_tokens": fwd,
            "cache_hit_share": hit / (hit + fwd) if hit + fwd else 0.0,
            "mean_cache_saved_est_s": (
                sum(tl.cache_saved_est_s for tl in done) / n if n else 0.0
            ),
        }


def request_trace_events(tracer: RequestTracer, *,
                         pid: Optional[int] = None,
                         process_name: Optional[str] = None) -> List[dict]:
    """Render a tracer's timelines as Perfetto ``trace_event`` rows —
    ONE TRACK PER DECODE SLOT (plus a queue track for pre-admission and
    preempted waits), phase slices (``req<uid> prefill`` /
    ``req<uid> decode``) with nested per-chunk slices, and instant
    markers for preempt / COW / spec-reject / first-token — loadable in
    ui.perfetto.dev next to the host spans and the pipeline timetable
    (``ChromeTraceExporter.add_request_timelines``)."""
    from pipegoose_tpu_torch.telemetry.chrometrace import PID_REQUESTS

    if pid is None:
        pid = PID_REQUESTS
    if process_name is None:
        name = getattr(tracer, "name", None)
        process_name = (f"serving requests ({name})" if name
                        else "serving requests (per-slot timelines)")
    off = tracer.wall_offset
    queue_tid = 1_000  # after any realistic slot count
    transfer_tid = 2_000  # disagg cross-pool page streaming track
    restore_tid = 3_000   # kv_tier host-tier restore track
    events: List[dict] = [
        {
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": process_name},
        },
        {
            "name": "thread_name", "ph": "M", "pid": pid, "tid": queue_tid,
            "args": {"name": "queue / preempted"},
        },
    ]
    seen_slots: set = set()
    seen_transfer = False
    seen_restore = False

    def us(t: float) -> float:
        return (t + off) * 1e6

    def slice_(name, cat, t0, t1, tid, **args):
        events.append({
            "name": name, "cat": cat, "ph": "X", "ts": us(t0),
            "dur": max(t1 - t0, 0.0) * 1e6, "pid": pid, "tid": tid,
            "args": args,
        })

    def marker(name, t, tid, **args):
        events.append({
            "name": name, "cat": "request.marker", "ph": "i", "s": "t",
            "ts": us(t), "pid": pid, "tid": tid, "args": args,
        })

    snap = tracer.snapshot()
    for tl in snap["completed"] + snap["in_flight"]:
        uid = tl["uid"]
        evs = tl["events"]
        if not evs:
            continue
        slot = tl.get("slot")
        tid = slot if slot is not None else queue_tid
        seen_slots.add(tid)
        t_open = evs[0]["t"]       # current phase's start
        phase = None
        t_end = evs[-1]["t"]       # in-flight timelines close here
        for ev in evs:
            t, kind = ev["t"], ev["kind"]
            if kind == "submit":
                phase, t_open = "queue", t
            elif kind == "admit":
                if phase in ("queue", "stall"):
                    slice_(f"req{uid} {phase}", f"request.{phase}",
                           t_open, t, queue_tid, uid=uid)
                phase, t_open = "prefill", t
                if ev.get("slot") is not None:
                    tid = ev["slot"]
                    seen_slots.add(tid)
            elif kind in ("first_token", "resume"):
                if phase == "prefill":
                    slice_(f"req{uid} prefill", "request.prefill",
                           t_open, t, tid, uid=uid,
                           hit_tokens=tl.get("hit_tokens", 0))
                if kind == "first_token":
                    marker(f"req{uid} first_token", t, tid, uid=uid)
                phase, t_open = "decode", t
            elif kind == "preempt":
                if phase in ("prefill", "decode"):
                    slice_(f"req{uid} {phase}", f"request.{phase}",
                           t_open, t, tid, uid=uid)
                marker(f"req{uid} preempt", t, tid, uid=uid)
                phase, t_open = "stall", t
            elif kind == "done":
                if phase in ("prefill", "decode"):
                    slice_(f"req{uid} {phase}", f"request.{phase}",
                           t_open, t, tid, uid=uid,
                           finish_reason=ev.get("finish_reason"))
                phase, t_open = None, t
            elif kind == "shed":
                if phase in ("queue", "stall"):
                    slice_(f"req{uid} {phase}", f"request.{phase}",
                           t_open, t, queue_tid, uid=uid,
                           finish_reason="shed")
                marker(f"req{uid} shed", t, queue_tid, uid=uid)
                phase, t_open = None, t
            elif kind == "transfer_start":
                if phase in ("prefill", "decode"):
                    slice_(f"req{uid} {phase}", f"request.{phase}",
                           t_open, t, tid, uid=uid)
                phase, t_open = "transfer", t
                seen_transfer = True
            elif kind == "transfer_done":
                if phase == "transfer":
                    slice_(f"req{uid} transfer", "request.transfer",
                           t_open, t, transfer_tid, uid=uid,
                           pages=tl.get("transfer_pages", 0),
                           nbytes=tl.get("transfer_bytes", 0))
                phase, t_open = "decode", t
                seen_transfer = True
            elif kind == "transfer_chunk":
                dur = float(ev.get("dur_s", 0.0))
                slice_(f"req{uid} xfer chunk", "request.transfer_chunk",
                       t - dur, t, transfer_tid, uid=uid,
                       pages=ev.get("pages"), nbytes=ev.get("nbytes"))
                seen_transfer = True
            elif kind == "restore_start":
                if phase == "queue":
                    slice_(f"req{uid} queue", "request.queue",
                           t_open, t, queue_tid, uid=uid)
                phase, t_open = "restore", t
                seen_restore = True
            elif kind == "restore_done":
                if phase == "restore":
                    slice_(f"req{uid} restore", "request.restore",
                           t_open, t, restore_tid, uid=uid,
                           pages=tl.get("restore_pages", 0),
                           nbytes=tl.get("restore_bytes", 0))
                phase, t_open = "queue", t
                seen_restore = True
            elif kind == "restore_chunk":
                dur = float(ev.get("dur_s", 0.0))
                slice_(f"req{uid} restore chunk", "request.restore_chunk",
                       t - dur, t, restore_tid, uid=uid,
                       pages=ev.get("pages"), nbytes=ev.get("nbytes"))
                seen_restore = True
            elif kind == "prefill_chunk":
                dur = float(ev.get("dur_s", 0.0))
                slice_(f"req{uid} chunk", "request.prefill_chunk",
                       t - dur, t, tid, uid=uid, tokens=ev.get("tokens"))
            elif kind == "cow":
                marker(f"req{uid} cow", t, tid, uid=uid)
            elif kind == "spec":
                if ev.get("accepted", 0) < ev.get("drafted", 0):
                    marker(f"req{uid} spec_reject", t, tid,
                           uid=uid, drafted=ev.get("drafted"),
                           accepted=ev.get("accepted"))
        if phase is not None:  # in-flight: close the open phase slice
            track = (queue_tid if phase in ("queue", "stall")
                     else transfer_tid if phase == "transfer"
                     else restore_tid if phase == "restore" else tid)
            slice_(f"req{uid} {phase}", f"request.{phase}",
                   t_open, t_end, track, uid=uid, open=True)
    if seen_restore:
        events.insert(1, {
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": restore_tid,
            "args": {"name": "restore (host KV tier)"},
        })
    if seen_transfer:
        events.insert(1, {
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": transfer_tid,
            "args": {"name": "transfer (cross-pool KV streaming)"},
        })
    for tid in sorted(s for s in seen_slots if s != queue_tid):
        events.insert(1, {
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": f"slot {tid}"},
        })
    return events
