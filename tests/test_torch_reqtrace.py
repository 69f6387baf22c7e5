"""The port's request tracer held against the JAX package on the CPU.

Unit counterparts of ``tests/telemetry/test_reqtrace.py``: each scenario
drives the JAX ``RequestTracer`` and the port's with the same hook calls
and hand-placed times; their timelines, attribution rows, registry
snapshots and Perfetto rows must be equal, and the JAX test's claims must
hold on the port's.

Engine parity: the JAX engine (``attn_kernel="paged"``) and the port's
serve the same requests (2-layer, width-64 BLOOM, pages of 4) with a
deterministic clock (each read +1 ms) in the plain, chunked, prefix-cache,
int8-KV, speculative and preempting arms, each with a tracer. Every
request's events and attribution components must be equal (1e-9), as must
``programs_run``, ``admission_deferrals`` and the ``request_trace_events``
JSON (wall offsets zeroed: each tracer anchors its own). Also the stall
black box's request payload, ``prefix_replay_benchmark(trace=True)`` and
the disabled-tracer cost guard."""
import json
import os
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pipegoose_tpu.telemetry.registry as jregistry
import pipegoose_tpu.telemetry.reqtrace as jreqtrace
import pipegoose_tpu_torch.telemetry.registry as tregistry
import pipegoose_tpu_torch.telemetry.reqtrace as treqtrace
from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.serving import Request as JRequest
from pipegoose_tpu.serving import ServingEngine as JServingEngine
from pipegoose_tpu.telemetry import FlightRecorder as JRecorder
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.serving import Request, ServingEngine
from pipegoose_tpu_torch.telemetry import FlightRecorder

JAX = SimpleNamespace(tracer=jreqtrace.RequestTracer, registry=jregistry.MetricsRegistry,
                      events=jreqtrace.request_trace_events)
PORT = SimpleNamespace(tracer=treqtrace.RequestTracer, registry=tregistry.MetricsRegistry,
                       events=treqtrace.request_trace_events)


def _req(uid, prompt_len=8, max_new=4):
    return SimpleNamespace(
        uid=uid, prompt_len=prompt_len, max_new_tokens=max_new, slot=None,
        hit_tokens=0, generated=[], finish_reason=None,
    )


def _tracer(m, **kw):
    t = [0.0]
    reg = m.registry(enabled=True)
    tr = m.tracer(registry=reg, clock=lambda: t[0], **kw)
    return tr, t, reg


def _view(m, tr, reg):
    """Everything a scenario leaves behind, JSON-able; the Perfetto rows
    with the wall offset zeroed (each tracer anchors its own)."""
    tr._wall_offset = 0.0
    return {"snapshot": tr.snapshot(), "summary": tr.attribution_summary(),
            "blackbox": tr.blackbox_payload(), "events": json.loads(json.dumps(m.events(tr))),
            "counters": reg.snapshot()["counters"],
            "hist_counts": {k: v["count"] for k, v in reg.snapshot()["histograms"].items()}}


def _both(scenario, **kw):
    """Run ``scenario(tracer, clock)`` on JAX's tracer and the port's;
    their views must be equal. Returns the port's tracer and view."""
    out = []
    for m in (JAX, PORT):
        tr, t, reg = _tracer(m, **kw)
        scenario(tr, t)
        out.append((tr, _view(m, tr, reg)))
    assert out[1][1] == out[0][1]
    return out[1]


def _lifecycle_with_preemption(tr, t):
    r = _req(0)
    tr.on_submit(r, 0.0)
    r.slot, r.hit_tokens = 1, 4
    tr.on_admit(r, 1.0)
    tr.on_prefill_chunk(r, 1.5, dur_s=0.4, tokens=4)
    tr.on_first_token(r, 2.0)
    tr.on_decode_tick(r, 2.5, dur_s=0.5)
    t[0] = 3.0
    tr.on_preempt(r)
    tr.on_admit(r, 4.0)
    tr.on_prefill_chunk(r, 4.5, dur_s=0.4, tokens=8)
    tr.on_resume(r, 5.0)
    r.finish_reason = "length"
    tr.on_done(r, 6.0)


def test_components_are_contiguous_segments_and_sum_to_e2e():
    tr, view = _both(_lifecycle_with_preemption)
    (row,) = view["summary"]["requests"]
    assert row["components"] == {
        "queue_s": 1.0, "prefill_s": 2.0, "restore_s": 0.0,
        "transfer_s": 0.0, "decode_s": 2.0, "stall_s": 1.0,
    }
    assert row["e2e_s"] == 6.0
    assert sum(row["components"].values()) == pytest.approx(row["e2e_s"])
    assert row["ttft_s"] == 2.0
    assert row["ttft_components"]["queue_s"] == 1.0
    assert row["ttft_components"]["prefill_s"] == 1.0
    assert row["preemptions"] == 1
    assert row["cache_saved_est_s"] == pytest.approx(2.0 * 4 / 12)
    assert treqtrace.COMPONENTS == jreqtrace.COMPONENTS


def test_attrib_histograms_observed_on_done():
    def scenario(tr, t):
        for uid in range(3):
            r = _req(uid)
            tr.on_submit(r, 0.0)
            r.slot = 0
            tr.on_admit(r, 1.0)
            tr.on_first_token(r, 2.0)
            r.finish_reason = "length"
            tr.on_done(r, 3.0)

    tr, view = _both(scenario)
    assert view["counters"]["serving.attrib.requests_total"] == 3
    for c in ("queue", "prefill", "decode", "stall"):
        assert view["hist_counts"][f"serving.attrib.{c}_seconds"] == 3
    assert tr.registry.snapshot()["histograms"]["serving.attrib.queue_seconds"]["max"] == 1.0


def test_event_ring_is_bounded_but_attribution_stays_exact():
    def scenario(tr, t):
        r = _req(0)
        tr.on_submit(r, 0.0)
        r.slot = 0
        tr.on_admit(r, 1.0)
        tr.on_first_token(r, 2.0)
        for i in range(100):
            tr.on_decode_tick(r, 2.0 + i * 0.01, dur_s=0.01)
        r.finish_reason = "length"
        tr.on_done(r, 10.0)

    _, view = _both(scenario, max_events=8)
    tl = view["snapshot"]["completed"][0]
    assert len(tl["events"]) == 8
    assert tl["events_dropped"] == 104 - 8
    assert tl["decode_ticks"] == 100
    assert tl["components"]["queue_s"] == 1.0
    assert sum(tl["components"].values()) == pytest.approx(tl["e2e_s"])


def test_readmit_keeps_first_admissions_hit_tokens():
    def scenario(tr, t):
        r = _req(0)
        tr.on_submit(r, 0.0)
        r.slot, r.hit_tokens = 0, 6
        tr.on_admit(r, 1.0)
        tr.on_preempt(r, 2.0)
        r.hit_tokens = 8
        tr.on_admit(r, 3.0)
        r.finish_reason = "length"
        tr.on_done(r, 4.0)

    _, view = _both(scenario)
    assert view["summary"]["requests"][0]["hit_tokens"] == 6


def test_perfetto_rows_per_slot_with_markers():
    def scenario(tr, t):
        r = _req(0)
        tr.on_submit(r, 0.0)
        r.slot, r.hit_tokens = 2, 0
        tr.on_admit(r, 1.0)
        tr.on_cow(r, 1.2)
        tr.on_prefill_chunk(r, 1.5, dur_s=0.3, tokens=8)
        tr.on_first_token(r, 2.0)
        tr.on_spec(r, 2.5, dur_s=0.5, drafted=3, accepted=1)
        t[0] = 3.0
        tr.on_preempt(r)
        tr.on_admit(r, 4.0)
        tr.on_resume(r, 5.0)
        r.finish_reason = "eos"
        tr.on_done(r, 6.0)

    _, view = _both(scenario)
    events = view["events"]
    threads = {e["args"]["name"] for e in events if e["name"] == "thread_name"}
    assert "slot 2" in threads and "queue / preempted" in threads
    markers = {e["name"] for e in events if e["ph"] == "i"}
    assert {"req0 preempt", "req0 cow", "req0 spec_reject", "req0 first_token"} <= markers
    slices = {e["name"]: e for e in events if e["ph"] == "X"}
    assert {"req0 queue", "req0 prefill", "req0 decode", "req0 stall", "req0 chunk"} <= set(slices)
    assert slices["req0 prefill"]["tid"] == 2
    assert slices["req0 queue"]["tid"] == slices["req0 stall"]["tid"] != 2


def test_in_flight_timelines_visible_and_blackbox_names_them():
    def scenario(tr, t):
        stuck = _req(7)
        tr.on_submit(stuck, 0.0)
        stuck.slot = 0
        tr.on_admit(stuck, 1.0)
        done = _req(8)
        tr.on_submit(done, 0.0)
        done.slot = 1
        tr.on_admit(done, 1.0)
        tr.on_first_token(done, 2.0)
        done.finish_reason = "length"
        tr.on_done(done, 3.0)

    _, view = _both(scenario)
    assert [tl["uid"] for tl in view["blackbox"]["in_flight"]] == [7]
    assert [tl["uid"] for tl in view["blackbox"]["last_completed"]] == [8]
    assert any(e["name"] == "req7 prefill" and e["args"].get("open")
               for e in view["events"] if e["ph"] == "X")


def test_completed_ring_is_bounded():
    def scenario(tr, t):
        for uid in range(10):
            r = _req(uid)
            tr.on_submit(r, 0.0)
            r.slot = 0
            tr.on_admit(r, 1.0)
            r.finish_reason = "length"
            tr.on_done(r, 2.0)

    _, view = _both(scenario, keep_completed=4)
    assert [tl["uid"] for tl in view["snapshot"]["completed"]] == [6, 7, 8, 9]


def test_concurrent_snapshot_while_recording():
    """The ops server reads while the engine thread records, both under
    the tracer's lock: no error, and the end state equals JAX's."""
    def scenario(tr, t):
        stop = threading.Event()
        errs = []

        def reader():
            while not stop.is_set():
                try:
                    tr.snapshot()
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

        th = threading.Thread(target=reader)
        th.start()
        for uid in range(200):
            r = _req(uid)
            tr.on_submit(r, 0.0)
            r.slot = 0
            tr.on_admit(r, 1.0)
            r.finish_reason = "length"
            tr.on_done(r, 2.0)
        stop.set()
        th.join()
        assert not errs

    _both(scenario)


def _median_call_seconds(fn, n=2000, rounds=15):
    samples = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        samples.append((time.perf_counter() - t0) / n)
    return sorted(samples)[len(samples) // 2]


def test_disabled_tracer_guard_under_5us():
    """The port engine's per-tick hook with ``tracer=None`` is one
    attribute read and branch, timed on the real method."""
    fake_engine = SimpleNamespace(tracer=None)
    active = [_req(i) for i in range(4)]
    assert _median_call_seconds(
        lambda: ServingEngine._trace_tick(fake_engine, active, 0.0, 0.0)) < 5e-6
    assert _median_call_seconds(
        lambda: treqtrace.NULL_TRACER.on_decode_tick(active[0], 0.0, 0.0)) < 5e-6


def test_validation():
    for m in (JAX, PORT):
        with pytest.raises(ValueError, match="max_events"):
            m.tracer(registry=m.registry(), max_events=2)
        with pytest.raises(ValueError, match="keep_completed"):
            m.tracer(registry=m.registry(), keep_completed=0)


def test_set_clock_reanchors_wall_offset():
    tr, _, _ = _tracer(PORT)
    off0 = tr.wall_offset
    tr.set_clock(lambda: -1000.0)
    assert tr.wall_offset != off0
    off1 = tr.wall_offset
    tr.set_clock(tr.clock)  # the same object: no-op
    assert tr.wall_offset == off1


def test_transfer_phase_is_additive_and_exact():
    def scenario(tr, t):
        r = _req(0)
        tr.on_submit(r, 0.0)
        r.slot = 0
        tr.on_admit(r, 1.0)
        tr.on_prefill_chunk(r, 1.5, dur_s=0.4, tokens=8)
        tr.on_transfer_chunk(r, 1.6, dur_s=0.05, tokens=8, pages=2, nbytes=4096)
        tr.on_first_token(r, 2.0)
        tr.on_transfer_start(r, 2.0)
        tr.on_transfer_chunk(r, 2.5, dur_s=0.1, tokens=4, pages=1, nbytes=2048)
        tr.on_transfer_done(r, 3.0)
        r.finish_reason = "length"
        tr.on_done(r, 5.0)

    tr, view = _both(scenario)
    (row,) = view["summary"]["requests"]
    assert row["components"] == {
        "queue_s": 1.0, "prefill_s": 1.0, "restore_s": 0.0,
        "transfer_s": 1.0, "decode_s": 2.0, "stall_s": 0.0,
    }
    assert row["ttft_s"] == 2.0
    tl = tr.completed[-1]
    assert (tl.transfer_chunks, tl.transfer_pages, tl.transfer_bytes) == (2, 3, 6144)
    assert tl.transfer_compute_s == pytest.approx(0.15)
    assert view["hist_counts"]["serving.attrib.transfer_seconds"] == 1


def test_transfer_failure_books_requeue_as_queue_time():
    def scenario(tr, t):
        r = _req(1)
        tr.on_submit(r, 0.0)
        r.slot = 0
        tr.on_admit(r, 1.0)
        tr.on_first_token(r, 2.0)
        tr.on_transfer_start(r, 2.0)
        tr.on_submit(r, 3.0)
        tr.on_admit(r, 4.0)
        tr.on_resume(r, 5.0)
        r.finish_reason = "length"
        tr.on_done(r, 6.0)

    _, view = _both(scenario)
    (row,) = view["summary"]["requests"]
    assert row["components"]["transfer_s"] == 1.0
    assert row["components"]["queue_s"] == 2.0
    assert sum(row["components"].values()) == pytest.approx(row["e2e_s"])


def test_perfetto_transfer_track():
    def scenario(tr, t):
        r = _req(2)
        tr.on_submit(r, 0.0)
        r.slot = 1
        tr.on_admit(r, 1.0)
        tr.on_first_token(r, 2.0)
        tr.on_transfer_start(r, 2.0)
        tr.on_transfer_chunk(r, 2.5, dur_s=0.1, tokens=4, pages=1, nbytes=2048)
        tr.on_transfer_done(r, 3.0)
        r.finish_reason = "length"
        tr.on_done(r, 4.0)

    _, view = _both(scenario)
    evs = view["events"]
    xfer = [e for e in evs if e.get("cat") == "request.transfer"]
    assert len(xfer) == 1 and xfer[0]["tid"] == 2_000
    assert xfer[0]["dur"] == pytest.approx(1e6)
    chunks = [e for e in evs if e.get("cat") == "request.transfer_chunk"]
    assert len(chunks) == 1 and chunks[0]["args"]["nbytes"] == 2048
    assert any(e["args"]["name"].startswith("transfer") for e in evs
               if e.get("ph") == "M" and e["name"] == "thread_name")


def test_restore_phase_and_annotate_leave_the_sum_exact():
    """The KV-tier restore hooks and a free-form annotation: the restore
    books as its own component, the annotation as one event only."""
    def scenario(tr, t):
        r = _req(3)
        tr.on_submit(r, 0.0)
        tr.on_restore_start(r, 0.5)
        tr.on_restore_chunk(r, 0.8, dur_s=0.2, tokens=4, pages=1, nbytes=512)
        tr.on_restore_done(r, 1.0)
        t[0] = 1.2
        tr.annotate(r, "pull_hint", peer="replica1")
        r.slot = 0
        tr.on_admit(r, 1.5)
        tr.on_first_token(r, 2.0)
        r.finish_reason = "length"
        tr.on_done(r, 3.0)

    _, view = _both(scenario)
    (tl,) = view["snapshot"]["completed"]
    assert tl["components"]["restore_s"] == 0.5
    assert tl["components"]["queue_s"] == 1.0
    assert sum(tl["components"].values()) == pytest.approx(tl["e2e_s"])
    assert [e["kind"] for e in tl["events"]].count("pull_hint") == 1
    assert any(e.get("cat") == "request.restore" for e in view["events"])


# -- the engines ----------------------------------------------------------------

JCFG = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
TCFG = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4,
                          initializer_range=0.3)
ENGINE = dict(num_slots=3, num_pages=48, page_size=4, max_context=48)

ARMS = {
    "plain": {},
    "chunked": {"prefill_chunk": 4},
    "cached": {"prefix_cache": True, "prefill_chunk": 8},
    "cached_int8kv": {"prefix_cache": True, "kv_dtype": "int8"},
    "speculative": {"prefix_cache": True, "prefill_chunk": 4, "speculative": (1, 3)},
    # a pool the queue outgrows (admissions deferred) and a preemption
    "preempting": {"prefix_cache": True, "prefill_chunk": 4, "num_pages": 12},
}


@pytest.fixture(scope="module")
def setup():
    np_tree = tbloom.init_params_numpy(TCFG, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tparams = params_from_jax(np_tree, TCFG, device="cpu")
    rng = np.random.RandomState(11)
    shared = rng.randint(1, 64, (13,))
    reqs = [(np.concatenate([shared, rng.randint(1, 64, (k,))]), n)
            for k, n in [(3, 6), (5, 4), (2, 7), (6, 5)]] + [
        (shared[:10], 5),
        (rng.randint(1, 64, (7,)), 6),
        (np.concatenate([shared, rng.randint(1, 64, (1,))]), 3),
    ]
    return jparams, tparams, reqs


def _clock():
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    return now


def _preempt_hook(eng, tick):
    """Preempt the first decoding request at tick 6: it re-prefills its
    prompt and tokens and resumes."""
    if tick == 6:
        live = [r for r in eng.sched.active() if r.generated]
        if live:
            eng.sched.preempt(live[0])


def _close(a, b, path="", tol=1e-9):
    """Recursive equality with floats within ``tol``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}", tol)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]", tol)
    elif isinstance(a, float) or isinstance(b, float):
        assert b is not None and abs(a - b) <= tol, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _traced(setup, arm, recorders=(None, None)):
    """Both engines with tracers serve the setup's requests; returns
    ((engine, tracer, outputs) for JAX, the same for the port)."""
    jparams, tparams, reqs = setup
    knobs = dict(ENGINE, **ARMS[arm])
    hook = _preempt_hook if arm == "preempting" else None
    out = []
    for eng_cls, req_cls, params, cfg, m, rec, kw in (
            (JServingEngine, JRequest, jparams, JCFG, JAX, recorders[0],
             {"attn_kernel": "paged"}),
            (ServingEngine, Request, tparams, TCFG, PORT, recorders[1], {"device": "cpu"})):
        tracer = m.tracer(registry=m.registry(enabled=True), keep_completed=64)
        eng = eng_cls(params, cfg, tracer=tracer, recorder=rec, **knobs, **kw)
        outs, _ = eng.run([req_cls(prompt=p, max_new_tokens=n) for p, n in reqs],
                          now=_clock(), tick_hook=hook)
        out.append((eng, tracer, outs))
    for j, t in zip(out[0][2], out[1][2]):
        np.testing.assert_array_equal(t.generated, j.generated)
    return out


@pytest.mark.parametrize("arm", list(ARMS))
def test_traced_engine_equals_jax(setup, arm):
    (jeng, jtr, jouts), (teng, ttr, touts) = _traced(setup, arm)
    want = [tl.to_json() for tl in jtr.completed]
    got = [tl.to_json() for tl in ttr.completed]
    _close(got, want)
    assert not ttr.in_flight
    assert teng.programs_run == jeng.programs_run > 0
    assert teng.sched.admission_deferrals == jeng.sched.admission_deferrals
    for tr in (jtr, ttr):
        tr._wall_offset = 0.0
    _close(json.loads(json.dumps(PORT.events(ttr))), json.loads(json.dumps(JAX.events(jtr))))
    # the components are contiguous: they sum to each request's end to end,
    # and the TTFT components to its TTFT
    by_uid = {o.uid: o for o in touts}
    for tl in got:
        assert sum(tl["components"].values()) == pytest.approx(tl["e2e_s"], abs=1e-9)
        assert tl["e2e_s"] == pytest.approx(by_uid[tl["uid"]].e2e_latency_s, abs=1e-9)
        assert sum(tl["ttft_components"].values()) == pytest.approx(tl["ttft_s"], abs=1e-9)
    kinds = {e["kind"] for tl in got for e in tl["events"]}
    if arm == "preempting":
        assert teng.sched.admission_deferrals > 0
        assert {"preempt", "resume"} <= kinds
    if "speculative" in ARMS[arm]:
        assert "spec" in kinds
    if ARMS[arm].get("prefix_cache"):
        assert sum(tl["hit_tokens"] for tl in got) > 0
    if arm == "cached":
        assert "cow" in kinds
    assert ttr.registry.snapshot()["counters"] == jtr.registry.snapshot()["counters"]


def test_untraced_engine_counts_programs_and_deferrals_like_jax(setup):
    """``programs_run`` and ``admission_deferrals`` need no tracer."""
    jparams, tparams, reqs = setup
    knobs = dict(ENGINE, **ARMS["preempting"])
    jeng = JServingEngine(jparams, JCFG, attn_kernel="paged", **knobs)
    teng = ServingEngine(tparams, TCFG, device="cpu", **knobs)
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        eng.run([cls(prompt=p, max_new_tokens=n) for p, n in reqs], now=_clock())
    assert (teng.programs_run, teng.sched.admission_deferrals) == (
        jeng.programs_run, jeng.sched.admission_deferrals)
    assert teng.programs_run > 0 and teng.sched.admission_deferrals > 0


def test_attach_tracer_wires_the_scheduler_and_the_recorder(setup, tmp_path):
    _, tparams, reqs = setup
    rec = FlightRecorder(str(tmp_path))
    eng = ServingEngine(tparams, TCFG, device="cpu", recorder=rec, prefill_chunk=4, **ENGINE)
    tracer = PORT.tracer(registry=PORT.registry(enabled=True))
    eng.attach_tracer(tracer)
    assert eng.sched.tracer is tracer and rec._req_tracer is tracer
    eng.run([Request(prompt=p, max_new_tokens=n) for p, n in reqs[:2]], now=_clock())
    assert len(tracer.completed) == 2
    eng.attach_tracer(None)
    assert eng.sched.tracer is None and rec._req_tracer is None
    eng.run([Request(prompt=p, max_new_tokens=n) for p, n in reqs[:2]], now=_clock())
    assert len(tracer.completed) == 2


def test_stall_black_box_names_the_stuck_request_like_jax(setup, tmp_path):
    """A pool that can never admit the queue head, with a tracer: the box's
    request payload equals JAX's and names the stuck request."""
    jparams, tparams, reqs = setup
    knobs = dict(num_slots=2, num_pages=4, page_size=4, max_context=48, stall_patience=3,
                 prefill_chunk=4)
    boxes = []
    for eng_cls, req_cls, rec_cls, params, cfg, m, tag, kw in (
            (JServingEngine, JRequest, JRecorder, jparams, JCFG, JAX, "jax",
             {"attn_kernel": "paged"}),
            (ServingEngine, Request, FlightRecorder, tparams, TCFG, PORT, "port",
             {"device": "cpu"})):
        rec = rec_cls(str(tmp_path / tag))
        tracer = m.tracer(registry=m.registry(enabled=True))
        eng = eng_cls(params, cfg, recorder=rec, tracer=tracer, **knobs, **kw)
        eng.pool.alloc(2)
        with pytest.raises(RuntimeError, match="black box"):
            eng.run([req_cls(prompt=reqs[0][0][:5], max_new_tokens=3)], now=_clock())
        boxes.append(json.load(open(rec.dumps[-1])))
    _close(boxes[1]["request_timelines"], boxes[0]["request_timelines"])
    assert [tl["uid"] for tl in boxes[1]["request_timelines"]["in_flight"]] == [0]
    assert boxes[1]["request_timelines"]["in_flight"][0]["phase"] == "queue"
    assert "fleet_traces" not in boxes[1]


def test_prefix_replay_benchmark_trace_equals_jax(setup):
    """``trace=True``: the ``request_trace`` block's keys and each arm's
    counts equal JAX's; the measured rows stay as without tracing."""
    from pipegoose_tpu.serving import prefix_replay_benchmark as jbench
    from pipegoose_tpu_torch.serving import prefix_replay_benchmark as tbench

    jparams, tparams, _ = setup
    kw = dict(n_requests=6, prefix_len=12, suffix_lens=(2, 5), max_new=4,
              num_slots=2, num_pages=32, page_size=4, max_context=32)
    want = jbench(jparams, JCFG, trace=True, **kw)
    got = tbench(tparams, TCFG, device="cpu", trace=True, **kw)
    assert set(got) == set(want)
    assert set(got["request_trace"]) == set(want["request_trace"])
    assert set(got["request_trace"]["summary"]) == set(want["request_trace"]["summary"])
    assert set(got["request_trace"]["arms"]) == set(want["request_trace"]["arms"])
    for arm, w in want["request_trace"]["arms"].items():
        g = got["request_trace"]["arms"][arm]
        assert set(g) == set(w)
        assert [g[k] for k in ("n", "hit_tokens", "prefill_tokens", "cache_hit_share")] == [
            w[k] for k in ("n", "hit_tokens", "prefill_tokens", "cache_hit_share")]
        assert [(r["uid"], r["hit_tokens"], r["prefill_tokens"], r["finish_reason"])
                for r in g["requests"]] == [
            (r["uid"], r["hit_tokens"], r["prefill_tokens"], r["finish_reason"])
            for r in w["requests"]]
        for r in g["requests"]:
            assert sum(r["components"].values()) == pytest.approx(r["e2e_s"], rel=1e-9)
    assert (got["request_trace"]["summary"]["prefill_token_reduction"]
            == want["request_trace"]["summary"]["prefill_token_reduction"])
    for arm in ("baseline", "cached"):
        assert got[arm]["prefill_tokens"] == want[arm]["prefill_tokens"]


def test_request_trace_events_files_are_valid_trace_json(setup, tmp_path):
    """A traced run's rows through the Chrome exporter: one JSON object,
    one named track per decode slot used."""
    from pipegoose_tpu_torch.telemetry import ChromeTraceExporter

    (_, _, _), (teng, ttr, _) = _traced(setup, "chunked")
    exp = ChromeTraceExporter(str(tmp_path / "t.json"))
    exp.add_request_timelines(ttr)
    payload = json.load(open(exp.write()))
    tracks = {e["args"]["name"] for e in payload["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name" and e["pid"] == 3}
    slots = {tl.slot for tl in ttr.completed}
    assert {f"slot {s}" for s in slots} <= tracks
    assert os.path.getsize(exp.path) > 0
