"""The port's fleet tracer held against the JAX package on the CPU.

Counterparts of ``tests/telemetry/test_fleettrace.py``: the same plane
hops, marked by hand with hand-placed times, and the same replica
fragments go through the JAX ``FleetTracer`` / ``RequestTracer`` and the
port's; the stitched traces, tail exemplars, black-box payloads, merged
Perfetto export and ``/debug/trace`` / ``/debug/tail`` bodies must be
equal (wall offsets zeroed: each tracer anchors its own), and the JAX
tests' claims must hold on the port's. Then a port engine's tracer
registered as one replica, its requests served by the engine and the
plane hops marked by hand: plane hops plus the replica share equal each
stitched trace's end-to-end time."""
import json
from types import SimpleNamespace
from urllib.error import HTTPError
from urllib.request import urlopen

import pytest

import pipegoose_tpu.telemetry.chrometrace as jct
import pipegoose_tpu.telemetry.fleettrace as jft
import pipegoose_tpu.telemetry.opsserver as jops
import pipegoose_tpu.telemetry.reqtrace as jrt
import pipegoose_tpu_torch.telemetry.chrometrace as tct
import pipegoose_tpu_torch.telemetry.fleettrace as tft
import pipegoose_tpu_torch.telemetry.opsserver as tops
import pipegoose_tpu_torch.telemetry.reqtrace as trt
from pipegoose_tpu.telemetry import MetricsRegistry as JRegistry
from pipegoose_tpu_torch.telemetry import MetricsRegistry

JAX = SimpleNamespace(ft=jft, rt=jrt, ct=jct, ops=jops, registry=JRegistry)
PORT = SimpleNamespace(ft=tft, rt=trt, ct=tct, ops=tops, registry=MetricsRegistry)


def _get(url):
    try:
        r = urlopen(url, timeout=5)
        return r.status, r.read().decode()
    except HTTPError as e:
        return e.code, e.read().decode()


class _Req:
    def __init__(self, uid=None, tenant=None):
        self.uid = uid
        self.tenant = tenant
        self.trace_id = None
        self.prompt_len = 4
        self.max_new_tokens = 2
        self.generated = []
        self.finish_reason = None
        self.t_submit = None
        self.t_done = None
        self.slot = 0
        self.hit_tokens = 0


def _stitch_one(ft, tracer, *, uid=11, t0=1.0, decode_s=0.6, tenant="acme"):
    """One request through every hook: plane hops 0.5/0.2/0.1/0.2, the
    replica fragment queue 0.2 + prefill 0.3 + decode ``decode_s``."""
    req = _Req(tenant=tenant)
    req.t_submit = t0
    ft.on_ingress(req, t0)
    ft.on_dispatch_pass(t0 + 0.5)
    ft.on_ledger_pop(req, t0 + 0.7)
    ft.on_routed(req, t0 + 0.8, "replica0")
    req.uid = uid
    tracer.on_submit(req, t0 + 1.0)
    ft.on_dispatched(req, "replica0")
    tracer.on_admit(req, t0 + 1.2)
    tracer.on_first_token(req, t0 + 1.5)
    t_done = t0 + 1.5 + decode_s
    req.finish_reason = "length"
    req.t_done = t_done
    tracer.on_done(req, t_done)
    ft.on_finished(req, SimpleNamespace(e2e_latency_s=t_done - t0, ttft_s=1.5,
                                        finish_reason="length"))
    return req


def _pair(m):
    reg = m.registry(enabled=True)
    ft = m.ft.FleetTracer(registry=reg)
    tracer = m.rt.RequestTracer(registry=m.registry(), name="replica0")
    ft.register_replica("replica0", tracer)
    return ft, tracer, reg


def _zero(ft, tracer):
    ft._wall_offset = 0.0
    tracer._wall_offset = 0.0


def _both(scenario):
    """``scenario(m, fleet tracer, replica tracer, registry)`` on both
    packages; the JSON-able results must be equal."""
    out = []
    for m in (JAX, PORT):
        ft, tracer, reg = _pair(m)
        out.append(json.loads(json.dumps(scenario(m, ft, tracer, reg))))
    assert out[1] == out[0]
    return out[1]


def test_constants_equal_jax():
    assert tft.PLANE_HOPS == jft.PLANE_HOPS and tft.OBJECTIVES == jft.OBJECTIVES


def test_synthetic_stitch_is_exact_and_queryable():
    def scenario(m, ft, tracer, reg):
        req = _stitch_one(ft, tracer)
        snap = reg.snapshot()
        return {"trace_id": req.trace_id, "row": ft.trace_json(trace_id=1),
                "by_uid": ft.trace_json(uid=11)["trace_id"],
                "missing": [ft.trace_json(uid=999), ft.trace_json(trace_id=999)],
                "counters": snap["counters"],
                "replica_count": snap["histograms"]["fleet.attrib.replica_seconds"]["count"]}

    out = _both(scenario)
    row = out["row"]
    assert out["trace_id"] == 1 and out["by_uid"] == 1 and out["missing"] == [None, None]
    assert row["hops"] == pytest.approx({"ingress_s": 0.5, "ledger_s": 0.2, "route_s": 0.1,
                                         "dispatch_s": 0.2, "salvage_s": 0.0})
    assert row["replica_s"] == pytest.approx(1.1)
    assert row["stitched_total_s"] == pytest.approx(row["e2e_s"], abs=1e-9)
    assert row["dominant_hop"] == "replica0:decode_s"
    assert row["legs"][0]["replica"] == "replica0" and row["legs"][0]["uid"] == 11
    assert out["counters"]["fleet.attrib.traces_total"] == 1.0
    assert out["counters"]["fleet.attrib.legs_total"] == 1.0
    assert out["replica_count"] == 1


def test_requeue_retry_books_as_route_wait():
    def scenario(m, ft, tracer, reg):
        req = _Req()
        ft.on_ingress(req, 0.0)
        ft.on_dispatch_pass(1.0)
        ft.on_ledger_pop(req, 1.0)
        ft.on_ledger_pop(req, 2.0)
        ft.on_routed(req, 3.0, "replica0")
        req.uid = 1
        tracer.on_submit(req, 3.5)
        ft.on_dispatched(req, "replica0")
        return ft.active[req.trace_id].hops()

    hops = _both(scenario)
    assert hops["ingress_s"] == pytest.approx(1.0)
    assert hops["route_s"] == pytest.approx(2.0)
    assert hops["dispatch_s"] == pytest.approx(0.5)


def test_leave_seals_the_fragment_and_books_salvage():
    """A drain migration: the fragment on replica0 is sealed at the leave,
    the re-route closes the salvage hop, and the second leg finishes on
    replica1; hops plus both legs equal the end-to-end time."""
    def scenario(m, ft, tracer, reg):
        tr1 = m.rt.RequestTracer(registry=m.registry(), name="replica1")
        ft.register_replica("replica1", tr1)
        req = _Req()
        ft.on_ingress(req, 0.0)
        ft.on_dispatch_pass(0.1)
        ft.on_ledger_pop(req, 0.2)
        ft.on_routed(req, 0.3, "replica0")
        req.uid = 4
        tracer.on_submit(req, 0.4)
        ft.on_dispatched(req, "replica0")
        tracer.on_admit(req, 0.6)
        ft.on_leave(req, "replica0", 1.0, "drain")
        ft.on_routed(req, 1.5, "replica1")
        req.uid = 9
        tr1.on_submit(req, 1.6)
        ft.on_dispatched(req, "replica1")
        tr1.on_admit(req, 1.7)
        tr1.on_first_token(req, 2.0)
        req.finish_reason = "length"
        tr1.on_done(req, 2.5)
        ft.on_finished(req, SimpleNamespace(e2e_latency_s=2.5, ttft_s=2.0,
                                            finish_reason="length"))
        return ft.trace_json(trace_id=req.trace_id)

    row = _both(scenario)
    assert [leg["replica"] for leg in row["legs"]] == ["replica0", "replica1"]
    assert row["legs"][0]["leave_reason"] == "drain"
    assert row["hops"]["salvage_s"] == pytest.approx(0.5)
    assert row["stitched_total_s"] == pytest.approx(row["e2e_s"], abs=1e-9)


def test_plane_shed_and_lost_finalize_without_tail():
    def scenario(m, ft, tracer, reg):
        shed, lost = _Req(), _Req()
        ft.on_ingress(shed, 0.0)
        ft.on_ingress(lost, 0.0)
        ft.on_dispatch_pass(0.4)
        ft.on_plane_shed(shed, 2.0)
        ft.on_lost(lost, 3.0)
        return {"active": len(ft.active),
                "done": [(t.finish_reason, t.e2e_s, t.lost) for t in ft.completed],
                "exemplar": ft.exemplar("e2e"), "tail": ft.tail_payload()["e2e"],
                "lost": reg.snapshot()["counters"]["fleet.attrib.lost_total"]}

    out = _both(scenario)
    assert out["active"] == 0 and out["exemplar"] is None and out["tail"] == []
    assert out["done"][0][0] == "shed" and out["done"][0][1] == pytest.approx(2.0)
    assert out["done"][1][2] is True and out["lost"] == 1.0


def test_tail_sampler_bounds_and_ordering():
    for mod in (jft, tft):
        with pytest.raises(ValueError, match="k must be"):
            mod.TailSampler(k=0)
    out = []
    for mod in (jft, tft):
        ts = mod.TailSampler(k=2)
        for i, e2e in enumerate((0.3, 0.9, 0.1, 0.5)):
            ts.offer(SimpleNamespace(ttft_s=None if i == 0 else e2e / 2, e2e_s=e2e,
                                     attribution=lambda: {"stub": True}))
        out.append(([v for v, _ in ts.top("e2e")], [v for v, _ in ts.top("ttft")],
                    [v for v, _ in ts.top("e2e", 1)], ts.payload()))
        with pytest.raises(ValueError, match="unknown objective"):
            ts.top("p99")
    assert out[1] == out[0]
    e2e, ttft, top1, payload = out[1]
    assert e2e == [0.9, 0.5] and ttft == [0.45, 0.25] and top1 == [0.9]
    assert set(payload) == set(tft.OBJECTIVES) and payload["e2e"][0]["value_s"] == 0.9


def test_fleettracer_validation():
    for m in (JAX, PORT):
        with pytest.raises(ValueError, match="keep_completed"):
            m.ft.FleetTracer(registry=m.registry(), keep_completed=0)


def test_exemplar_and_blackbox_payloads():
    def scenario(m, ft, tracer, reg):
        _stitch_one(ft, tracer, uid=1, t0=0.0, decode_s=0.2)
        _stitch_one(ft, tracer, uid=2, t0=10.0, decode_s=1.4)
        live = _Req()
        ft.on_ingress(live, 20.0)
        return {"ex": ft.exemplar("e2e"), "box": ft.blackbox_payload(top_n=1),
                "summary": ft.summary_payload(), "live": live.trace_id}

    out = _both(scenario)
    ex, box, summary = out["ex"], out["box"], out["summary"]
    assert ex["objective"] == "e2e" and ex["trace"]["uid"] == 2
    assert ex["dominant_hop"] == "replica0:decode_s"
    assert ex["dominant_share"] == pytest.approx(1.4 / ex["trace"]["e2e_s"])
    assert [a["trace_id"] for a in box["active"]] == [out["live"]]
    assert len(box["tail"]["e2e"]) == 1
    assert summary["traces"] == 2
    assert set(summary["per_hop"]) == set(tft.PLANE_HOPS + ("replica_s",))
    assert summary["per_hop"]["replica_s"]["p99"] >= summary["per_hop"]["replica_s"]["p50"]


def test_recorder_embeds_the_fleet_traces(tmp_path):
    """``FlightRecorder.set_fleet_tracer``: every later black box embeds
    the active traces and tail exemplars, as the JAX recorder's does."""
    from pipegoose_tpu.telemetry import FlightRecorder as JRecorder
    from pipegoose_tpu_torch.telemetry import FlightRecorder

    boxes = []
    for m, rec_cls in ((JAX, JRecorder), (PORT, FlightRecorder)):
        ft, tracer, _ = _pair(m)
        _stitch_one(ft, tracer, uid=3)
        ft.on_ingress(_Req(), 9.0)
        rec = rec_cls(str(tmp_path / m.ft.__name__))
        rec.set_fleet_tracer(ft)
        trig = rec.fire_trigger("slo_burn", "ttft burn", 1)
        boxes.append(json.load(open(trig.dump_path))["fleet_traces"])
    assert boxes[1] == boxes[0]
    assert len(boxes[1]["active"]) == 1 and boxes[1]["tail"]["e2e"][0]["uid"] == 3


def test_shared_tracer_reuse_uid_keeps_two_timelines():
    def scenario(m, ft, tracer, reg):
        tr = m.rt.RequestTracer(registry=m.registry())
        a, b = _Req(uid=5, tenant="a"), _Req(uid=5, tenant="b")
        a.trace_id, b.trace_id = 1, 2
        tr.on_submit(a, 1.0)
        tr.on_submit(b, 1.5)
        keys = sorted(map(list, tr.in_flight))
        tenants = [tr.in_flight[(1, 5)].tenant, tr.in_flight[(2, 5)].tenant]
        a.finish_reason = b.finish_reason = "length"
        tr.on_done(a, 2.0)
        tr.on_done(b, 3.0)
        return keys, tenants, sorted(tl.e2e_s for tl in tr.completed), sorted(
            r.attribution()["trace_id"] for r in tr.completed)

    keys, tenants, e2es, ids = _both(scenario)
    assert keys == [[1, 5], [2, 5]] and tenants == ["a", "b"]
    assert e2es == [pytest.approx(1.0), pytest.approx(1.5)] and ids == [1, 2]


def test_untraced_requests_keep_bare_uid_behavior():
    tracer = trt.RequestTracer(registry=MetricsRegistry())
    a = _Req(uid=7)
    tracer.on_submit(a, 1.0)
    tracer.on_admit(a, 1.5)
    assert len(tracer.in_flight) == 1
    assert tracer.in_flight[(None, 7)].trace_id is None


def test_two_replica_export_has_disjoint_pids(tmp_path):
    out = []
    for m in (JAX, PORT):
        tr0 = m.rt.RequestTracer(registry=m.registry(), name="replica0")
        tr1 = m.rt.RequestTracer(registry=m.registry(), name="replica1")
        for i, tr in enumerate((tr0, tr1)):
            req = _Req(uid=i)
            tr.on_submit(req, 1.0)
            tr.on_admit(req, 1.5)
            req.finish_reason = "length"
            tr.on_done(req, 2.0)
            tr._wall_offset = 0.0
        exp = m.ct.ChromeTraceExporter(str(tmp_path / f"{m.ft.__name__}.json"))
        exp.add_request_timelines(tr0)
        exp.add_request_timelines(tr1)
        exp.add_request_timelines(tr0)
        events = json.load(open(exp.write()))["traceEvents"]
        out.append([e for e in events if e.get("pid") != tct.PID_HOST])
    assert out[1] == out[0]
    pids = {e["args"]["name"]: e["pid"] for e in out[1]
            if e.get("ph") == "M" and e["name"] == "process_name"}
    assert pids == {"serving requests (replica0)": tct.PID_REQUESTS,
                    "serving requests (replica1)": tct.REPLICA_PID_BASE}
    assert {e["pid"] for e in out[1] if e.get("ph") == "X"} == {
        tct.PID_REQUESTS, tct.REPLICA_PID_BASE}


def test_request_trace_events_default_name_unchanged():
    tr = trt.RequestTracer(registry=MetricsRegistry())
    req = _Req(uid=1)
    tr.on_submit(req, 1.0)
    req.finish_reason = "length"
    tr.on_done(req, 2.0)
    meta = [e for e in trt.request_trace_events(tr)
            if e.get("ph") == "M" and e.get("name") == "process_name"]
    assert meta[0]["args"]["name"] == "serving requests (per-slot timelines)"
    assert meta[0]["pid"] == tct.PID_REQUESTS


def test_fleet_trace_events_merged_export():
    def scenario(m, ft, tracer, reg):
        _stitch_one(ft, tracer)
        _zero(ft, tracer)
        return m.ft.fleet_trace_events(ft)

    events = _both(scenario)
    meta = {(e["pid"], e["args"]["name"]) for e in events
            if e.get("ph") == "M" and e["name"] == "process_name"}
    assert (tct.PID_PLANE, "control plane (fleet hops)") in meta
    assert (tct.REPLICA_PID_BASE, "replica replica0") in meta
    hops = [e for e in events if e.get("ph") == "X" and e.get("cat", "").startswith("fleet.")]
    assert {e["name"] for e in hops} >= {"trace1 ingress", "trace1 ledger", "trace1 route",
                                         "trace1 dispatch", "trace1 replica"}
    assert all(e["pid"] == tct.PID_PLANE for e in hops)
    flows = [e for e in events if e.get("cat") == "fleet.flow"]
    starts = [e for e in flows if e["ph"] == "s"]
    finishes = [e for e in flows if e["ph"] == "f"]
    assert starts and {e["id"] for e in starts} == {e["id"] for e in finishes}
    assert starts[0]["pid"] == tct.PID_PLANE and finishes[0]["pid"] == tct.REPLICA_PID_BASE
    frag = [e for e in events if e.get("ph") == "X" and e.get("cat", "").startswith("request.")]
    assert frag and all(e["pid"] == tct.REPLICA_PID_BASE for e in frag)


def test_fleet_trace_events_transfer_and_pull_flows():
    """A fragment with a transfer and a pull hint: the arrows inside the
    replica process and from the hinted peer, equal to JAX's."""
    def scenario(m, ft, tracer, reg):
        peer = m.rt.RequestTracer(registry=m.registry(), name="replica1")
        ft.register_replica("replica1", peer)
        req = _Req()
        ft.on_ingress(req, 0.0)
        ft.on_dispatch_pass(0.1)
        ft.on_ledger_pop(req, 0.2)
        ft.on_routed(req, 0.3, "replica0")
        req.uid = 2
        tracer.on_submit(req, 0.4)
        ft.on_dispatched(req, "replica0")
        tracer.annotate(req, "pull_hint", t=0.45, peer="replica1")
        tracer.on_admit(req, 0.5)
        tracer.on_first_token(req, 0.8)
        tracer.on_transfer_start(req, 0.8)
        tracer.on_transfer_done(req, 1.0)
        req.finish_reason = "length"
        tracer.on_done(req, 1.2)
        ft.on_finished(req, SimpleNamespace(e2e_latency_s=1.2, ttft_s=0.8,
                                            finish_reason="length"))
        _zero(ft, tracer)
        peer._wall_offset = 0.0
        return m.ft.fleet_trace_events(ft)

    events = _both(scenario)
    names = {e["name"] for e in events if e.get("cat") == "fleet.flow"}
    assert {"trace1 dispatch", "trace1 transfer", "trace1 pull replica1"} <= names


def test_debug_trace_and_tail_endpoints():
    bodies = []
    for m in (JAX, PORT):
        ft, tracer, _ = _pair(m)
        req = _stitch_one(ft, tracer)
        with m.ops.OpsServer(registry=m.registry(enabled=True), port=0, fleettrace=ft) as srv:
            got = [_get(srv.url + p) for p in (
                f"/debug/trace?trace_id={req.trace_id}", f"/debug/trace?uid={req.uid}",
                "/debug/trace", "/debug/trace?uid=bogus", "/debug/trace?trace_id=404",
                "/debug/tail")]
            listing = json.loads(_get(srv.url + "/")[1])["endpoints"]
        bodies.append([(code, json.loads(body)) for code, body in got])
        assert "/debug/trace" in listing and "/debug/tail" in listing
    assert bodies[1] == bodies[0]
    by_id, by_uid, none, bogus, missing, tail = bodies[1]
    assert by_id[0] == 200 and by_id[1]["dominant_hop"] == "replica0:decode_s"
    assert by_uid[0] == 200 and by_uid[1]["uid"] == 11
    assert (none[0], bogus[0], missing[0]) == (400, 400, 404)
    assert tail[0] == 200 and tail[1]["e2e"][0]["trace_id"] == 1


def test_debug_trace_404_without_tracer():
    with tops.OpsServer(registry=MetricsRegistry(enabled=True), port=0) as srv:
        code, body = _get(srv.url + "/debug/trace?uid=1")
        assert code == 404 and "no fleet tracer" in json.loads(body)["error"]
        assert _get(srv.url + "/debug/tail")[0] == 404
    srv = tops.OpsServer(registry=MetricsRegistry(enabled=True), port=0)
    srv.set_fleettrace(tft.FleetTracer(registry=MetricsRegistry()))
    with srv:
        assert _get(srv.url + "/debug/tail")[0] == 200


def test_engine_replica_stitches_to_end_to_end(tmp_path):
    """A port engine's tracer as replica "r0": the hops before dispatch
    marked by hand, the engine serving the requests on the same clock;
    every stitched trace's plane hops plus its replica share equal its
    end-to-end time within 1e-6 s."""
    import numpy as np

    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.serving import Request, ServingEngine

    cfg = bloom.BloomConfig(vocab_size=64, hidden_size=32, n_layer=2, n_head=4)
    params = params_from_jax(bloom.init_params_numpy(cfg, seed=0), cfg, device="cpu")
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    tracer = trt.RequestTracer(registry=MetricsRegistry(enabled=True), name="r0")
    ft = tft.FleetTracer(registry=MetricsRegistry(enabled=True), clock=now)
    ft.register_replica("r0", tracer)
    eng = ServingEngine(params, cfg, device="cpu", tracer=tracer, num_slots=2, num_pages=16,
                        page_size=4, max_context=32, prefill_chunk=4)
    rng = np.random.RandomState(1)
    reqs = [Request(prompt=rng.randint(1, 64, (k,)), max_new_tokens=3) for k in (5, 9, 6)]
    for r in reqs:
        ft.on_ingress(r, now())
    ft.on_dispatch_pass(now())
    for r in reqs:
        ft.on_ledger_pop(r, now())
        ft.on_routed(r, now(), "r0")
    eng.start_run(now=now)
    for r in reqs:
        eng.sched.submit(r, now())
        ft.on_dispatched(r, "r0")
    while not eng.sched.all_done():
        eng.tick_once()
    outs, _ = eng.finish_run()
    t0 = {r.trace_id: ft.active[r.trace_id].t0 for r in reqs}
    for r, o in zip(reqs, outs):
        ft.on_finished(r, SimpleNamespace(e2e_latency_s=r.t_done - t0[r.trace_id],
                                          ttft_s=r.t_first_token - t0[r.trace_id],
                                          finish_reason=o.finish_reason))
    rows = [ft.trace_json(trace_id=r.trace_id) for r in reqs]
    for row in rows:
        assert abs(row["stitched_total_s"] - row["e2e_s"]) <= 1e-6
        assert row["hops"]["dispatch_s"] > 0 and row["replica_s"] > 0
    assert [row["uid"] for row in rows] == [r.uid for r in reqs]
