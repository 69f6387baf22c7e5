"""The port's ops server held against the JAX package on the CPU.

Counterparts of ``tests/telemetry/test_opsserver.py`` and the
``/debug/fleet`` tests of ``tests/telemetry/test_fleet.py``, against a real
server on ``127.0.0.1``, port 0: ``/metrics`` parses and agrees with the
textfile exporter and with what the JAX server serves for an equal
registry; ``/healthz`` turns degraded on a flight-recorder trigger and on
SLO burn, with the JAX server's body; the debug endpoints serve the
tracer, memory-ledger, goodput and fleet providers. The JAX server's
doctor, profile and plan providers wait for the port's A13b: the port's
server takes no such argument and those paths answer 404, as an unset
provider does. Then an engine's live registry, tracer and ledger served
while it runs."""
import inspect
import json
from types import SimpleNamespace
from urllib.error import HTTPError
from urllib.request import urlopen

import pytest

import pipegoose_tpu.telemetry.opsserver as jops
import pipegoose_tpu_torch.telemetry.opsserver as tops
from pipegoose_tpu.telemetry import MetricsRegistry as JRegistry
from pipegoose_tpu.telemetry.flightrec import FlightRecorder as JRecorder
from pipegoose_tpu.telemetry.reqtrace import RequestTracer as JTracer
from pipegoose_tpu.telemetry.slo import SLOMonitor as JMonitor
from pipegoose_tpu.telemetry.slo import SLOTarget as JTarget
from pipegoose_tpu_torch.telemetry import (
    FlightRecorder,
    MetricsRegistry,
    PrometheusTextfileExporter,
    RequestTracer,
    SLOMonitor,
    SLOTarget,
)
from pipegoose_tpu_torch.telemetry.opsserver import OpsServer, parse_prometheus_text

JAX = SimpleNamespace(ops=jops, registry=JRegistry, recorder=JRecorder, tracer=JTracer,
                      monitor=JMonitor, target=JTarget)
PORT = SimpleNamespace(ops=tops, registry=MetricsRegistry, recorder=FlightRecorder,
                       tracer=RequestTracer, monitor=SLOMonitor, target=SLOTarget)


def _get(url):
    try:
        r = urlopen(url, timeout=5)
        return r.status, r.read().decode()
    except HTTPError as e:
        return e.code, e.read().decode()


def _filled(m):
    r = m.registry(enabled=True)
    r.counter("serving.tokens_total", help="tokens").inc(42)
    r.gauge("serving.queue_depth").set(3)
    h = r.histogram("serving.ttft_seconds")
    h.observe(0.02)
    h.observe(0.2)
    return r


@pytest.fixture()
def reg():
    return _filled(PORT)


def test_metrics_parses_and_agrees_with_textfile_exporter_and_jax(reg, tmp_path):
    with OpsServer(registry=reg, port=0) as srv:
        assert srv.url is not None and srv.port != 0
        code, live = _get(srv.url + "/metrics")
    assert code == 200
    parsed = parse_prometheus_text(live)
    assert parsed["serving_tokens_total"] == 42.0
    assert parsed["serving_queue_depth"] == 3.0
    assert parsed["serving_ttft_seconds_count"] == 2.0
    assert parsed == parse_prometheus_text(reg.to_prometheus())
    path = str(tmp_path / "snap.prom")
    PrometheusTextfileExporter(path).write(reg)
    assert open(path).read() == live
    with jops.OpsServer(registry=_filled(JAX), port=0) as jsrv:
        _, jlive = _get(jsrv.url + "/metrics")
    assert live == jlive


def test_healthz_flips_on_flight_recorder_trigger(tmp_path):
    bodies = []
    for m in (JAX, PORT):
        rec = m.recorder(str(tmp_path / m.ops.__name__))
        with m.ops.OpsServer(registry=_filled(m), port=0, recorder=rec) as srv:
            seen = [_get(srv.url + "/healthz")]
            rec.trigger_decode_stall(17, "no decode progress for 100 iterations")
            seen.append(_get(srv.url + "/healthz"))
            rec.take_trigger()
            seen.append(_get(srv.url + "/healthz"))
        for code, body in seen:
            body = json.loads(body)
            for p in body["problems"]:
                p.pop("dump_path")
            bodies.append((code, body))
    assert bodies[3:] == bodies[:3]
    (ok0, b0), (bad, b1), (ok1, _) = bodies[3:]
    assert (ok0, bad, ok1) == (200, 503, 200) and b0["ok"] is True and b1["ok"] is False
    (problem,) = b1["problems"]
    assert problem["kind"] == "flight_recorder_trigger" and problem["name"] == "decode_stall"
    assert "no decode progress" in problem["reason"]


def test_healthz_flips_on_blown_slo_burn():
    out = []
    for m in (JAX, PORT):
        reg = _filled(m)
        clock = [0.0]
        mon = m.monitor([m.target(name="ttft", metric="serving.ttft_seconds",
                                  objective=0.1, target=0.9)],
                        registry=reg, fast_window_s=10, slow_window_s=100,
                        burn_threshold=2.0, clock=lambda: clock[0])
        with m.ops.OpsServer(registry=reg, port=0, slo=mon) as srv:
            c0, b0 = _get(srv.url + "/healthz")
            for _ in range(30):
                reg.metrics()["serving.ttft_seconds"].observe(9.0)
            clock[0] = 5.0
            c1, b1 = _get(srv.url + "/healthz")
        out.append((c0, json.loads(b0), c1, json.loads(b1)))
    assert out[1] == out[0]
    c0, b0, c1, b1 = out[1]
    assert c0 == 200 and "slo" in b0
    assert c1 == 503 and "slo_burn" in {p["kind"] for p in b1["problems"]}
    assert b1["slo"]["targets"]["ttft"]["breaching"] is True


def test_debug_requests_serves_tracer_snapshot():
    out = []
    for m in (JAX, PORT):
        reg = _filled(m)
        tracer = m.tracer(registry=reg)
        req = SimpleNamespace(uid=5, prompt_len=8, max_new_tokens=4, slot=None, hit_tokens=0,
                              generated=[], finish_reason=None)
        tracer.on_submit(req, 0.0)
        req.slot = 1
        tracer.on_admit(req, 1.0)
        with m.ops.OpsServer(registry=reg, port=0, tracer=tracer) as srv:
            code, body = _get(srv.url + "/debug/requests")
            _, hz = _get(srv.url + "/healthz")
        out.append((code, json.loads(body), json.loads(hz)["requests_in_flight"]))
    assert out[1] == out[0]
    code, payload, in_flight = out[1]
    assert code == 200 and [tl["uid"] for tl in payload["in_flight"]] == [5]
    assert payload["in_flight"][0]["phase"] == "prefill" and in_flight == 1


def test_debug_requests_404_without_tracer(reg):
    with OpsServer(registry=reg, port=0) as srv:
        code, body = _get(srv.url + "/debug/requests")
    assert code == 404 and "tracer" in json.loads(body)["error"]


@pytest.mark.parametrize("path,knob", [("/debug/doctor", "doctor"),
                                       ("/debug/profile", "profile"),
                                       ("/debug/plan", "plan")])
def test_doctor_profile_and_plan_answer_as_unset_providers(reg, path, knob):
    """A13b's providers: no constructor argument, no setter, and the path
    answers 404 where the JAX server with nothing attached does too."""
    assert knob not in inspect.signature(OpsServer.__init__).parameters
    assert not hasattr(OpsServer, f"set_{knob}") and not hasattr(OpsServer, "set_doctor_report")
    with pytest.raises(TypeError):
        OpsServer(registry=reg, port=0, **{knob: {"x": 1}})
    with OpsServer(registry=reg, port=0) as srv:
        got = _get(srv.url + path)
        _, root = _get(srv.url + "/")
    with jops.OpsServer(registry=_filled(JAX), port=0) as jsrv:
        want = _get(jsrv.url + path)
    assert got == want and got[0] == 404
    assert path not in json.loads(root)["endpoints"]


def test_unknown_path_404_and_root_lists_endpoints(reg):
    with OpsServer(registry=reg, port=0) as srv:
        code, _ = _get(srv.url + "/nope")
        assert code == 404
        code, body = _get(srv.url + "/")
    eps = json.loads(body)["endpoints"]
    assert code == 200
    assert set(eps) == {"/metrics", "/healthz", "/debug/requests", "/debug/fleet",
                        "/debug/memory", "/debug/goodput", "/debug/trace", "/debug/tail"}


def test_rank_filtered_server_never_binds(reg):
    srv = OpsServer(registry=reg, port=0, rank=1)
    assert srv.start() is None
    assert srv.port is None and srv.url is None
    srv.stop()


def test_stop_is_idempotent_and_start_after_stop_rebinds(reg):
    srv = OpsServer(registry=reg, port=0)
    url1 = srv.start()
    assert srv.start() == url1
    srv.stop()
    srv.stop()
    url2 = srv.start()
    assert url2 is not None
    assert _get(url2 + "/healthz")[0] == 200
    srv.stop()


@pytest.mark.parametrize("text", ["metric_one 1.0\nbroken line here extra\n",
                                  "metric notanumber\n", "1bad 2\n"])
def test_parse_prometheus_text_rejects_malformed(text):
    for mod in (jops, tops):
        with pytest.raises(ValueError):
            mod.parse_prometheus_text(text)


def test_parse_prometheus_text_equals_jax():
    text = "# TYPE a counter\na 1.0\nb{le=\"0.5\"} 2\n\n"
    assert tops.parse_prometheus_text(text) == jops.parse_prometheus_text(text) == {
        "a": 1.0, 'b{le="0.5"}': 2.0}


def test_debug_memory_serves_ledger_report(reg):
    """``MemoryLedger.report`` (the port's ledger over the port's pool)
    behind ``/debug/memory``, given at construction or by ``set_memory``;
    the payload equals the JAX ledger's over the same pool events."""
    from pipegoose_tpu.serving.kv_pool import PagePool as JPool
    from pipegoose_tpu.telemetry.memledger import MemoryLedger as JLedger
    from pipegoose_tpu_torch.serving.kv_pool import PagePool
    from pipegoose_tpu_torch.telemetry import MemoryLedger

    with OpsServer(registry=reg, port=0) as srv:
        code, body = _get(srv.url + "/debug/memory")
    assert code == 404 and "memory" in json.loads(body)["error"]
    pool, led = PagePool(num_pages=8, page_size=4), MemoryLedger()
    led.bind(pool, bytes_per_page=64)
    pool.alloc(2, owner=("req", 1))
    led.on_tick(1)
    jpool, jled = JPool(num_pages=8, page_size=4), JLedger()
    jled.bind(jpool, bytes_per_page=64)
    jpool.tag = ("req", 1)
    jpool.alloc(2)
    jled.on_tick(1)
    with OpsServer(registry=reg, port=0, memory=led.report) as srv:
        code, body = _get(srv.url + "/debug/memory")
    payload = json.loads(body)
    assert code == 200 and payload == json.loads(json.dumps(jled.report()))
    assert payload["classes"]["request"] == {"pages": 2, "bytes": 128}
    assert payload["conservation"]["ok"] is True and payload["capacity_bytes"] == 7 * 64
    with OpsServer(registry=reg, port=0) as srv:
        srv.set_memory(led.report)
        code, body = _get(srv.url + "/debug/memory")
    assert code == 200 and json.loads(body)["ticks"] == 1


def test_debug_goodput_serves_ledger_report(reg):
    from pipegoose_tpu_torch.telemetry import GoodputLedger

    led = GoodputLedger()
    led.touch("r0", 0.0, "serving", 0)
    led.account("r0", 1.0, "productive", "serving", 1)
    with OpsServer(registry=reg, port=0) as srv:
        assert _get(srv.url + "/debug/goodput")[0] == 404
        srv.set_goodput(led.report)
        code, body = _get(srv.url + "/debug/goodput")
    assert code == 200 and json.loads(body) == json.loads(json.dumps(led.report()))


def test_debug_fleet_endpoint_serves_provider(reg):
    payload = {"replicas": [{"name": "replica0", "state": "serving"}], "serving": 1}
    with OpsServer(registry=reg, port=0, fleet=lambda: payload) as srv:
        assert json.loads(_get(srv.url + "/debug/fleet")[1]) == payload
        assert "/debug/fleet" in json.loads(_get(srv.url + "/")[1])["endpoints"]


def test_debug_fleet_404_without_provider_and_on_a_raising_one(reg):
    def broken():
        raise RuntimeError("provider down")

    with OpsServer(registry=reg, port=0) as srv:
        assert _get(srv.url + "/debug/fleet")[0] == 404
        srv.set_fleet(broken)
        assert _get(srv.url + "/debug/fleet")[0] == 404


def test_engine_served_live(tmp_path):
    """A port engine with an enabled registry, a tracer, a recorder and a
    memory ledger, served while idle after a run: ``/metrics`` is the
    registry's text, ``/debug/requests`` the tracer's snapshot and
    ``/debug/memory`` the ledger's report; the server thread reads host
    state only."""
    import numpy as np

    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.serving import Request, ServingEngine

    cfg = bloom.BloomConfig(vocab_size=64, hidden_size=32, n_layer=2, n_head=4)
    params = params_from_jax(bloom.init_params_numpy(cfg, seed=0), cfg, device="cpu")
    reg = MetricsRegistry(enabled=True)
    tracer = RequestTracer(registry=reg)
    rec = FlightRecorder(str(tmp_path))
    eng = ServingEngine(params, cfg, device="cpu", registry=reg, tracer=tracer, recorder=rec,
                        memledger=True, num_slots=2, num_pages=16, page_size=4,
                        max_context=32, prefill_chunk=4)
    rng = np.random.RandomState(0)
    eng.run([Request(prompt=rng.randint(1, 64, (7,)), max_new_tokens=4) for _ in range(3)])
    with OpsServer(reg, slo=None, recorder=rec, tracer=tracer,
                   memory=eng.memledger.report) as srv:
        metrics = _get(srv.url + "/metrics")[1]
        requests = json.loads(_get(srv.url + "/debug/requests")[1])
        memory = json.loads(_get(srv.url + "/debug/memory")[1])
        health = _get(srv.url + "/healthz")
    assert metrics == reg.to_prometheus()      # an idle engine: the same text
    assert parse_prometheus_text(metrics)
    assert requests == json.loads(json.dumps(tracer.snapshot()))
    assert len(requests["completed"]) == 3
    assert memory == json.loads(json.dumps(eng.memledger.report()))
    assert health[0] == 200
