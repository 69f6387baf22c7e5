"""The port's Chrome / Perfetto trace export held against the JAX package.

Counterparts of ``tests/telemetry/test_chrometrace.py``, the router track
of ``tests/telemetry/test_fleet.py`` and the memory counter tracks of
``tests/telemetry/test_memledger.py``: the same span events, pipeline
schedulers, router decisions and ledger samples go through the JAX
renderers and the port's, and the rows must be equal (the host-span
process title and the exporter's name and creation time are each
package's own); the JAX tests' claims must hold on the port's rows."""
import json
import os
import threading
from types import SimpleNamespace

import pytest

import pipegoose_tpu.telemetry.chrometrace as jct
import pipegoose_tpu_torch.telemetry.chrometrace as tct
from pipegoose_tpu.nn.pipeline_parallel import scheduler as jsched
from pipegoose_tpu.telemetry import MetricsRegistry as JRegistry
from pipegoose_tpu.telemetry.spans import span as jspan
from pipegoose_tpu_torch.nn.pipeline_parallel import scheduler as tsched
from pipegoose_tpu_torch.telemetry import MetricsRegistry
from pipegoose_tpu_torch.telemetry.spans import span


def _assert_valid_trace(payload):
    assert set(payload) >= {"traceEvents", "displayTimeUnit"}
    for ev in payload["traceEvents"]:
        assert isinstance(ev["name"], str)
        assert ev["ph"] in ("X", "M", "i", "C")
        assert isinstance(ev["pid"], int)
        if ev["ph"] != "M" or "tid" in ev:
            assert isinstance(ev.get("tid", 0), int)
        if ev["ph"] == "X":
            assert ev["dur"] >= 0 and ev["ts"] >= 0
    json.dumps(payload)


def _comparable(payload):
    """A written trace without what is each package's own: the host-span
    process title and the exporter's name and creation time."""
    out = json.loads(json.dumps(payload))
    out["traceEvents"] = [e for e in out["traceEvents"]
                          if not (e["ph"] == "M" and e["name"] == "process_name"
                                  and e["pid"] == 1)]
    other = out.pop("otherData")
    return out, other["dropped_events"]


def test_pid_constants_equal_jax():
    names = ("PID_HOST", "PID_PIPELINE", "PID_REQUESTS", "PID_FLEET", "PID_PLANE",
             "PID_MEMORY", "PID_GOODPUT", "REPLICA_PID_BASE")
    assert [getattr(tct, n) for n in names] == [getattr(jct, n) for n in names]


def test_span_events_to_trace_microsecond_math():
    events = [
        {"kind": "span", "span": "train.step", "ts": 10.0, "dur_s": 0.5},
        {"kind": "train.fit_start", "ts": 9.0},
        {"no_kind": True},
    ]
    out = tct.span_events_to_trace(events)
    assert out == jct.span_events_to_trace(events)
    slice_, instant = out
    assert slice_["name"] == "train.step" and slice_["ph"] == "X"
    assert slice_["ts"] == pytest.approx(9.5e6)
    assert slice_["dur"] == pytest.approx(0.5e6)
    assert instant["ph"] == "i" and instant["name"] == "train.fit_start"


@pytest.mark.parametrize("m,p", [(4, 2), (3, 3), (1, 4)])
def test_pipeline_trace_events_rows_match_schedule(m, p):
    events = tct.pipeline_trace_events(tsched.GPipeScheduler(m, p), clock_s=1e-3)
    assert events == jct.pipeline_trace_events(jsched.GPipeScheduler(m, p), clock_s=1e-3)
    meta = [e for e in events if e["ph"] == "M"]
    assert {x["args"]["name"] for x in meta} == {
        "pipeline (theoretical clock timeline)", *(f"stage {i}" for i in range(p))}
    fwd = [e for e in events if e.get("cat") == "pipeline.forward"]
    bwd = [e for e in events if e.get("cat") == "pipeline.backward"]
    assert len(fwd) == m * p and len(bwd) == m * p
    for e in fwd:
        mb, st = e["args"]["microbatch"], e["args"]["stage"]
        assert e["tid"] == st and e["args"]["clock"] == mb + st
        assert e["ts"] == pytest.approx((mb + st) * 1e3)
    assert min(e["args"]["clock"] for e in bwd) == tsched.GPipeScheduler(m, p).total_forward_clocks
    _assert_valid_trace({"traceEvents": events, "displayTimeUnit": "ms"})


def test_bubble_fraction_and_gauges():
    assert tsched.GPipeScheduler(4, 4).bubble_fraction == pytest.approx(3 / 7)
    assert tsched.GPipeScheduler(8, 1).bubble_fraction == 0.0
    assert tsched.OneFOneBScheduler(4, 4).bubble_fraction == pytest.approx(3 / 7)
    reg, jreg = MetricsRegistry(enabled=True), JRegistry(enabled=True)
    frac = tct.register_pipeline_gauges(tsched.GPipeScheduler(8, 4), registry=reg,
                                        step_seconds=0.2)
    jct.register_pipeline_gauges(jsched.GPipeScheduler(8, 4), registry=jreg, step_seconds=0.2)
    assert frac == pytest.approx(3 / 11)
    assert reg.snapshot()["gauges"] == jreg.snapshot()["gauges"]
    assert reg.gauge("pipeline.bubble_seconds").value == pytest.approx(0.2 * 3 / 11)
    assert reg.gauge("pipeline.n_microbatches").value == 8.0


@pytest.mark.parametrize("m,p", [(4, 2), (6, 3)])
def test_pipeline_trace_events_1f1b_interleaved_timetable(m, p):
    sched = tsched.OneFOneBScheduler(m, p)
    events = tct.pipeline_trace_events(sched, clock_s=1e-3)
    assert events == jct.pipeline_trace_events(jsched.OneFOneBScheduler(m, p), clock_s=1e-3)
    slices = [e for e in events if e["ph"] == "X"]
    fwd = [e for e in slices if e["cat"] == "pipeline.forward"]
    bwd = [e for e in slices if e["cat"] == "pipeline.backward"]
    assert len(fwd) == m * p and len(bwd) == m * p
    seen = set()
    for e in slices:
        key = (e["tid"], e["args"]["clock"])
        assert key not in seen
        seen.add(key)
    assert max(e["args"]["clock"] for e in slices) == sched.n_clock - 1
    last_fwd = max(e["args"]["clock"] for e in fwd)
    assert any(e["args"]["clock"] < last_fwd for e in bwd)


def test_1f1b_bubble_fraction_from_timetable_and_gauges():
    s = tsched.OneFOneBScheduler(4, 2)
    assert s.bubble_fraction == pytest.approx(1.0 - 8.0 / s.n_clock)
    assert s.n_clock == 2 * (4 + 2 - 1)
    reg, jreg = MetricsRegistry(enabled=True), JRegistry(enabled=True)
    frac = tct.register_pipeline_gauges(s, registry=reg, step_seconds=0.1)
    jct.register_pipeline_gauges(jsched.OneFOneBScheduler(4, 2), registry=jreg,
                                 step_seconds=0.1)
    assert frac == pytest.approx(s.bubble_fraction)
    assert reg.snapshot()["gauges"] == jreg.snapshot()["gauges"]


def test_exporter_collects_spans_and_writes_atomically(tmp_path):
    reg = MetricsRegistry(enabled=True)
    path = str(tmp_path / "trace.json")
    exp = tct.ChromeTraceExporter(path, registry=reg)
    with span("train.step", registry=reg):
        with span("forward", registry=reg):
            pass
    reg.event("train.fit_end")
    exp.add_pipeline_timeline(tsched.GPipeScheduler(2, 2), clock_s=1e-3)
    assert exp.write() == path
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    payload = json.load(open(path))
    _assert_valid_trace(payload)
    names = [e["name"] for e in payload["traceEvents"]]
    assert {"train.step", "train.step.forward", "train.fit_end", "F0", "B1"} <= set(names)
    by = {e["name"]: e for e in payload["traceEvents"] if e["ph"] == "X"}
    outer, inner = by["train.step"], by["train.step.forward"]
    assert outer["ts"] <= inner["ts"] + 1000.0
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1000.0
    # the JAX exporter fed the same registry events writes the same names
    jreg = JRegistry(enabled=True)
    jexp = jct.ChromeTraceExporter(str(tmp_path / "jax.json"), registry=jreg)
    with jspan("train.step", registry=jreg):
        with jspan("forward", registry=jreg):
            pass
    jreg.event("train.fit_end")
    jexp.add_pipeline_timeline(jsched.GPipeScheduler(2, 2), clock_s=1e-3)
    jnames = [e["name"] for e in json.load(open(jexp.write()))["traceEvents"]]
    assert sorted(names) == sorted(jnames)
    exp.close()
    assert exp not in reg._sinks


def test_exporter_bounds_memory_keeping_newest(tmp_path):
    payloads = []
    for mod in (jct, tct):
        exp = mod.ChromeTraceExporter(str(tmp_path / f"{mod.__name__}.json"), max_events=5)
        for i in range(12):
            exp({"kind": "span", "span": f"s{i}", "ts": float(i), "dur_s": 0.1})
        payloads.append(_comparable(json.load(open(exp.write()))))
    assert payloads[1] == payloads[0]
    trace, dropped = payloads[1]
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in spans] == ["s7", "s8", "s9", "s10", "s11"]
    assert dropped == 7


def test_exporter_separates_threads(tmp_path):
    exp = tct.ChromeTraceExporter(str(tmp_path / "t.json"))
    exp({"kind": "span", "span": "main", "ts": 1.0, "dur_s": 0.1})
    t = threading.Thread(target=exp, args=({"kind": "span", "span": "bg", "ts": 1.0,
                                            "dur_s": 0.1},))
    t.start()
    t.join()
    payload = json.load(open(exp.write()))
    by = {e["name"]: e for e in payload["traceEvents"] if e["ph"] == "X"}
    assert by["main"]["tid"] != by["bg"]["tid"]


def test_rank_filter_suppresses_write(tmp_path):
    exp = tct.ChromeTraceExporter(str(tmp_path / "t.json"), rank=7)
    exp({"kind": "span", "span": "s", "ts": 1.0, "dur_s": 0.1})
    assert exp.write() is None
    assert not os.path.exists(tmp_path / "t.json")
    assert len(exp._events) == 0     # filtered at capture, not only at write


def test_trace_from_jsonl_offline_conversion(tmp_path):
    jsonl = tmp_path / "run.jsonl"
    lines = [
        {"ts": 1.0, "kind": "span", "span": "serving.decode_step", "dur_s": 0.01},
        {"ts": 2.0, "kind": "snapshot", "counters": {}},
        {"ts": 3.0, "kind": "serving.step", "step": 1},
    ]
    with open(jsonl, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
        f.write('{"truncated": \n')
    got = json.load(open(tct.trace_from_jsonl(str(jsonl), str(tmp_path / "t.json"))))
    want = json.load(open(jct.trace_from_jsonl(str(jsonl), str(tmp_path / "j.json"))))
    assert _comparable(got) == _comparable(want)
    _assert_valid_trace(got)
    names = [e["name"] for e in got["traceEvents"]]
    assert "serving.decode_step" in names and "serving.step" in names
    assert "snapshot" not in names


def test_router_trace_events_one_track_per_replica():
    decisions = [
        {"t": 1.0, "seq": 0, "tenant": "t0", "replica": "replica0",
         "policy": "cache_aware", "matched_tokens": 0, "prompt_len": 20, "candidates": 2},
        {"t": 2.0, "seq": 1, "tenant": "t1", "replica": "replica1",
         "policy": "cache_aware", "matched_tokens": 16, "prompt_len": 20, "candidates": 2},
        {"t": 3.0, "seq": 2, "tenant": None, "replica": "replica0",
         "policy": "cache_aware", "matched_tokens": 16, "prompt_len": 20, "candidates": 2},
    ]
    rows = tct.router_trace_events(decisions)
    assert rows == jct.router_trace_events(decisions)
    assert {r["args"]["name"] for r in rows if r["name"] == "thread_name"} == {
        "replica0", "replica1"}
    assert all(r["pid"] == tct.PID_FLEET for r in rows)
    markers = [r for r in rows if r["ph"] == "i"]
    assert len(markers) == 3 and markers[0]["ts"] == pytest.approx(1.0e6)
    assert markers[1]["name"] == "route t1 +16tok"
    assert markers[2]["name"] == "route default +16tok"
    assert markers[0]["tid"] == markers[2]["tid"]
    assert tct.router_trace_events(decisions, wall_offset=2.0)[-1]["ts"] == pytest.approx(5e6)


def test_memory_trace_events_render_counter_tracks():
    """The same pool events through the JAX ledger and the port's: equal
    counter tracks, with the host tier's resident bytes."""
    from pipegoose_tpu.serving.kv_pool import PagePool as JPool
    from pipegoose_tpu.telemetry.memledger import MemoryLedger as JLedger
    from pipegoose_tpu_torch.serving.kv_pool import PagePool
    from pipegoose_tpu_torch.telemetry.memledger import MemoryLedger

    tier = SimpleNamespace(resident_bytes=640, resident_pages=5, byte_budget=1 << 20)
    out = []
    for pool_cls, led_cls, alloc in (
            (JPool, JLedger, lambda pool: (setattr(pool, "tag", ("req", 1)), pool.alloc(2))),
            (PagePool, MemoryLedger, lambda pool: pool.alloc(2, owner=("req", 1)))):
        pool, led = pool_cls(num_pages=8, page_size=4), led_cls()
        led.bind(pool, host_tier=tier)
        led.bytes_per_page = 64
        alloc(pool)
        led.on_tick(1, t=1.0)
        led.on_tick(2, t=1.5)
        out.append((pool_cls is PagePool and tct or jct).memory_trace_events(led))
    assert out[1] == out[0]
    events = out[1]
    assert events[0]["ph"] == "M" and events[0]["pid"] == tct.PID_MEMORY
    kv = [e for e in events if e["ph"] == "C" and e["name"] == "kv bytes"]
    assert len(kv) == 2 and kv[0]["ts"] == 1.0e6 and kv[0]["args"]["request"] == 128
    assert {e["name"] for e in events if e["ph"] == "C"} >= {
        "kv bytes", "fragmentation", "host tier bytes"}
