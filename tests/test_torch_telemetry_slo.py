"""The port's exporters, SLO monitor and fleet merge: the counterparts of
``tests/telemetry/test_exporters.py``, ``test_slo.py`` and
``test_fleet.py`` (all but the router's Chrome track and the ops server's
``/debug/fleet``, which wait for the second half of the telemetry core),
run on ``pipegoose_tpu_torch.telemetry``; and the two packages fed the same
inputs: equal JSONL lines apart from ``ts``, equal SLO verdicts, burn
rates and black-box triggers, equal merged fleet snapshots."""
import json
import os

import numpy as np
import pytest
import torch

from pipegoose_tpu_torch.telemetry import (
    JSONLExporter,
    MetricsRegistry,
    PrometheusTextfileExporter,
)
from pipegoose_tpu_torch.telemetry.fleet import (
    FleetRegistry,
    merge_histograms,
    merge_metrics,
)
from pipegoose_tpu_torch.telemetry.flightrec import FlightRecorder
from pipegoose_tpu_torch.telemetry.registry import Histogram
from pipegoose_tpu_torch.telemetry.slo import (
    SLOMonitor,
    SLOTarget,
    default_serving_slos,
)


# -- exporters (tests/telemetry/test_exporters.py) ---------------------------

def _reg():
    reg = MetricsRegistry(enabled=True)
    reg.counter("tok.total").inc(42)
    reg.gauge("tps").set(1234.5)
    reg.histogram("lat.seconds").observe(0.02)
    return reg


def test_jsonl_events_and_snapshot_roundtrip(tmp_path):
    path = str(tmp_path / "events.jsonl")
    reg = _reg()
    with JSONLExporter(path, registry=reg) as ex:
        reg.event("step", i=0, tokens_per_s=10.0)
        reg.event("step", i=1, tokens_per_s=12.0)
        ex.export_snapshot()
    lines = [json.loads(l) for l in open(path)]
    assert [l["kind"] for l in lines] == ["step", "step", "snapshot"]
    assert lines[1]["tokens_per_s"] == 12.0
    snap = lines[2]
    assert snap["counters"]["tok.total"] == 42.0
    assert snap["gauges"]["tps"] == 1234.5
    assert snap["histograms"]["lat.seconds"]["count"] == 1


def test_jsonl_close_detaches_sink(tmp_path):
    path = str(tmp_path / "e.jsonl")
    reg = _reg()
    ex = JSONLExporter(path, registry=reg)
    reg.event("a")
    ex.close()
    reg.event("b")  # after close: not written
    kinds = [json.loads(l)["kind"] for l in open(path)]
    assert kinds == ["a"]


def test_jsonl_serializes_numpy_scalars(tmp_path):
    import numpy as np

    path = str(tmp_path / "np.jsonl")
    reg = _reg()
    with JSONLExporter(path, registry=reg):
        reg.event("x", v=np.float32(1.5), n=np.int64(3))
    (line,) = [json.loads(l) for l in open(path)]
    assert line["v"] == 1.5 and line["n"] == 3


def test_prometheus_textfile_write(tmp_path):
    path = str(tmp_path / "metrics.prom")
    reg = _reg()
    out = PrometheusTextfileExporter(path).write(reg)
    assert out == path
    text = open(path).read()
    assert "tok_total 42.0" in text
    assert "tps 1234.5" in text
    assert 'lat_seconds_bucket{le="+Inf"} 1' in text
    # atomic write leaves no temp litter
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_rank_filter_suppresses_non_matching_rank(tmp_path):
    """Rank filtering reuses the DistributedLogger convention: only
    the torch.distributed rank == rank writes. This single-process test IS
    process 0, so rank=1 exporters must produce nothing."""
    jl = str(tmp_path / "r1.jsonl")
    reg = _reg()
    ex = JSONLExporter(jl, registry=reg, rank=1)
    reg.event("x")
    ex.export_snapshot()
    ex.close()
    assert not os.path.exists(jl)

    prom = str(tmp_path / "r1.prom")
    assert PrometheusTextfileExporter(prom, rank=1).write(reg) is None
    assert not os.path.exists(prom)

    # rank=None: every process writes
    all_path = str(tmp_path / "all.jsonl")
    with JSONLExporter(all_path, registry=reg):
        reg.event("y")
    assert os.path.exists(all_path)


# -- SLOs (tests/telemetry/test_slo.py) ---------------------------------------

@pytest.fixture()
def reg():
    return MetricsRegistry(enabled=True)


def _monitor(reg, targets=None, **kw):
    clock = [0.0]
    kw.setdefault("fast_window_s", 10.0)
    kw.setdefault("slow_window_s", 100.0)
    kw.setdefault("burn_threshold", 2.0)
    mon = SLOMonitor(
        targets or [SLOTarget(name="ttft", metric="serving.ttft_seconds",
                              objective=0.1, target=0.9)],
        registry=reg, clock=lambda: clock[0], **kw,
    )
    return mon, clock


def test_target_validation():
    with pytest.raises(ValueError, match="target must be in"):
        SLOTarget(name="x", metric="m", target=1.0)
    with pytest.raises(ValueError, match="latency kind needs"):
        SLOTarget(name="x")
    with pytest.raises(ValueError, match="ratio kind needs"):
        SLOTarget(name="x", kind="ratio")
    with pytest.raises(ValueError, match="unknown kind"):
        SLOTarget(name="x", metric="m", kind="mean")


def test_monitor_validation(reg):
    t = SLOTarget(name="a", metric="m")
    with pytest.raises(ValueError, match="at least one"):
        SLOMonitor([], registry=reg)
    with pytest.raises(ValueError, match="windows"):
        SLOMonitor([t], registry=reg, fast_window_s=60, slow_window_s=60)
    with pytest.raises(ValueError, match="duplicate"):
        SLOMonitor([t, t], registry=reg)


def test_burn_rate_hand_computed(reg):
    """target=0.9 -> 10% budget. 20 good then 5 bad out of 25 new
    events in the window -> bad fraction 0.2 -> burn 2.0."""
    h = reg.histogram("serving.ttft_seconds")
    mon, clock = _monitor(reg)
    mon.evaluate()                       # baseline sample at t=0
    for _ in range(20):
        h.observe(0.01)                  # good: <= 0.1
    for _ in range(5):
        h.observe(1.0)                   # bad
    clock[0] = 5.0
    st = mon.evaluate()
    t = st["targets"]["ttft"]
    assert t["bad_fraction_fast"] == pytest.approx(5 / 25)
    assert t["burn_fast"] == pytest.approx((5 / 25) / 0.1)
    assert t["breaching"] and not st["ok"]
    # gauges exported next to the histograms they judge
    snap = reg.snapshot()
    assert snap["gauges"]["slo.ttft.burn_fast"] == pytest.approx(2.0)
    assert snap["gauges"]["slo.breaching"] == 1.0
    assert snap["counters"]["slo.alerts_total"] == 1.0


def test_no_data_means_no_burn(reg):
    mon, clock = _monitor(reg)
    st = mon.evaluate()
    assert st["ok"]
    clock[0] = 50.0
    st = mon.evaluate()                  # still no observations
    assert st["ok"]
    assert st["targets"]["ttft"]["events_fast"] == 0


def test_objective_between_buckets_counts_conservatively(reg):
    """An observation in the bucket straddling the objective counts as
    BAD (only buckets whose upper bound <= objective are good) — the
    monitor over-alerts rather than under-alerts."""
    h = reg.histogram("x.seconds", buckets=(0.1, 1.0))
    mon, clock = _monitor(
        reg, [SLOTarget(name="x", metric="x.seconds", objective=0.5,
                        target=0.5)],
    )
    mon.evaluate()
    h.observe(0.3)   # truly meets the 0.5 objective, but lands in the
    h.observe(0.05)  # (0.1, 1.0] bucket -> judged bad
    clock[0] = 5.0
    st = mon.evaluate()
    assert st["targets"]["x"]["bad_fraction_fast"] == pytest.approx(0.5)


def test_short_blip_does_not_page_when_slow_window_is_clean(reg):
    """Multi-window behavior: a burst that blows the fast window while
    the slow window still averages under threshold must NOT alert."""
    h = reg.histogram("serving.ttft_seconds")
    mon, clock = _monitor(reg)
    # 200s of good history, sampled every 5s (beyond the slow window)
    for i in range(41):
        clock[0] = i * 5.0
        for _ in range(10):
            h.observe(0.01)
        mon.evaluate()
    # now a short 100%-bad burst inside the fast window only
    clock[0] = 205.0
    for _ in range(10):
        h.observe(2.0)
    st = mon.evaluate()
    t = st["targets"]["ttft"]
    assert t["burn_fast"] >= 2.0          # fast window is on fire...
    assert t["burn_slow"] < 2.0           # ...slow window dilutes it
    assert st["ok"]                       # -> no page


def test_trigger_fires_once_per_breach_episode(reg, tmp_path):
    h = reg.histogram("serving.ttft_seconds")
    rec = FlightRecorder(str(tmp_path), registry=reg)
    mon, clock = _monitor(reg, recorder=rec)
    mon.evaluate()
    for _ in range(30):
        h.observe(5.0)
    clock[0] = 5.0
    st = mon.evaluate()
    assert not st["ok"]
    trig = rec.last_trigger
    assert trig is not None and trig.name == "slo_burn"
    assert "ttft" in trig.reason and "burning" in trig.reason
    assert trig.dump_path is not None
    blackbox = json.loads(open(trig.dump_path).read())
    assert blackbox["trigger"]["name"] == "slo_burn"
    assert blackbox["trigger"]["details"]["target"]["name"] == "ttft"
    # still breaching on the next evaluation: no second dump
    clock[0] = 8.0
    mon.evaluate()
    assert len(rec.dumps) == 1
    assert mon.breaching == ["ttft"]
    # recovery clears the breach state; a NEW episode re-fires
    clock[0] = 200.0
    for _ in range(500):
        h.observe(0.01)
    mon.evaluate()
    clock[0] = 205.0
    st = mon.evaluate()
    assert st["targets"]["ttft"]["breaching"] is False


def test_ratio_kind_uses_counters(reg):
    bad = reg.counter("serving.errors_total")
    tot = reg.counter("serving.requests_total")
    mon, clock = _monitor(
        reg,
        [SLOTarget(name="errors", kind="ratio",
                   bad_metric="serving.errors_total",
                   total_metric="serving.requests_total", target=0.99)],
    )
    mon.evaluate()
    tot.inc(100)
    bad.inc(4)
    clock[0] = 5.0
    st = mon.evaluate()
    t = st["targets"]["errors"]
    assert t["bad_fraction_fast"] == pytest.approx(0.04)
    assert t["burn_fast"] == pytest.approx(0.04 / 0.01)
    assert t["breaching"]


def test_status_is_evaluate(reg):
    h = reg.histogram("serving.ttft_seconds")
    mon, clock = _monitor(reg)
    mon.evaluate()
    for _ in range(10):
        h.observe(9.0)
    clock[0] = 5.0
    # /healthz's entry point: one status() call sees the blown budget
    assert mon.status()["ok"] is False


def test_default_serving_slos_cover_ttft_and_decode_gap():
    targets = default_serving_slos()
    assert [t.name for t in targets] == ["ttft", "decode_gap",
                                         "shed_fraction"]
    assert targets[0].metric == "serving.ttft_seconds"
    assert targets[1].metric == "serving.decode_gap_seconds"
    # graceful degradation: shed / submitted as a ratio-kind target —
    # /healthz stays 200 under shedding until the budget burns
    assert targets[2].kind == "ratio"
    assert targets[2].bad_metric == "serving.shed_total"
    assert targets[2].total_metric == "serving.requests_total"


# -- fleet merge (tests/telemetry/test_fleet.py) ------------------------------

def _member(name):
    return name, MetricsRegistry(enabled=True)


def test_merge_counters_sum_and_gauges_sum_skipping_unset():
    a, b = MetricsRegistry(enabled=True), MetricsRegistry(enabled=True)
    a.counter("req_total").inc(3)
    b.counter("req_total").inc(4)
    a.gauge("pages_free").set(10.0)
    b.gauge("pages_free").set(7.0)
    a.gauge("only_a").set(2.0)
    b.gauge("only_a")            # registered, never set (NaN): skipped
    merged = merge_metrics([a.metrics(), b.metrics()])
    assert merged["req_total"].value == 7.0
    assert merged["pages_free"].value == 17.0
    assert merged["only_a"].value == 2.0


def test_merge_histograms_equals_union_hand_computed():
    """The merged histogram must be indistinguishable (buckets, count,
    sum, min/max) from one histogram that saw every observation —
    that identity is what makes fleet burn rates exact."""
    buckets = (0.1, 1.0)
    ha = Histogram("h", buckets=buckets)
    hb = Histogram("h", buckets=buckets)
    hu = Histogram("h", buckets=buckets)   # the union reference
    for v in (0.05, 0.07, 2.0):
        ha.observe(v)
        hu.observe(v)
    for v in (0.5, 0.06):
        hb.observe(v)
        hu.observe(v)
    m = merge_histograms("h", [ha, hb])
    assert m._counts == hu._counts == [3, 1, 1]
    assert m.count == 5
    assert m.sum == pytest.approx(hu.sum)
    assert m._min == pytest.approx(0.05)
    assert m._max == pytest.approx(2.0)


def test_merge_histograms_rejects_mismatched_buckets():
    ha = Histogram("h", buckets=(0.1, 1.0))
    hb = Histogram("h", buckets=(0.2, 1.0))
    with pytest.raises(ValueError, match="mismatched buckets"):
        merge_histograms("h", [ha, hb])


def test_merge_metrics_rejects_conflicting_types():
    a, b = MetricsRegistry(enabled=True), MetricsRegistry(enabled=True)
    a.counter("x")
    b.gauge("x")
    with pytest.raises(TypeError, match="conflicting types"):
        merge_metrics([a.metrics(), b.metrics()])


def test_fleet_registry_overlays_own_metrics_and_members():
    na, ra = _member("a")
    nb, rb = _member("b")
    fleet = FleetRegistry([(na, ra), (nb, rb)])
    ra.counter("serving.tokens_total").inc(5)
    rb.counter("serving.tokens_total").inc(7)
    fleet.gauge("slo.breaching").set(1.0)     # own write
    m = fleet.metrics()
    assert m["serving.tokens_total"].value == 12.0
    assert m["slo.breaching"].value == 1.0
    assert fleet.member_names == ["a", "b"]
    # snapshot()/to_prometheus() ride the merged view
    assert fleet.snapshot()["counters"]["serving.tokens_total"] == 12.0
    assert "serving_tokens_total 12.0" in fleet.to_prometheus()
    fleet.remove_member("a")
    assert fleet.metrics()["serving.tokens_total"].value == 7.0
    with pytest.raises(ValueError, match="already registered"):
        fleet.add_member("b", rb)
    with pytest.raises(ValueError, match="no fleet member"):
        fleet.remove_member("zzz")


def _fleet_monitor(reg, **kw):
    clock = [0.0]
    kw.setdefault("fast_window_s", 10.0)
    kw.setdefault("slow_window_s", 100.0)
    mon = SLOMonitor(
        [SLOTarget(name="ttft", metric="serving.ttft_seconds",
                   objective=0.1, target=0.9)],
        registry=reg, clock=lambda: clock[0], **kw,
    )
    return mon, clock


def test_merged_burn_verdict_matches_union_hand_computed():
    """Observations split across two replicas must produce the EXACT
    burn rate of a single registry that saw the union: 5 bad / 25
    events -> bad fraction 0.2 -> burn 2.0 at a 10% budget."""
    na, ra = _member("a")
    nb, rb = _member("b")
    fleet = FleetRegistry([(na, ra), (nb, rb)])
    union = MetricsRegistry(enabled=True)
    fmon, fclock = _fleet_monitor(fleet)
    umon, uclock = _fleet_monitor(union)
    fmon.evaluate()
    umon.evaluate()
    for i in range(20):                      # good, alternating replicas
        (ra if i % 2 else rb).histogram(
            "serving.ttft_seconds").observe(0.01)
        union.histogram("serving.ttft_seconds").observe(0.01)
    for _ in range(5):                       # bad, all on replica b
        rb.histogram("serving.ttft_seconds").observe(1.0)
        union.histogram("serving.ttft_seconds").observe(1.0)
    fclock[0] = uclock[0] = 5.0
    fs = fmon.evaluate()["targets"]["ttft"]
    us = umon.evaluate()["targets"]["ttft"]
    assert fs["bad_fraction_fast"] == pytest.approx(5 / 25)
    assert fs["burn_fast"] == pytest.approx(2.0)
    for key in ("burn_fast", "burn_slow", "bad_fraction_fast",
                "events_fast", "breaching"):
        assert fs[key] == us[key], key
    assert fs["breaching"] is True


def test_blip_suppression_still_holds_post_merge():
    """A fast-window burst on ONE replica against a fleet-wide clean
    slow window must not page — the multi-window behavior survives the
    merge."""
    na, ra = _member("a")
    nb, rb = _member("b")
    fleet = FleetRegistry([(na, ra), (nb, rb)])
    mon, clock = _fleet_monitor(fleet)
    for i in range(41):                      # 200s of good fleet history
        clock[0] = i * 5.0
        for j in range(10):
            (ra if j % 2 else rb).histogram(
                "serving.ttft_seconds").observe(0.01)
        mon.evaluate()
    clock[0] = 205.0
    for _ in range(10):                      # short burst, replica b only
        rb.histogram("serving.ttft_seconds").observe(2.0)
    st = mon.evaluate()
    t = st["targets"]["ttft"]
    assert t["burn_fast"] >= 2.0
    assert t["burn_slow"] < 2.0
    assert st["ok"]


# -- the two packages on the same inputs --------------------------------------

def test_jsonl_serializes_tensor_scalars(tmp_path):
    """0-d tensors reach the stream as numbers, non-finite ones as strings
    (strict JSON), where the JAX exporter takes numpy and jax scalars."""
    path = str(tmp_path / "t.jsonl")
    reg = MetricsRegistry(enabled=True)
    with JSONLExporter(path, registry=reg):
        reg.event("x", v=torch.tensor(1.5), n=torch.tensor(3),
                  bad=torch.tensor(float("nan")), inf=float("inf"))
    text = open(path).read()
    assert "NaN" not in text and "Infinity" not in text
    (line,) = [json.loads(l) for l in text.splitlines()]
    assert line["v"] == 1.5 and line["n"] == 3
    assert line["bad"] == "nan" and line["inf"] == "inf"


def _jsonl_lines(pkg, tmp_path, tag):
    path = str(tmp_path / f"{tag}.jsonl")
    reg = pkg.MetricsRegistry(enabled=True)
    reg.counter("tok.total").inc(42)
    reg.gauge("tps").set(float("nan"))
    h = reg.histogram("lat.seconds")
    for v in (0.02, 0.5, 3.0, 120.0):
        h.observe(v)
    with pkg.JSONLExporter(path, registry=reg, mode="w") as ex:
        with pkg.span("outer", registry=reg, attrs={"shard": 1}):
            with pkg.span("inner", registry=reg):
                pass
        reg.event("step", i=0, tokens_per_s=10.0, health={"g": float("inf")},
                  vals=[1.0, float("-inf")])
        ex.export_snapshot()
    out = []
    for line in open(path):
        ev = json.loads(line)
        ev.pop("ts")
        if ev["kind"] == "span":
            ev.pop("dur_s")
        if ev["kind"] == "snapshot":
            for name in list(ev["histograms"]):
                if name.startswith("span."):
                    ev["histograms"][name] = ev["histograms"][name]["count"]
        out.append(ev)
    return out


def test_jsonl_lines_equal_jax_apart_from_ts(tmp_path):
    """The same events through the two exporters: equal lines once ``ts``
    (and a span's measured duration) are dropped."""
    import pipegoose_tpu.telemetry as jt
    import pipegoose_tpu_torch.telemetry as tt

    assert _jsonl_lines(tt, tmp_path, "port") == _jsonl_lines(jt, tmp_path, "jax")


def _slo_run(pkg_slo, pkg_reg, pkg_rec, tmp_path, tag):
    reg = pkg_reg.MetricsRegistry(enabled=True)
    rec = pkg_rec.FlightRecorder(str(tmp_path / tag))
    clock = [0.0]
    mon = pkg_slo.SLOMonitor(
        pkg_slo.default_serving_slos(ttft_objective_s=0.1, decode_gap_objective_s=0.05),
        registry=reg, fast_window_s=10.0, slow_window_s=60.0, recorder=rec,
        clock=lambda: clock[0])
    rng = np.random.RandomState(7)
    out = []
    for t in range(40):
        clock[0] = float(t * 3)
        bad = 0.5 if 10 <= t < 25 else 0.02
        for _ in range(20):
            reg.histogram("serving.ttft_seconds").observe(
                0.5 if rng.rand() < bad else 0.01)
            reg.histogram("serving.decode_gap_seconds").observe(
                rng.exponential(0.01))
        reg.counter("serving.requests_total").inc(20)
        reg.counter("serving.shed_total").inc(int(rng.rand() < 0.2))
        out.append(mon.evaluate())
    trig = [(os.path.basename(p), json.load(open(p))["trigger"]) for p in rec.dumps]
    for _, tr in trig:
        tr["details"]["target"] = dict(tr["details"]["target"])
    return out, trig, reg.snapshot()["gauges"]


def test_slo_verdicts_equal_jax(tmp_path):
    """A burn episode through the two monitors, the same observations at
    the same clock: equal status dicts every evaluation, equal black-box
    triggers and equal exported gauges."""
    import pipegoose_tpu.telemetry.flightrec as jrec
    import pipegoose_tpu.telemetry.registry as jreg
    import pipegoose_tpu.telemetry.slo as jslo
    import pipegoose_tpu_torch.telemetry.flightrec as trec
    import pipegoose_tpu_torch.telemetry.registry as treg
    import pipegoose_tpu_torch.telemetry.slo as tslo

    got = _slo_run(tslo, treg, trec, tmp_path, "port")
    want = _slo_run(jslo, jreg, jrec, tmp_path, "jax")
    assert got == want
    assert any(not s["ok"] for s in got[0]) and got[1]


def _fleet_snapshot(pkg_fleet, pkg_reg, seed):
    rng = np.random.RandomState(seed)
    members = []
    for r in range(3):
        reg = pkg_reg.MetricsRegistry(enabled=True)
        for _ in range(300):
            reg.histogram("serving.ttft_seconds").observe(rng.exponential(0.2))
        reg.counter("serving.shed_total").inc(r)
        reg.gauge("serving.queue_depth").set(float(r * 2))
        if r:
            reg.gauge("only.some").set(1.5)
        members.append((f"replica{r}", reg))
    fleet = pkg_fleet.FleetRegistry(members)
    fleet.gauge("slo.breaching").set(1.0)
    return fleet.snapshot(), fleet.member_snapshots(), fleet.to_prometheus()


@pytest.mark.parametrize("seed", [0, 3])
def test_fleet_merge_equal_jax(seed):
    import pipegoose_tpu.telemetry.fleet as jfleet
    import pipegoose_tpu.telemetry.registry as jreg
    import pipegoose_tpu_torch.telemetry.fleet as tfleet
    import pipegoose_tpu_torch.telemetry.registry as treg

    assert _fleet_snapshot(tfleet, treg, seed) == _fleet_snapshot(jfleet, jreg, seed)
