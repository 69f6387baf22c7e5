"""The port's metrics registry and spans against ``pipegoose_tpu.telemetry``:
the counterparts of ``tests/telemetry/test_registry.py`` and
``tests/telemetry/test_spans.py`` (every behaviour that is host logic,
the < 5 µs disabled-cost guard included), one stream of ``inc`` / ``set``
/ ``observe`` calls giving equal ``snapshot()`` and ``to_prometheus()``
text in the two packages, and the port's own guards: ``torch.compile``
counts once per call, a ``meta`` or fake tensor value records nothing.

Not held as ground truth (ROADMAP.md § C, "Not oracles"): the JAX tests
``test_tracer_and_trace_time_mutation_noop`` and
``test_span_inside_jit_noops_cleanly``. Their port counterparts (a CUDA-
graph capture records nothing) need a card and live in
``tests/test_torch_telemetry_cuda.py``."""
import json
import math
import threading
import time

import numpy as np
import pytest
import torch

from pipegoose_tpu.telemetry import MetricsRegistry as JaxRegistry
from pipegoose_tpu_torch import telemetry as tt
from pipegoose_tpu_torch.telemetry import MetricsRegistry, span
from pipegoose_tpu_torch.telemetry.registry import DEFAULT_TIME_BUCKETS
from pipegoose_tpu_torch.telemetry.spans import _NOOP, current_span_path


@pytest.fixture()
def reg():
    return MetricsRegistry(enabled=True)


def test_counter_gauge_basics(reg):
    c = reg.counter("req.total", help="requests")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("depth")
    g.set(7)
    g.set(3)
    assert g.value == 3.0


def test_metric_getters_idempotent_and_type_checked(reg):
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x")


def test_histogram_stats_and_quantiles(reg):
    h = reg.histogram("lat.seconds")
    for i in range(1, 101):
        h.observe(i / 1000)
    assert h.count == 100
    assert h.sum == pytest.approx(5.05)
    snap = h.snapshot()
    assert snap["min"] == pytest.approx(0.001)
    assert snap["max"] == pytest.approx(0.1)
    assert snap["p50"] == pytest.approx(0.05, rel=0.1)
    assert snap["p99"] == pytest.approx(0.1, rel=0.05)
    assert sum(snap["buckets"][str(b)] for b in DEFAULT_TIME_BUCKETS) \
        + snap["buckets"]["+Inf"] == 100


def test_histogram_reservoir_bounded(reg):
    h = reg.histogram("r", reservoir=64)
    for i in range(10_000):
        h.observe(float(i))
    assert len(h._reservoir) == 64
    assert h.count == 10_000
    assert 0 <= h.quantile(0.5) < 10_000


def test_thread_safety_no_lost_increments(reg):
    c = reg.counter("t")
    h = reg.histogram("th")

    def work():
        for _ in range(10_000):
            c.inc()
            h.observe(0.001)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value == 40_000
    assert h.count == 40_000


def test_disabled_registry_records_nothing():
    reg = MetricsRegistry(enabled=False)
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")
    events = []
    reg.attach(events.append)
    c.inc()
    g.set(1.0)
    h.observe(1.0)
    reg.event("e")
    assert c.value == 0.0
    assert g.value != g.value  # NaN: never set
    assert h.count == 0
    assert events == []
    reg.enable()
    c.inc()
    assert c.value == 1.0


def _median_call_s(fn, n=2000, rounds=15):
    samples = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        samples.append((time.perf_counter() - t0) / n)
    return sorted(samples)[len(samples) // 2]


def test_disabled_overhead_under_5us():
    """Instrumentation stays on in library code because a disabled counter
    inc or span entry costs < 5 µs (median over batches)."""
    reg = MetricsRegistry(enabled=False)
    c = reg.counter("c")
    assert _median_call_s(c.inc) < 5e-6

    def enter_span():
        with span("s", registry=reg):
            pass

    assert _median_call_s(enter_span) < 5e-6


def test_snapshot_and_prometheus_render(reg):
    reg.counter("a.total", help="things").inc(3)
    reg.gauge("b.depth").set(2.0)
    reg.histogram("c.seconds").observe(0.02)
    snap = reg.snapshot()
    assert snap["counters"]["a.total"] == 3.0
    assert snap["gauges"]["b.depth"] == 2.0
    assert snap["histograms"]["c.seconds"]["count"] == 1
    json.dumps(snap)
    text = reg.to_prometheus()
    assert "# TYPE a_total counter" in text
    assert "a_total 3.0" in text
    assert "b_depth 2.0" in text
    assert "# HELP a_total things" in text
    assert 'c_seconds_bucket{le="+Inf"} 1' in text
    assert "c_seconds_count 1" in text
    counts = [int(line.rsplit(" ", 1)[1]) for line in text.splitlines()
              if line.startswith("c_seconds_bucket")]
    assert counts == sorted(counts)


def test_events_dispatch_to_sinks(reg):
    got = []
    reg.attach(got.append)
    reg.event("step", i=1)
    reg.detach(got.append)
    reg.event("step", i=2)
    assert len(got) == 1
    assert got[0]["kind"] == "step" and got[0]["i"] == 1
    assert "ts" in got[0]


def _stream(seed=0, n=3000):
    """One seeded stream of (op, name, value) calls: counters, gauges (a
    NaN and an inf among them), histograms past the reservoir cap, names
    that need Prometheus sanitizing, one with help text."""
    rng = np.random.RandomState(seed)
    names = {"inc": ["serving.tokens_total", "a-b.c", "9lives"],
             "set": ["serving.queue_depth", "x.gauge"],
             "observe": ["span.step.seconds", "lat", "big.values"]}
    ops = []
    for i in range(n):
        op = ("inc", "set", "observe")[rng.randint(3)]
        name = names[op][rng.randint(len(names[op]))]
        if op == "inc":
            v = float(rng.randint(0, 5))
        elif op == "set":
            v = float(rng.choice([rng.randn() * 1e3, float("nan"), float("inf")],
                                 p=[0.9, 0.05, 0.05]))
        else:
            v = float(rng.exponential(0.05 if name != "big.values" else 100.0))
        ops.append((op, name, v))
    return ops


def _drive(reg, ops):
    reg.counter("help.total", help="counted things").inc(2)
    reg.histogram("custom.buckets", buckets=(0.5, 0.1, 2.0), reservoir=16)
    for op, name, v in ops:
        if op == "inc":
            reg.counter(name).inc(v)
        elif op == "set":
            reg.gauge(name).set(v)
        else:
            reg.histogram(name).observe(v)
            reg.histogram("custom.buckets").observe(v)


def _nan_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_nan_equal(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_and_prometheus_equal_jax(seed):
    """One stream of calls: the port's snapshot() and to_prometheus() equal
    the JAX registry's (the crc32-seeded reservoir and the bucket rule
    included), and the port's reads back as JSON."""
    ops = _stream(seed)
    jreg, treg = JaxRegistry(enabled=True), MetricsRegistry(enabled=True)
    _drive(jreg, ops)
    _drive(treg, ops)
    js, ts = jreg.snapshot(), treg.snapshot()
    assert _nan_equal(ts, js)
    assert treg.to_prometheus() == jreg.to_prometheus()
    # past its reservoir's cap, so the seeded replacement draws ran
    assert ts["histograms"]["custom.buckets"]["count"] > 16


def test_tensor_values_record_their_number(reg):
    """0-d tensors count as their number; a meta or fake tensor (no data)
    records nothing and raises nothing."""
    reg.counter("c").inc(torch.tensor(2.0))
    reg.gauge("g").set(torch.tensor(3.5))
    reg.histogram("h").observe(torch.tensor(0.25, dtype=torch.float64))
    assert reg.counter("c").value == 2.0 and reg.gauge("g").value == 3.5
    assert reg.histogram("h").sum == 0.25
    meta = torch.empty((), device="meta")
    reg.counter("c").inc(meta)
    reg.gauge("g").set(meta)
    reg.histogram("h").observe(meta)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = mode.from_tensor(torch.tensor(1.0))
        reg.counter("c").inc(fake)
        reg.histogram("h").observe(fake)
    assert reg.counter("c").value == 2.0 and reg.gauge("g").value == 3.5
    assert reg.histogram("h").count == 1


def test_torch_compile_counts_once_per_call(reg):
    """Dynamo replays a compiled function's host side effects on every
    call: a counter inside counts once per call, and so does a span."""
    c = reg.counter("compiled.calls")

    def f(x):
        c.inc()
        with span("compiled", registry=reg):
            y = x * 2
        return y + 1

    g = torch.compile(f, backend="eager")
    for _ in range(5):
        out = g(torch.arange(4.0))
    assert out.tolist() == [1.0, 3.0, 5.0, 7.0]
    assert c.value == 5.0
    assert reg.histogram("span.compiled.seconds").count == 5


def test_global_registry_starts_disabled_and_toggles():
    reg = tt.get_registry()
    was = reg.enabled
    try:
        reg.disable()
        assert span("x") is _NOOP
        tt.enable()
        assert reg.enabled and span("x") is not _NOOP
        tt.disable()
        assert not reg.enabled
    finally:
        reg._enabled = was


# -- spans (tests/telemetry/test_spans.py) -----------------------------------

def test_span_records_histogram_and_event():
    reg = MetricsRegistry(enabled=True)
    events = []
    reg.attach(events.append)
    with span("load", registry=reg, attrs={"shard": 3}):
        pass
    h = reg.histogram("span.load.seconds")
    assert h.count == 1 and h.sum >= 0
    (ev,) = events
    assert ev["kind"] == "span" and ev["span"] == "load" and ev["shard"] == 3
    assert ev["dur_s"] >= 0


def test_nested_spans_join_paths():
    reg = MetricsRegistry(enabled=True)
    with span("step", registry=reg):
        assert current_span_path() == "step"
        with span("forward", registry=reg):
            assert current_span_path() == "step.forward"
            with span("attn", registry=reg):
                assert current_span_path() == "step.forward.attn"
        with span("backward", registry=reg):
            assert current_span_path() == "step.backward"
    assert current_span_path() is None
    assert {"span.step.seconds", "span.step.forward.seconds",
            "span.step.forward.attn.seconds",
            "span.step.backward.seconds"} <= set(reg.snapshot()["histograms"])


def test_fence_on_cpu_tensors_and_non_tensors():
    """A CPU tensor is ready when its op returns; a non-tensor target (and
    a container of them) is skipped, as JAX skips non-arrays."""
    reg = MetricsRegistry(enabled=True)
    with span("compute", registry=reg) as sp:
        x = (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
        sp.fence(x, [x, {"y": x}])
    assert reg.histogram("span.compute.seconds").count == 1
    with span("odd", registry=reg) as sp:
        sp.fence(object(), None, 3)
    assert reg.histogram("span.odd.seconds").count == 1


def test_disabled_registry_returns_shared_noop():
    reg = MetricsRegistry(enabled=False)
    s = span("x", registry=reg)
    assert s is _NOOP
    with s as sp:
        sp.fence(torch.ones(2))
    assert reg.snapshot()["histograms"] == {}


def test_exception_inside_span_still_pops_stack():
    reg = MetricsRegistry(enabled=True)
    with pytest.raises(RuntimeError):
        with span("boom", registry=reg):
            raise RuntimeError("x")
    assert current_span_path() is None
    assert reg.histogram("span.boom.seconds").count == 1


def test_stopiteration_exit_not_recorded():
    reg = MetricsRegistry(enabled=True)
    it = iter([1, 2])
    pulls = 0
    while True:
        try:
            with span("data", registry=reg):
                next(it)
            pulls += 1
        except StopIteration:
            break
    assert pulls == 2
    assert current_span_path() is None
    assert reg.histogram("span.data.seconds").count == 2


def test_span_stream_equal_jax():
    """The same nested spans in the two packages record the same histogram
    names and counts and the same event kinds, paths and attributes."""
    from pipegoose_tpu.telemetry import span as jspan

    out = []
    for pkg_span, reg in ((jspan, JaxRegistry(enabled=True)),
                          (span, MetricsRegistry(enabled=True))):
        events = []
        reg.attach(events.append)
        for i in range(3):
            with pkg_span("step", registry=reg, attrs={"i": i}):
                with pkg_span("data", registry=reg):
                    pass
                with pkg_span("fwd", registry=reg):
                    pass
        snap = reg.snapshot()["histograms"]
        out.append(({k: v["count"] for k, v in snap.items()},
                    [{k: v for k, v in e.items() if k not in ("ts", "dur_s")}
                     for e in events]))
    assert out[0] == out[1]
