"""The serving engine's telemetry held against the JAX engine on the CPU.

The JAX engine (``attn_kernel="paged"``) and the port's, each with an
enabled private registry, serve the same requests (2-layer, width-64
BLOOM, pages of 4) in the plain (monolithic prefill), chunked, prefix-cache
and speculative arms, int8 KV among them, and a run with a preemption and
a deadline shed: every counter, every gauge at the end of the run, and
every histogram's sample count must be equal. Time-valued metrics
(``serving.tokens_per_s``, and the histograms' sums and quantiles) are
left out by name: the two runs take different times. Also: the
``memory_report`` gauges, the flight recorder's per-step records and the
stall watchdog's black box against JAX's, the engine's JSONL step events,
and an engine on the disabled global registry recording nothing."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.serving import Request as JRequest
from pipegoose_tpu.serving import ServingEngine as JServingEngine
from pipegoose_tpu.telemetry import FlightRecorder as JRecorder
from pipegoose_tpu.telemetry import MetricsRegistry as JRegistry
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.serving import Request, ServingEngine
from pipegoose_tpu_torch.telemetry import FlightRecorder, MetricsRegistry, get_registry

JCFG = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
TCFG = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4,
                          initializer_range=0.3)
ENGINE = dict(num_slots=3, num_pages=48, page_size=4, max_context=48)
TIME_VALUED = {"serving.tokens_per_s"}

ARMS = {
    "plain": {},
    "chunked": {"prefill_chunk": 4},
    "cached": {"prefix_cache": True, "prefill_chunk": 8},
    "cached_int8kv": {"prefix_cache": True, "kv_dtype": "int8"},
    "speculative": {"prefix_cache": True, "prefill_chunk": 4, "speculative": (1, 3)},
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
    """A deterministic clock: every read advances 1 ms, so both engines
    see a strictly increasing time whatever their speed."""
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    return now


def _counts(reg):
    """(counters, end gauges, histogram counts) without the time-valued
    ones; NaN gauges (never set) as None."""
    snap = reg.snapshot()
    gauges = {k: (None if v != v else v) for k, v in snap["gauges"].items()
              if k not in TIME_VALUED}
    return (snap["counters"], gauges,
            {k: v["count"] for k, v in snap["histograms"].items()})


def _serve(setup, knobs, recorders=None, run_kw=None):
    jparams, tparams, reqs = setup
    jreg, treg = JRegistry(enabled=True), MetricsRegistry(enabled=True)
    jrec, trec = recorders or (None, None)
    jeng = JServingEngine(jparams, JCFG, attn_kernel="paged", registry=jreg, recorder=jrec,
                          **ENGINE, **knobs)
    teng = ServingEngine(tparams, TCFG, device="cpu", registry=treg, recorder=trec,
                         **ENGINE, **knobs)
    run_kw = run_kw or {}
    jout, jmet = jeng.run([JRequest(prompt=p, max_new_tokens=n, **run_kw.get("req", {}))
                           for p, n in reqs], now=_clock(), **run_kw.get("j", {}))
    tout, tmet = teng.run([Request(prompt=p, max_new_tokens=n, **run_kw.get("req", {}))
                           for p, n in reqs], now=_clock(), **run_kw.get("t", {}))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.generated, j.generated)
    return (jeng, jreg, jmet), (teng, treg, tmet)


@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_metrics_equal_jax(setup, arm):
    (jeng, jreg, jmet), (teng, treg, tmet) = _serve(setup, ARMS[arm])
    got, want = _counts(treg), _counts(jreg)
    assert got == want
    counters, gauges, hists = got
    assert counters["serving.tokens_total"] == tmet["generated_tokens"]
    assert counters["serving.decode_steps_total"] == tmet["decode_steps"]
    assert hists["span.serving.decode_step.seconds"] == tmet["decode_steps"]
    assert hists["serving.ttft_seconds"] == len(setup[2])
    if "prefill_chunk" in ARMS[arm]:
        assert counters["serving.prefill_chunks_total"] == tmet["prefill_chunks"]
    if ARMS[arm].get("prefix_cache"):
        assert counters["serving.prefix_cache.hit_tokens"] > 0
        assert gauges["serving.prefix_cache.cached_pages"] == tmet["prefix_cache"]["cached_pages"]
    if "speculative" in ARMS[arm]:
        assert counters["serving.spec.cycles"] == tmet["speculative"]["cycles"]
    # tokens/s from the counter's delta, over the same run's wall
    assert treg.gauge("serving.tokens_per_s").value == pytest.approx(
        tmet["generated_tokens"] / tmet["wall_time_s"])


def test_engine_metrics_with_preemption_and_shed_equal_jax(setup):
    """A mid-run preemption (re-prefill through the chunked path: TTFT
    still observed once) and a deadline that sheds a queued request."""
    def hook(eng, tick):
        if tick == 4:
            live = [r for r in eng.sched.active()]
            eng.sched.preempt(live[0])

    (_, jreg, _), (_, treg, tmet) = _serve(
        setup, {"prefill_chunk": 4, "prefix_cache": True},
        run_kw={"j": {"tick_hook": hook}, "t": {"tick_hook": hook}})
    assert _counts(treg) == _counts(jreg)
    jparams, tparams, reqs = setup
    # the shed arm: one slot, a deadline below the first request's service
    jreg, treg = JRegistry(enabled=True), MetricsRegistry(enabled=True)
    knobs = dict(ENGINE, num_slots=1, prefill_chunk=4)
    jeng = JServingEngine(jparams, JCFG, attn_kernel="paged", registry=jreg, **knobs)
    teng = ServingEngine(tparams, TCFG, device="cpu", registry=treg, **knobs)
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        eng.run([cls(prompt=p, max_new_tokens=n, deadline_s=0.02 if i >= 4 else None)
                 for i, (p, n) in enumerate(reqs)], now=_clock())
    assert _counts(treg) == _counts(jreg)
    assert treg.counter("serving.shed_total").value > 0


def test_memory_report_gauges_equal_jax(setup):
    (jeng, jreg, _), (teng, treg, _) = _serve(setup, {"kv_dtype": "int8", "prefill_chunk": 4})
    jrep, trep = jeng.memory_report(), teng.memory_report()
    assert trep["kv"]["bytes_per_page"] == jrep["kv"]["bytes_per_page"]
    names = ("serving.hbm.weights_bytes", "serving.hbm.kv_bytes",
             "serving.hbm.kv_page_capacity_ratio")
    assert [treg.gauge(n).value for n in names] == [jreg.gauge(n).value for n in names]
    other = MetricsRegistry(enabled=True)
    teng.memory_report(registry=other)
    assert other.gauge("serving.hbm.kv_bytes").value == trep["kv"]["total_bytes"]


def test_recorder_records_every_step_like_jax(setup, tmp_path):
    recs = (JRecorder(str(tmp_path / "jax"), capacity=512),
            FlightRecorder(str(tmp_path / "port"), capacity=512))
    (_, _, jmet), (_, _, tmet) = _serve(setup, {"prefill_chunk": 4}, recorders=recs)

    def strip(rec):
        return [{k: v for k, v in r.items() if k not in ("ts", "dur_s")} for r in rec.records]

    assert strip(recs[1]) == strip(recs[0])
    assert len(recs[1].records) == tmet["decode_steps"]


def test_stall_black_box_equal_jax(setup, tmp_path):
    """A pool that can never admit the queue head: the watchdog raises
    after ``stall_patience`` ticks, naming the black box, whose trigger and
    context equal JAX's apart from the wall time."""
    jparams, tparams, reqs = setup
    knobs = dict(num_slots=2, num_pages=4, page_size=4, max_context=48, stall_patience=3,
                 prefill_chunk=4)
    out = []
    for eng_cls, req_cls, rec_cls, params, cfg, tag, kw in (
            (JServingEngine, JRequest, JRecorder, jparams, JCFG, "jax",
             {"attn_kernel": "paged"}),
            (ServingEngine, Request, FlightRecorder, tparams, TCFG, "port",
             {"device": "cpu"})):
        rec = rec_cls(str(tmp_path / tag))
        eng = eng_cls(params, cfg, recorder=rec, **knobs, **kw)
        eng.pool.alloc(2)   # two of the three pages held outside any request
        with pytest.raises(RuntimeError, match="black box") as err:
            eng.run([req_cls(prompt=reqs[0][0][:5], max_new_tokens=3)], now=_clock())
        (path,) = rec.dumps[-1:]
        assert str(path) in str(err.value)
        box = json.load(open(path))
        box["context"].pop("wall_s")
        out.append((os.path.basename(path), box["trigger"], box["context"]))
    assert out[1] == out[0]
    assert out[1][1]["name"] == "decode_stall"


def test_engine_events_stream_to_jsonl(setup, tmp_path):
    from pipegoose_tpu_torch.telemetry import JSONLExporter

    (_, _, _), (teng, treg, tmet) = _serve(setup, {"prefill_chunk": 4})
    path = str(tmp_path / "serve.jsonl")
    with JSONLExporter(path, registry=treg):
        _, met = teng.run([Request(prompt=p, max_new_tokens=n) for p, n in setup[2]],
                          now=_clock())
    kinds = [json.loads(line)["kind"] for line in open(path)]
    assert kinds.count("serving.step") == met["decode_steps"]
    assert kinds.count("span") == met["decode_steps"] + met["prefill_chunks"]


def test_disabled_global_registry_records_nothing(setup):
    """An engine built without ``registry=`` instruments the global
    registry, disabled until enabled: a run records nothing there."""
    reg = get_registry()
    assert not reg.enabled
    _, tparams, reqs = setup
    before = reg.snapshot()
    eng = ServingEngine(tparams, TCFG, device="cpu", prefill_chunk=4, **ENGINE)
    eng.run([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    after = reg.snapshot()
    assert {k: v for k, v in after["counters"].items() if v} == {
        k: v for k, v in before["counters"].items() if v}
