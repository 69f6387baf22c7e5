"""The port's perf-regression sentinel held against the JAX package.

Counterparts of ``tests/telemetry/test_sentinel.py``: the same run
observations go through the JAX ``PerfSentinel`` and the port's, and their
verdicts (reason, regressions, baseline) and gauges must be equal; the
history reader is run on a ``tmp_path`` file. Then the engine's
``sentinel=`` hook: one observation per run with decode steps (equal to
what the JAX engine observes for the same run on the same clock), none for
a run that decodes nothing, and the disabled-hook cost guard."""
import json
import os
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pipegoose_tpu.telemetry.sentinel as jsent
import pipegoose_tpu_torch.telemetry.sentinel as tsent
from pipegoose_tpu.telemetry import FlightRecorder as JRecorder
from pipegoose_tpu.telemetry import MetricsRegistry as JRegistry
from pipegoose_tpu_torch.telemetry import FlightRecorder, MetricsRegistry

PAIRS = ((jsent, JRegistry, JRecorder), (tsent, MetricsRegistry, FlightRecorder))


def _base_run(**over):
    run = {"tokens_per_s": 100.0, "compute_s": 0.01, "comm[tensor]_s": 0.004, "idle_s": 0.002}
    run.update(over)
    return run


def _both(observations, **kw):
    """Feed ``observations`` (a list of (run, observe kwargs)) to a JAX
    and a port sentinel; every verdict, the baselines and the regression
    counts must be equal. Returns the port's sentinel and verdicts."""
    out = []
    for mod, _, _ in PAIRS:
        s = mod.PerfSentinel(**kw)
        verdicts = [s.observe(json.loads(json.dumps(run)), **okw) for run, okw in observations]
        out.append((s, verdicts))
    (js, jv), (ts, tv) = out
    assert tv == jv
    assert ts.baseline() == js.baseline() and ts.regressions == js.regressions
    assert ts.baseline_size == js.baseline_size
    return ts, tv


def test_constructor_validation():
    for mod, _, _ in PAIRS:
        with pytest.raises(ValueError, match="window"):
            mod.PerfSentinel(window=0)
        with pytest.raises(ValueError, match="min_baseline"):
            mod.PerfSentinel(min_baseline=0)
        with pytest.raises(ValueError, match="ratio_threshold"):
            mod.PerfSentinel(ratio_threshold=1.0)
        with pytest.raises(ValueError, match="drop_threshold"):
            mod.PerfSentinel(drop_threshold=1.5)


def test_no_verdict_below_min_baseline():
    s, v = _both([(_base_run(), {}), (_base_run(idle_s=1.0), {}), (_base_run(idle_s=5.0), {})],
                 min_baseline=3)
    assert v == [None, None, None]
    assert s.regressions == 0 and s.baseline_size == 3


def test_component_regression_names_the_component():
    s, v = _both([(_base_run(), {})] * 3 + [(_base_run(**{"comm[tensor]_s": 0.0084}), {}),
                                            (_base_run(), {})],
                 min_baseline=2, ratio_threshold=1.5)
    assert v[:3] == [None] * 3 and v[4] is None
    assert "tensor-axis collective time 2.1x baseline" in v[3]["reason"]
    assert s.regressions == 1 and s.baseline_size == 4
    assert s.baseline()["comm[tensor]_s"] == pytest.approx(0.004)


def test_tokens_per_s_drop_direction():
    _, v = _both([(_base_run(), {})] * 2 + [(_base_run(tokens_per_s=500.0), {}),
                                            (_base_run(tokens_per_s=60.0), {})],
                 min_baseline=2, drop_threshold=0.7)
    assert v[2] is None
    assert "tokens/s 0.60x baseline" in v[3]["reason"]


def test_worst_component_leads_the_reason():
    _, v = _both([(_base_run(), {})] * 2
                 + [(_base_run(idle_s=0.02, **{"comm[tensor]_s": 0.007}), {})],
                 min_baseline=2, ratio_threshold=1.5)
    assert v[2]["reason"].startswith("idle time 10.0x")
    assert {r["component"] for r in v[2]["regressions"]} == {"idle_s", "comm[tensor]_s"}


def test_recorder_black_box_fired(tmp_path):
    boxes = []
    for mod, _, rec_cls in PAIRS:
        rec = rec_cls(str(tmp_path / mod.__name__), capacity=4)
        s = mod.PerfSentinel(recorder=rec, min_baseline=2)
        for _ in range(2):
            s.observe(_base_run())
        trig = s.observe(_base_run(idle_s=0.02), step=7)
        assert trig.name == "perf_regression" and trig.step == 7
        assert "idle time" in trig.reason and os.path.exists(trig.dump_path)
        assert rec.take_trigger() is trig
        boxes.append(json.load(open(trig.dump_path)))
    assert boxes[1]["trigger"] == boxes[0]["trigger"]
    assert boxes[1]["trigger"]["details"]["regressions"][0]["component"] == "idle_s"


def test_gauges_exported_on_enabled_registry():
    run = {"tokens_per_s": 50.0,
           "profile": {"wall_step_s": 0.01, "compute_s": 0.005, "comm_s": 0.002,
                       "idle_s": 0.003, "comm_by_axes": {"tensor": 0.002}}}
    snaps = []
    for mod, reg_cls, _ in PAIRS:
        reg = reg_cls(enabled=True)
        mod.PerfSentinel(registry=reg, min_baseline=2).observe(json.loads(json.dumps(run)))
        snaps.append(reg.snapshot()["gauges"])
    assert snaps[1] == snaps[0]
    assert snaps[1]["perf.compute_fraction"] == pytest.approx(0.5)
    assert snaps[1]["perf.comm_fraction"] == pytest.approx(0.2)
    assert snaps[1]["perf.idle_fraction"] == pytest.approx(0.3)
    assert snaps[1]["perf.tokens_per_s"] == pytest.approx(50.0)


def test_profile_subdict_components_flatten():
    row = {"tokens_per_s": 100.0,
           "profile": {"wall_step_s": 0.01, "compute_s": 0.005, "comm_s": 0.002,
                       "idle_s": 0.003, "comm_by_axes": {"tensor": 0.002}}}
    slow = json.loads(json.dumps(row))
    slow["profile"]["comm_by_axes"]["tensor"] = 0.008
    _, v = _both([(row, {}), (row, {}), (slow, {})], min_baseline=2, ratio_threshold=1.5)
    assert "tensor-axis collective" in v[2]["reason"]


def test_read_bench_history_and_from_history(tmp_path):
    path = tmp_path / "history.jsonl"
    rows = [{"run_id": f"r{i}", "tokens_per_s": 100.0 + i,
             "profile": {"compute_s": 0.01, "idle_s": 0.002, "comm_by_axes": {"data": 0.001}}}
            for i in range(5)]
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write("{truncated-append\n")
    for mod, _, _ in PAIRS:
        assert len(mod.read_bench_history(str(path))) == 5
        assert [r["run_id"] for r in mod.read_bench_history(str(path), tail=2)] == ["r3", "r4"]
        assert mod.read_bench_history(str(tmp_path / "missing.jsonl")) == []
    js = jsent.PerfSentinel.from_history(str(path), window=3, min_baseline=2)
    s = tsent.PerfSentinel.from_history(str(path), window=3, min_baseline=2)
    assert s.baseline() == js.baseline() and s.baseline_size == 3
    assert s.baseline()["tokens_per_s"] == pytest.approx(103.0)
    v = s.observe({"tokens_per_s": 50.0})
    assert v == js.observe({"tokens_per_s": 50.0}) and "tokens/s" in v["reason"]


def test_from_history_skips_regressed_and_other_device_rows(tmp_path):
    """Rows stamped ``perf_regression`` never seed a baseline, and the
    device filter (the card's name) keeps other devices' rows out."""
    path = tmp_path / "history.jsonl"
    card = "NVIDIA H100 80GB HBM3"
    rows = [
        {"run_id": "a", "device": card, "tokens_per_s": 100.0},
        {"run_id": "cpu", "device": "cpu", "tokens_per_s": 2.0},
        {"run_id": "b", "device": card, "tokens_per_s": 30.0,
         "perf_regression": "tokens/s 0.30x baseline"},
        {"run_id": "c", "device": card, "tokens_per_s": 104.0},
    ]
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    s = tsent.PerfSentinel.from_history(str(path), device=card, window=8, min_baseline=2)
    js = jsent.PerfSentinel.from_history(str(path), device=card, window=8, min_baseline=2)
    assert s.baseline_size == js.baseline_size == 2
    assert s.baseline()["tokens_per_s"] == pytest.approx(102.0)
    v = s.observe({"tokens_per_s": 30.0})
    assert v == js.observe({"tokens_per_s": 30.0}) and "0.29x" in v["reason"]


# -- the engine's hook -----------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    from pipegoose_tpu.models import bloom as jbloom
    from pipegoose_tpu_torch.models import bloom as tbloom
    from pipegoose_tpu_torch.models.weights import params_from_jax

    jcfg = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
    tcfg = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4,
                              initializer_range=0.3)
    np_tree = tbloom.init_params_numpy(tcfg, seed=0)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(1, 64, (k,)), n) for k, n in [(6, 5), (9, 3), (5, 6)]]
    return (jax.tree_util.tree_map(jnp.asarray, np_tree), jcfg,
            params_from_jax(np_tree, tcfg, device="cpu"), tcfg, reqs)


def _clock():
    t = [0.0]

    def now():
        t[0] += 1e-3
        return t[0]

    return now


def test_engine_observes_each_run_like_jax(setup):
    """Three runs on the deterministic clock through both engines: the
    same components enter both baselines; a 3x decode-step observation
    then fires one box naming the decode-step time."""
    from pipegoose_tpu.serving import Request as JRequest
    from pipegoose_tpu.serving import ServingEngine as JServingEngine
    from pipegoose_tpu_torch.serving import Request, ServingEngine

    jparams, jcfg, tparams, tcfg, reqs = setup
    knobs = dict(num_slots=2, num_pages=32, page_size=4, max_context=32, prefill_chunk=4)
    sents = (jsent.PerfSentinel(min_baseline=2), tsent.PerfSentinel(min_baseline=2))
    jeng = JServingEngine(jparams, jcfg, attn_kernel="paged", sentinel=sents[0], **knobs)
    teng = ServingEngine(tparams, tcfg, device="cpu", sentinel=sents[1], **knobs)
    for _ in range(3):
        for eng, cls in ((jeng, JRequest), (teng, Request)):
            eng.run([cls(prompt=p, max_new_tokens=n) for p, n in reqs], now=_clock())
    assert sents[1].baseline_size == 3
    jb, tb = sents[0].baseline(), sents[1].baseline()
    assert set(tb) == set(jb) == {"decode_step_s", "idle_s", "tokens_per_s"}
    for k in tb:
        assert tb[k] == pytest.approx(jb[k], rel=1e-9)
    v = sents[1].observe({"decode_step_s": 3 * tb["decode_step_s"],
                          "idle_s": tb["idle_s"]}, tokens_per_s=tb["tokens_per_s"])
    assert v["reason"].startswith("decode-step time 3.0x baseline")


def test_engine_does_not_observe_a_run_without_decode_steps(setup):
    """Every request shed before admission: no decode step, no sample."""
    from pipegoose_tpu_torch.serving import Request, ServingEngine

    _, _, tparams, tcfg, reqs = setup
    s = tsent.PerfSentinel(min_baseline=1)
    eng = ServingEngine(tparams, tcfg, device="cpu", sentinel=s, num_slots=1, num_pages=32,
                        page_size=4, max_context=32, prefill_chunk=4)
    clock = _clock()
    _, met = eng.run([Request(prompt=p, max_new_tokens=n, deadline_s=0.0) for p, n in reqs],
                     now=lambda: clock() * 10)
    assert met["decode_steps"] == 0 and met["shed_requests"] == len(reqs)
    assert s.baseline_size == 0 and s.last_verdict is None


def _median_call_seconds(fn, n=2000, rounds=15):
    samples = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        samples.append((time.perf_counter() - t0) / n)
    return sorted(samples)[len(samples) // 2]


def test_disabled_sentinel_guard_under_5us():
    """``sentinel=None`` (the default): the per-run hook is one attribute
    read and branch, timed on the real method."""
    from pipegoose_tpu_torch.serving import ServingEngine

    fake_engine = SimpleNamespace(sentinel=None)
    rs = SimpleNamespace(steps=5, step_time=0.01)
    assert _median_call_seconds(
        lambda: ServingEngine._sentinel_observe(fake_engine, rs, 1.0, 10)) < 5e-6
