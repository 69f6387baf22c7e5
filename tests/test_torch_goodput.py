"""The port's goodput ledgers held against the JAX package on the CPU.

Counterparts of ``tests/telemetry/test_goodput.py`` (its autoscaler test
waits for the port's control plane): the same ticks, incidents, recorder
rings and trainer callbacks go through the JAX ``GoodputLedger`` /
``TrainerGoodput`` and the port's, and their reports, incidents, registry
snapshots and Perfetto bands must be equal; the JAX tests' claims must
hold on the port's. Then the ledger classifying ticks of real engines
(``pre_tick`` reads the port engine's ``programs_run`` and the
scheduler's ``admission_deferrals``), ``TrainerGoodput`` on a port
``Trainer.fit`` with a checkpoint and a recovery rewind, and the
disabled-cost guard."""
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

import pipegoose_tpu.telemetry.chrometrace as jct
import pipegoose_tpu.telemetry.goodput as jgp
import pipegoose_tpu_torch.telemetry.chrometrace as tct
import pipegoose_tpu_torch.telemetry.goodput as tgp
from pipegoose_tpu.telemetry import MetricsRegistry as JRegistry
from pipegoose_tpu.telemetry.slo import SLOMonitor as JMonitor
from pipegoose_tpu_torch.telemetry import MetricsRegistry, SLOMonitor

MODS = ((jgp, JRegistry, JMonitor, jct), (tgp, MetricsRegistry, SLOMonitor, tct))


def _rep(state="serving", probation=0, programs_run=0, deferrals=0):
    eng = SimpleNamespace(programs_run=programs_run,
                          sched=SimpleNamespace(admission_deferrals=deferrals), kv_tier=None)
    return SimpleNamespace(state=SimpleNamespace(value=state), engine=eng,
                           probation_ticks_left=probation)


def _both(scenario):
    """``scenario(goodput module, registry class, monitor class)`` on both
    packages; the returned (JSON-able) results must be equal."""
    out = [scenario(gp, reg, mon) for gp, reg, mon, _ in MODS]
    assert out[1] == out[0]
    return out[1]


def test_taxonomy_equals_jax():
    assert tgp.CLASSES == jgp.CLASSES and tgp.GOOD_CLASSES == ("productive",)
    assert tgp.TrainerGoodput.CLASSES == jgp.TrainerGoodput.CLASSES
    assert tgp.MAX_EPISODES == jgp.MAX_EPISODES


def test_telescoping_conservation_is_exact():
    def scenario(gp, reg, mon):
        led = gp.GoodputLedger()
        led.touch("r0", 10.0, "serving", 0)
        t = 10.0
        for tick, klass in enumerate(["compile_warmup", "productive", "productive", "idle",
                                      "stall", "idle"], start=1):
            t += 0.125
            led.account("r0", t, klass, "serving", tick)
        return led.report(), led.totals(), led.conservation()

    rep, tot, cons = _both(scenario)
    assert cons["ok"] and cons["max_error_s"] == 0.0
    assert rep["replicas"]["r0"]["alive_wall_s"] == pytest.approx(0.75)
    assert tot["productive_seconds"] == pytest.approx(0.25)
    assert tot["badput_seconds"] == pytest.approx(0.5)
    assert tot["fraction"] == pytest.approx(1 / 3)


def test_episodes_merge_consecutive_same_class_and_state():
    def scenario(gp, reg, mon):
        led = gp.GoodputLedger()
        led.touch("r0", 0.0, "serving", 0)
        for tick, (klass, state) in enumerate(
                [("productive", "serving"), ("productive", "serving"), ("stall", "serving"),
                 ("stall", "suspect"), ("stall", "suspect")], start=1):
            led.account("r0", float(tick), klass, state, tick)
        return led.replicas["r0"].episodes, led.state_seconds("r0")

    eps, states = _both(scenario)
    assert [(e["class"], e["state"], e["ticks"]) for e in eps] == [
        ("productive", "serving", 2), ("stall", "serving", 1), ("stall", "suspect", 2)]
    assert eps[0]["t0"] == 0.0 and eps[0]["t1"] == 2.0
    assert states == {"serving": 3.0, "suspect": 2.0}


def test_touch_books_lifecycle_gap_by_state():
    def scenario(gp, reg, mon):
        led = gp.GoodputLedger()
        led.touch("r0", 0.0, "serving", 0)
        led.account("r0", 1.0, "productive", "serving", 1)
        led.touch("r0", 3.0, "failed", 5)
        led.touch("r0", 2.5, "failed", 6)
        acct = led.replicas["r0"]
        return acct.classes, acct.last_mark, led.conservation()["ok"]

    classes, mark, ok = _both(scenario)
    assert classes["failed_quarantine"] == pytest.approx(2.0)
    assert mark == 3.0 and ok


def test_classify_priority_tree():
    pre = (0, 0, 0)
    cases = [
        (_rep("failed"), True, True, True, "failed_quarantine"),
        (_rep("draining"), True, True, False, "draining"),
        (_rep("stopped"), False, False, False, "draining"),
        (_rep(programs_run=1), True, True, False, "compile_warmup"),
        (_rep(), True, True, False, "productive"),
        (_rep(), True, False, True, "productive"),
        (_rep("suspect"), True, False, False, "suspect_probing"),
        (_rep(deferrals=2), True, False, False, "admission_blocked"),
        (_rep(), True, False, False, "stall"),
        (_rep(probation=3), False, False, False, "probation"),
        (_rep("suspect"), False, False, False, "suspect_probing"),
        (_rep(), False, False, False, "idle"),
    ]
    for rep, had_work, ticked, took, want in cases:
        assert tgp.GoodputLedger().classify(rep, pre, had_work, ticked, took) == want
        assert jgp.GoodputLedger().classify(rep, pre, had_work, ticked, took) == want
    assert tgp.GoodputLedger().pre_tick(_rep(programs_run=3, deferrals=2)) == (3, 2, 0)


def _ring(*records):
    return SimpleNamespace(records=deque(records))


def test_incident_mttr_gap_integral_and_slo_burn():
    def scenario(gp, reg, mon):
        led = gp.GoodputLedger()
        led.touch("r0", 0.0, "serving", 0)
        led.touch("r1", 0.0, "serving", 0)
        led.account("r0", 1.0, "productive", "serving", 1)
        led.account("r1", 1.0, "productive", "serving", 1)
        led.on_tick(1, 1.0)
        inc = led.open_incident("crash", "r1", 2, 2.0, reason="boom", capacity_gap=1)
        opened = [i.id for i in led.open_incidents]
        for tick in (2, 3):
            led.account("r0", float(tick), "productive", "serving", tick)
            led.account("r1", float(tick), "failed_quarantine", "failed", tick)
            led.on_tick(tick, float(tick))
        gap = inc.capacity_gap_integral_s
        closed = led.resolve_incident("r1", 12, 4.5, "rejoin")
        return opened, gap, closed is inc, inc.as_dict(), led.open_incidents

    opened, gap, same, d, still_open = _both(scenario)
    assert opened == [0] and same and still_open == []
    assert gap == pytest.approx(2.0)
    assert d["mttr_s"] == pytest.approx(2.5) and d["mttr_ticks"] == 10
    assert d["slo_burn"] == {"badput_s": 2.0, "wall_s": 4.0, "availability": 0.5}
    assert d["resolved_by"] == "rejoin" and d["reason"] == "boom"


def test_injection_join_latency_is_ring_distance_and_claims_once():
    def scenario(gp, reg, mon):
        rec = _ring(
            {"ts": 0.0, "kind": "chaos.injection", "injection": "replica_crash", "step": 4,
             "victim": "r1"},
            {"ts": 0.0, "kind": "chaos.injection", "injection": "replica_wedge", "step": 6,
             "victim": "r0"},
            {"ts": 0.0, "kind": "other_noise"})
        led = gp.GoodputLedger()
        kinds = ("replica_crash", "replica_wedge")
        return [(i.detection_latency_ticks, i.injection_step) for i in (
            led.open_incident("crash", "r1", 7, 7.0, recorder=rec, injection_kinds=kinds),
            led.open_incident("wedge", "r0", 9, 9.0, recorder=rec, injection_kinds=kinds),
            led.open_incident("crash", "r1", 11, 11.0, recorder=rec, injection_kinds=kinds))]

    assert _both(scenario) == [(3, 4), (3, 6), (None, None)]


def test_injection_join_matches_victimless_records():
    def scenario(gp, reg, mon):
        rec = _ring({"ts": 0.0, "kind": "chaos.injection", "injection": "transfer_flap",
                     "step": 2})
        return gp.GoodputLedger().note_transfer_flap("r0", 5, 5.0, 3, recorder=rec).as_dict()

    d = _both(scenario)
    assert d["detection_latency_ticks"] == 3 and not d["open"]
    assert d["resolved_by"] == "fallback" and d["mttr_s"] == 0.0 and d["events"] == 3


def test_transfer_flap_bursts_merge_into_one_incident():
    def scenario(gp, reg, mon):
        led = gp.GoodputLedger()
        first = led.note_transfer_flap("r0", 5, 5.0, 2)
        merged = [led.note_transfer_flap("r0", 6, 6.0, 1), led.note_transfer_flap("r0", 7, 7.0, 1)]
        second = led.note_transfer_flap("r0", 10, 10.0, 1)
        other = led.note_transfer_flap("r1", 10, 10.0, 1)
        return (first.events, merged, second is not first, other is not None,
                [i.as_dict() for i in led.incidents])

    events, merged, new, other, incidents = _both(scenario)
    assert events == 4 and merged == [None, None] and new and other
    assert len(incidents) == 3


def test_incident_log_bounded_with_drop_counter():
    def scenario(gp, reg, mon):
        led = gp.GoodputLedger(max_incidents=3)
        for i in range(5):
            led.open_incident("crash", f"r{i}", i, float(i))
            led.resolve_incident(f"r{i}", i, float(i), "rejoin")
        return led.incidents_dropped, [i.replica for i in led.incidents]

    assert _both(scenario) == (2, ["r2", "r3", "r4"])


def test_resolve_without_replica_closes_oldest_open():
    def scenario(gp, reg, mon):
        led = gp.GoodputLedger()
        led.open_incident("crash", "r0", 1, 1.0)
        led.open_incident("crash", "r1", 2, 2.0)
        return [None if i is None else i.replica for i in (
            led.resolve_incident(None, 3, 3.0, "scale_up"),
            led.resolve_incident(None, 4, 4.0, "scale_up"),
            led.resolve_incident(None, 5, 5.0, "scale_up"))]

    assert _both(scenario) == ["r0", "r1", None]


def test_publish_gauges_and_monotone_counters():
    def scenario(gp, reg_cls, mon):
        reg = reg_cls(enabled=True)
        led = gp.GoodputLedger(registry=reg)
        led.touch("r0", 0.0, "serving", 0)
        led.account("r0", 1.0, "productive", "serving", 1)
        led.account("r0", 2.0, "stall", "serving", 2)
        led.on_tick(2, 2.0)
        first = reg.snapshot()
        led.publish()
        return first, reg.snapshot()

    snap, snap2 = _both(scenario)
    assert snap["gauges"]["goodput.fraction"] == pytest.approx(0.5)
    assert snap["gauges"]["goodput.badput.stall_seconds"] == pytest.approx(1.0)
    assert snap["counters"]["goodput.badput_seconds_total"] == pytest.approx(1.0)
    assert snap["counters"]["goodput.wall_seconds_total"] == pytest.approx(2.0)
    assert snap2["counters"] == snap["counters"]


def test_availability_slo_target_breaches_on_badput_burn():
    def scenario(gp, reg_cls, mon_cls):
        reg = reg_cls(enabled=True)
        led = gp.GoodputLedger(registry=reg)
        clock = [0.0]
        mon = mon_cls([gp.availability_slo_target(target=0.95)], registry=reg,
                      clock=lambda: clock[0], fast_window_s=10.0, slow_window_s=100.0,
                      burn_threshold=2.0)
        mon.evaluate()
        led.touch("r0", 0.0, "serving", 0)
        led.account("r0", 10.0, "failed_quarantine", "failed", 1)
        led.on_tick(1, 10.0)
        clock[0] = 5.0
        return mon.evaluate()["targets"]["fleet_availability"]

    t = _both(scenario)
    assert t["bad_fraction_fast"] == pytest.approx(1.0) and t["breaching"]


def test_availability_target_validates():
    t = tgp.availability_slo_target(0.99)
    assert t.kind == "ratio" and t.target == 0.99
    assert t.bad_metric == jgp.availability_slo_target(0.99).bad_metric
    with pytest.raises(ValueError):
        tgp.availability_slo_target(1.0)


def test_goodput_trace_events_render_bands_and_incident_markers():
    out = []
    for gp, _, _, ct in MODS:
        led = gp.GoodputLedger()
        led.touch("r0", 0.0, "serving", 0)
        led.account("r0", 1.0, "productive", "serving", 1)
        led.account("r0", 2.0, "stall", "serving", 2)
        led.touch("r1", 0.0, "serving", 0)
        led.account("r1", 2.0, "idle", "serving", 2)
        inc = led.open_incident("crash", "r1", 2, 1.5)
        led.resolve_incident("r1", 4, 2.0, "rejoin")
        out.append((ct.goodput_trace_events(led), inc.mttr_s))
    assert out[1] == out[0]
    evs, mttr = out[1]
    assert all(e["pid"] == tct.PID_GOODPUT for e in evs)
    threads = {e["args"]["name"]: e["tid"] for e in evs if e["name"] == "thread_name"}
    assert set(threads) == {"r0", "r1"}
    bands = [e for e in evs if e.get("cat") == "goodput.state"]
    r0 = [e for e in bands if e["tid"] == threads["r0"]]
    assert [e["name"] for e in r0] == ["productive", "stall"]
    assert r0[0]["ts"] == 0.0 and r0[0]["dur"] == 1e6
    (mark,) = [e for e in evs if e.get("cat") == "goodput.incident"]
    assert mark["name"] == "incident crash" and mark["tid"] == threads["r1"]
    assert mark["args"]["mttr_s"] == mttr


class _FakeTrainer:
    def __init__(self, step=0):
        self.state = SimpleNamespace(step=step)


def _rewind_scenario(gp, reg_cls, mon):
    clock = [0.0]
    g = gp.TrainerGoodput(clock=lambda: clock[0])
    tr = _FakeTrainer()
    g.on_fit_start(tr)
    seen = {}

    def run_step(step, dt, gap=0.25):
        clock[0] += gap
        g.on_step_start(tr, step)
        clock[0] += dt
        g.on_step_end(tr, step, 0.0)

    run_step(1, 2.0)
    run_step(2, 0.5)
    g.on_checkpoint(tr, 2, "/unused")
    run_step(3, 0.5, gap=1.0)
    seen["ckpt"] = g.classes["checkpoint_save"]
    run_step(2, 0.5, gap=0.75)
    seen["restore"] = g.classes["restore"]
    seen["open"] = [dict(i) for i in g.incidents]
    run_step(3, 0.5)
    run_step(4, 0.5)
    g.on_fit_end(tr)
    return seen, g.report()


def test_trainer_goodput_partitions_fit_wall_and_prices_rewind():
    seen, rep = _both(_rewind_scenario)
    assert seen["ckpt"] == pytest.approx(1.0) and seen["restore"] == pytest.approx(0.75)
    (inc,) = seen["open"]
    assert inc["open"] and inc["rewound_to"] == 2 and inc["step_detected"] == 3
    (inc,) = rep["incidents"]
    assert not inc["open"] and inc["replayed_steps"] == 2
    assert inc["mttr_s"] == pytest.approx(1.25)
    assert rep["conservation_ok"] and rep["replayed_steps"] == 2
    assert rep["classes"]["compile_warmup"] == pytest.approx(2.0)
    assert rep["classes"]["rewind_replay"] == pytest.approx(1.0)
    assert rep["classes"]["step_compute"] == pytest.approx(1.5)
    assert sum(rep["classes"].values()) == pytest.approx(rep["fit_wall_s"])
    assert 0 < rep["goodput_fraction"] < 1


def test_trainer_goodput_publishes_gauges_and_sorts_first():
    def scenario(gp, reg_cls, mon):
        reg = reg_cls(enabled=True)
        clock = [0.0]
        g = gp.TrainerGoodput(clock=lambda: clock[0], registry=reg)
        tr = _FakeTrainer()
        g.on_fit_start(tr)
        clock[0] = 1.0
        g.on_step_start(tr, 1)
        clock[0] = 2.0
        g.on_step_end(tr, 1, 0.0)
        g.on_fit_abort(tr, RuntimeError("x"))
        return g.order, reg.snapshot()["gauges"]

    order, gauges = _both(scenario)
    assert order == -100
    assert "train.goodput.fraction" in gauges
    assert gauges["train.goodput.compile_warmup_seconds"] == pytest.approx(1.0)


def _median_call_seconds(fn, n=2000, rounds=15):
    samples = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        samples.append((time.perf_counter() - t0) / n)
    return sorted(samples)[len(samples) // 2]


def test_disabled_trainer_goodput_guard_under_5us():
    """A ``TrainerGoodput`` that is not passed to ``fit`` costs nothing;
    one that is costs a clock read and a dict update per hook, and its
    ``publish`` on a disabled registry is one branch."""
    g = tgp.TrainerGoodput()
    tr = _FakeTrainer()
    g.on_fit_start(tr)
    step = [0]

    def hooks():
        step[0] += 1
        g.on_step_start(tr, step[0])
        g.on_step_end(tr, step[0], 0.0)

    assert _median_call_seconds(hooks) < 5e-6
    led = tgp.GoodputLedger(registry=MetricsRegistry(enabled=False))
    assert _median_call_seconds(led.publish) < 5e-6


# -- real engines and a real Trainer --------------------------------------------


def test_ledger_classifies_real_engine_ticks_like_jax():
    """One replica account per engine, driven tick by tick as the control
    plane drives it: the JAX engine's and the port's classify alike
    (first programs -> compile_warmup, a deferred head -> its delta)."""
    import jax
    import jax.numpy as jnp

    from pipegoose_tpu.models import bloom as jbloom
    from pipegoose_tpu.serving import Request as JRequest
    from pipegoose_tpu.serving import ServingEngine as JServingEngine
    from pipegoose_tpu_torch.models import bloom as tbloom
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.serving import Request, ServingEngine

    jcfg = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
    tcfg = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4,
                              initializer_range=0.3)
    np_tree = tbloom.init_params_numpy(tcfg, seed=0)
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(1, 64, (k,)), n) for k, n in [(9, 4), (6, 5), (11, 3), (7, 4)]]
    knobs = dict(num_slots=2, num_pages=8, page_size=4, max_context=32, prefill_chunk=4)
    engines = (
        (jgp, JServingEngine(jax.tree_util.tree_map(jnp.asarray, np_tree), jcfg,
                             attn_kernel="paged", **knobs), JRequest),
        (tgp, ServingEngine(params_from_jax(np_tree, tcfg, device="cpu"), tcfg,
                            device="cpu", **knobs), Request))
    reports = []
    for gp, eng, cls in engines:
        led = gp.GoodputLedger()
        rep = SimpleNamespace(state=SimpleNamespace(value="serving"), engine=eng,
                              probation_ticks_left=0)
        t = [0.0]
        eng.start_run([cls(prompt=p, max_new_tokens=n) for p, n in reqs],
                      now=lambda: t[0])
        led.touch("r0", 0.0, "serving", 0)
        tick = 0
        while not eng.sched.all_done():
            tick += 1
            pre = led.pre_tick(rep)
            had_work = bool(eng.sched.queue) or bool(eng.sched.active())
            ticked = eng.tick_once()
            t[0] = float(tick)
            led.account("r0", t[0], led.classify(rep, pre, had_work, ticked, False),
                        "serving", tick)
        eng.finish_run()
        reports.append(led.report())
    assert reports[1] == reports[0]
    classes = reports[1]["classes"]
    assert classes["compile_warmup"] > 0 and classes["productive"] > 0
    assert reports[1]["conservation_ok"]


@pytest.fixture()
def parts(tmp_path):
    import torch
    import torch.distributed as dist

    from pipegoose_tpu_torch.distributed import ParallelContext
    from pipegoose_tpu_torch.models import bloom as tbloom

    store = dist.FileStore(str(tmp_path / "store"), 1)
    ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cpu",
                                         tensor_parallel_size=1, data_parallel_size=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # runs compared bit for bit
    cfg = tbloom.BloomConfig(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
    yield cfg, tbloom.init_params_numpy(cfg, seed=0)
    torch.set_num_threads(threads)
    ctx.destroy()


def _batch(seed, poison=False):
    from test_torch_trainer_ranks import POISON

    ids = np.random.RandomState(seed).randint(1, 128, (8, 8))
    if poison:
        ids[0, 0] = POISON
    return ids


def test_trainer_goodput_on_fit_conserves_and_prices_a_rewind(parts, tmp_path):
    """``TrainerGoodput`` on the port's ``Trainer.fit`` (2-layer BLOOM on
    the CPU, one gloo rank): the losses and params of the run without it,
    bit for bit; the fit wall conserved, the first step booked as warm-up
    and a checkpoint's gap as save. With an ``AutoRecovery`` rewind over a
    poisoned batch: one incident, its replayed steps the rewind's length
    (step 3 rewound to the step-2 checkpoint), its MTTR set."""
    import torch
    from test_torch_trainer_ranks import make_trainer

    from pipegoose_tpu_torch.nn.parallel import tree_leaves
    from pipegoose_tpu_torch.trainer import AutoRecovery, CheckpointCallback

    cfg, np_tree = parts
    batches = [_batch(s) for s in (1, 2, 3, 4)]
    plain = make_trainer(np_tree, cfg, 1e-3, poison=True, callbacks=[])
    plain.fit(batches)
    gp = tgp.TrainerGoodput()
    traced = make_trainer(np_tree, cfg, 1e-3, poison=True, callbacks=[
        gp, CheckpointCallback(str(tmp_path / "a"), every=2)])
    traced.fit(batches)
    assert [float(x) for x in traced.state.losses] == [float(x) for x in plain.state.losses]
    for got, want in zip(tree_leaves(traced.params), tree_leaves(plain.params)):
        assert torch.equal(got, want)
    rep = gp.report()
    assert rep["conservation_ok"] and rep["incidents"] == [] and rep["replayed_steps"] == 0
    assert rep["classes"]["compile_warmup"] > 0 and rep["classes"]["checkpoint_save"] > 0
    assert rep["classes"]["step_compute"] > 0

    run_dir = str(tmp_path / "b")
    gp = tgp.TrainerGoodput()
    rec = AutoRecovery(run_dir, max_restores=2)
    trainer = make_trainer(np_tree, cfg, 1e-3, poison=True, callbacks=[
        gp, CheckpointCallback(run_dir, every=2), rec])
    trainer.fit([_batch(1), _batch(2), _batch(3, poison=True), _batch(4), _batch(5)])
    assert rec.restores == 1 and trainer.state.step == 4
    rep = gp.report()
    assert rep["conservation_ok"]
    (inc,) = rep["incidents"]
    assert inc["kind"] == "recovery_rewind" and not inc["open"]
    assert (inc["step_detected"], inc["rewound_to"]) == (3, 2)
    assert inc["replayed_steps"] == rep["replayed_steps"] == 3 - 2
    assert inc["mttr_s"] is not None and inc["mttr_s"] > 0
    assert rep["classes"]["restore"] > 0 and rep["classes"]["rewind_replay"] > 0
