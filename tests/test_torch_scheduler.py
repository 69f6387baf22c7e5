"""The port's scheduler held against the JAX scheduler on fake-clock
scripts: deadline shedding, preemption order and the timestamp contract,
``continuous=False``, and the engine's stall watchdog.

Each script is a list of operations with explicit ``now`` values, run on
a port ``Scheduler`` and a JAX ``Scheduler`` over their own pools; after
every operation the two states (queue, slots, every request's lifecycle
fields, timestamps and pages, the pool history, the shed list) must be
equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.serving import PagePool as JPagePool
from pipegoose_tpu.serving import Request as JRequest
from pipegoose_tpu.serving import Scheduler as JScheduler
from pipegoose_tpu.serving import ServingEngine as JServingEngine
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.serving import PagePool, Request, Scheduler, ServingEngine

SIDES = {"port": (PagePool, Request, Scheduler),
         "jax": (JPagePool, JRequest, JScheduler)}


def _state(sched, reqs):
    fields = ("uid", "slot", "pages", "outstanding", "prefilled_len", "generated",
              "finish_reason", "t_submit", "t_admit", "t_first_token", "t_done")
    return {
        "queue": [r.uid for r in sched.queue],
        "slots": [None if r is None else r.uid for r in sched.slots],
        "reqs": [(r.status.value, *(getattr(r, f) for f in fields)) for r in reqs],
        "history": list(sched.pool.history),
        "outstanding": sched._outstanding_total,
        "shed": [r.uid for r in sched.shed],
    }


def _drive(script, specs, num_slots=2, num_pages=33, continuous=True):
    """Run ``script`` on both sides; returns the port's per-op results.
    ``specs`` are (prompt_len, max_new, deadline_s) per request; an op is
    (name, request index or None, now, extra)."""
    states, results = {}, {}
    for side, (P, R, S) in SIDES.items():
        sched = S(num_slots, P(num_pages, 4), max_context=32, continuous=continuous)
        reqs = [R(prompt=np.arange(1, n + 1, dtype=np.int64), max_new_tokens=m,
                  deadline_s=d) for n, m, d in specs]
        states[side], results[side] = [], []
        for op, i, now, extra in script:
            if op == "submit":
                out = sched.submit(reqs[i], now=now)
            elif op == "admit":
                out = [r.uid for r in sched.admit(now=now)]
            elif op == "drain":
                out = [r.uid for r in sched.drain_shed()]
            elif op == "preempt":
                out = sched.preempt(reqs[i])
            elif op == "token":
                sched.ensure_page(reqs[i])
                out = sched.record_token(reqs[i], extra, now=now)
            elif op == "can_admit":
                out = sched.can_admit(reqs[i])
            results[side].append(out)
            states[side].append(_state(sched, reqs))
    for k, (a, b) in enumerate(zip(states["port"], states["jax"])):
        assert a == b, f"after op {k} {script[k]}"
    assert results["port"] == results["jax"]
    return results["port"], states["port"]


def test_deadline_shed_at_admission():
    """A queued request past its deadline sheds at admission (terminal,
    drained once); the fresh one admits."""
    res, st = _drive([("submit", 0, 0.0, None), ("submit", 1, 0.0, None),
                      ("admit", None, 1.0, None), ("drain", None, 1.0, None),
                      ("drain", None, 1.0, None)],
                     [(4, 4, 0.5), (4, 4, None)])
    assert res[2] == [1] and res[3] == [0] and res[4] == []
    assert st[-1]["reqs"][0][0] == "done" and st[-1]["reqs"][0][7] == "shed"


def test_admitted_and_preempted_requests_never_shed():
    """Admission is the only deadline checkpoint: an admitted request runs
    past its deadline, and a preempted one (``t_admit`` set) re-admits
    past it with its generated tokens."""
    res, st = _drive([("submit", 0, 0.0, None), ("admit", None, 0.1, None),
                      ("token", 0, 0.2, 7), ("preempt", 0, None, None),
                      ("admit", None, 99.0, None), ("drain", None, 99.0, None),
                      ("submit", 1, 99.0, None), ("admit", None, 99.5, None),
                      ("token", 1, 100.0, 7), ("token", 1, 101.0, 7)],
                     [(4, 4, 0.5), (4, 2, 0.5)], num_slots=2)
    assert res[4] == [0] and res[5] == []
    assert st[-1]["reqs"][0][7] is None and st[-1]["reqs"][0][6] == [7]
    assert st[-1]["reqs"][1][7] == "length"


def test_negative_deadline_refused():
    for P, R, S in SIDES.values():
        with pytest.raises(ValueError, match="deadline_s must be >= 0, got -1.0"):
            S(1, P(33, 4), max_context=32).submit(
                R(prompt=np.arange(1, 5), max_new_tokens=4, deadline_s=-1.0), now=0.0)


def test_preempt_order_and_timestamp_contract():
    """Preempting in reverse order re-queues by original submit order,
    ahead of fresh arrivals; t_submit, t_admit and t_first_token survive
    preempt -> re-admit."""
    res, st = _drive([("submit", 0, 1.0, None), ("submit", 1, 1.0, None),
                      ("submit", 2, 1.5, None), ("admit", None, 2.0, None),
                      ("token", 0, 3.0, 7), ("token", 1, 3.0, 8),
                      ("preempt", 1, None, None), ("preempt", 0, None, None),
                      ("admit", None, 9.0, None), ("token", 0, 10.0, 9)],
                     [(4, 8, None)] * 3)
    assert st[7]["queue"] == [0, 1, 2]
    assert res[8] == [0, 1]
    t_sub, t_adm, t_first = (st[-1]["reqs"][0][i] for i in (8, 9, 10))
    assert (t_sub, t_adm, t_first) == (1.0, 2.0, 3.0)


def test_continuous_false_drains_before_refill():
    """continuous=False admits only into an empty slot set: a freed slot
    stays empty (and ``can_admit`` says so) until the batch drains; the
    continuous scheduler backfills it at once."""
    script = [("submit", i, 0.0, None) for i in range(3)] + [
        ("admit", None, 0.0, None), ("token", 0, 1.0, 5), ("token", 1, 1.0, 1),
        ("can_admit", 2, None, None), ("admit", None, 2.0, None),
        ("token", 1, 3.0, 5), ("admit", None, 4.0, None)]
    specs = [(4, 1, None), (4, 2, None), (4, 4, None)]
    res, _ = _drive(script, specs, continuous=False)
    assert res[3] == [0, 1] and res[6] is False and res[7] == [] and res[9] == [2]
    res, _ = _drive(script, specs, continuous=True)
    assert res[6] is True and res[7] == [2]


def test_stall_watchdog_raises_after_patience():
    """A queue head that can never be admitted (the pool stranded behind
    the scheduler's back): after ``stall_patience`` empty ticks both
    engines raise the same error, and the port's engine is free to run
    again."""
    jcfg = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
    tcfg = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
    np_tree = tbloom.init_params_numpy(tcfg, seed=0)
    kw = dict(num_slots=2, num_pages=8, page_size=4, max_context=32, stall_patience=5)
    jeng = JServingEngine(jax.tree_util.tree_map(jnp.asarray, np_tree), jcfg,
                          attn_kernel="paged", **kw)
    teng = ServingEngine(params_from_jax(np_tree, tcfg, device="cpu"), tcfg,
                         device="cpu", **kw)
    errors, ticks = [], []
    for eng, R in ((jeng, JRequest), (teng, Request)):
        eng.pool.alloc(eng.pool.free_count - 1)
        n = [0]

        def hook(engine, tick, n=n):
            n[0] = tick
        with pytest.raises(RuntimeError, match="decode stall") as err:
            eng.run([R(prompt=np.arange(1, 6), max_new_tokens=4)], tick_hook=hook)
        errors.append(str(err.value))
        ticks.append(n[0])
    assert errors[0] == errors[1]
    assert "1 queued" in errors[1] and "1/7 pages free" in errors[1]
    assert ticks == [5, 5]
    with pytest.raises(ValueError, match="stall_patience"):
        ServingEngine(teng.params, tcfg, device="cpu", **{**kw, "stall_patience": 0})
    assert teng._run is None
