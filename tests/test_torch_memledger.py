"""The port's memory ledger: the counterparts of
``tests/telemetry/test_memledger.py`` (owner tags mirroring the pool's
refcounts, classification by strongest owner, integer-exact conservation,
the leak / double-owner / stranded-reservation audit firing each black box
once, the exhaustion forecast; not the Chrome counter tracks, which wait
for the second half of the telemetry core) on the port's ``PagePool``; and
the JAX engine and the port's, each with ``memledger=True``, serving the
same requests: equal ``counts()``, ``conservation()``, per-tick samples and
the non-time fields of ``run_summary()``, the bytes per page measured from
each pool (int8 pages: q + scale planes) equal, and a clean audit."""
import math
from collections import deque
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pipegoose_tpu_torch.serving import kv_pool as tkv
from pipegoose_tpu_torch.serving.kv_pool import PagePool
from pipegoose_tpu_torch.telemetry.flightrec import FlightRecorder
from pipegoose_tpu_torch.telemetry.memledger import MemoryLedger
from pipegoose_tpu_torch.telemetry.registry import MetricsRegistry


def _pool(n=16, ps=4):
    return PagePool(n, ps)


def _bound(pool=None, **kw):
    pool = pool if pool is not None else _pool()
    led = MemoryLedger()
    led.bind(pool, **kw)
    return pool, led


def _alloc(pool, n, tag):
    return pool.alloc(n, owner=tag)


def test_alloc_share_release_mirror_refcounts_and_classify():
    pool, led = _bound()
    pages = _alloc(pool, 2, ("req", 7))
    assert led.counts()["request"] == 2
    # a cache share on a request page: counted ONCE, strongest owner
    pool.share([pages[0]], owner=("cache",))
    c = led.counts()
    assert c["request"] == 2 and c["cached"] == 0
    # the request side releases: the page DEMOTES to cached, not freed
    pool.release([pages[0]], owner=("req", 7))
    c = led.counts()
    assert c["request"] == 1 and c["cached"] == 1
    assert pool.refcount(pages[0]) == 1
    assert led.conservation()["ok"]
    assert led.mismatched_releases == 0


def test_untagged_release_drops_weakest_tag():
    pool, led = _bound()
    (p,) = _alloc(pool, 1, ("req", 1))
    pool.share([p], owner=("cache",))
    # untagged release (legacy call site): the WEAKEST owner goes, the
    # page stays request-class — a ledger gap may misattribute, never
    # demote a live request's page
    pool.release([p])
    assert led.counts()["request"] == 1
    assert led.counts()["cached"] == 0


def test_mismatched_release_counted_not_raised():
    pool, led = _bound()
    (p,) = _alloc(pool, 1, ("req", 1))
    pool.release([p], owner=("stage", 99))   # a tag the page never had
    assert led.mismatched_releases == 1
    assert led.counts()["request"] == 0   # refcount 0: fully freed
    assert led.conservation()["ok"]


def test_retag_moves_staged_to_request_without_refcount_change():
    pool, led = _bound()
    pages = _alloc(pool, 2, ("stage", 3))
    assert led.counts()["staged"] == 2
    led.retag(pages, ("stage", 3), ("req", 3))
    c = led.counts()
    assert c["staged"] == 0 and c["request"] == 2
    assert pool.used_count == 2 and led.conservation()["ok"]


def test_trail_records_transitions_and_survives_free():
    pool, led = _bound()
    (p,) = _alloc(pool, 1, ("req", 5))
    pool.release([p], owner=("req", 5))
    trail = led.trail(p)
    assert [e["event"] for e in trail] == ["alloc", "release"]
    assert trail[0]["owner"] == ["req", 5]
    assert p not in led._tags            # freed, but the trail remains


def test_resync_adopts_warm_pool_as_untracked():
    pool = _pool()
    pages = pool.alloc(3)                # allocated BEFORE any ledger
    led = MemoryLedger()
    led.bind(pool)
    assert led.counts()["request"] == 3  # untracked counts as request
    assert led.conservation()["ok"]
    # the adopted refs release cleanly (weakest-tag drop)
    pool.release(pages)
    assert led.counts()["request"] == 0


def test_reserved_unmaterialized_completes_the_partition():
    pool = _pool(16)
    sched = SimpleNamespace(_outstanding_total=5, transfers={},
                            active=lambda: [])
    led = MemoryLedger()
    led.bind(pool, sched=sched)
    _alloc(pool, 4, ("req", 1))
    c = led.counts()
    assert c["reserved_unmaterialized"] == 5
    assert c["free"] == pool.free_count - 5
    cons = led.conservation()
    assert cons["ok"]
    assert cons["sum_pages"] == pool.capacity
    # reservations beyond the physically free pages report as
    # evictable-backed overlap, keeping the capacity sum a partition
    sched._outstanding_total = pool.free_count + 3
    cons = led.conservation()
    assert cons["ok"] and cons["reserved_evictable_backed"] == 3


def test_on_tick_conservation_break_fires_once_and_never_raises(tmp_path):
    pool = _pool()
    rec = FlightRecorder(str(tmp_path), capacity=8)
    led = MemoryLedger()
    led.bind(pool, recorder=rec)
    _alloc(pool, 2, ("req", 1))
    # corrupt the mirror behind the ledger's back: classified != used
    led._tags.clear()
    led._class.clear()
    led._counts = {k: 0 for k in led._counts}
    led.on_tick(1)
    led.on_tick(2)
    assert led.conservation_failures == 2
    trig = rec.take_trigger()
    assert trig is not None and trig.name == "ledger_conservation"
    assert rec.take_trigger() is None    # fired ONCE across both ticks


def test_audit_detects_leak_with_owner_trail_and_fires_once(tmp_path):
    pool = _pool()
    rec = FlightRecorder(str(tmp_path), capacity=8)
    sched = SimpleNamespace(_outstanding_total=0, transfers={},
                            active=lambda: [])
    led = MemoryLedger()
    led.bind(pool, sched=sched, recorder=rec)
    (p,) = _alloc(pool, 1, ("req", 4))
    # the leak: an extra reference nobody reachable owns
    pool.share([p], owner=("req", 4))
    report = led.audit()
    assert not report["ok"]
    (leak,) = report["leaks"]
    assert leak["page"] == p and leak["refcount"] == 2
    assert leak["holders"] == 0          # the stub sched holds nothing
    assert leak["trail"], "leak box must carry the ownership trail"
    trig = rec.take_trigger()
    assert trig is not None and trig.name == "memory_leak"
    assert str(p) in trig.reason
    led.audit()                          # re-audit: counted, quiet
    assert led.audits_run == 2
    assert rec.take_trigger() is None


def test_audit_detects_double_owner(tmp_path):
    pool = _pool()
    rec = FlightRecorder(str(tmp_path), capacity=8)
    led = MemoryLedger()
    (p,) = pool.alloc(1)
    # two requests both claim the page; the pool granted ONE reference
    req_a = SimpleNamespace(uid=1, pages=[p], cow=None, outstanding=0)
    req_b = SimpleNamespace(uid=2, pages=[p], cow=None, outstanding=0)
    sched = SimpleNamespace(_outstanding_total=0, transfers={},
                            active=lambda: [req_a, req_b])
    led.bind(pool, sched=sched, recorder=rec)
    report = led.audit()
    (dbl,) = report["double_owners"]
    assert dbl["page"] == p and dbl["holders"] == 2 and dbl["refcount"] == 1
    trig = rec.take_trigger()
    assert trig is not None and trig.name == "double_owner"


def test_audit_detects_stranded_reservation(tmp_path):
    pool = _pool()
    rec = FlightRecorder(str(tmp_path), capacity=8)
    sched = SimpleNamespace(_outstanding_total=3, transfers={},
                            active=lambda: [])
    led = MemoryLedger()
    led.bind(pool, sched=sched, recorder=rec)
    report = led.audit()
    assert report["stranded_reserved_pages"] == 3
    trig = rec.take_trigger()
    assert trig is not None and trig.name == "stranded_reservation"
    assert "3" in trig.reason


def test_audit_clean_pool_is_ok():
    pool, led = _bound()
    req = SimpleNamespace(uid=1, pages=[], cow=None, outstanding=0)
    sched = SimpleNamespace(_outstanding_total=0, transfers={},
                            active=lambda: [req])
    led.sched = sched
    req.pages = _alloc(pool, 2, ("req", 1))
    assert led.audit()["ok"]


def test_forecast_monotone_to_zero_under_steady_consumption():
    pool = _pool(32)
    sched = SimpleNamespace(_outstanding_total=0, transfers={},
                            active=lambda: [])
    led = MemoryLedger()
    led.bind(pool, sched=sched)
    seen = []
    for t in range(1, 14):
        _alloc(pool, 2, ("req", t))
        led.note_admission(4, True)
        led.on_tick(t)
        seen.append(led.steps_to_exhaustion)
    finite = [s for s in seen if not math.isinf(s)]
    assert finite, "a steady drain must produce a finite forecast"
    assert finite == sorted(finite, reverse=True)   # monotone down
    assert finite[-1] == 0.0
    assert led.min_steps_to_exhaustion == 0.0


def test_forecast_infinite_without_consumption_trend():
    pool, led = _bound()
    for t in range(1, 4):
        led.on_tick(t)
    assert math.isinf(led.steps_to_exhaustion)


def test_note_admission_block_records_first_tick():
    pool, led = _bound()
    led.on_tick(1)
    led.on_tick(2)
    led.note_admission(4, False)
    led.note_admission(4, False)
    assert led.first_admission_block_tick == 2   # first block only


def test_report_shapes_and_gauges(tmp_path):
    reg = MetricsRegistry(enabled=True)
    pool = _pool()
    led = MemoryLedger()
    led.bind(pool, registry=reg, bytes_per_page=128)
    _alloc(pool, 3, ("req", 1))
    led.on_tick(1, t=0.25)
    rep = led.report()
    assert rep["classes"]["request"] == {"pages": 3, "bytes": 384}
    assert rep["conservation"]["ok"]
    assert rep["capacity_bytes"] == pool.capacity * 128
    assert rep["forecast"]["steps_to_exhaustion"] is None   # inf -> None
    g = reg.gauge("serving.memledger.request_bytes")
    assert g.value == 384.0
    assert reg.gauge("serving.memledger.steps_to_exhaustion").value == -1.0
    summary = led.run_summary()
    assert summary["peak_pages"]["request"] == 3
    assert summary["peak_bytes"]["request"] == 384
    assert summary["conservation_failures"] == 0


def test_unbind_detaches_observer():
    pool, led = _bound()
    led.unbind()
    assert pool.ledger is None
    pool.alloc(1)
    assert led.counts()["request"] == 0   # no longer fed


def test_history_ring_bounded_with_dropped_counter(monkeypatch):
    monkeypatch.setattr(tkv, "HISTORY_LIMIT", 4)
    pool = _pool(64, 4)
    for _ in range(6):
        pool.release(pool.alloc(1))
    assert len(pool.history) == 4
    assert pool.history_dropped == 8          # 12 events, 4 kept


def test_ledger_exact_after_history_ring_wraps(monkeypatch):
    """Accounting stays exact after the bounded history ring has dropped
    events: the ledger is fed synchronously, not parsed from the ring."""
    monkeypatch.setattr(tkv, "HISTORY_LIMIT", 2)
    pool = _pool(64, 4)
    led = MemoryLedger()
    led.bind(pool)
    held = []
    for i in range(8):
        held += _alloc(pool, 1, ("req", i))
    assert pool.history_dropped > 0
    assert led.counts()["request"] == 8
    assert led.conservation()["ok"]
    for i, p in enumerate(held):
        pool.release([p], owner=("req", i))
    assert led.counts()["request"] == 0 and led.conservation()["ok"]


def test_tag_is_one_shot_and_free_without_a_ledger():
    """An owner labels its own call's event only: the next call without
    one is untracked. Without a ledger the owner is ignored."""
    pool = _pool()
    pool.alloc(1, owner=("req", 1))
    assert pool.ledger is None and pool.used_count == 1
    pool, led = _bound()
    (p,) = pool.alloc(1, owner=("req", 2))
    pool.share([p])
    assert led._tags[p] == [("req", 2), ("untracked",)]
    assert led.counts()["request"] == 1


# -- the engines -------------------------------------------------------------

from pipegoose_tpu.models import bloom as jbloom  # noqa: E402
from pipegoose_tpu.serving import Request as JRequest  # noqa: E402
from pipegoose_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from pipegoose_tpu_torch.models import bloom as tbloom  # noqa: E402
from pipegoose_tpu_torch.models.weights import params_from_jax  # noqa: E402
from pipegoose_tpu_torch.serving import Request, ServingEngine  # noqa: E402

JCFG = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
TCFG = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4,
                          initializer_range=0.3)


@pytest.fixture(scope="module")
def engine_setup():
    np_tree = tbloom.init_params_numpy(TCFG, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tparams = params_from_jax(np_tree, TCFG, device="cpu")
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 64, (13,))
    reqs = [(np.concatenate([shared, rng.randint(1, 64, (k,))]), n)
            for k, n in [(3, 6), (5, 4), (2, 7), (4, 9)]] + [
        (shared[:10], 5), (rng.randint(1, 64, (9,)), 6)]
    return jparams, tparams, reqs


LEDGER_ARMS = {
    "cached_chunked": dict(prefix_cache=True, prefill_chunk=4),
    "cached_int8kv": dict(prefix_cache=True, kv_dtype="int8"),
    "tight_pool": dict(prefix_cache=True, prefill_chunk=4, num_pages=20),
    "speculative": dict(prefix_cache=True, prefill_chunk=4, speculative=(1, 2)),
}


def _sample(s):
    return {k: v for k, v in s.items() if k != "t"}


@pytest.mark.parametrize("arm", list(LEDGER_ARMS))
def test_engine_ledgers_equal_jax(engine_setup, arm):
    jparams, tparams, reqs = engine_setup
    knobs = dict(num_slots=3, num_pages=48, page_size=4, max_context=48)
    knobs.update(LEDGER_ARMS[arm])
    jeng = JServingEngine(jparams, JCFG, attn_kernel="paged", memledger=True, **knobs)
    teng = ServingEngine(tparams, TCFG, device="cpu", memledger=True, **knobs)
    out = []
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        outs, met = eng.run([cls(prompt=p, max_new_tokens=n) for p, n in reqs])
        led = eng.memledger
        audit = led.audit()
        out.append({
            "tokens": [o.generated.tolist() for o in outs],
            "bytes_per_page": led.bytes_per_page,
            "counts": led.counts(), "conservation": led.conservation(),
            "summary": met["memory"], "samples": [_sample(s) for s in led.samples],
            "ticks": led.ticks, "audit": {k: v for k, v in audit.items()},
            "report": {k: v for k, v in led.report().items() if k != "last_audit"},
        })
    got, want = out[1], out[0]
    assert got == want
    assert got["summary"]["conservation_failures"] == 0 and got["audit"]["ok"]
    assert got["ticks"] == len(got["samples"]) > 0
    assert got["bytes_per_page"] == teng.memory_report()["kv"]["bytes_per_page"]


def test_ledger_attached_to_a_warm_engine_adopts_its_pool(engine_setup):
    """attach_memledger after a run with cached pages: the resync adopts
    the cache's pages under their owner, conserved; detaching stops it."""
    _, tparams, reqs = engine_setup
    eng = ServingEngine(tparams, TCFG, device="cpu", prefix_cache=True, prefill_chunk=4,
                        num_slots=3, num_pages=48, page_size=4, max_context=48)
    eng.run([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    led = MemoryLedger()
    eng.attach_memledger(led)
    assert led.counts()["cached"] == eng.prefix_cache.cached_pages > 0
    assert led.conservation()["ok"]
    _, met = eng.run([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    assert met["memory"]["conservation_failures"] == 0 and led.audit()["ok"]
    eng.attach_memledger(None)
    assert eng.pool.ledger is None and eng.memledger is None
