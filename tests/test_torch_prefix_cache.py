"""The prefix cache slice held against the JAX package: the refcounted
``PagePool``, the ``PrefixCache`` radix index, ``copy_page`` and the
engine with ``prefix_cache=True``.

The host-side pieces run one seeded script of operations on the port's
object and on JAX's and must agree exactly: results, refcounts, pool
event histories. ``copy_page`` must copy bit for bit. The engines (the
2-layer, width-64 config of ``test_torch_engine.py``, pages of 4) must
give identical greedy tokens, identical pool histories and equal cache
metrics, cold and warm, chunked and bucketed, fp and int8 KV. The JAX
engine runs ``attn_kernel="paged"``, which on the CPU takes the JAX
kernel's plain reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.serving import PagePool as JPagePool
from pipegoose_tpu.serving import PrefixCache as JPrefixCache
from pipegoose_tpu.serving import Request as JRequest
from pipegoose_tpu.serving import Scheduler as JScheduler
from pipegoose_tpu.serving import ServingEngine as JServingEngine
from pipegoose_tpu.serving import Status as JStatus
from pipegoose_tpu.serving import kv_pool as jkv
from pipegoose_tpu.telemetry import MetricsRegistry
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.serving import (
    PagePool,
    PrefixCache,
    Request,
    Scheduler,
    ServingEngine,
    Status,
)
from pipegoose_tpu_torch.serving import kv_pool as tkv

JCFG = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
TCFG = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4,
                          initializer_range=0.3)


@pytest.fixture(scope="module")
def setup():
    np_tree = tbloom.init_params_numpy(TCFG, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tparams = params_from_jax(np_tree, TCFG, device="cpu")
    rng = np.random.RandomState(7)
    shared = rng.randint(1, 64, (13,))          # 3 full pages + 1 tail at ps=4
    reqs = [(np.concatenate([shared, rng.randint(1, 64, (k,))]), n)
            for k, n in [(3, 6), (5, 4), (2, 7)]] + [
        (shared[:10], 5),                       # strict prefix: COW mid-page
        (rng.randint(1, 64, (7,)), 6),          # unrelated: a pure miss
    ]
    return jparams, tparams, shared, reqs


def _engines(setup, **kw):
    jparams, tparams, _, _ = setup
    reg = MetricsRegistry(enabled=True)
    jeng = JServingEngine(jparams, JCFG, attn_kernel="paged", registry=reg, **kw)
    teng = ServingEngine(tparams, TCFG, device="cpu", **kw)
    return jeng, teng, reg


def _run_both(jeng, teng, reqs, **run_kw):
    jout, jmet = jeng.run([JRequest(prompt=p, max_new_tokens=n) for p, n in reqs],
                          **run_kw.get("j", {}))
    tout, tmet = teng.run([Request(prompt=p, max_new_tokens=n) for p, n in reqs],
                          **run_kw.get("t", {}))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.generated, j.generated,
                                      err_msg=f"request {t.uid} vs the JAX engine")
        assert t.finish_reason == j.finish_reason
    assert list(teng.pool.history) == list(jeng.pool.history)
    return jout, jmet, tout, tmet


# -- the refcounted pool -------------------------------------------------------


def _apply(pool, op):
    kind, arg = op
    if kind == "alloc":
        return pool.alloc(arg)
    if kind == "bad":
        for f in (pool.release, pool.share):
            try:
                f([arg])
            except RuntimeError as e:
                return str(e)
        return None
    return getattr(pool, kind)(arg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_event_script_matches_jax(seed, monkeypatch):
    """One seeded script on both pools: every result, error, refcount,
    shared count, fragmentation and the whole history equal; the bounded
    ring (limit 16) drops the same events."""
    rng = np.random.default_rng(seed)
    monkeypatch.setattr(tkv, "HISTORY_LIMIT", 16)
    tpool, jpool = PagePool(16, 4), JPagePool(16, 4, history_limit=16)
    for _ in range(400):
        refs = [p for p in range(16) for _ in range(jpool.refcount(p))]
        kind = rng.choice(["alloc", "share", "release", "free", "bad"],
                          p=[0.3, 0.2, 0.3, 0.1, 0.1])
        if kind == "alloc":
            op = ("alloc", int(rng.integers(1, 4)))
        elif kind == "bad" or not refs:
            op = ("bad", int(rng.integers(0, 16)))
        else:
            op = (str(kind), sorted({int(p) for p in rng.choice(refs, size=2)}))
        try:
            want = _apply(jpool, op)
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match="exhausted"):
                _apply(tpool, op)
            assert "exhausted" in str(e)
            continue
        assert _apply(tpool, op) == want, op
        assert [tpool.refcount(p) for p in range(16)] == [jpool.refcount(p)
                                                          for p in range(16)]
        assert (tpool.free_count, tpool.used_count, tpool.shared_count) == (
            jpool.free_count, jpool.used_count, jpool.shared_count)
        assert tpool.fragmentation() == jpool.fragmentation()
    assert list(tpool.history) == list(jpool.history)
    assert tpool.history_dropped == jpool.history_dropped > 0


def test_share_release_refcounting():
    """The JAX pool test's own walk on the port's pool, with ``free`` the
    alias of ``release``."""
    pool = PagePool(num_pages=9, page_size=4)
    (p,) = pool.alloc(1)
    pool.share([p])
    pool.share([p])
    assert pool.refcount(p) == 3 and pool.shared_count == 1
    pool.free([p])
    assert pool.refcount(p) == 2 and pool.free_count == 7
    pool.release([p])
    pool.release([p])
    assert pool.refcount(p) == 0 and pool.free_count == 8
    for f in (pool.release, pool.share):
        with pytest.raises(RuntimeError, match="not allocated"):
            f([p])
    assert [(e, d) for e, _, d in pool.history] == [
        ("alloc", 1), ("share", 1), ("share", 1), ("release", -1),
        ("release", -1), ("release", -1)]


# -- the radix index -----------------------------------------------------------


def _hit(h):
    return (h.pages, h.tokens, h.cow_page, h.cow_tokens, h.total_tokens)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prefix_cache_operation_script_matches_jax(seed):
    """A seeded script of insert / lookup / acquire / release / evict /
    clear over prompts built from a few shared blocks (so walks share
    prefixes, stop mid-trie and find COW candidates): every result, the
    evictable and cached counts, the longest-prefix probe and the pool
    history equal."""
    rng = np.random.default_rng(seed)
    ps = 4
    tpool, jpool = PagePool(40, ps), JPagePool(40, ps)
    tc, jc = PrefixCache(tpool), JPrefixCache(jpool)
    blocks = [list(rng.integers(1, 9, ps)) for _ in range(4)]
    held = []                        # page lists this script still references

    def prompt():
        toks = []
        for _ in range(int(rng.integers(1, 5))):
            toks += blocks[int(rng.integers(0, len(blocks)))]
        return toks + list(rng.integers(1, 9, int(rng.integers(0, ps + 2))))

    for _ in range(120):
        kind = rng.choice(["insert", "lookup", "release", "evict", "clear"],
                          p=[0.35, 0.35, 0.15, 0.12, 0.03])
        if kind == "insert":
            toks = prompt()
            n = -(-len(toks) // ps)
            if n > jpool.free_count:
                continue
            tp, jp = tpool.alloc(n), jpool.alloc(n)
            assert tp == jp
            assert tc.insert(toks, tp) == jc.insert(toks, jp)
            held.append(tp)
        elif kind == "lookup":
            toks = prompt()
            cap = int(rng.integers(0, len(toks) + 1))
            th, jh = tc.lookup(toks, max_tokens=cap), jc.lookup(toks, max_tokens=cap)
            assert _hit(th) == _hit(jh)
            assert tc.longest_prefix_len(toks) == jc.longest_prefix_len(toks)
            if rng.random() < 0.6:
                tc.acquire(th)
                jc.acquire(jh)
                pins = th.pages + ([th.cow_page] if th.cow_page is not None else [])
                if pins:
                    held.append(pins)
        elif kind == "release" and held:
            pages = held.pop(int(rng.integers(0, len(held))))
            tpool.release(pages)
            jpool.release(pages)
        elif kind == "evict":
            n = int(rng.integers(1, 6))
            assert tc.evict(n) == jc.evict(n)
        elif kind == "clear":
            assert tc.clear() == jc.clear()
        assert tc.evictable_count() == jc.evictable_count()
        assert tc.cached_pages == jc.cached_pages
    assert list(tpool.history) == list(jpool.history)
    assert tc.evictions > 0


def test_lazy_growth_retracts_when_insert_invalidates_the_ledger():
    """The JAX test of the temporal ledger hole, step for step on both
    schedulers: a later insert turns an evictable credit into a phantom,
    and lazy growth retracts the newest other request instead of
    raising (the port counts it). Every state along the way equal."""
    def state(sched, pool, reqs):
        return ([r.uid for r in sched.queue], [(r.status.value, r.pages, r.outstanding,
                                                r.prefilled_len) for r in reqs],
                list(pool.history), sched._outstanding_total)

    sides = []
    for mod in ("port", "jax"):
        P, C, S, R = ((PagePool, PrefixCache, Scheduler, Request) if mod == "port"
                      else (JPagePool, JPrefixCache, JScheduler, JRequest))
        pool = P(num_pages=9, page_size=4)
        cache = C(pool)
        sched = S(2, pool, max_context=32, prefix_cache=cache)
        blk_a = [7] * 4
        r0 = R(prompt=np.array(blk_a + [8] * 4), max_new_tokens=4)
        sched.submit(r0, 0.0)
        (a0,) = sched.admit(0.0)
        assert (len(a0.pages), a0.outstanding) == (2, 1)
        (pa,) = pool.alloc(1)
        cache.insert(blk_a, [pa])
        pool.release([pa])
        assert cache.evictable_count() == 1
        r1 = R(prompt=np.array([9] * 4), max_new_tokens=16)
        sched.submit(r1, 0.0)
        (a1,) = sched.admit(0.0)
        assert (len(a1.pages), a1.outstanding) == (1, 4)
        cache.insert(r0.tokens[:8], r0.pages)
        assert cache.evictable_count() == 0
        sched.ensure_pages(r0, 9)
        sched.ensure_pages(r1, 20)
        assert len(r1.pages) == 5 and r0.pages == [] and sched.queue[0] is r0
        assert r0.status.value == "queued"
        if mod == "port":
            assert sched.retractions == 1
        sides.append(state(sched, pool, [r0, r1]))
    assert sides[0] == sides[1]


# -- copy-on-write -------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
def test_copy_page_matches_jax_bit_for_bit(kv_dtype):
    """Random banks, written through the same quantizer for int8; copies
    in a chain (a copy of a copy, and onto a page just written) equal
    JAX's ``copy_page`` bit for bit, scale plane included."""
    rng = np.random.default_rng(3)
    shape = (JCFG.n_layer, 9, 4, JCFG.n_head, JCFG.head_dim)
    kv = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    if kv_dtype == "int8":
        jbanks = [dict(zip(("q", "scale"), jkv.quantize_kv(jnp.asarray(x)))) for x in kv]
        tbanks = [{"q": torch.from_numpy(np.array(b["q"])),
                   "scale": torch.from_numpy(np.array(b["scale"]))}
                  for b in jbanks]
    else:
        jbanks = [jnp.asarray(x) for x in kv]
        tbanks = [torch.from_numpy(x.copy()) for x in kv]
    jk, jv = jbanks
    tk, tv = tbanks
    for src, dst in [(3, 7), (7, 1), (5, 3), (2, 2)]:
        jk, jv = jkv.copy_page(jk, jv, jnp.int32(src), jnp.int32(dst))
        tkv.copy_page(tk, tv, src, dst)
    for t, j in ((tk, jk), (tv, jv)):
        if kv_dtype == "int8":
            for name in ("q", "scale"):
                np.testing.assert_array_equal(t[name].numpy(), np.asarray(j[name]))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("chunk", [8, None], ids=["chunk8", "bucketed"])
def test_cached_engine_matches_jax_cold_and_warm(setup, chunk, kv_dtype):
    """prefix_cache=True, chunked and bucketed, fp and int8 KV, a cold run
    then a warm one on the same engine: tokens and pool histories
    identical; the ``prefix_cache`` block, prefill tokens, chunks and steps
    equal; the COW count equal to the JAX registry's."""
    _, _, _, reqs = setup
    jeng, teng, reg = _engines(setup, num_slots=3, num_pages=32, page_size=4,
                               max_context=64, prefix_cache=True,
                               prefill_chunk=chunk, kv_dtype=kv_dtype)
    cow = reg.counter("serving.prefix_cache.cow_copies")
    for run in ("cold", "warm"):
        before = cow.value
        _, jmet, _, tmet = _run_both(jeng, teng, reqs)
        tblock = dict(tmet["prefix_cache"])
        assert tblock.pop("cow_copies") == cow.value - before, run
        assert tblock == jmet["prefix_cache"], run
        for key in ("prefill_tokens", "prefill_chunks", "decode_steps", "prefills",
                    "generated_tokens", "shed_requests"):
            assert tmet[key] == jmet[key], (run, key)
        assert teng.pool.used_count == teng.prefix_cache.cached_pages
    assert tmet["prefix_cache"]["hit_rate"] > 0.5
    assert tmet["prefix_cache"]["cow_copies"] >= 1


def test_cow_mid_page_tail_matches_jax(setup):
    """A strict mid-page prefix of a cached prompt: exactly one COW copy,
    9 hit tokens (2 shared pages + 1 COW token), and JAX's tokens."""
    _, _, shared, _ = setup
    jeng, teng, reg = _engines(setup, num_slots=2, num_pages=32, page_size=4,
                               max_context=64, prefix_cache=True)
    _run_both(jeng, teng, [(shared, 4)])
    _, _, _, tmet = _run_both(jeng, teng, [(shared[:10], 5)])
    snap = reg.snapshot()["counters"]
    assert tmet["prefix_cache"]["cow_copies"] == snap[
        "serving.prefix_cache.cow_copies"] == 1
    assert tmet["prefix_cache"]["hit_tokens"] == snap[
        "serving.prefix_cache.hit_tokens"] == 9
    assert tmet["prefill_tokens"] == 1


def test_evicted_and_readmitted_request_matches_uninterrupted(setup):
    """Preempt a shared-prefix request mid-decode: it re-admits through
    the cache, replays its generated tokens and equals both the JAX
    engine under the same preemption and an uninterrupted port run; the
    pool returns to its state before the run."""
    _, _, shared, _ = setup
    kw = dict(num_slots=2, num_pages=32, page_size=4, max_context=64,
              prefix_cache=True, prefill_chunk=8)
    jeng, teng, _ = _engines(setup, **kw)
    _run_both(jeng, teng, [(shared, 4)])
    free_before = teng.pool.free_count
    cached_before = teng.prefix_cache.cached_pages

    def preempt_once(status):
        state = {"hits": 0}

        def hook(engine, tick):
            if state["hits"]:
                return
            for r in engine.sched.active():
                if r.status is status and len(r.generated) >= 3:
                    engine.sched.preempt(r)
                    state["hits"] += 1
                    return
        return hook, state

    jhook, jstate = preempt_once(JStatus.DECODE)
    thook, tstate = preempt_once(Status.DECODE)
    _, jmet, tout, tmet = _run_both(jeng, teng, [(shared, 8)],
                                    j={"tick_hook": jhook}, t={"tick_hook": thook})
    assert jstate["hits"] == tstate["hits"] == 1
    assert tmet["prefills"] == jmet["prefills"] == 2
    assert teng.pool.free_count == free_before
    assert teng.prefix_cache.cached_pages == cached_before
    plain = ServingEngine(setup[1], TCFG, device="cpu", **kw)
    (ref,), _ = plain.run([Request(prompt=shared, max_new_tokens=8)])
    np.testing.assert_array_equal(tout[0].generated, ref.generated)


@pytest.mark.parametrize("num_pages", [9, 7])
def test_pool_pressure_evicts_lru_and_stays_correct(setup, num_pages):
    """The JAX test's pool of 9 pages, and one of 7 where admission must
    spend evictable cache pages: the port evicts the same LRU leaves as
    JAX (identical histories) and the tokens never change."""
    _, _, shared, _ = setup
    rng = np.random.RandomState(3)
    reqs = [(shared[:9], 4), (rng.randint(1, 64, (10,)), 4),
            (rng.randint(1, 64, (11,)), 4), (shared[:9], 4)]
    jeng, teng, _ = _engines(setup, num_slots=1, num_pages=num_pages, page_size=4,
                             max_context=32, prefix_cache=True)
    _run_both(jeng, teng, reqs)
    assert (teng.prefix_cache.evictions > 0) == (num_pages == 7)
    assert teng.pool.used_count == teng.prefix_cache.cached_pages <= num_pages - 1


def test_monolithic_prefill_refuses_a_preempted_request(setup):
    """Without the cache or chunking a preempted request cannot resume:
    the monolithic prefill raises the JAX engine's error."""
    _, tparams, shared, _ = setup
    eng = ServingEngine(tparams, TCFG, device="cpu", num_slots=1, num_pages=32,
                        page_size=4, max_context=64)

    def hook(engine, tick):
        for r in engine.sched.active():
            if len(r.generated) >= 2:
                engine.sched.preempt(r)

    with pytest.raises(RuntimeError, match="paged prefill path"):
        eng.run([Request(prompt=shared, max_new_tokens=6)], tick_hook=hook)
    assert eng._run is None


# -- the replay ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_requests=9, n_prefixes=3, prefix_len=20, suffix_lens=(2, 5), max_new=4),
    dict(n_requests=7, n_prefixes=2, prefix_len=12, suffix_lens=(3,), max_new=2,
         seed=4, zipf_a=2.0),
    dict(n_requests=5, n_prefixes=1, prefix_len=8, suffix_lens=(1, 2), max_new=3,
         seed=9),
], ids=["pairs", "steep_zipf", "one_prefix"])
def test_make_skewed_replay_matches_jax(kw):
    """The port's replay draws the JAX trace, row for row."""
    from pipegoose_tpu.serving import make_skewed_replay as jreplay
    from pipegoose_tpu_torch.serving import make_skewed_replay as treplay

    want, got = jreplay(vocab=64, **kw), treplay(vocab=64, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1:] == w[1:]


def test_prefix_replay_benchmark_counts_match_jax(setup):
    """Arms (a)-(e) of the replay benchmark on both packages: every
    deterministic column (prefill tokens, steps, hit rate, acceptance) and
    the summary's hit rate and prefill reduction equal; times are the
    port's own."""
    from pipegoose_tpu.serving import prefix_replay_benchmark as jbench
    from pipegoose_tpu_torch.serving import prefix_replay_benchmark as tbench

    jparams, tparams, _, _ = setup
    kw = dict(n_requests=6, prefix_len=12, suffix_lens=(2, 5), max_new=4,
              num_slots=2, num_pages=32, page_size=4, max_context=32,
              include_speculative=True, speculative=(1, 2))
    want = jbench(jparams, JCFG, **kw)
    got = tbench(tparams, TCFG, device="cpu", **kw)
    keys = ("prefill_tokens", "decode_steps", "hit_rate", "spec_acceptance_rate")
    assert set(got) == set(want)
    for arm in ("baseline", "chunked", "cached", "cached+chunked", "cached+spec"):
        assert set(got[arm]) == set(want[arm]), arm
        assert {k: got[arm].get(k) for k in keys} == {k: want[arm].get(k) for k in keys}
        assert got[arm]["decode_tokens_per_s"] > 0 and got[arm]["ttft_p99_s"] > 0
    for k in ("requests", "shared_prefix_len", "hit_rate", "prefill_token_reduction"):
        assert got["summary"][k] == want["summary"][k]


def test_prefix_replay_benchmark_arms_and_measure_hook(setup):
    """Arms given by name, as ``chip_smoke.py``'s phase 24 gives them: the
    hook takes each arm's measured (third) run once, its outputs are that
    run's, the rows' deterministic columns equal the JAX benchmark's arms
    of the same engines, and with no baseline there is no summary."""
    from pipegoose_tpu.serving import prefix_replay_benchmark as jbench
    from pipegoose_tpu_torch.serving import prefix_replay_benchmark as tbench

    jparams, tparams, _, _ = setup
    kw = dict(n_requests=6, prefix_len=12, suffix_lens=(2, 5), max_new=4,
              num_slots=2, num_pages=32, page_size=4, max_context=32)
    want = jbench(jparams, JCFG, include_speculative=True, speculative=(1, 2), **kw)
    arms = {"cached+chunked": dict(prefill_chunk=4, prefix_cache=True),
            "cached+spec": dict(prefill_chunk=4, prefix_cache=True, speculative=(1, 2))}
    seen = []

    def measure(label, engine, run):
        outs, metrics = run()
        seen.append((label, engine.speculative, len(outs), metrics["prefill_tokens"]))
        return outs, metrics

    got = tbench(tparams, TCFG, device="cpu", arms=arms, measure=measure, **kw)
    assert set(got) == set(arms)
    assert seen == [(label, arms[label].get("speculative"), 6, got[label]["prefill_tokens"])
                    for label in arms]
    keys = ("prefill_tokens", "decode_steps", "hit_rate", "spec_acceptance_rate")
    for arm in arms:
        assert {k: got[arm].get(k) for k in keys} == {k: want[arm].get(k) for k in keys}
