"""The slice as a whole: the port's ServingEngine held against the JAX
ServingEngine(attn_kernel="paged", prefill_chunk=8) and against
per-request ``generate()``, on the same converted params, fp and int8 KV.

Greedy tokens must be identical, and so must the page pool's event
history: placement is a pure function of the admit/evict order. The
weights use a wide init (std 0.3) so the tiny model's greedy streams
vary from token to token instead of repeating one id."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.models import generate as jgen
from pipegoose_tpu.serving import Request as JRequest
from pipegoose_tpu.serving import ServingEngine as JServingEngine
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.serving import Request, Scheduler, ServingEngine
from pipegoose_tpu_torch.serving.kv_pool import PagePool

JCFG = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
TCFG = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4,
                          initializer_range=0.3)
ENGINE = dict(num_slots=2, num_pages=32, page_size=4, max_context=64,
              prefill_chunk=8)
KV_MODES = {"fp": None, "int8": "int8"}


@pytest.fixture(scope="module")
def setup():
    np_tree = tbloom.init_params_numpy(TCFG, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tparams = params_from_jax(np_tree, TCFG, device="cpu")
    rng = np.random.default_rng(7)
    # mixed lengths: multi-chunk, exactly one chunk, sub-page, mid-page
    reqs = [(rng.integers(1, 64, (k,)), n)
            for k, n in [(19, 6), (8, 4), (3, 7), (13, 5)]]
    refs = [np.asarray(jgen.generate(jparams, jnp.asarray(p)[None], JCFG,
                                     max_new_tokens=n))[0, len(p):]
            for p, n in reqs]
    return jparams, tparams, reqs, refs


@pytest.fixture(scope="module", params=sorted(KV_MODES))
def runs(request, setup):
    """Both engines run once per KV mode; the tests below read the runs."""
    jparams, tparams, reqs, _ = setup
    kv = KV_MODES[request.param]
    jeng = JServingEngine(jparams, JCFG, attn_kernel="paged", kv_dtype=kv, **ENGINE)
    jout, jmet = jeng.run([JRequest(prompt=p, max_new_tokens=n) for p, n in reqs])
    teng = ServingEngine(tparams, TCFG, kv_dtype=kv, device="cpu", **ENGINE)
    tout, tmet = teng.run([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    return jeng, jout, jmet, teng, tout, tmet


def test_tokens_identical_to_jax_engine_and_generate(setup, runs):
    _, _, reqs, refs = setup
    _, jout, _, _, tout, _ = runs
    assert len({int(t) for ref in refs for t in ref}) > 4   # streams vary
    for j, t, ref in zip(jout, tout, refs):
        np.testing.assert_array_equal(t.generated, j.generated,
                                      err_msg=f"request {t.uid} vs JAX engine")
        np.testing.assert_array_equal(t.generated, ref,
                                      err_msg=f"request {t.uid} vs generate()")
        assert t.finish_reason == j.finish_reason == "length"


def test_pool_history_identical_and_pool_drained(runs):
    jeng, _, _, teng, _, _ = runs
    assert list(teng.pool.history) == list(jeng.pool.history)
    assert teng.pool.used_count == 0
    assert teng.sched.all_done()


def test_run_metrics_match_jax_counts(runs):
    _, _, jmet, _, tout, tmet = runs
    assert tmet["decode_steps"] == jmet["decode_steps"]
    assert tmet["prefill_chunks"] == jmet["prefill_chunks"]
    assert tmet["generated_tokens"] == jmet["generated_tokens"] == 22
    assert all(o.ttft_s >= o.queue_latency_s >= 0 for o in tout)


def test_steppable_run_equals_run(setup, runs):
    _, tparams, reqs, _ = setup
    teng, tout = runs[3], runs[4]
    eng = ServingEngine(tparams, TCFG, kv_dtype=teng.kv_dtype, device="cpu", **ENGINE)
    eng.start_run([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    with pytest.raises(RuntimeError, match="already in progress"):
        eng.start_run([])
    while not eng.sched.all_done():
        assert eng.tick_once()
    outs, _ = eng.finish_run()
    for a, b in zip(outs, tout):
        np.testing.assert_array_equal(a.generated, b.generated)


@pytest.mark.parametrize("probe, kwargs, error, match", [
    ("fp8 weights", {"weight_dtype": "fp8"}, ValueError, "weight_dtype"),
    ("chunk not a page multiple", {"prefill_chunk": 6}, ValueError, "multiple"),
    ("int4 KV", {"kv_dtype": "int4"}, ValueError, "kv_dtype"),
    ("context not a page multiple", {"max_context": 62}, ValueError, "multiple"),
])
def test_engine_probes_raise(setup, probe, kwargs, error, match):
    _, tparams, _, _ = setup
    with pytest.raises(error, match=match):
        ServingEngine(tparams, TCFG, **{**ENGINE, "device": "cpu", **kwargs})


def test_engine_refuses_the_cpu_unless_asked(setup):
    """No ``device`` means the card: without one the engine raises."""
    _, tparams, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(tparams, TCFG, **ENGINE)


def test_request_probes_raise(setup):
    _, tparams, _, _ = setup
    eng = ServingEngine(tparams, TCFG, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="sized for"):
        eng.run([Request(prompt=np.ones(60, np.int64), max_new_tokens=8)])
    with pytest.raises(NotImplementedError, match="deadline"):
        eng.run([Request(prompt=np.ones(4, np.int64), max_new_tokens=2,
                         deadline_s=1.0)])
    with pytest.raises(NotImplementedError, match="prefix caching"):
        Scheduler(2, PagePool(8, 4), 32, chunk_tokens=8, prefix_cache=object())
