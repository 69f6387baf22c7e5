"""Self-speculative decoding held against the JAX package: the draft and
verification forwards (``paged_decode_step(write_ok=, draft_layers=)``,
``paged_prefill_chunk(all_logits=True)``) and the engine with
``speculative=(k, n)``.

The config is the width-64 one of ``test_torch_engine.py`` with 4 layers
instead of 2, so that a draft of 2 layers is still a shallow exit. Its
init (std 0.2) makes the greedy streams vary and the shallow exit agree
with the full model part of the time (acceptance 0.25-0.45), so both the
accepted and the rejected branches run. Logits agree to 1e-5 in float32
(the forward tests use std 0.02 weights, whose logits are small); tokens,
pool histories and the drafted / accepted counts are identical. The JAX
engine runs ``attn_kernel="paged"``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.serving import Request as JRequest
from pipegoose_tpu.serving import ServingEngine as JServingEngine
from pipegoose_tpu.serving import kv_pool as jkv
from pipegoose_tpu.telemetry import MetricsRegistry
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.serving import Request, ServingEngine
from pipegoose_tpu_torch.serving import kv_pool as tkv

JCFG = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=4, n_head=4)
TCFG = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=4, n_head=4,
                          initializer_range=0.2)
LOGIT_ATOL = 1e-5
ENGINE = dict(num_slots=3, num_pages=64, page_size=4, max_context=64)


def _params(cfg, seed):
    np_tree = tbloom.init_params_numpy(cfg, seed=seed)
    return (jax.tree_util.tree_map(jnp.asarray, np_tree),
            params_from_jax(np_tree, cfg, device="cpu"))


@pytest.fixture(scope="module")
def setup():
    jparams, tparams = _params(TCFG, seed=1)
    rng = np.random.RandomState(5)
    reqs = [(rng.randint(1, 64, (s,)), n)
            for s, n in [(5, 10), (9, 8), (3, 12), (12, 3), (6, 1)]]
    return jparams, tparams, reqs


def _run_both(setup, reqs, eos=None, **kw):
    jparams, tparams, _ = setup
    reg = MetricsRegistry(enabled=True)
    jeng = JServingEngine(jparams, JCFG, attn_kernel="paged", registry=reg, **kw)
    teng = ServingEngine(tparams, TCFG, device="cpu", **kw)
    runs = []
    for _ in range(2 if kw.get("prefix_cache") else 1):    # cold, then warm
        jout, jmet = jeng.run([JRequest(prompt=p, max_new_tokens=n, eos_token_id=eos)
                               for p, n in reqs])
        tout, tmet = teng.run([Request(prompt=p, max_new_tokens=n, eos_token_id=eos)
                               for p, n in reqs])
        for j, t in zip(jout, tout):
            np.testing.assert_array_equal(t.generated, j.generated,
                                          err_msg=f"request {t.uid} vs the JAX engine")
            assert t.finish_reason == j.finish_reason
        assert list(teng.pool.history) == list(jeng.pool.history)
        runs.append((jout, jmet, tout, tmet))
    return reg, teng, runs


# -- the forwards --------------------------------------------------------------


def _pools_equal(tpages, jpages):
    """Every page but the NULL page (which absorbs held-back writes in an
    order neither framework fixes): fp values to 1e-6, int8 codes exactly."""
    if isinstance(jpages, dict):
        np.testing.assert_array_equal(tpages["q"][:, 1:].numpy(),
                                      np.asarray(jpages["q"])[:, 1:])
        np.testing.assert_allclose(tpages["scale"][:, 1:].numpy(),
                                   np.asarray(jpages["scale"])[:, 1:], rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(tpages[:, 1:].numpy(), np.asarray(jpages)[:, 1:],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
def test_draft_steps_and_verification_match_jax(kv_dtype):
    """A prefilled pool, then n = 3 draft steps of k = 2 layers with the
    write held back on some rows (a row bound to g = 1 and an idle row at
    g = 0, whose position runs past its table), then the verification
    over C = n + 1 tokens from per-row starts with all-position logits:
    the logits of every step to 1e-5, the pools after each."""
    cfg_j = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=4, n_head=4)
    cfg_t = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=4, n_head=4)
    jparams, tparams = _params(cfg_t, seed=2)
    rng = np.random.default_rng(0)
    table = np.array([[3, 7, 1, 0], [2, 5, 9, 11], [0, 0, 0, 0]], np.int32)
    jk, jv = jkv.init_pages(cfg_j, 12, 4, kv_dtype=kv_dtype)
    tk, tv = tkv.init_pages(cfg_t, 12, 4, kv_dtype=kv_dtype, device="cpu")
    prompt = rng.integers(0, 64, (3, 8)).astype(np.int32)
    n_valid = np.array([6, 8, 1], np.int32)
    zero = np.zeros(3, np.int32)
    J, T = jnp.asarray, torch.from_numpy
    _, jk, jv = jkv.paged_prefill_chunk(jparams, J(prompt), jk, jv, J(table), J(zero),
                                        J(n_valid), cfg_j, attn_impl="paged")
    tkv.paged_prefill_chunk(tparams, T(prompt), tk, tv, T(table), T(zero),
                            T(n_valid), cfg_t)
    seq = np.array([6, 8, 15], np.int32)
    g = np.array([3, 1, 0], np.int32)
    tok = rng.integers(0, 64, (3,)).astype(np.int32)
    bundle = [tok]
    for j in range(3):
        ok = g > j
        jlog, jk, jv = jkv.paged_decode_step(
            jparams, J(bundle[-1]), jk, jv, J(table), J(seq + j), cfg_j,
            write_ok=J(ok), draft_layers=2, attn_impl="paged")
        tlog = tkv.paged_decode_step(
            tparams, T(bundle[-1]), tk, tv, T(table), T(seq + j), cfg_t,
            write_ok=T(ok), draft_layers=2)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=LOGIT_ATOL)
        for t, jp in ((tk, jk), (tv, jv)):
            _pools_equal(t, jp)
        bundle.append(np.asarray(jlog).argmax(-1).astype(np.int32))
    ids = np.stack(bundle, axis=1)
    jlog, jk, jv = jkv.paged_prefill_chunk(
        jparams, J(ids), jk, jv, J(table), J(seq), J(g + 1), cfg_j,
        all_logits=True, attn_impl="paged")
    tlog = tkv.paged_prefill_chunk(tparams, T(ids), tk, tv, T(table), T(seq),
                                   T(g + 1), cfg_t, all_logits=True)
    assert tuple(tlog.shape) == (3, 4, 64) and tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=LOGIT_ATOL)
    for t, jp in ((tk, jk), (tv, jv)):
        _pools_equal(t, jp)


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("spec", [(1, 3), (1, 4), (2, 2)], ids=["k1n3", "k1n4", "k2n2"])
def test_speculative_engine_matches_jax(setup, spec):
    """Mixed lengths, a max_new = 1 request that never speculates and a
    near-end request whose bundle is clamped: tokens and pool histories
    identical; drafted, accepted and cycle counts equal to JAX's."""
    _, _, reqs = setup
    reg, teng, [(_, jmet, _, tmet)] = _run_both(setup, reqs, speculative=spec, **ENGINE)
    js, ts = jmet["speculative"], dict(tmet["speculative"])
    assert ts.pop("cycles") == reg.snapshot()["counters"]["serving.spec.cycles"]
    emitted = ts.pop("tokens")
    assert ts == js
    # a cycle emits each slot's accepted drafts plus one token, or stops at the end
    assert ts["accepted_tokens"] < emitted <= tmet["generated_tokens"] - len(reqs)
    assert 0 < ts["accepted_tokens"] < ts["draft_tokens"]
    assert tmet["decode_steps"] == jmet["decode_steps"]
    assert tmet["generated_tokens"] == sum(n for _, n in reqs)
    assert teng.pool.used_count == 0


def test_speculative_eos_mid_bundle(setup):
    """EOS inside a verified bundle stops the request where JAX stops it:
    later bundle tokens are dropped, the slot and pages free at once."""
    jparams, tparams, reqs = setup
    p = reqs[0][0]
    eng = ServingEngine(tparams, TCFG, device="cpu", **ENGINE)
    (plain,), _ = eng.run([Request(prompt=p, max_new_tokens=8)])
    eos = int(plain.generated[2])
    _, teng, [(_, _, tout, tmet)] = _run_both(setup, [(p, 8)], eos=eos,
                                               speculative=(1, 4), **ENGINE)
    assert tout[0].finish_reason == "eos"
    assert list(tout[0].generated) == list(plain.generated[:list(plain.generated).index(eos) + 1])
    assert tmet["speculative"]["cycles"] >= 1
    assert teng.pool.used_count == 0


def test_speculative_with_cache_and_chunking(setup):
    """Prefix cache + chunked prefill + speculation, cold and warm: tokens,
    histories, the cache block and the speculative counts equal JAX's."""
    rng = np.random.RandomState(9)
    shared = rng.randint(1, 64, (11,))
    reqs = [(shared, 6), (np.concatenate([shared, rng.randint(1, 64, (4,))]), 8),
            (shared[:9], 5)]
    _, teng, runs = _run_both(setup, reqs, num_slots=2, num_pages=32, page_size=4,
                              max_context=48, prefix_cache=True, prefill_chunk=8,
                              speculative=(2, 2))
    for _, jmet, _, tmet in runs:
        tblock = dict(tmet["prefix_cache"])
        tblock.pop("cow_copies")
        assert tblock == jmet["prefix_cache"]
        ts = dict(tmet["speculative"])
        ts.pop("cycles"), ts.pop("tokens")
        assert ts == jmet["speculative"]
    assert teng.pool.used_count == teng.prefix_cache.cached_pages


@pytest.mark.parametrize("spec, match", [((4, 2), "draft depth"), ((0, 2), "draft depth"),
                                         ((1, 0), "draft length")])
def test_speculative_validates_config(setup, spec, match):
    """k must lie in [1, n_layer) and n be >= 1, with JAX's messages."""
    jparams, tparams, _ = setup
    with pytest.raises(ValueError, match=match) as jerr:
        JServingEngine(jparams, JCFG, speculative=spec)
    with pytest.raises(ValueError, match=match) as terr:
        ServingEngine(tparams, TCFG, speculative=spec, device="cpu")
    assert str(terr.value) == str(jerr.value)
