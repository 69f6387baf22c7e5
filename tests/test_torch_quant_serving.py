"""Quantized serving held against the JAX package: the port's ServingEngine
and the JAX ServingEngine(attn_kernel="paged") with the same knobs (int8
weights, grouped int4 weights, int8 KV, int8 weights + int8 KV), each with
chunked (prefill_chunk=8) and monolithic (prefill_chunk=None) prefill,
give identical greedy tokens, decode-step and prefill counts, and
memory reports; the port's contiguous-cache ``generate()`` gives JAX
``generate()``'s tokens (ragged left-padded batch, eos, quantized
params); the quantized forward keeps the perplexity contract of
tests/serving/test_quantized.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.models import generate as jgen
from pipegoose_tpu.quant import QuantSpec as JQuantSpec
from pipegoose_tpu.quant import quantize_params as jquantize
from pipegoose_tpu.serving import Request as JRequest
from pipegoose_tpu.serving import ServingEngine as JServingEngine
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models import generate as tgen
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.quant import QuantSpec, quantize_params
from pipegoose_tpu_torch.serving import Request, ServingEngine
from pipegoose_tpu_torch.serving.kv_pool import init_pages, write_prompt_pages

JCFG = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
TCFG = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4,
                          initializer_range=0.3)
ENGINE = dict(num_slots=2, num_pages=32, page_size=4, max_context=64)
QUANT_MODES = {
    "int8w": dict(weight_dtype="int8"),
    "int4w": dict(weight_dtype="int4", weight_group_size=16),
    "int8kv": dict(kv_dtype="int8"),
    "int8w+int8kv": dict(weight_dtype="int8", kv_dtype="int8"),
}
PREFILL = {"chunked": 8, "monolithic": None}


@pytest.fixture(scope="module")
def setup():
    np_tree = tbloom.init_params_numpy(TCFG, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tparams = params_from_jax(np_tree, TCFG, device="cpu")
    rng = np.random.default_rng(7)
    # mixed lengths: multi-chunk, exactly one chunk, sub-page, mid-page
    reqs = [(rng.integers(1, 64, (k,)), n)
            for k, n in [(19, 6), (8, 4), (3, 7), (13, 5)]]
    return jparams, tparams, reqs


@pytest.fixture(scope="module",
                params=[(m, p) for m in sorted(QUANT_MODES) for p in sorted(PREFILL)],
                ids=lambda mp: f"{mp[0]}-{mp[1]}")
def runs(request, setup):
    """Both engines run once per (mode, prefill); the tests read the runs."""
    jparams, tparams, reqs = setup
    mode, prefill = request.param
    kw = dict(ENGINE, prefill_chunk=PREFILL[prefill], **QUANT_MODES[mode])
    jeng = JServingEngine(jparams, JCFG, attn_kernel="paged", **kw)
    jout, jmet = jeng.run([JRequest(prompt=p, max_new_tokens=n) for p, n in reqs])
    teng = ServingEngine(tparams, TCFG, device="cpu", **kw)
    tout, tmet = teng.run([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    return jeng, jout, jmet, teng, tout, tmet, prefill


def test_tokens_identical_to_jax_engine(runs):
    _, jout, _, _, tout, _, _ = runs
    assert len({int(t) for o in tout for t in o.generated}) > 4   # streams vary
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.generated, j.generated,
                                      err_msg=f"request {t.uid} vs JAX engine")
        assert t.finish_reason == j.finish_reason == "length"


def test_step_and_prefill_counts_identical(runs):
    """Both engines report ``prefill_chunks`` only with chunked prefill: a
    monolithic prefill counts in ``prefills`` alone."""
    _, _, jmet, teng, _, tmet, prefill = runs
    assert tmet["decode_steps"] == jmet["decode_steps"]
    assert tmet["prefills"] == jmet["prefills"] == 4
    assert ("prefill_chunks" in tmet) == ("prefill_chunks" in jmet) == (prefill == "chunked")
    assert tmet.get("prefill_chunks") == jmet.get("prefill_chunks")
    assert tmet["generated_tokens"] == jmet["generated_tokens"] == 22
    assert list(teng.pool.history) == list(runs[0].pool.history)
    assert teng.pool.used_count == 0 and teng.sched.all_done()


def test_memory_report_equals_jax(runs):
    jeng, _, _, teng, _, _, _ = runs
    want, got = jeng.memory_report(), teng.memory_report()
    for key in ("weight_dtype", "kv_dtype", "weights", "kv"):
        assert got[key] == want[key], key


def test_quantized_engine_holds_quantized_leaves(runs):
    _, _, _, teng, _, _, _ = runs
    leaf = teng.params["blocks"][0]["mlp"]["up"]
    if teng.weight_dtype is None:
        assert "kernel" in leaf
        return
    assert set(leaf) == {"q", "scale", "bias"} and leaf["q"].dtype == torch.int8
    assert teng.memory_report()["weights"]["bytes_by_dtype"]["int8"] > 0


@pytest.mark.parametrize("spec", [("int8", 32), ("int4", 16), None],
                         ids=["int8", "int4", "fp"])
def test_generate_equals_jax_generate(setup, spec):
    jparams, tparams, reqs = setup
    if spec is not None:
        jparams = jquantize(jparams, JQuantSpec(*spec))
        tparams = quantize_params(tparams, QuantSpec(*spec))
    for prompt, n in reqs:
        want = np.asarray(jgen.generate(jparams, jnp.asarray(prompt)[None], JCFG,
                                        max_new_tokens=n))
        got = tgen.generate(tparams, prompt[None], TCFG, n, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_engine_tokens_equal_generate_on_the_same_quantized_params(setup):
    """The JAX quantization tests' oracle: per-request generate() on the
    engine's own quantized params."""
    _, tparams, reqs = setup
    for prefill in PREFILL.values():
        eng = ServingEngine(tparams, TCFG, device="cpu", prefill_chunk=prefill,
                            weight_dtype="int4", weight_group_size=16, **ENGINE)
        outs, _ = eng.run([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
        for o, (p, n) in zip(outs, reqs):
            ref = tgen.generate(eng.params, p[None], TCFG, n, device="cpu")
            np.testing.assert_array_equal(o.generated, ref[0, len(p):].numpy())


def test_ragged_left_padded_batch_and_eos_equal_jax(setup):
    jparams, tparams, reqs = setup
    lens = [len(p) for p, _ in reqs]
    s = max(lens)
    ids = np.zeros((len(reqs), s), np.int64)
    mask = np.zeros((len(reqs), s), np.int64)
    for i, (p, _) in enumerate(reqs):
        ids[i, s - len(p):] = p
        mask[i, s - len(p):] = 1
    plain = np.asarray(jgen.generate(jparams, jnp.asarray(ids), JCFG, max_new_tokens=6,
                                     attention_mask=jnp.asarray(mask)))
    eos = int(plain[0, s + 1])            # row 0 stops after its second token
    for eos_id in (None, eos):
        want = np.asarray(jgen.generate(jparams, jnp.asarray(ids), JCFG,
                                        max_new_tokens=6, eos_token_id=eos_id,
                                        attention_mask=jnp.asarray(mask)))
        got = tgen.generate(tparams, ids, TCFG, 6, eos_token_id=eos_id,
                            attention_mask=mask, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0, s + 1:] == eos).all()


def test_right_padded_mask_raises(setup):
    _, tparams, _ = setup
    ids = np.ones((2, 5), np.int64)
    mask = np.ones((2, 5), np.int64)
    mask[1, -2:] = 0
    with pytest.raises(ValueError, match="LEFT-padded"):
        tgen.generate(tparams, ids, TCFG, 3, attention_mask=mask, device="cpu")
    with pytest.raises(ValueError, match="LEFT-padded"):
        tgen.generate(tparams, ids, TCFG, 3, temperature=0.7, attention_mask=mask,
                      device="cpu")


def test_write_prompt_pages_equals_jax(setup):
    """The monolithic prefill's scatter, fp and int8 pools: pages from 1 on
    (page 0, the NULL page, takes every pad write in an unspecified
    order)."""
    from pipegoose_tpu.serving import kv_pool as jpool

    jparams, tparams, _ = setup
    rng = np.random.default_rng(11)
    prompt, pad, ps, n_pages = rng.integers(1, 64, (10,)), 2, 4, 8
    ids = np.concatenate([np.zeros(pad, np.int64), prompt])[None]
    mask = (np.arange(12) >= pad).astype(np.int64)[None]
    phys = np.zeros(6, np.int32)
    phys[:3] = [5, 2, 7]
    jcache = jgen.init_cache(JCFG, 1, 12)
    _, jcache = jgen.forward_cached(jparams, jnp.asarray(ids), jcache, 0, JCFG,
                                    extras={"mask": jnp.asarray(mask)})
    tcache = tgen.init_cache(TCFG, 1, 12, device="cpu")
    _, tcache = tgen.forward_cached(tparams, torch.from_numpy(ids), tcache, 0, TCFG,
                                    extras={"mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-5, atol=1e-5)
    for kv in (None, "int8"):
        jk, jv = jpool.init_pages(JCFG, n_pages, ps, kv_dtype=kv)
        jk, jv = jpool.write_prompt_pages(jk, jv, jcache, jnp.asarray(phys), pad, ps)
        tk, tv = init_pages(TCFG, n_pages, ps, kv_dtype=kv, device="cpu")
        write_prompt_pages(tk, tv, tcache, torch.from_numpy(phys), pad, ps)
        for got, want in ((tk, jk), (tv, jv)):
            for name in (("q", "scale") if kv else (None,)):
                g = got[name] if name else got
                w = want[name] if name else want
                np.testing.assert_allclose(g[:, 1:].float().numpy(),
                                           np.asarray(w[:, 1:], np.float32),
                                           rtol=1e-5, atol=1e-5 if name != "q" else 1)


def test_fp_alias_passes_params_through_by_object(setup):
    _, tparams, _ = setup
    for alias in (None, "fp"):
        eng = ServingEngine(tparams, TCFG, device="cpu", weight_dtype=alias,
                            kv_dtype=alias, prefill_chunk=8, **ENGINE)
        assert eng.params is tparams
        assert eng.weight_dtype is None and eng.kv_dtype is None
        assert eng.memory_report()["weight_dtype"] == "fp"


@pytest.mark.parametrize("kwargs, match", [
    ({"weight_dtype": "fp8"}, "weight_dtype"),
    ({"weight_dtype": "int4", "weight_group_size": 24}, "must divide"),
    ({"weight_dtype": "int4", "weight_group_size": 5}, "group_size"),
])
def test_quant_knob_probes_raise(setup, kwargs, match):
    _, tparams, _ = setup
    with pytest.raises(ValueError, match=match):
        ServingEngine(tparams, TCFG, device="cpu", prefill_chunk=8, **ENGINE, **kwargs)


def test_perplexity_delta_within_contract():
    """The contract of tests/serving/test_quantized.py, on the port's own
    forward (the quantized matmul's plain version on the CPU): perplexity
    moves by < 1% at int8 and < 5% at grouped int4."""
    cfg = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
    params = params_from_jax(tbloom.init_params_numpy(cfg, seed=0), cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(3).integers(1, 64, (2, 24)))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        base = tbloom.loss_fn(params, ids, mask, ids, cfg).item()
        for spec, bound in ((QuantSpec("int8"), 0.01), (QuantSpec("int4", 16), 0.05)):
            qp = quantize_params(params, spec)
            delta = abs(np.exp(tbloom.loss_fn(qp, ids, mask, ids, cfg).item() - base) - 1.0)
            assert delta < bound, f"{spec.weight_dtype} ppl moved {delta:.4f}"
            assert delta > 0.0          # the quantized forward did run
