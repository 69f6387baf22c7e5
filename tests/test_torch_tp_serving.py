"""Tensor-parallel serving held against the JAX package: the port's
``ServingEngine(param_specs=tp_specs(params), tp_axis="tensor")`` on gloo
ranks against the JAX ``ServingEngine(mesh=..., param_specs=tp_specs(
params), attn_kernel="paged")`` at the same tp on the fake CPU devices, and
against the port's own single-device engine.

- At tp 2 (one 2-rank spawn), in every mode: fp and int8 KV, chunked
  (``prefill_chunk=8``) and monolithic; int8 and int4 (G = 16) weights,
  chunked and monolithic; the prefix cache with a copy-on-write; speculative
  (1, 3). Every rank's greedy tokens, finish reasons, page-pool event
  history, step / prefill / chunk / cache / draft counts and
  ``memory_report()`` equal the JAX engine's (the report counts the whole
  engine's bytes over every rank, as JAX counts its global arrays), and its
  tokens and history the port's tp = 1 engine's. Exact: no run here needs
  the near-tie rule of ``chip_smoke.check_flip`` (every comparison is
  exact at tp 2 and tp 4).
- The sharding order: the int8 engine's shards equal the JAX
  ``quantize_params`` of the WHOLE tree, sliced by
  ``quantize_param_specs``, bit for bit; quantizing a row-parallel shard
  alone (``attn.out``, ``mlp.down``) gives other scales.
- Lockstep: each rank's clock runs at its own rate (rank r reads k (1 + r)
  at its k-th call) and the requests' deadline falls between the ranks'
  readings (rank 0's clock serves all four, rank 1's would shed two). The
  ranks shed the same requests (none), with rank 0's TTFTs, and finish.
- ``prefix_replay_benchmark(param_specs=...)``: its counts equal the tp = 1
  run's.
- At tp 4 (one 4-rank spawn): fp KV chunked and int4 weights (G = 16)
  chunked against the JAX tp 4 engine, exactly; the tp 2 x dp 2 context's
  two data replicas serving alike.

Tiny BLOOM (vocab 64, hidden 64, 2 layers, 4 heads), float32 weights from
``init_params_numpy`` at the wide init (std 0.3) so greedy streams vary.
The rank bodies live in ``test_torch_tp_serving_ranks.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pipegoose_tpu.distributed import ParallelContext as JaxContext
from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.quant import QuantSpec as JQuantSpec
from pipegoose_tpu.quant import quantize_param_specs as jquantize_specs
from pipegoose_tpu.quant import quantize_params as jquantize
from pipegoose_tpu.serving import Request as JRequest
from pipegoose_tpu.serving import ServingEngine as JServingEngine
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.serving import Request, ServingEngine
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_tp_serving_ranks import (
    SERVING,
    _skewed_clock,
    engine_rank,
    tp4_then_tp2dp2_rank,
)

CFG_KW = dict(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
JCFG = jbloom.BloomConfig(**CFG_KW)
TCFG = tbloom.BloomConfig(**CFG_KW, initializer_range=0.3)
MODES = {   # name -> engine options
    "fp-chunked": dict(prefill_chunk=8),
    "int8kv-chunked": dict(prefill_chunk=8, kv_dtype="int8"),
    "fp-monolithic": dict(prefill_chunk=None),
    "int8kv-monolithic": dict(kv_dtype="int8"),
    "int8w-chunked": dict(prefill_chunk=8, weight_dtype="int8"),
    "int4w-chunked": dict(prefill_chunk=8, weight_dtype="int4", weight_group_size=16),
    "int8w-monolithic": dict(weight_dtype="int8"),
    "cache-cow": dict(prefill_chunk=8, prefix_cache=True),
    "spec-1-3": dict(prefill_chunk=8, speculative=(1, 3)),
}
TP4_MODES = ("fp-chunked", "int4w-chunked")
CLOCK_DEADLINE = 24.0       # between the skewed clocks' readings (asserted below)
CLOCK_ENGINE = dict(num_slots=1, prefill_chunk=8)
REPLAY = dict(n_requests=5, n_prefixes=2, prefix_len=9, suffix_lens=(2, 3), max_new=3,
              num_slots=2, num_pages=32, page_size=4, max_context=32,
              arms={"cached+chunked": {"prefix_cache": True, "prefill_chunk": 4}})


def _data():
    np_tree = tbloom.init_params_numpy(TCFG, seed=0)
    rng = np.random.default_rng(7)
    # mixed lengths: multi-chunk, exactly one chunk, sub-page, mid-page
    plain = [(rng.integers(1, 64, (k,)), n, {}) for k, n in [(19, 6), (8, 4), (3, 7), (13, 5)]]
    rs = np.random.RandomState(7)
    shared = rs.randint(1, 64, (13,))          # 3 full pages + 1 tail at ps = 4
    cached = [(np.concatenate([shared, rs.randint(1, 64, (k,))]), n, {})
              for k, n in [(3, 6), (5, 4), (2, 7)]] + [
        (shared[:10], 5, {}),                  # a strict prefix: COW mid-page
        (rs.randint(1, 64, (7,)), 6, {})]      # unrelated: a pure miss
    rc = np.random.default_rng(3)
    clocked = [(rc.integers(1, 64, (k,)), 3, {"deadline_s": CLOCK_DEADLINE})
               for k in (6, 9, 5, 7)]
    return np_tree, plain, cached, clocked


def _requests(name, plain, cached):
    return cached if name == "cache-cow" else plain


def _jax_run(jparams, mesh, kw, reqs):
    eng = JServingEngine(jparams, JCFG, attn_kernel="paged", mesh=mesh,
                         param_specs=jbloom.tp_specs(jparams), **{**SERVING, **kw})
    outs, metrics = eng.run([JRequest(prompt=p, max_new_tokens=n) for p, n, _ in reqs])
    return eng, outs, metrics


def _tp1_run(tparams, kw, reqs, **run_kw):
    eng = ServingEngine(tparams, TCFG, device="cpu", **{**SERVING, **kw})
    outs, metrics = eng.run([Request(prompt=p, max_new_tokens=n, **rkw)
                             for p, n, rkw in reqs], **run_kw)
    return eng, outs, metrics


COUNTS = ("generated_tokens", "decode_steps", "prefills", "prefill_tokens",
          "shed_requests", "prefill_chunks")


def _check_mode(name, rank, got, jax_run, tp1_run):
    """One mode on one rank against the JAX engine and the tp = 1 engine."""
    jeng, jout, jmet = jax_run
    teng, tout, _ = tp1_run
    where = f"{name}, rank {rank}"
    assert len(got["tokens"]) == len(jout), where
    for i, (g, j, t) in enumerate(zip(got["tokens"], jout, tout)):
        np.testing.assert_array_equal(g, j.generated, err_msg=f"{where}: request {i} vs JAX")
        np.testing.assert_array_equal(g, t.generated, err_msg=f"{where}: request {i} vs tp 1")
    assert got["finish"] == [o.finish_reason for o in jout], where
    history = [tuple(e) for e in got["history"]]
    assert history == [(e, tuple(p), d) for e, p, d in jeng.pool.history], where
    assert history == list(teng.pool.history), where
    for key in COUNTS:
        assert got["metrics"].get(key) == jmet.get(key), (where, key)
    for block in ("prefix_cache", "speculative"):
        if block in jmet:
            for key, want in jmet[block].items():
                assert got["metrics"][block][key] == want, (where, block, key)
    want = jeng.memory_report()
    for key in ("weight_dtype", "kv_dtype", "weights", "kv"):
        assert got["memory"][key] == want[key], (where, key)
    assert got["drained"], where


@pytest.fixture(scope="module")
def data():
    return _data()


def test_tp2_engine_matches_the_jax_tp2_engine_in_every_mode(devices, data):
    """The acceptance test at tp 2, the sharding order, lockstep clocks and
    the replay benchmark, in one 2-rank spawn."""
    np_tree, plain, cached, clocked = data
    cases = [(name, kw, _requests(name, plain, cached)) for name, kw in MODES.items()]
    order = dict(weight_dtype="int8")
    ranks = run_ranks(engine_rank, 2, 2, CFG_KW | {"initializer_range": 0.3}, np_tree,
                      cases, (clocked, 1.0, CLOCK_ENGINE), order, REPLAY, timeout=300)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tparams = params_from_jax(np_tree, TCFG, device="cpu")
    ctx = JaxContext(tensor_parallel_size=2, data_parallel_size=4)
    try:
        for name, kw, reqs in cases:
            jax_run = _jax_run(jparams, ctx.mesh, kw, reqs)
            tp1_run = _tp1_run(tparams, kw, reqs)
            for rank, got in enumerate(ranks):
                _check_mode(name, rank, got[name], jax_run, tp1_run)
        # the streams vary (anti-false-positive)
        assert len({int(t) for o in ranks[0]["fp-chunked"]["tokens"] for t in o}) > 4
    finally:
        ctx.destroy()
    _check_order(ranks, np_tree, order)
    _check_clock(ranks, tparams, clocked)
    _check_replay(ranks, tparams)


def _check_order(ranks, np_tree, order):
    """Each rank's quantized leaves equal rank r's slice of the JAX whole-tree
    quantization (the JAX ``quantize_param_specs`` says which dims); a
    row-parallel shard quantized alone has other scales, a column shard the
    same ones."""
    spec = JQuantSpec(order["weight_dtype"])
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    whole = jquantize(jparams, spec)
    jspecs = jquantize_specs(jbloom.tp_specs(jparams), jparams, spec)
    tp = len(ranks)
    for rank, got in enumerate(ranks):
        for name, (held, per_shard) in got["order"].items():
            grp = "attn" if name in ("qkv", "out") else "mlp"
            for key in ("q", "scale"):
                arr = np.asarray(whole["blocks"][grp][name][key])[0]
                entries = tuple(jspecs["blocks"][grp][name][key])[1:]
                for dim, entry in enumerate(entries):
                    if entry == "tensor":
                        n = arr.shape[dim] // tp
                        arr = np.take(arr, np.arange(rank * n, (rank + 1) * n), axis=dim)
                np.testing.assert_array_equal(held[key], arr, err_msg=f"{name}.{key} r{rank}")
            same = np.array_equal(held["scale"], per_shard["scale"])
            assert same == (name == "qkv"), (name, rank, "per-shard scales")


def _check_clock(ranks, tparams, clocked):
    """Every rank ran on rank 0's clock: the finish reasons and TTFTs of a
    single engine reading rank 0's clock, while rank 1's clock alone would
    have shed two requests."""
    _, want, _ = _tp1_run(tparams, CLOCK_ENGINE, clocked, now=_skewed_clock(0, 1.0))
    _, other, _ = _tp1_run(tparams, CLOCK_ENGINE, clocked, now=_skewed_clock(1, 1.0))
    reasons = [o.finish_reason for o in want]
    assert reasons != [o.finish_reason for o in other], "the deadline must split the clocks"
    assert reasons == ["length"] * 4
    for rank, got in enumerate(ranks):
        run = got["clock"]
        assert run["finish"] == reasons, rank
        assert run["ttft"] == [o.ttft_s for o in want], rank
        for g, w in zip(run["tokens"], want):
            np.testing.assert_array_equal(g, w.generated)
        assert run["drained"], rank


def _check_replay(ranks, tparams):
    from pipegoose_tpu_torch.serving.engine import prefix_replay_benchmark

    rows = prefix_replay_benchmark(tparams, TCFG, device="cpu", **REPLAY)
    want = {arm: {k: v for k, v in row.items() if not k.endswith("_s")}
            for arm, row in rows.items()}
    assert want["cached+chunked"]["hit_rate"] > 0
    for got in ranks:
        assert got["replay"] == want


def test_tp4_engine_matches_the_jax_tp4_engine(devices, data):
    """fp KV chunked and int4 weights at tp 4 in one 4-rank spawn, which
    also serves fp KV chunked on a tp 2 x dp 2 context (two data
    replicas, each its own tp 2 engine)."""
    np_tree, plain, cached, _ = data
    cases = [(name, MODES[name], plain) for name in TP4_MODES]
    ranks = run_ranks(tp4_then_tp2dp2_rank, 4, CFG_KW | {"initializer_range": 0.3}, np_tree,
                      cases, timeout=300)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tparams = params_from_jax(np_tree, TCFG, device="cpu")
    runs = {}
    for tp in (4, 2):
        ctx = JaxContext(tensor_parallel_size=tp, data_parallel_size=8 // tp)
        try:
            for name, kw, reqs in (cases if tp == 4 else cases[:1]):
                runs[tp, name] = (_jax_run(jparams, ctx.mesh, kw, reqs),
                                  _tp1_run(tparams, kw, reqs))
        finally:
            ctx.destroy()
    for rank, (tp4, tp2) in enumerate(ranks):
        for name, _, _ in cases:
            _check_mode(name, rank, tp4[name], *runs[4, name])
        _check_mode("fp-chunked (tp 2 x dp 2)", rank, tp2["fp-chunked"],
                    *runs[2, "fp-chunked"])


def test_int4_group_that_does_not_divide_a_shard_raises_as_in_jax(devices, data):
    """At tp 2 the row-parallel shards contract over 32 (attn.out) and 128
    (mlp.down) rows: a group of 64 divides the whole kernels but not the
    shard, and both engines refuse it at construction."""
    from pipegoose_tpu.quant.weights import validate_tp_compat as jvalidate
    from pipegoose_tpu_torch.quant.weights import QuantSpec, validate_tp_compat

    with pytest.raises(ValueError, match="per-shard contraction") as want:
        jvalidate(JCFG, 2, JQuantSpec("int4", 64))
    with pytest.raises(ValueError, match="per-shard contraction") as got:
        validate_tp_compat(TCFG, 2, QuantSpec("int4", 64))
    assert str(got.value) == str(want.value)
    np_tree = data[0]
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    ctx = JaxContext(tensor_parallel_size=2, data_parallel_size=4)
    try:
        with pytest.raises(ValueError, match="per-shard contraction"):
            _jax_run(jparams, ctx.mesh, dict(weight_dtype="int4", weight_group_size=64), [])
    finally:
        ctx.destroy()
