"""Tensor-parallel decoding held against the JAX package on the CPU.

- ``models.generate.generate_tp`` on gloo ranks at tp 2 (a 2-rank spawn)
  and at tp 4 and tp 2 x dp 2 (one 4-rank spawn), every rank given the
  WHOLE tree: its ids equal, exactly, the JAX ``generate_tp``'s on a mesh of
  the same tp and the JAX single-device ``generate``'s, for plain prompts,
  with ``eos_token_id``, with a vocabulary of 62 padded for tp (no padded id
  is ever emitted) and with ragged left-padded prompts
  (``tests/models/test_generate_tp.py``'s four cases).
- ``models._decode.global_greedy_pick`` on every rank's vocab shard equal,
  exactly, to the JAX function under ``shard_map`` on the same rows: random
  rows, ties across shards (the lowest global id wins) and within one, and
  a padded column holding the row's largest value, never picked.
- ``quant.quantize_param_specs`` equal to the JAX function, int8 and int4,
  on the JAX numpy tree and (per layer) on the port's tree.
- ``write_prompt_pages`` and ``copy_page`` on head-sharded banks (fp and
  int8): every rank's banks equal the same heads of the whole banks, bit for
  bit.
- The errors: heads that do not divide tp (``generate_tp``, ``init_cache``,
  ``init_pages``, the engine), and an int4 group that does not divide a
  row-parallel shard, raise ValueError as the JAX package does.

Tiny BLOOM (vocab 64, hidden 64, 2 layers, 4 heads), float32 weights from
``init_params_numpy`` at the wide init (std 0.3) so greedy streams vary.
The rank bodies live in ``test_torch_tp_serving_ranks.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pipegoose_tpu.distributed import ParallelContext as JaxContext
from pipegoose_tpu.distributed.compat import shard_map
from pipegoose_tpu.models import _decode as jdecode
from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.models import generate as jgen
from pipegoose_tpu.quant import QuantSpec as JQuantSpec
from pipegoose_tpu.quant import quantize_param_specs as jquantize_specs
from pipegoose_tpu.serving import ServingEngine as JServingEngine
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.quant import QuantSpec, quantize_param_specs
from pipegoose_tpu_torch.serving import kv_pool as tkv
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_tp_serving_ranks import generate_rank, generate_tp4_then_tp2dp2_rank

CFG_KW = dict(vocab_size=64, hidden_size=64, n_layer=2, n_head=4, initializer_range=0.3)
PAD_KW = dict(CFG_KW, vocab_size=62)
PROBE_KW = dict(vocab_size=64, hidden_size=48, n_layer=2, n_head=6)   # 6 heads: not / 4
INT4_GROUP_TOO_WIDE = 32    # attn.out's shard contracts over 64 / 4 = 16 rows at tp 4


def _jcfg(kw):
    return jbloom.BloomConfig(**{k: v for k, v in kw.items() if k != "initializer_range"})


def _cases():
    """(name, port config kw, numpy tree, ids, max_new, generate kw), and the
    JAX config of each."""
    tree = tbloom.init_params_numpy(tbloom.BloomConfig(**CFG_KW), seed=0)
    ids = np.random.RandomState(11).randint(1, 64, (2, 6))
    first = np.asarray(jgen.generate(jax.tree_util.tree_map(jnp.asarray, tree),
                                     jnp.asarray(ids), _jcfg(CFG_KW), max_new_tokens=4))
    eos = int(first[0, ids.shape[1]])
    # the vocabulary of 62 padded for tp 4 (64 slots: 62 and 63 are padding)
    pcfg = tbloom.BloomConfig(**PAD_KW)
    ptree, pcfg = tbloom.pad_for_tp(tbloom.init_params_numpy(pcfg, seed=2), pcfg, tp=4)
    pad_kw = dict(CFG_KW, vocab_size=pcfg.vocab_size, valid_vocab_size=pcfg.valid_vocab_size)
    pids = np.random.RandomState(3).randint(1, 62, (2, 5))
    rng = np.random.RandomState(13)
    rids = rng.randint(1, 64, (2, 6))
    mask = np.ones((2, 6), np.int64)
    rids[1, :3] = 0
    mask[1, :3] = 0
    return [("plain", CFG_KW, tree, ids, 8, {}),
            ("eos", CFG_KW, tree, ids, 6, {"eos_token_id": eos}),
            ("padded-vocab", pad_kw, ptree, pids, 8, {}),
            ("ragged", CFG_KW, tree, rids, 7, {"attention_mask": mask})]


def _picks():
    """(name, logits (B, 64), valid_size) rows for global_greedy_pick."""
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((5, 64)).astype(np.float32)
    tie = rng.standard_normal((4, 64)).astype(np.float32)
    tie[0, [3, 40]] = 9.0          # across shards (tp 2 and tp 4): 3 wins
    tie[1, [17, 50]] = 9.0         # shards 1 and 3 at tp 4, 0 and 1 at tp 2: 17 wins
    tie[2, [20, 21]] = 9.0         # within one shard: 20 wins
    tie[3, [31, 32]] = 9.0         # the last slot of one shard, the first of the next
    padded = rng.standard_normal((3, 64)).astype(np.float32)
    padded[:, 62] = 50.0           # padding, never picked
    padded[1, 63] = 60.0
    return [("random", rows, None), ("ties", tie, None), ("padded", padded, 60)]


@pytest.fixture(scope="module")
def cases():
    return _cases()


def _jax_generate(cases, tp):
    """Each case's ids from the JAX ``generate_tp`` at ``tp`` and from the
    JAX single-device ``generate``."""
    out = []
    ctx = JaxContext(tensor_parallel_size=tp, data_parallel_size=8 // tp)
    try:
        for _, cfg_kw, tree, ids, max_new, kw in cases:
            cfg = _jcfg(cfg_kw)
            params = jax.tree_util.tree_map(jnp.asarray, tree)
            jkw = {k: jnp.asarray(v) if k == "attention_mask" else v for k, v in kw.items()}
            sharded = jgen.generate_tp(params, jnp.asarray(ids), cfg, max_new, ctx.mesh,
                                       jbloom.tp_specs(params), **jkw)
            single = jgen.generate(params, jnp.asarray(ids), cfg, max_new_tokens=max_new,
                                   **jkw)
            out.append((np.asarray(sharded), np.asarray(single)))
    finally:
        ctx.destroy()
    return out


def _jax_picks(tp):
    ctx = JaxContext(tensor_parallel_size=tp, data_parallel_size=8 // tp)
    try:
        out = []
        for _, logits, valid in _picks():
            fn = jax.jit(shard_map(
                lambda x, v=valid: jdecode.global_greedy_pick(x, "tensor", v),
                mesh=ctx.mesh, in_specs=P(None, "tensor"), out_specs=P(),
                check_vma=False))
            out.append(np.asarray(fn(jnp.asarray(logits))))
        return out
    finally:
        ctx.destroy()


def _check_generate(cases, got, want, where):
    for (name, cfg_kw, *_), ids, (sharded, single) in zip(cases, got, want):
        np.testing.assert_array_equal(ids, sharded, err_msg=f"{where} {name} vs JAX generate_tp")
        np.testing.assert_array_equal(ids, single, err_msg=f"{where} {name} vs JAX generate")
        if "valid_vocab_size" in cfg_kw:
            assert (ids < cfg_kw["valid_vocab_size"]).all(), where


def _check_picks(got, want, where):
    for (name, logits, valid), ids, jids in zip(_picks(), got, want):
        np.testing.assert_array_equal(ids, jids, err_msg=f"{where} {name}")
        masked = logits if valid is None else np.where(np.arange(64) < valid, logits, -1e30)
        np.testing.assert_array_equal(ids, masked.argmax(-1), err_msg=f"{where} {name}")
    assert list(got[1]) == [3, 17, 20, 31], where


def test_generate_tp_and_the_pick_at_tp2_match_jax(devices, cases):
    ranks = run_ranks(generate_rank, 2, 2, [c[1:] for c in cases],
                      [p[1:] for p in _picks()], None, timeout=300)
    want, picks = _jax_generate(cases, 2), _jax_picks(2)
    for rank, (gens, got_picks, _) in enumerate(ranks):
        _check_generate(cases, gens, want, f"tp 2 rank {rank}")
        _check_picks(got_picks, picks, f"tp 2 rank {rank}")
    assert len({int(t) for t in ranks[0][0][0][:, 6:].ravel()}) > 4   # streams vary


def test_generate_tp_at_tp4_and_tp2dp2_match_jax_and_probes_raise(devices, cases):
    """tp 4 (every case, the picks, the probes), then tp 2 x dp 2 (plain
    prompts), in one 4-rank spawn."""
    probe_tree = tbloom.init_params_numpy(tbloom.BloomConfig(**PROBE_KW), seed=0)
    ranks = run_ranks(generate_tp4_then_tp2dp2_rank, 4, [c[1:] for c in cases],
                      [p[1:] for p in _picks()],
                      (PROBE_KW, probe_tree, INT4_GROUP_TOO_WIDE), timeout=300)
    want4, picks4 = _jax_generate(cases, 4), _jax_picks(4)
    want2 = _jax_generate(cases[:1], 2)
    jax_errors = _jax_probe_errors(probe_tree, cases[0][2])
    for rank, ((gens, got_picks, errors), (gens2, _, _)) in enumerate(ranks):
        _check_generate(cases, gens, want4, f"tp 4 rank {rank}")
        _check_picks(got_picks, picks4, f"tp 4 rank {rank}")
        _check_generate(cases[:1], gens2, want2, f"tp 2 x dp 2 rank {rank}")
        assert "must be divisible by the tensor axis size 4" in errors["generate_tp"]
        for key in ("init_cache", "init_pages", "engine"):
            assert errors[key] == "n_head=6 not divisible by tp=4", key
        assert errors["engine"] == jax_errors["engine"]
        assert errors["engine_int4"] == jax_errors["engine_int4"]
        assert "per-shard contraction" in errors["engine_int4"]


def _jax_probe_errors(probe_tree, tree):
    """The messages of the JAX engine at tp 4 with 6 heads, and with int4
    weights whose group does not divide a row-parallel shard."""
    out = {}
    ctx = JaxContext(tensor_parallel_size=4, data_parallel_size=2)
    try:
        for key, cfg, params, kw in (
                ("engine", _jcfg(PROBE_KW), probe_tree, {}),
                ("engine_int4", _jcfg(CFG_KW), tree,
                 dict(weight_dtype="int4", weight_group_size=INT4_GROUP_TOO_WIDE))):
            params = jax.tree_util.tree_map(jnp.asarray, params)
            with pytest.raises(ValueError) as err:
                JServingEngine(params, cfg, num_slots=2, num_pages=32, page_size=4,
                               max_context=64, mesh=ctx.mesh,
                               param_specs=jbloom.tp_specs(params), **kw)
            out[key] = str(err.value)
    finally:
        ctx.destroy()
    return out


@pytest.mark.parametrize("quant", [("int8", 32), ("int4", 16)], ids=["int8", "int4"])
def test_quantize_param_specs_equals_jax(cases, quant):
    """On the JAX numpy tree, leaf for leaf (a PartitionSpec as its tuple of
    entries); on the port's tree, each layer's specs are JAX's without the
    stacked leading None."""
    tree = cases[0][2]
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jquantize_specs(jbloom.tp_specs(jparams), jparams, JQuantSpec(*quant))
    got = quantize_param_specs(tbloom.tp_specs(tree), tree, QuantSpec(*quant))
    flat = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, P))[0]
    for path, spec in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node) == tuple(spec), jax.tree_util.keystr(path)
    assert got["blocks"]["attn"]["out"]["scale"] == (
        (None, None) if quant[0] == "int8" else (None, "tensor", None))
    tparams = params_from_jax(tree, tbloom.BloomConfig(**CFG_KW), device="cpu")
    per_layer = quantize_param_specs(tbloom.tp_specs(tparams), tparams, QuantSpec(*quant))
    for layer in per_layer["blocks"]:
        for grp, name in (("attn", "qkv"), ("attn", "out"), ("mlp", "up"), ("mlp", "down")):
            for key in ("q", "scale"):
                assert layer[grp][name][key] == tuple(want["blocks"][grp][name][key])[1:]
            assert layer[grp][name]["bias"] == tuple(want["blocks"][grp][name]["bias"])[1:]


@pytest.mark.parametrize("kv", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_prompt_write_and_copy_on_head_sharded_banks(kv, tp):
    """Every rank's banks (``init_pages(tp=)``), written from its heads of
    a prefill cache and copied on write, equal the same heads of the whole
    banks, bit for bit (an int8 bank's scale plane with its heads)."""
    cfg = tbloom.BloomConfig(**CFG_KW)
    nh, ps, n_pages = cfg.n_head, 4, 9
    rng = np.random.default_rng(tp)
    cache = {k: torch.from_numpy(rng.standard_normal(
        (cfg.n_layer, 1, 11, nh, cfg.head_dim)).astype(np.float32)) for k in ("k", "v")}
    phys = torch.tensor([5, 2, 7, 0], dtype=torch.int32)

    def write(cache, tp_):
        k, v = tkv.init_pages(cfg, n_pages, ps, tp=tp_, kv_dtype=kv, device="cpu")
        tkv.write_prompt_pages(k, v, cache, phys, 2, ps)   # 2 pad slots, 9 tokens
        tkv.copy_page(k, v, 7, 3)
        return k, v

    whole = write(cache, 1)
    lh = nh // tp
    for r in range(tp):
        heads = slice(r * lh, (r + 1) * lh)
        part = write({k: c[..., heads, :].contiguous() for k, c in cache.items()}, tp)
        for got, want in zip(part, whole):
            if kv is None:
                assert got.shape[3] == lh
                assert torch.equal(got, want[:, :, :, heads])
            else:
                assert torch.equal(got["q"], want["q"][:, :, :, heads])
                assert torch.equal(got["scale"], want["scale"][:, :, :, heads])
    plane = whole[0] if kv is None else whole[0]["q"]
    assert torch.equal(plane[:, 3], plane[:, 7]) and plane[:, 7].abs().sum() > 0
