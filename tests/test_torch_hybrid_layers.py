"""The port's tensor-parallel layers held against the JAX package on the CPU.

- Every layer of ``nn/tensor_parallel/layers.py`` under a "tensor" axis of 2
  and 4 gloo ranks (column, row, the vocab-parallel embedding, the
  vocab-parallel cross
  entropy with and without padded slots, ``chunked_ce_sums`` through
  ``bloom.logits_fn``), and the fused cross entropy's plain versions under
  the axis (``fused_ce_shifted_loss``): each rank's output and the
  gradients of its inputs against the JAX functions under ``shard_map`` on
  the same per-rank inputs (the fused CE's Pallas kernels in interpret
  mode). At tp 4 the padded case's last vocab shard is all padding.
- The spec tables (``tp_specs``, ``tp_mapping``, ``pad_for_tp``) against
  the JAX ones, and ``BloomConfig.overlap_tp`` on a one-rank tensor axis
  equal to the monolithic path.

Tolerance 1e-5 (float32, the same products reduced over ranks in another
order). One spawn per world size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pipegoose_tpu.distributed.compat import shard_map
from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.nn import parallel_mapping as jpm
from pipegoose_tpu.nn.tensor_parallel import layers as jlayers
from pipegoose_tpu.nn.tensor_parallel.tensor_parallel import pad_vocab as jpad_vocab
from pipegoose_tpu.ops import fused_ce as jce
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.nn import parallel_mapping as tpm
from pipegoose_tpu_torch.nn.tensor_parallel import layers as tlayers
from pipegoose_tpu_torch.nn.tensor_parallel.tensor_parallel import pad_vocab
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_hybrid_ranks import CHUNKS, V_GLOBAL, VALID_CUT, tp_layers_rank

LAYER_TOL = 1e-5
B, S, H, O, T = 2, 6, 16, 24, 7
SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
KINDS = ("column", "row", "embedding", "ce",
         "ce_valid", "chunked", "chunked_valid", "fused", "fused_valid")


def _split(a, tp, axis):
    return np.stack(np.split(a, tp, axis=axis))


def _same(a, tp):
    return np.stack([a] * tp)


def _inputs(kind, tp, seed=0):
    """Per-rank inputs, each stacked on a leading axis of tp."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    base = kind.removesuffix("_valid")
    n_tgt = V_GLOBAL - (VALID_CUT if kind.endswith("_valid") else 0)
    if base == "column":
        return dict(x=_same(f(B, S, H), tp), kernel=_split(f(H, O), tp, 1),
                    bias=_split(f(O), tp, 0), ct=_split(f(B, S, O), tp, 2))
    if base == "row":
        return dict(x=_split(f(B, S, H), tp, 2), kernel=_split(f(H, O), tp, 0),
                    bias=_same(f(O), tp), ct=_same(f(B, S, O), tp))
    if base == "embedding":
        return dict(weight=_split(f(V_GLOBAL, H), tp, 0),
                    ids=_same(rng.integers(0, V_GLOBAL, (B, S)).astype(np.int32), tp),
                    ct=_same(f(B, S, H), tp))
    if base == "ce":
        return dict(logits=_split(f(B, S, V_GLOBAL) * 3, tp, 2),
                    targets=_same(rng.integers(0, n_tgt, (B, S)).astype(np.int32), tp),
                    ct=_same(f(B, S), tp))
    w = np.ones((B, T), np.float32)
    w[1, -2:] = 0.0
    common = dict(hidden=_same(f(B, T, H), tp), weight=_split(f(V_GLOBAL, H), tp, 0),
                  labels=_same(rng.integers(0, n_tgt, (B, T)).astype(np.int32), tp))
    if base == "chunked":
        return dict(common, w=_same(w, tp))
    return dict(common, mask=_same(w.astype(np.int32), tp))


def _jax_case(kind, x, axis):
    """JAX's counterpart of ``test_torch_hybrid_ranks.layer_case``."""
    floats = [k for k in x if jnp.issubdtype(x[k].dtype, jnp.floating) and k != "ct"]
    valid = V_GLOBAL - VALID_CUT if kind.endswith("_valid") else None
    base = kind.removesuffix("_valid")

    def f(fl):
        t = {**x, **fl}
        lin = {k: t[k] for k in ("kernel", "bias") if k in t}
        if base == "column":
            y = jlayers.column_parallel_linear(lin, t["x"], axis)
        elif base == "row":
            y = jlayers.row_parallel_linear(lin, t["x"], axis)
        elif base == "embedding":
            y = jlayers.vocab_parallel_embedding({"weight": t["weight"]}, t["ids"], axis)
        elif base == "ce":
            y = jlayers.vocab_parallel_cross_entropy(t["logits"], t["targets"], axis,
                                                     valid_size=valid)
        elif base == "chunked":
            params = {"embed": {"weight": t["weight"]}}
            tot, cnt = jlayers.chunked_ce_sums(
                t["hidden"], t["labels"], t["w"],
                lambda h: jbloom.logits_fn(params, h, axis), axis, valid, CHUNKS)
            y = tot / cnt
        else:
            y = jce.fused_ce_shifted_loss(t["hidden"], t["weight"], t["labels"],
                                          t["mask"], axis, valid)
        return ((y * t["ct"]).sum() if "ct" in t else y), y

    (_, y), g = jax.value_and_grad(f, has_aux=True)({k: x[k] for k in floats})
    return y, g


def _jax_layers(kind, xs, tp):
    mesh = Mesh(np.array(jax.devices()[:tp]), ("tensor",))

    def body(xs):
        y, g = _jax_case(kind, {k: v[0] for k, v in xs.items()}, "tensor")
        return y[None], {k: v[None] for k, v in g.items()}

    fn = shard_map(body, mesh=mesh, in_specs=(P("tensor"),), out_specs=P("tensor"),
                   check_vma=False)
    return jax.jit(fn)({k: jnp.asarray(v) for k, v in xs.items()})


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_layers_and_fused_ce_match_jax_under_shard_map(tp, devices):
    """Every case of KINDS at this tp; the ranks run all of them in one
    spawn."""
    cases = [(kind, _inputs(kind, tp, seed=i)) for i, kind in enumerate(KINDS)]
    ranks = run_ranks(tp_layers_rank, tp, cases)
    for i, (kind, xs) in enumerate(cases):
        want_y, want_g = _jax_layers(kind, xs, tp)
        got_y = np.stack([r[i][0] for r in ranks])
        np.testing.assert_allclose(got_y, np.asarray(want_y), rtol=LAYER_TOL,
                                   atol=LAYER_TOL, err_msg=f"{kind} tp={tp} output")
        assert set(ranks[0][i][1]) == set(want_g), kind
        for name, want in want_g.items():
            got = np.stack([r[i][1][name] for r in ranks])
            np.testing.assert_allclose(got, np.asarray(want), rtol=LAYER_TOL,
                                       atol=LAYER_TOL,
                                       err_msg=f"{kind} tp={tp} d{name}")


# -- the spec tables --------------------------------------------------------------------------


def _as_tuples(tree):
    return jax.tree_util.tree_map(lambda s: tuple(s), tree,
                                  is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("axis", ["tensor", "model"])
def test_tp_specs_of_the_stacked_tree_equal_jax(axis):
    np_tree = tbloom.init_params_numpy(tbloom.BloomConfig(**SIZE), seed=0)
    want = _as_tuples(jbloom.tp_specs(jax.tree_util.tree_map(jnp.asarray, np_tree), axis))
    assert tbloom.tp_specs(np_tree, axis) == want


def test_tp_specs_of_the_port_tree_drop_the_layer_dim():
    cfg = tbloom.BloomConfig(**SIZE)
    np_tree = tbloom.init_params_numpy(cfg, seed=0)
    stacked = _as_tuples(jbloom.tp_specs(jax.tree_util.tree_map(jnp.asarray, np_tree)))
    per_layer = tbloom.tp_specs(params_from_jax(np_tree, cfg, device="cpu"))
    assert len(per_layer["blocks"]) == cfg.n_layer
    for blk in per_layer["blocks"]:
        assert blk == jax.tree_util.tree_map(
            lambda s: s[1:], stacked["blocks"], is_leaf=lambda x: isinstance(x, tuple))
    for key in ("embed", "embed_ln", "ln_f"):
        assert per_layer[key] == stacked[key]


PATHS = ("blocks/attn/qkv/kernel", "blocks/attn/qkv/bias", "blocks/attn/out/kernel",
         "blocks/attn/out/bias", "blocks/mlp/up/kernel", "blocks/mlp/down/bias",
         "embed/weight", "ln_f/scale", "experts/w_in")


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("ndim", [None, 1, 2, 3])
def test_parallel_mapping_spec_for_equals_jax(path, ndim):
    rules = [(r"attn/qkv", "Column"), (r"attn/out", "Row"), (r"mlp/up", "Column"),
             (r"mlp/down", "Row"), (r"embed/weight", "Vocab"), (r"experts", "Expert"),
             (r"ln_f", "Replicate")]

    def mapping(mod):
        return mod.ParallelMapping([
            (pat, getattr(mod, role)() if role == "Replicate"
             else getattr(mod, role)("expert" if role == "Expert" else "tensor"))
            for pat, role in rules])

    jm, tm = mapping(jpm), mapping(tpm)
    assert tm.spec_for(path, ndim) == tuple(jm.spec_for(path, ndim))
    for pred in ("is_column_parallel", "is_row_parallel", "is_vocab_parallel",
                 "is_expert"):
        assert getattr(tm, pred)(path) == getattr(jm, pred)(path)


@pytest.mark.parametrize("tp", [1, 2, 3, 4, 7])
def test_pad_for_tp_equals_jax(tp):
    cfg = tbloom.BloomConfig(**dict(SIZE, vocab_size=125))
    np_tree = tbloom.init_params_numpy(cfg, seed=0)
    jparams, jcfg = jbloom.pad_for_tp(jax.tree_util.tree_map(jnp.asarray, np_tree),
                                      jbloom.BloomConfig(**dict(SIZE, vocab_size=125)), tp)
    params, pcfg = tbloom.pad_for_tp(np_tree, cfg, tp)
    np.testing.assert_array_equal(params["embed"]["weight"],
                                  np.asarray(jparams["embed"]["weight"]))
    assert (pcfg.vocab_size, pcfg.valid_vocab_size) == (jcfg.vocab_size,
                                                        jcfg.valid_vocab_size)
    w = torch.from_numpy(np_tree["embed"]["weight"])
    np.testing.assert_array_equal(pad_vocab(w, tp).numpy(),
                                  np.asarray(jpad_vocab(jnp.asarray(w.numpy()), tp)))


def test_padded_vocab_is_masked_in_the_loss_as_in_jax():
    """A vocab padded for tp 3 gives the unpadded loss (valid_vocab_size)."""
    cfg = tbloom.BloomConfig(**dict(SIZE, vocab_size=125))
    np_tree = tbloom.init_params_numpy(cfg, seed=0)
    ids = np.random.default_rng(2).integers(0, 125, (2, 8))
    params, pcfg = tbloom.pad_for_tp(np_tree, cfg, 3)
    losses = []
    for tree, c in ((np_tree, cfg), (params, pcfg)):
        p = params_from_jax(tree, c, device="cpu")
        losses.append(tbloom.loss_fn(p, torch.from_numpy(ids), None,
                                     torch.from_numpy(ids), c).item())
    assert abs(losses[0] - losses[1]) < 1e-6


@pytest.mark.parametrize("probe", ["forward", "loss_fn", "loss_fn_fused"])
def test_overlap_options_raise_naming_item_6(probe, tmp_path):
    """``BloomConfig.overlap_tp`` under a tensor axis now runs the ring
    collective-matmul path from every entry point that runs the blocks on
    the full sequence: on a one-rank tensor axis the ring is the plain
    product, so the outputs and gradients equal the monolithic path's (to
    1e-6 of the largest value: the ring's backward sums its own products).
    (The multi-rank cases are ``test_torch_overlap.py`` and
    ``test_torch_comm_hybrid.py``.)"""
    import torch.distributed as dist

    from pipegoose_tpu_torch.distributed import ParallelContext

    cfg = dataclasses.replace(tbloom.BloomConfig(**SIZE), fused_ce=probe == "loss_fn_fused")
    store = dist.FileStore(str(tmp_path / "store"), 1)
    ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cpu",
                                         tensor_parallel_size=1)
    try:
        ids = torch.from_numpy(np.random.default_rng(3).integers(0, 125, (2, 8)))
        outs = []
        for overlap in (False, True):
            c = dataclasses.replace(cfg, overlap_tp=overlap)
            params = params_from_jax(tbloom.init_params_numpy(c, seed=0), c, device="cpu")
            for leaf in (params["embed"]["weight"], params["blocks"][0]["ln_1"]["scale"]):
                leaf.requires_grad_(True)
            if probe == "forward":
                y = tbloom.forward(params, ids, None, c, tp_axis="tensor")
            else:
                y = tbloom.loss_fn(params, ids, None, ids, c, tp_axis="tensor")
            y.float().sum().backward()
            outs.append((y.detach(), params["embed"]["weight"].grad,
                         params["blocks"][0]["ln_1"]["scale"].grad))
    finally:
        ctx.destroy()
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=1e-6 * float(a.abs().max()))
