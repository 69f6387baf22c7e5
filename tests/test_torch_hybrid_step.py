"""The port's hybrid tensor x data parallel step with ZeRO-1 held against the
JAX package on the CPU: the acceptance test of ``tests/test_hybrid.py`` on
gloo ranks.

- TP2 x DP2 on 4 ranks, 5 Adam steps of ``make_hybrid_train_step`` with
  ``DistributedOptimizer`` over "data": the losses and the final params
  (gathered whole) against the JAX ``make_hybrid_train_step`` on a (data,
  tensor) mesh and against the port's single-device ``train_step``, to
  ``tests/test_hybrid.py``'s rtol 2e-3, atol 2e-4; the first step's loss
  (1e-5 relative) and gradients (1e-4 of each leaf's largest value) against
  JAX ``value_and_grad(loss_fn)`` on the whole batch. Full logits, and
  remat + flash + fused CE. With ``n_accum = 2``, 3 steps against the JAX
  step with ``n_accum = 2`` and against the one-shot step. Each rank's ZeRO
  shards hold ceil(d0 / 2) rows of its tensor shard of every leaf.
- ``DistributedOptimizer`` alone at dp 1, 2 and 4 on leaves whose dim 0
  needs padding (and a scalar), 3 steps against ``optax.adam`` on the mean
  gradient; each rank's shard shape and Adam moments hold ``ceil(d0 / dp)
  x rest`` elements (at dp 1 the shards are the leaves themselves).
- Accumulation at K = 2 and 4 (``accumulate_gradients``,
  ``make_accumulating_loss``) against the JAX functions.
- The spec helpers against the JAX ones, ``with_health`` (ROADMAP.md
  queue A, item 13) raising, and the comm engine's options raising only
  JAX's errors.

Tiny BLOOM (vocab 128, hidden 64, 2 layers, 4 heads), B = 8 x S = 12, as
``tests/test_hybrid.py``; weights and data from numpy seeds, float32. The
ranks' bodies live in ``test_torch_hybrid_ranks.py``; one spawn per world
size (the dp 4 ZeRO run rides the 4-rank spawn).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pipegoose_tpu.core import accumulation as jacc
from pipegoose_tpu.distributed import ParallelContext as JaxContext
from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.nn.pipeline_parallel.microbatch import split as jsplit
from pipegoose_tpu.optim import zero as jzero
from pipegoose_tpu.optim.zero import DistributedOptimizer as JaxZero
from pipegoose_tpu.parallel import hybrid as jhybrid
from pipegoose_tpu.parallel import make_hybrid_train_step as jax_hybrid_step
from pipegoose_tpu_torch.core import accumulation as tacc
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import grads_of, params_from_jax, params_to_jax
from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
from pipegoose_tpu_torch.optim import zero as tzero
from pipegoose_tpu_torch.parallel import hybrid as thybrid
from pipegoose_tpu_torch.testing.dist import run_ranks
from pipegoose_tpu_torch.trainer import make_optimizer, train_step
from test_torch_hybrid_ranks import step_rank, zero_rank

STEPS = 5
BATCH, SEQ = 8, 12
LR = 1e-3
RTOL, ATOL = 2e-3, 2e-4           # tests/test_hybrid.py:78
LOSS0_RTOL, GRAD0_REL = 1e-5, 1e-4
SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
RUNS = {   # name -> (config options, steps, n_accum)
    "full_logits": (dict(), STEPS, 1),
    "remat_flash_fused_ce": (dict(remat=True, use_flash=True, fused_ce=True), STEPS, 1),
    "accum_2": (dict(), 3, 2),
}
RUN_NAMES = list(RUNS)


@functools.lru_cache(maxsize=None)
def _data():
    """Weights with nonzero LayerNorm and bias leaves, and the batches."""
    np_tree = tbloom.init_params_numpy(tbloom.BloomConfig(**SIZE), seed=0)
    rng = np.random.default_rng(1)
    for ln in (np_tree["embed_ln"], np_tree["ln_f"], np_tree["blocks"]["ln_1"],
               np_tree["blocks"]["ln_2"]):
        for name in ("scale", "bias"):
            ln[name] += rng.standard_normal(ln[name].shape, dtype=np.float32) * 0.1
    for group, subs in (("attn", ("qkv", "out")), ("mlp", ("up", "down"))):
        for sub in subs:
            b = np_tree["blocks"][group][sub]["bias"]
            b += rng.standard_normal(b.shape, dtype=np.float32) * 0.1
    rs = np.random.RandomState(1)
    batches = [rs.randint(0, SIZE["vocab_size"], (BATCH, SEQ)).astype(np.int32)
               for _ in range(STEPS)]
    return np_tree, batches


def _jax_hybrid(opts, steps, n_accum):
    """The JAX hybrid step at TP2 x DP2: its losses and final params."""
    np_tree, batches = _data()
    cfg = jbloom.BloomConfig(**SIZE, **opts)
    params = jax.tree_util.tree_map(jnp.asarray, np_tree)
    ctx = JaxContext(tensor_parallel_size=2, data_parallel_size=2)
    try:
        def loss_fn(p, ids):
            return jbloom.loss_fn(p, ids, None, ids, cfg, tp_axis="tensor")

        init_fn, make_step = jax_hybrid_step(loss_fn, jbloom.tp_specs(params),
                                             JaxZero(optax.adam(LR), axis_name="data"),
                                             ctx, n_accum=n_accum)
        p = jax.tree_util.tree_map(jnp.copy, params)
        state = init_fn(p)
        step = make_step(p)
        losses = []
        for ids in batches[:steps]:
            p, state, loss = step(p, state, jnp.asarray(ids))
            losses.append(float(loss))
        return losses, jax.tree_util.tree_map(np.asarray, p)
    finally:
        ctx.destroy()


def _single_device(opts, steps):
    """The port's single-device train_step on the whole batches."""
    np_tree, batches = _data()
    cfg = tbloom.BloomConfig(**SIZE, **opts)
    params = params_from_jax(np_tree, cfg, device="cpu")
    opt = make_optimizer(params, LR)
    losses = [float(train_step(params, opt, ids, None, ids, cfg, device="cpu"))
              for ids in batches[:steps]]
    return losses, params_to_jax(params)


def _close_trees(got, want, what, rtol=RTOL, atol=ATOL):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _spec_leaves(specs):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            out.append(t)
    walk(specs)
    return out


def _check_run(name, ranks):
    """Each run's losses and final params on all four ranks against the
    JAX hybrid step, the port's single-device step (for accumulation: the
    one-shot step), and each other."""
    opts, steps, n_accum = RUNS[name]
    for r in ranks[1:]:   # the all-gathers leave every rank the same params
        _close_trees(r["params"], ranks[0]["params"], f"{name}: a rank vs rank 0",
                     rtol=0, atol=0)
        assert r["losses"] == ranks[0]["losses"], name
    got = ranks[0]
    want_losses, want_params = _jax_hybrid(opts, steps, n_accum)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=RTOL, atol=ATOL,
                               err_msg=name)
    _close_trees(got["params"], want_params, f"{name} vs the JAX hybrid step")
    ref_losses, ref_params = _single_device(opts, steps)
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=RTOL, atol=ATOL,
                               err_msg=name)
    _close_trees(got["params"], ref_params, f"{name} vs train_step")
    # anti-false-positive: the steps moved every leaf by more than the tolerance
    moved = [float(np.abs(np.asarray(w) - i0).max()) for w, i0 in zip(
        jax.tree_util.tree_leaves(want_params), jax.tree_util.tree_leaves(_data()[0]))]
    assert min(moved) > 10 * ATOL, (name, moved)


def _check_first_step(name, ranks):
    """The first step's loss and global gradients against JAX
    ``value_and_grad(loss_fn)`` on the whole batch."""
    np_tree, batches = _data()
    cfg = jbloom.BloomConfig(**SIZE, **RUNS[name][0])
    ids = jnp.asarray(batches[0])
    loss, grads = jax.value_and_grad(jbloom.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, np_tree), ids, None, ids, cfg)
    paths = jax.tree_util.tree_flatten_with_path(grads)[0]
    for got in ranks:
        assert abs(got["loss0"] - float(loss)) <= LOSS0_RTOL * abs(float(loss)), name
        for (path, w), g in zip(paths, jax.tree_util.tree_leaves(got["grads0"])):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=GRAD0_REL * float(np.abs(w).max()),
                                       err_msg=f"{name} {jax.tree_util.keystr(path)}")


def _check_zero_state(ranks):
    """Each rank's shards are ceil(d0 / 2) rows of its tensor shard of every
    leaf (the per-layer leaves', not JAX's stacked ones), and Adam's two
    moments hold that many elements each."""
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    np_tree, _ = _data()
    params = params_from_jax(np_tree, tbloom.BloomConfig(**SIZE), device="cpu")
    local = []
    for p, spec in zip(tree_leaves(params), _spec_leaves(tbloom.tp_specs(params))):
        shape = list(p.shape) if p.dim() else [1]
        for d, entry in enumerate(spec):
            if entry == "tensor":
                shape[d] //= 2
        shape[0] = math.ceil(shape[0] / 2)
        local.append(tuple(shape))
    for got in ranks:
        assert got["shard_shapes"] == local
        assert got["state_elems"] == [2 * math.prod(s) for s in local]


LEAVES = {"a": (5, 3), "b": (7,), "c": (), "d": (8, 2)}


def _zero_case(dp):
    rng = np.random.default_rng(dp)
    leaves = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in LEAVES.items()}
    grads = [{k: rng.standard_normal((dp, *s)).astype(np.float32)
              for k, s in LEAVES.items()} for _ in range(3)]
    return leaves, grads, LR


def _check_zero(ranks, case, dp):
    """ZeRO-1 alone against ``optax.adam`` on the mean gradient; each rank's
    shard shape and Adam moments hold ceil(d0 / dp) x rest elements."""
    leaves, grads, lr = case
    opt = optax.adam(lr)
    p = {k: jnp.asarray(v) for k, v in leaves.items()}
    state = opt.init(p)
    for g in grads:
        mean = {k: jnp.asarray(v.mean(axis=0)) for k, v in g.items()}
        updates, state = opt.update(mean, state, p)
        p = optax.apply_updates(p, updates)
    for params, shapes, moments in ranks:
        for k, s in LEAVES.items():
            np.testing.assert_allclose(params[k], np.asarray(p[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
            d0 = s[0] if s else 1
            # on one rank the shards are the leaves themselves
            want = s if dp == 1 else (math.ceil(d0 / dp), *s[1:])
            assert shapes[k] == want, (k, shapes[k], want)
            assert moments[k] == math.prod(want), k


def test_tp2_dp2_zero1_matches_the_jax_hybrid_step_and_single_device(devices):
    """The acceptance test, ZeRO-1 alone at dp 4, ``TensorParallel`` and
    ``DataParallel`` against ``params_from_jax(specs=)``, and ``with_rng``
    under accumulation, in one 4-rank spawn."""
    np_tree, batches = _data()
    runs = [(tbloom.BloomConfig(**SIZE, **RUNS[n][0]), batches[:RUNS[n][1]], LR,
             RUNS[n][2]) for n in RUN_NAMES]
    zero_case = _zero_case(4)
    rng_case = (tbloom.BloomConfig(**SIZE), batches[0], 7)
    ranks = run_ranks(step_rank, 4, np_tree, runs, 2, zero_case, rng_case, timeout=300)
    assert all(r[0][0] for r in ranks), "TensorParallel / DataParallel disagree"
    hybrid = [r[0][1:] for r in ranks]
    for i, name in enumerate(RUN_NAMES):
        _check_run(name, [r[i] for r in hybrid])
        if RUNS[name][2] == 1:
            _check_first_step(name, [r[i] for r in hybrid])
    _check_zero_state([r[0] for r in hybrid])
    _check_zero([r[1] for r in ranks], zero_case, 4)
    for seen, refused in (r[2] for r in ranks):   # with_rng: one seed a microbatch
        assert seen == [tacc.fold_in(7, 0), tacc.fold_in(7, 1)] and refused


@pytest.mark.parametrize("dp", [1, 2])
def test_zero1_matches_optax_adam_on_the_mean_gradient(dp):
    case = _zero_case(dp)
    _check_zero(run_ranks(zero_rank, dp, *case), case, dp)


def test_zero_without_an_axis_is_plain_adam():
    rng = np.random.default_rng(0)
    leaves = {k: torch.from_numpy(np.asarray(rng.standard_normal(s), np.float32))
              for k, s in LEAVES.items()}
    grads = [{k: torch.from_numpy(np.asarray(rng.standard_normal(s), np.float32))
              for k, s in LEAVES.items()} for _ in range(3)]
    opt = DistributedOptimizer(adam(LR), axis_name=None)
    params = {k: v.clone() for k, v in leaves.items()}
    state = opt.init(params)
    jopt = optax.adam(LR)
    p = {k: jnp.asarray(v.numpy()) for k, v in leaves.items()}
    jstate = jopt.init(p)
    for g in grads:
        params, state = opt.step(g, state, params)
        updates, jstate = jopt.update({k: jnp.asarray(v.numpy()) for k, v in g.items()},
                                      jstate, p)
        p = optax.apply_updates(p, updates)
    assert state.shards is None
    for k in LEAVES:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(p[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


# -- accumulation ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 4])
def test_accumulate_gradients_matches_jax(k):
    np_tree, batches = _data()
    cfg, jcfg = tbloom.BloomConfig(**SIZE), jbloom.BloomConfig(**SIZE)
    ids = batches[0]
    mbs = ids.reshape(k, BATCH // k, SEQ)
    jloss, jgrads = jacc.accumulate_gradients(
        lambda p, b: jbloom.loss_fn(p, b, None, b, jcfg),
        jax.tree_util.tree_map(jnp.asarray, np_tree), jnp.asarray(mbs))
    params = params_from_jax(np_tree, cfg, device="cpu")
    make_optimizer(params, LR)
    loss, grads = tacc.accumulate_gradients(
        lambda p, b: tbloom.loss_fn(p, b.long(), None, b.long(), cfg), params,
        torch.from_numpy(mbs))
    assert abs(loss.item() - float(jloss)) <= 2e-6
    _close_trees(params_to_jax(grads), jgrads, f"K={k}", rtol=0, atol=2e-6)
    _close_trees(params_to_jax(grads_of(params)), jgrads, f"K={k} .grad", rtol=0,
                 atol=2e-6)


@pytest.mark.parametrize("k", [2, 4])
def test_make_accumulating_loss_matches_jax(k):
    np_tree, batches = _data()
    cfg = tbloom.BloomConfig(**SIZE, remat=True, use_flash=True)
    jcfg = jbloom.BloomConfig(**SIZE, remat=True, use_flash=True)
    ids = batches[1]
    jfn = jacc.make_accumulating_loss(
        lambda p, b: jbloom.loss_fn(p, b, None, b, jcfg), k)
    jloss, jgrads = jax.value_and_grad(jfn)(
        jax.tree_util.tree_map(jnp.asarray, np_tree), jnp.asarray(ids))
    params = params_from_jax(np_tree, cfg, device="cpu")
    make_optimizer(params, LR)
    fn = tacc.make_accumulating_loss(
        lambda p, b: tbloom.loss_fn(p, b.long(), None, b.long(), cfg), k)
    loss = fn(params, torch.from_numpy(ids))
    assert not loss.requires_grad
    assert abs(loss.item() - float(jloss)) <= 2e-6
    _close_trees(params_to_jax(grads_of(params)), jgrads, f"K={k}", rtol=0, atol=2e-6)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_microbatch_split_equals_jax(n):
    batch = {"ids": np.arange(48).reshape(8, 6), "mask": np.ones((8, 6), np.int32)}
    got = tacc.split(batch, n)
    want = jsplit(jax.tree_util.tree_map(jnp.asarray, batch), n)
    for i in range(n):
        for key in batch:
            np.testing.assert_array_equal(got[i][key], np.asarray(want[key][i]))
    with pytest.raises(ValueError, match="not divisible"):
        tacc.split(batch, 3)


def test_fold_in_gives_each_microbatch_its_own_seed():
    seeds = {tacc.fold_in(7, i) for i in range(4)}
    assert len(seeds) == 4 and tacc.fold_in(7, 1) == tacc.fold_in(7, 1)
    seen = []
    fn = tacc.make_accumulating_loss(
        lambda p, b, rng: (seen.append(rng), (p * b.sum()).sum())[1], 4)
    p = torch.ones(2, requires_grad=True)
    fn(p, torch.ones(8, 3), 7)
    assert seen == [tacc.fold_in(7, i) for i in range(4)]
    assert torch.allclose(p.grad, torch.full((2,), 6.0))


# -- spec helpers and probes ---------------------------------------------------------------

SPECS = [(), ("tensor",), (None, "tensor"), ("tensor", None), (("tensor", "seq"), None),
         (None,)]


@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("ndim", [0, 1, 2, 3])
def test_zero_param_spec_equals_jax(spec, ndim):
    from jax.sharding import PartitionSpec as P

    assert tzero.zero_param_spec(spec, ndim) == tuple(jzero.zero_param_spec(P(*spec), ndim))


def test_shard_shapes_and_state_specs_equal_jax():
    np_tree, _ = _data()
    dp = 3
    jtree = jax.tree_util.tree_map(jnp.asarray, np_tree)
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), jzero.shard_shapes(jtree, dp))
    ttree = jax.tree_util.tree_map(torch.from_numpy, np_tree)
    assert tzero.shard_shapes(ttree, dp) == want
    jspecs = jbloom.tp_specs(jtree)
    got = tzero.state_specs(ttree, tbloom.tp_specs(np_tree), "data")
    jleaves = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    want_specs = [tuple(jzero.zero_param_spec(s, p.ndim, "data"))
                  for s, p in zip(jleaves, jax.tree_util.tree_leaves(jtree))]
    assert _spec_leaves(got) == want_specs
    assert thybrid.zero_state_spec(DistributedOptimizer(adam(LR)), ttree,
                                   tbloom.tp_specs(np_tree)) == got


@dataclasses.dataclass
class _Candidate:
    tp: int = 2
    dp: int = 2
    pp: int = 1
    ep: int = 1
    grad_comm: str = "fp32"
    overlap_tp: bool = False


@pytest.mark.parametrize("pp", [1, 2])
def test_candidate_helpers_equal_jax(pp):
    c = _Candidate(pp=pp)
    assert thybrid.parallel_context_sizes(c) == jhybrid.parallel_context_sizes(c)
    assert thybrid.hybrid_step_kwargs(c) == jhybrid.hybrid_step_kwargs(c)


def test_hybrid_build_config_round_trips_every_option():
    opt = DistributedOptimizer(adam(LR))
    cfg = thybrid.hybrid_build_config(len, {}, opt, n_accum=2)
    jcfg = jhybrid.hybrid_build_config(len, {}, opt, n_accum=2)
    assert set(cfg) == set(jcfg)
    assert cfg["n_accum"] == 2 and cfg["batch_spec"] == ("data",)


@pytest.mark.parametrize("probe", ["with_health", "overlap_tp", "grad_comm",
                                   "error_feedback", "fp8", "no_context"])
def test_unported_hybrid_options_raise(probe):
    """``with_health`` (ROADMAP.md queue A, item 13) raises; ``overlap_tp``,
    ``grad_comm`` and ``error_feedback`` run (the comm engine) and raise only
    JAX's errors: an unknown wire, error feedback without a compressed one,
    a step with no context."""
    opt = DistributedOptimizer(adam(LR))
    if probe == "fp8":
        with pytest.raises(ValueError, match="grad_comm"):
            DistributedOptimizer(adam(LR), grad_comm="fp8")
        return
    if probe == "no_context":
        with pytest.raises(ValueError, match="no ParallelContext"):
            thybrid.make_hybrid_train_step(len, {}, opt)
        return
    if probe == "with_health":
        with pytest.raises(NotImplementedError, match="item 13"):
            thybrid.make_hybrid_train_step(len, {}, opt, with_health=True)
        return
    if probe == "error_feedback":
        with pytest.raises(ValueError, match="error_feedback requires grad_comm"):
            DistributedOptimizer(adam(LR), error_feedback=True)
        assert DistributedOptimizer(adam(LR), grad_comm="int8",
                                    error_feedback=True).error_feedback
        return
    if probe == "grad_comm":
        assert DistributedOptimizer(adam(LR), grad_comm="int8").grad_comm == "int8"
    with pytest.raises(ValueError, match="no ParallelContext"):
        thybrid.make_hybrid_train_step(len, {}, opt, **(
            {"grad_comm": "int8"} if probe == "grad_comm" else {probe: True}))
