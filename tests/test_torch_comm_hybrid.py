"""The comm engine through the port's hybrid step, held against the JAX
package on the CPU: ``tests/test_comm_hybrid.py``'s cases at TP2 x DP2 on 4
gloo ranks (tiny BLOOM: vocab 128, hidden 64, 2 layers, 4 heads; B = 8 x S
= 16; 5 Adam steps at lr 1e-3; that test's weights, ``init_params`` at
``PRNGKey(0)``, and its ``RandomState(1)`` batches; float32).

- ``overlap_tp=True``: the losses and final params against the JAX overlap
  hybrid step (rtol 2e-3, atol 2e-4, as ``tests/test_hybrid.py``) and
  against the port's monolithic step (losses rtol 2e-4, atol 2e-5; params
  rtol 2e-3, atol 2e-4, as ``test_overlap_hybrid_matches_monolithic``). A
  sequence that does not divide over the tensor axis raises JAX's
  ValueError.
- ``grad_comm`` "int8" and "bf16", with and without error feedback, held
  two ways:
  - against a JAX reference ON THE PORT'S LAYOUT: JAX's own
    ``make_hybrid_train_step`` and ``DistributedOptimizer(grad_comm=,
    error_feedback=)`` over a per-layer parameter tree (the loss restacks
    it), so both sides quantize the same per-leaf chunks (the JAX package's
    stacked leaves chunk differently, ROADMAP.md § C). Losses to rtol 2e-3,
    atol 2e-4; params too, but for int8 rounding flips: at most 1e-3 of a
    leaf's elements may miss, each by at most 5 x lr (``_close_with_flips``);
  - to JAX's own bounds against float32 (``tests/test_comm_hybrid.py``):
    every loss within 5e-3 of the float32 run's, and error feedback not
    widening the int8 gap by more than 1e-5.
- A checkpoint round trip carries ``ZeroState.ef`` bit for bit into a
  fresh state, and a restore at tp 1 x dp 4 raises a ValueError naming
  ``ef``.

One spawn; the rank body lives in ``test_torch_comm_ranks.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax

from pipegoose_tpu.distributed import ParallelContext as JaxContext
from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.optim.zero import DistributedOptimizer as JaxZero
from pipegoose_tpu.parallel import make_hybrid_train_step as jax_hybrid_step
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_comm_ranks import comm_hybrid_rank

SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
BATCH, SEQ, STEPS, LR = 8, 16, 5, 1e-3
RTOL, ATOL = 2e-3, 2e-4                # tests/test_hybrid.py:78
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5      # tests/test_comm_hybrid.py:82
GAP = 5e-3                             # tests/test_comm_hybrid.py:188-189
FLIP_SHARE = 1e-3                      # int8 flips: see _close_with_flips
RUNS = [("fp32", False, None, False), ("overlap", True, None, False),
        ("int8", False, "int8", False), ("bf16", False, "bf16", False),
        ("int8_ef", False, "int8", True), ("bf16_ef", False, "bf16", True)]


@functools.lru_cache(maxsize=None)
def _data():
    """``tests/test_comm_hybrid.py``'s weights (``init_params`` at
    ``PRNGKey(0)``) and batches (``RandomState(1)``)."""
    np_tree = jax.tree_util.tree_map(np.asarray, jbloom.init_params(
        jbloom.BloomConfig(**SIZE), jax.random.PRNGKey(0)))
    rs = np.random.RandomState(1)
    batches = [rs.randint(0, SIZE["vocab_size"], (BATCH, SEQ)).astype(np.int32)
               for _ in range(STEPS)]
    return np_tree, batches


def _spawn(tmp):
    """The one 4-rank spawn the test reads."""
    np_tree, batches = _data()
    runs = [(name, tbloom.BloomConfig(**SIZE, overlap_tp=ovl), comm, ef)
            for name, ovl, comm, ef in RUNS]
    short = np.zeros((BATCH, 7), np.int32)   # 7 tokens over a tensor axis of 2
    return run_ranks(comm_hybrid_rank, 4, np_tree, runs, batches, LR, tmp, short,
                     timeout=600)


def _close_trees(got, want, what, rtol=RTOL, atol=ATOL):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _close_with_flips(got, want, what):
    """``_close_trees``, but for int8 rounding flips: a gradient element at
    a rounding boundary lands one int8 step off under float32 noise (the
    jitted JAX step fuses the residual's ``g - q x scale`` into one FMA,
    the port rounds the product first), and Adam then moves that parameter
    differently. At most FLIP_SHARE of a leaf's elements may miss RTOL /
    ATOL, and none by more than the STEPS x lr that Adam's steps can move
    a parameter."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(paths, jax.tree_util.tree_leaves(got)):
        w = np.asarray(w)
        bad = ~np.isclose(g, w, rtol=RTOL, atol=ATOL)
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert bad.mean() <= FLIP_SHARE, (name, int(bad.sum()), bad.size)
        assert (np.abs(g - w)[bad] <= STEPS * LR).all(), name


def _jax_run(overlap=False, grad_comm="fp32", ef=False, per_layer=False):
    """The JAX hybrid step at TP2 x DP2: its losses and final params
    (stacked). ``per_layer``: over the per-layer tree the port keeps, the
    loss restacking it, so the optimizer sees (and quantizes) per-layer
    leaves."""
    np_tree, batches = _data()
    cfg = jbloom.BloomConfig(**SIZE, overlap_tp=overlap)
    params = jax.tree_util.tree_map(jnp.asarray, np_tree)
    specs = jbloom.tp_specs(params)
    L = SIZE["n_layer"]

    def restack(p):
        return {**p, "blocks": jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                                      *p["blocks"])}

    if per_layer:
        params = {**params, "blocks": [jax.tree_util.tree_map(lambda a: a[i],
                                                              params["blocks"])
                                       for i in range(L)]}
        one = jax.tree_util.tree_map(lambda s: jax.sharding.PartitionSpec(*s[1:]),
                                     specs["blocks"],
                                     is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        specs = {**specs, "blocks": [one] * L}
    ctx = JaxContext(tensor_parallel_size=2, data_parallel_size=2)
    try:
        def loss_fn(p, ids):
            return jbloom.loss_fn(restack(p) if per_layer else p, ids, None, ids, cfg,
                                  tp_axis="tensor")

        opt = JaxZero(optax.adam(LR), axis_name="data", grad_comm=grad_comm,
                      error_feedback=ef)
        init_fn, make_step = jax_hybrid_step(loss_fn, specs, opt, ctx,
                                             overlap_tp=overlap)
        p = jax.tree_util.tree_map(jnp.copy, params)
        state = init_fn(p)
        step = make_step(p)
        losses = []
        for ids in batches:
            p, state, loss = step(p, state, jnp.asarray(ids))
            losses.append(float(loss))
        if per_layer:
            p = restack(p)
        return losses, jax.tree_util.tree_map(np.asarray, p)
    finally:
        ctx.destroy()


def _gap(a, b):
    return max(abs(x - y) for x, y in zip(a, b))


def _check_overlap(ranks):
    for r in ranks[1:]:
        assert r["overlap"]["losses"] == ranks[0]["overlap"]["losses"]
    got, mono = ranks[0]["overlap"], ranks[0]["fp32"]
    assert mono["losses"][-1] < mono["losses"][0], "the reference must learn"
    np.testing.assert_allclose(got["losses"], mono["losses"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    _close_trees(got["params"], mono["params"], "overlap vs monolithic")
    want_losses, want_params = _jax_run(overlap=True)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=RTOL, atol=ATOL)
    _close_trees(got["params"], want_params, "overlap vs the JAX overlap step")
    assert ranks[0]["probe"] is not None and "overlap_tp" in ranks[0]["probe"]
    # JAX raises the same error for the same batch
    cfg = jbloom.BloomConfig(**SIZE, overlap_tp=True)
    ctx = JaxContext(tensor_parallel_size=2, data_parallel_size=2)
    try:
        params = jax.tree_util.tree_map(jnp.asarray, _data()[0])
        init_fn, make_step = jax_hybrid_step(
            lambda p, ids: jbloom.loss_fn(p, ids, None, ids, cfg, tp_axis="tensor"),
            jbloom.tp_specs(params), JaxZero(optax.adam(LR), axis_name="data"), ctx)
        state = init_fn(params)
        try:
            make_step(params)(params, state, jnp.zeros((BATCH, 7), jnp.int32))
            raise AssertionError("JAX accepted an indivisible sequence")
        except ValueError as e:
            assert str(e) == ranks[0]["probe"]
    finally:
        ctx.destroy()


def _check_compressed_vs_jax(ranks):
    for name, _, comm, ef in RUNS[2:]:
        for r in ranks[1:]:
            assert r[name]["losses"] == ranks[0][name]["losses"], name
        got = ranks[0][name]
        want_losses, want_params = _jax_run(grad_comm=comm, ef=ef, per_layer=True)
        np.testing.assert_allclose(got["losses"], want_losses, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        _close_with_flips(got["params"], want_params, f"{name} vs JAX on the port layout")


def _check_compressed_vs_fp32(ranks):
    out = ranks[0]
    ref = out["fp32"]["losses"]
    assert ref[-1] < ref[0]
    for name in ("int8", "bf16", "int8_ef", "bf16_ef"):
        assert _gap(out[name]["losses"], ref) < GAP, (name, out[name]["losses"], ref)
    assert _gap(out["int8_ef"]["losses"], ref) <= _gap(out["int8"]["losses"], ref) + 1e-5
    # the compressed runs really rounded: their params differ from float32's
    for name in ("int8", "bf16"):
        diff = [float(np.abs(a - b).max()) for a, b in zip(
            jax.tree_util.tree_leaves(out[name]["params"]),
            jax.tree_util.tree_leaves(out["fp32"]["params"]))]
        assert max(diff) > 0, name


def _check_checkpoint(ranks):
    for r in ranks:
        assert r["ef_equal"], "ZeroState.ef did not restore bit for bit"
        assert r["other_dp"] is not None and "ef" in r["other_dp"], r["other_dp"]


def test_comm_engine_in_the_hybrid_step_matches_jax(devices, tmp_path):
    """One 4-rank spawn (a test of its own, so that no two workers spawn it)
    read four ways."""
    ranks = _spawn(str(tmp_path / "ckpt"))
    _check_overlap(ranks)
    _check_compressed_vs_jax(ranks)
    _check_compressed_vs_fp32(ranks)
    _check_checkpoint(ranks)


def test_bf16_is_the_optimizer_field_the_step_swaps():
    """``make_hybrid_train_step(grad_comm=)`` swaps a copy's wire precision,
    as JAX's does, and keeps the caller's optimizer."""
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam

    opt = DistributedOptimizer(adam(LR), "data", "int8", True)
    swapped = opt.replace(grad_comm="bf16")
    jopt = JaxZero(optax.adam(LR), "data", "int8", True).replace(grad_comm="bf16")
    assert (swapped.grad_comm, swapped.error_feedback) == (jopt.grad_comm,
                                                           jopt.error_feedback)
    assert opt.grad_comm == "int8"
