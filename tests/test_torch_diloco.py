"""The port's DiLoCo (``optim/diloco.py``) held against the JAX package.

- ``outer_optimizer``: four steps of SGD with Nesterov momentum on the same
  gradients against ``optax.sgd(0.7, 0.9, nesterov=True)``;
- :class:`DiLoCo` at data 2 (``tests/optim/test_diloco.py``'s setup: BLOOM
  vocab 64, H 32, 2 layers, Adam 1e-3, 3 inner steps a round, 2 rounds, 8 x
  8 ids) against JAX's ``DiLoCo``: every inner loss, each worker before the
  sync, the anchor after it, and every worker equal to the anchor after it;
- :class:`DiLoCoHybrid` at diloco 2 x data 2 (``tests/optim/
  test_diloco_4d.py``'s BLOOM, 3 inner steps) against JAX's, with
  ``metric_pmean`` True (the global loss) and False (each worker's), and
  each worker's inner steps equal to the plain hybrid step on its own rows
  bit for bit; Mixtral at diloco 2 x expert 2 against JAX's.

Tolerances: losses 2e-5 absolute; worker parameters after Adam steps
``rtol 2e-4, atol 2e-5`` (``test_diloco_4d.py``'s); the outer step and the
anchor ``rtol 2e-5, atol 2e-6`` of what it would be from the workers (the
outer update's own arithmetic), and ``rtol 2e-4, atol 2e-5`` against JAX's
anchor (it carries the workers' difference). Weights from the port's
``init_params_numpy`` (numpy seeds), float32; one spawn per test, the rank
bodies in ``test_torch_diloco_rank_bodies.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.sharding import PartitionSpec as P

from pipegoose_tpu.distributed import ParallelContext as JaxContext
from pipegoose_tpu.models import bloom as jb
from pipegoose_tpu.models import mixtral as jm
from pipegoose_tpu.optim import diloco as jd
from pipegoose_tpu.optim.zero import DistributedOptimizer as JaxZero
from pipegoose_tpu_torch.models import bloom as tb
from pipegoose_tpu_torch.models import mixtral as tm
from pipegoose_tpu_torch.optim import outer_optimizer
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_diloco_rank_bodies import (
    diloco_hybrid_bloom_rank,
    diloco_hybrid_mixtral_rank,
    diloco_plain_rank,
)

LOSS_ATOL = 2e-5
H = 3   # inner steps a round


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, rtol, atol, what):
    flat = jax.tree_util.tree_leaves(got)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _equal(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y)


def _worker(tree, w):
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[w], tree)


def _nesterov(anchor, workers):
    """optax's outer step from the first round: anchor - lr (g + m g), g =
    anchor - mean(workers), computed leaf by leaf in numpy."""
    return jax.tree_util.tree_map(
        lambda a, *ws: a - 0.7 * ((a - np.mean(ws, 0)) * 1.9), anchor, *workers)


def test_outer_optimizer_matches_optax_sgd_nesterov():
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 7), dtype=np.float32)
    grads = rng.standard_normal((4, 5, 7), dtype=np.float32)
    opt = optax.sgd(0.7, momentum=0.9, nesterov=True)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    tp = torch.from_numpy(p0.copy())
    topt = outer_optimizer()([tp])
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g.copy())
        topt.step()
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def test_diloco_plain_at_data2_matches_jax(devices):
    size = dict(vocab_size=64, hidden_size=32, n_layer=2, n_head=2)
    tree = tb.init_params_numpy(tb.BloomConfig(**size), seed=0)
    ids = np.random.RandomState(0).randint(0, 64, (8, 8))
    jcfg = jb.BloomConfig(**size)
    ctx = JaxContext(data_parallel_size=2, devices=jax.devices()[:2])
    try:
        dl = jd.DiLoCo(lambda p, i: jb.loss_fn(p, i, None, i, jcfg), optax.adam(1e-3),
                       jd.outer_optimizer(lr=0.7), sync_every=H, parallel_context=ctx)
        anchor = _j(tree)
        wp, inner, outer = dl.init(anchor)
        step, sync = dl.make_inner_step(wp), dl.make_sync_step(wp)
        losses, workers, anchors = [], [], []
        for _ in range(2):
            for _ in range(H):
                wp, inner, loss = step(wp, inner, jnp.asarray(ids))
                losses.append(float(loss))
            workers.append(jax.tree_util.tree_map(np.asarray, wp))
            anchor, wp, outer = sync(anchor, wp, outer)
            anchors.append(jax.tree_util.tree_map(np.asarray, anchor))
    finally:
        ctx.destroy()
    ranks = run_ranks(diloco_plain_rank, 2, tree, tb.BloomConfig(**size), ids, 2, H)
    for w, r in enumerate(ranks):
        np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=LOSS_ATOL)
        for k in range(2):
            _close(r["workers"][k], _worker(workers[k], w), 2e-4, 2e-5, f"worker {w} round {k}")
            _close(r["anchors"][k], anchors[k], 2e-4, 2e-5, f"anchor round {k}")
            _equal(r["after"][k], r["anchors"][k])
    # the first outer step, from the port's own workers
    _close(ranks[0]["anchors"][0], _nesterov(tree, [r["workers"][0] for r in ranks]),
           2e-5, 2e-6, "outer step")
    assert losses[-1] < losses[0]
    w0, w1 = (r["workers"][0]["blocks"]["attn"]["qkv"]["kernel"] for r in ranks)
    assert np.abs(w0 - w1).max() > 0   # the workers diverged between syncs


def _jax_hybrid(loss_fn, specs, ctx, **kw):
    return jd.DiLoCoHybrid(loss_fn, specs, JaxZero(optax.adam(1e-3), axis_name="data"),
                           parallel_context=ctx, **kw)


def _run_jax_round(dl, tree, batches):
    """One round of JAX's DiLoCoHybrid and its sync: (losses, workers before
    the sync, anchor after it)."""
    params = _j(tree)
    wp, inner, outer = dl.init(params)
    step = dl.make_inner_step(params)
    losses = []
    for b in batches:
        wp, inner, loss = step(wp, inner, jnp.asarray(b))
        losses.append(np.asarray(loss))
    workers = jax.tree_util.tree_map(np.asarray, wp)
    anchor, wp, outer = dl.make_sync_step(params)(params, wp, outer)
    return np.stack(losses), workers, jax.tree_util.tree_map(np.asarray, anchor)


def test_diloco_hybrid_bloom_diloco2_data2_matches_jax(devices):
    size = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
    tree = tb.init_params_numpy(tb.BloomConfig(**size), seed=0)
    jcfg = jb.BloomConfig(**size)
    raw = np.random.RandomState(5).randint(0, 128, (H, 2, 8, 16))
    batches = [raw[t].reshape(-1, 16) for t in range(H)]   # worker w: rows 8w..8w+7
    ctx = JaxContext(diloco_parallel_size=2, data_parallel_size=2, devices=jax.devices()[:4])
    try:
        specs = jb.tp_specs(_j(tree))
        want = {}
        for metric_pmean in (True, False):
            dl = _jax_hybrid(lambda p, i: jb.loss_fn(p, i, None, i, jcfg), specs, ctx,
                             metric_pmean=metric_pmean)
            want[metric_pmean] = _run_jax_round(dl, tree, batches)
    finally:
        ctx.destroy()
    ranks = run_ranks(diloco_hybrid_bloom_rank, 4, tree, tb.BloomConfig(**size), batches,
                      (True, False))
    for r in ranks:
        w = r["worker"]
        for run, metric_pmean in zip(r["runs"], (True, False)):
            losses, workers, anchor = want[metric_pmean]
            if metric_pmean:   # the global loss
                np.testing.assert_allclose(run["losses"], losses, rtol=0, atol=LOSS_ATOL)
            else:              # this worker's own, a (1,) entry of JAX's (W,)
                np.testing.assert_allclose(run["losses"][:, 0], losses[:, w], rtol=0,
                                           atol=LOSS_ATOL)
            _close(run["worker"], _worker(workers, w), 2e-4, 2e-5, f"worker {w}")
            _close(run["anchor"], anchor, 2e-4, 2e-5, "anchor")
            _equal(run["after"], run["anchor"])
            _equal(run["worker"], r["standalone"])
        pm, own = r["runs"][0]["losses"], want[False][0]
        np.testing.assert_allclose(pm, own.mean(1), rtol=0, atol=LOSS_ATOL)
    workers = {r["worker"]: r["runs"][0]["worker"] for r in ranks}
    _close(ranks[0]["runs"][0]["anchor"], _nesterov(tree, [workers[0], workers[1]]),
           2e-5, 2e-6, "outer step")
    k = lambda t: t["blocks"]["attn"]["qkv"]["kernel"]   # noqa: E731
    assert np.abs(k(workers[0]) - k(workers[1])).max() > 0


def test_diloco_hybrid_mixtral_diloco2_expert2_matches_jax(devices):
    size = dict(vocab_size=128, hidden_size=64, intermediate_size=112, n_layer=2, n_head=4,
                n_kv_head=2, num_experts=4, top_k=2, aux_loss_weight=0.0,
                z_loss_weight=0.001)
    tree = tm.init_params_numpy(tm.MixtralConfig(**size), seed=1)
    jcfg = jm.MixtralConfig(**size)
    ids = np.random.RandomState(9).randint(0, 128, (8, 16))
    batches = [ids, ids[::-1].copy()]
    ctx = JaxContext(diloco_parallel_size=2, expert_parallel_size=2,
                     devices=jax.devices()[:4])
    try:
        dl = _jax_hybrid(
            lambda p, i: jm.loss_fn(p, i, None, i, jcfg, tp_axis="tensor",
                                    ep_axis="expert", train=False),
            jm.specs(_j(tree)), ctx, batch_spec=P(("diloco", "expert")),
            loss_axis=("expert",), grad_sync_axes=(("expert", "mean"),))
        losses, workers, anchor = _run_jax_round(dl, tree, batches)
    finally:
        ctx.destroy()
    ranks = run_ranks(diloco_hybrid_mixtral_rank, 4, tree, tm.MixtralConfig(**size),
                      batches)
    for r in ranks:
        w = r["worker_index"]
        np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=LOSS_ATOL)
        _close(r["worker"], _worker(workers, w), 2e-4, 2e-5, f"worker {w}")
        _close(r["anchor"], anchor, 2e-4, 2e-5, "anchor")
        _equal(r["after"], r["anchor"])
    assert all(np.isfinite(losses))
