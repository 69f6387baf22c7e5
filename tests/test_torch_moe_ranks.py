"""The port's expert parallelism on gloo ranks, held against the JAX package.

- ``moe_layer`` at ep 4 x dp 2 (8 ranks, each expert coordinate routing its
  own token shard, the experts sharded over "expert", ``all_to_all``
  dispatch) against the port at ep = 1 on each shard and against JAX's
  ``shard_map`` (``tests/nn/expert_parallel/test_experts.py:55-85``; rtol
  2e-4, atol 1e-5); the gradients of the local experts (every rank's tokens
  reach them through the ``all_to_all`` backward) and of the tokens against
  the ep = 1 port (same tolerances); ``ExpertParallel`` refuses 6 experts
  over 4 ranks.
- BLOOM-MoE at EP2 x TP2 x DP2: each rank's local batch (dim 0 cut
  data-major, then by expert, as JAX's device order), loss and gradient
  shard against JAX's ``shard_map`` ``value_and_grad``
  (``tests/models/test_bloom_moe.py:45-84``; the loss within 2e-4, each
  gradient within 2e-4 of its leaf's largest value); ``params_from_jax(
  specs=moe_specs(np_tree))`` gathered back by ``unshard_tree`` is the whole
  tree, bit for bit.
- Three ZeRO-1 SGD (0.05) steps at EP2 x TP2 x DP2 through
  ``make_hybrid_train_step`` with the aux weight at 0 (the aux loss is not
  linear in the batch), against JAX's single-device run
  (``tests/models/test_bloom_moe.py:86-162``: losses rtol 5e-3 / atol 5e-4,
  params rtol 1e-2 / atol 1e-3) and against JAX's hybrid step on the same
  mesh (rtol 2e-3, atol 2e-4); each expert leaf's ZeRO shard is ceil(E_local
  / dp) of its own dim 0. In the same spawn, two steps of
  ``Trainer.fit(with_rng=True)`` with router noise: finite losses, seed 5
  twice bit for bit, seed 6 different, the replicated trunk equal on every
  expert rank.

Tiny BLOOM-MoE as ``tests/models/test_bloom_moe.py`` (vocab 128, hidden 64,
2 layers, 4 heads, 4 experts, top-1, capacity factor 4.0, no noise), B = 8 x
S = 12, weights and data from numpy seeds, float32. One spawn per test
function; the rank bodies live in ``test_torch_moe_rank_bodies.py``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import PartitionSpec as P

from pipegoose_tpu.distributed import ParallelContext as JaxContext
from pipegoose_tpu.distributed.compat import shard_map
from pipegoose_tpu.models import bloom_moe as jmoe
from pipegoose_tpu.nn.expert_parallel import experts as jex
from pipegoose_tpu.nn.expert_parallel import routers as jr
from pipegoose_tpu.optim.zero import DistributedOptimizer as JaxZero
from pipegoose_tpu.parallel import make_hybrid_train_step as jax_hybrid_step
from pipegoose_tpu_torch.models import bloom_moe as tmoe
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_moe_rank_bodies import ep_tp_loss_rank, moe_layer_rank, zero_steps_rank

SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4, num_experts=4, top_k=1,
            capacity_factor=4.0, router_noise_eps=0.0)
B, S = 8, 12
DEV_SPEC = P(("data", "expert", "tensor"))   # one row per device, in the port's rank order


def _cfgs(**kw):
    return jmoe.BloomMoEConfig(**SIZE, **kw), tmoe.BloomMoEConfig(**SIZE, **kw)


def _tree():
    return tmoe.init_params_numpy(tmoe.BloomMoEConfig(**SIZE), seed=0)


def _ids(seed=5):
    return np.random.RandomState(seed).randint(0, SIZE["vocab_size"], (B, S)).astype(np.int32)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _is_spec(x):
    return isinstance(x, P)


# -- moe_layer at ep 4 x dp 2 ------------------------------------------------------------

H, E, T, FFN = 8, 4, 16, 32


def test_moe_layer_ep4_dp2_matches_ep1_and_jax(devices):
    import torch

    from pipegoose_tpu_torch.nn.expert_parallel import TopKRouter, moe_layer

    rng = np.random.default_rng(0)
    experts = {"up": {"kernel": rng.standard_normal((E, H, FFN)).astype(np.float32) * 0.3,
                      "bias": rng.standard_normal((E, FFN)).astype(np.float32) * 0.1},
               "down": {"kernel": rng.standard_normal((E, FFN, H)).astype(np.float32) * 0.3,
                        "bias": rng.standard_normal((E, H)).astype(np.float32) * 0.1}}
    gate = {"gate": {"kernel": rng.standard_normal((H, E)).astype(np.float32)}}
    xs = rng.standard_normal((4, T // 4, H)).astype(np.float32)
    ct = rng.standard_normal(xs.shape).astype(np.float32)
    router_kw = dict(num_experts=E, top_k=1, noise=None, capacity_factor=10.0)
    ranks = run_ranks(moe_layer_rank, 8, experts, gate, xs, ct, router_kw, timeout=300)

    # the JAX shard_map of test_experts.py:55-85
    ctx = JaxContext(expert_parallel_size=4, data_parallel_size=2)
    try:
        jrouter = jr.TopKRouter(**router_kw)
        espec = {"up": {"kernel": P("expert"), "bias": P("expert")},
                 "down": {"kernel": P("expert"), "bias": P("expert")}}
        fn = jax.jit(shard_map(
            lambda xs, ex: jex.moe_layer(ex, xs.reshape(-1, H),
                                         jrouter(_j(gate), xs.reshape(-1, H)),
                                         axis_name="expert").reshape(1, T // 4, H),
            mesh=ctx.mesh, in_specs=(P("expert"), espec), out_specs=P("expert"),
            check_vma=False))
        jout = np.asarray(fn(jnp.asarray(xs), _j(experts)))
    finally:
        ctx.destroy()

    # the port at ep = 1 on each shard: outputs, and the gradients of the sum
    # over the shards (every shard's tokens reach every expert)
    tex = {k: {n: torch.tensor(v).requires_grad_(True) for n, v in d.items()}
           for k, d in experts.items()}
    ref_out, ref_dx = [], []
    for r in range(4):
        x = torch.tensor(xs[r]).requires_grad_(True)
        out = moe_layer(tex, x, TopKRouter(**router_kw)(
            {"gate": {"kernel": torch.tensor(gate["gate"]["kernel"])}}, x), axis_name=None)
        (out * torch.from_numpy(ct[r])).sum().backward()
        ref_out.append(out.detach().numpy())
        ref_dx.append(x.grad.numpy())
    for rank, (out, grads, dx, refused) in enumerate(ranks):
        e = rank % 4   # ep 4, tp 1: rank = data * 4 + expert
        np.testing.assert_allclose(out, jout[e], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(out, ref_out[e], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(dx, ref_dx[e], rtol=2e-4, atol=1e-5)
        for k in ("up", "down"):
            for n in ("kernel", "bias"):
                np.testing.assert_allclose(grads[k][n], tex[k][n].grad.numpy()[e:e + 1],
                                           rtol=2e-4, atol=1e-5, err_msg=f"{k}/{n}")
        assert refused


# -- BLOOM-MoE at EP2 x TP2 x DP2 ----------------------------------------------------------


def _jax_per_device(params, ids, cfg):
    """JAX's loss and local gradients on every device of the (data, expert,
    tensor) = (2, 2, 2) mesh, stacked in the port's rank order."""
    ctx = JaxContext(tensor_parallel_size=2, expert_parallel_size=2, data_parallel_size=2)
    try:
        specs = jmoe.moe_specs(params)

        def f(p, ids):
            loss, g = jax.value_and_grad(lambda p: jmoe.loss_fn(
                p, ids, None, ids, cfg, tp_axis="tensor", ep_axis="expert",
                train=False))(p)
            return loss[None], jax.tree_util.tree_map(lambda x: x[None], g)

        fn = jax.jit(shard_map(
            f, mesh=ctx.mesh, in_specs=(specs, P(("data", "expert"))),
            out_specs=(DEV_SPEC, jax.tree_util.tree_map(lambda _: DEV_SPEC, specs,
                                                        is_leaf=_is_spec)),
            check_vma=False))
        loss, grads = fn(params, jnp.asarray(ids))
        return np.asarray(loss), jax.tree_util.tree_map(np.asarray, grads)
    finally:
        ctx.destroy()


def test_ep2_tp2_dp2_loss_and_gradient_shards_match_jax(devices):
    jcfg, tcfg = _cfgs()
    tree, ids = _tree(), _ids()
    ranks = run_ranks(ep_tp_loss_rank, 8, tree, tcfg, ids, timeout=300)
    jloss, jgrads = _jax_per_device(_j(tree), ids, jcfg)
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for rank, (local, loss, grads, whole) in enumerate(ranks):
        data, expert = rank // 4, (rank // 2) % 2
        shard = 2 * data + expert   # data-major, then expert: 2 rows each
        np.testing.assert_array_equal(local, ids[2 * shard:2 * shard + 2])
        assert abs(float(loss) - float(jloss[rank])) < 2e-4, (rank, loss, jloss[rank])
        flat = jax.tree_util.tree_leaves(grads)
        assert len(flat) == len(paths)
        for (path, w), g in zip(paths, flat):
            w = w[rank]
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * float(np.abs(w).max()),
                                       err_msg=f"rank {rank} {jax.tree_util.keystr(path)}")
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                jax.tree_util.tree_leaves(whole)):
            np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    # the expert leaves' local gradients differ between expert ranks (each
    # holds its own experts), and the loss between token shards
    assert not np.array_equal(ranks[0][2]["blocks"]["moe"]["up"]["kernel"],
                              ranks[2][2]["blocks"]["moe"]["up"]["kernel"])


# -- ZeRO-1 steps and the Trainer ----------------------------------------------------------

STEPS, LR = 3, 0.05


def _jax_single_device(tree, ids, cfg):
    opt = optax.sgd(LR)
    p = _j(tree)
    state = opt.init(p)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda p: jmoe.loss_fn(p, jnp.asarray(ids), None, jnp.asarray(ids), cfg,
                                   train=False))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    losses = []
    for _ in range(STEPS):
        p, state, loss = step(p, state)
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, p)


def _jax_hybrid(tree, ids, cfg):
    ctx = JaxContext(tensor_parallel_size=2, expert_parallel_size=2, data_parallel_size=2)
    try:
        params = _j(tree)
        init_fn, make_step = jax_hybrid_step(
            lambda p, ids: jmoe.loss_fn(p, ids, None, ids, cfg, tp_axis="tensor",
                                        ep_axis="expert", train=False),
            jmoe.moe_specs(params), JaxZero(optax.sgd(LR), axis_name="data"), ctx,
            batch_spec=P(("data", "expert")), loss_axis=("data", "expert"),
            grad_sync_axes=(("expert", "mean"),))
        state = init_fn(params)
        step = make_step(params)
        losses = []
        for _ in range(STEPS):
            params, state, loss = step(params, state, jnp.asarray(ids))
            losses.append(float(loss))
        return losses, jax.tree_util.tree_map(np.asarray, params)
    finally:
        ctx.destroy()


def _close_trees(got, want, rtol, atol, what):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_zero1_steps_track_jax_and_the_trainer_draws_by_seed(devices):
    jcfg, tcfg = _cfgs(aux_loss_weight=0.0)
    tree, ids = _tree(), _ids()
    noisy = dataclasses.replace(tcfg, router_noise_eps=0.1, aux_loss_weight=0.01)
    fit_batches = [_ids(11), _ids(12)]
    ranks = run_ranks(zero_steps_rank, 8, tree, tcfg, [ids] * STEPS, LR, noisy,
                      fit_batches, timeout=300)

    ref_losses, ref_params = _jax_single_device(tree, ids, jcfg)
    assert ref_losses[-1] < ref_losses[0]
    hyb_losses, hyb_params = _jax_hybrid(tree, ids, jcfg)
    losses, final, shard_shapes, fits, _ = ranks[0]
    for r in ranks[1:]:   # every rank returns the same losses and whole params
        assert r[0] == losses
        _close_trees(r[1], final, 0, 0, "a rank vs rank 0")
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-3, atol=5e-4)
    _close_trees(final, ref_params, 1e-2, 1e-3, "vs the JAX single-device run")
    np.testing.assert_allclose(losses, hyb_losses, rtol=2e-3, atol=2e-4)
    _close_trees(final, hyb_params, 2e-3, 2e-4, "vs the JAX hybrid step")
    # ZeRO-1 shards each per-layer leaf on its own dim 0: E_local for an expert leaf
    e_local, dp = SIZE["num_experts"] // 2, 2
    f_local = 4 * SIZE["hidden_size"] // 2
    assert (math.ceil(e_local / dp), SIZE["hidden_size"], f_local) in shard_shapes

    # the Trainer with router noise
    for r in ranks:
        a, b, c = r[3]
        assert len(a) == len(fit_batches) and np.isfinite(a).all()
        assert a == b, "the same seed must give the same losses"
        assert a != c, "another seed must route otherwise"
    for rank, r in enumerate(ranks):   # the trunk is one replica across expert ranks
        twin = rank ^ 2                # the same (data, tensor), the other expert rank
        for x, y in zip(r[4], ranks[twin][4]):
            np.testing.assert_array_equal(x, y)
