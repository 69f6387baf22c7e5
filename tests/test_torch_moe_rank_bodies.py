"""The per-rank bodies of the port's expert-parallel tests.

``run_ranks`` pickles a rank body into spawned processes, which import this
module by name: it imports torch, numpy and the port only, never JAX. The
JAX side of each comparison lives in ``test_torch_moe_ranks.py``. Inputs
arrive as numpy arrays.

A rank's coordinates follow the port's layout, ``rank = data * (ep * tp) +
expert * tp + tensor``, which is also the row order of the JAX side's
per-device outputs (``P(("data", "expert", "tensor"))``).
"""
import numpy as np
import torch

from pipegoose_tpu_torch.distributed import ParallelContext

BATCH_SPEC = (("data", "expert"),)   # dim 0 data-major, then by expert


def _t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).requires_grad_(grad)


def moe_layer_rank(rank, world, experts, gate, xs, ct, router_kw):
    """``moe_layer`` at ep 4 x dp 2: this rank routes its expert
    coordinate's token shard ``xs[e]`` (the data axis replicates it) through
    its E / 4 experts over ``all_to_all``. Returns the output, the
    gradients of ``sum(out * ct[e])`` with respect to the local experts and
    the tokens, and whether ``ExpertParallel`` refuses 6 experts over 4."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.nn.expert_parallel import ExpertParallel, TopKRouter, moe_layer
    from pipegoose_tpu_torch.nn.parallel import shard_tree

    ctx = ParallelContext(expert_parallel_size=4, data_parallel_size=world // 4,
                          device="cpu")
    try:
        e = axis_index("expert")
        specs = {"up": {"kernel": ("expert",), "bias": ("expert",)},
                 "down": {"kernel": ("expert",), "bias": ("expert",)}}
        local = shard_tree(_t(experts), specs)
        for leaf in (local["up"]["kernel"], local["up"]["bias"], local["down"]["kernel"],
                     local["down"]["bias"]):
            leaf.requires_grad_(True)
        x = _t(xs[e], grad=True)
        routing = TopKRouter(**router_kw)(_t(gate), x)
        out = moe_layer(local, x, routing, axis_name="expert")
        (out * torch.from_numpy(ct[e])).sum().backward()
        grads = {k: {n: v.grad for n, v in d.items()} for k, d in local.items()}
        try:
            ExpertParallel(num_experts=6)
            refused = False
        except ValueError:
            refused = True
        return out.detach(), grads, x.grad, refused
    finally:
        ctx.destroy()


def _moe_ctx(world):
    return ParallelContext(tensor_parallel_size=2, expert_parallel_size=2,
                           data_parallel_size=world // 4, device="cpu")


def ep_tp_loss_rank(rank, world, np_tree, cfg, ids):
    """BLOOM-MoE at EP2 x TP2 x DP2: this rank's shard of the weights
    (``params_from_jax(specs=moe_specs(np_tree))``), its part of the batch
    (``_local_batch`` by ``BATCH_SPEC``), the loss and its backward with no
    gradient sync. Returns the local ids, the loss, the local gradients in
    the JAX layout, and the whole tree gathered back from the shards."""
    from pipegoose_tpu_torch.models import bloom_moe
    from pipegoose_tpu_torch.models.weights import grads_of, params_from_jax, params_to_jax
    from pipegoose_tpu_torch.nn.parallel import unshard_tree
    from pipegoose_tpu_torch.parallel.hybrid import _local_batch
    from pipegoose_tpu_torch.trainer.step import make_optimizer

    ctx = _moe_ctx(world)
    try:
        params = params_from_jax(np_tree, cfg, device="cpu",
                                 specs=bloom_moe.moe_specs(np_tree))
        whole = params_to_jax(unshard_tree(params, bloom_moe.moe_specs(params)))
        make_optimizer(params, 1e-3)   # marks the leaves trainable
        local = _local_batch(ids, BATCH_SPEC, ctx, "cpu")
        loss = bloom_moe.loss_fn(params, local, None, local, cfg, tp_axis="tensor",
                                 ep_axis="expert", train=False)
        loss.backward()
        return local, loss.detach(), params_to_jax(grads_of(params)), whole
    finally:
        ctx.destroy()


def _moe_loss(cfg, ep):
    from pipegoose_tpu_torch.core.accumulation import fold_in
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models import bloom_moe

    def loss_fn(p, ids, *rng):
        # examples/moe_training.py: every (data, expert) rank draws its own
        # router noise; the tensor ranks of one token shard draw alike
        seed = (fold_in(rng[0], axis_index("data") * ep + axis_index("expert"))
                if rng else None)
        return bloom_moe.loss_fn(p, ids, None, ids, cfg, tp_axis="tensor",
                                 ep_axis="expert", rng=seed, train=bool(rng))

    return loss_fn


def zero_steps_rank(rank, world, np_tree, cfg, batches, lr, noisy_cfg, fit_batches):
    """(a) ``len(batches)`` ZeRO-1 SGD steps at EP2 x TP2 x DP2 through
    ``make_hybrid_train_step`` (``moe_specs``, ``BATCH_SPEC``, the loss over
    ("data", "expert"), the trunk's gradients averaged over "expert"): the
    losses, the final params gathered whole (JAX layout), each leaf's ZeRO
    shard shape. (b) ``Trainer.fit(with_rng=True)`` with router noise, Adam,
    over ``fit_batches``: seed 5 twice and seed 6, each a fresh Trainer from
    the whole tree; the losses of each and, of the first, this rank's
    replicated trunk leaves (for the check across expert ranks)."""
    from pipegoose_tpu_torch.models import bloom_moe
    from pipegoose_tpu_torch.models.weights import params_from_jax, params_to_jax
    from pipegoose_tpu_torch.nn.parallel import tree_leaves, unshard_tree
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step
    from pipegoose_tpu_torch.trainer import Trainer

    ctx = _moe_ctx(world)
    try:
        ep = ctx.axis_size("expert")
        params = params_from_jax(np_tree, cfg, device="cpu",
                                 specs=bloom_moe.moe_specs(np_tree))
        specs = bloom_moe.moe_specs(params)
        sgd = lambda leaves: torch.optim.SGD(leaves, lr=lr)   # noqa: E731
        init_fn, make_step = make_hybrid_train_step(
            _moe_loss(cfg, ep), specs, DistributedOptimizer(sgd, axis_name="data"), ctx,
            batch_spec=BATCH_SPEC, loss_axis=("data", "expert"),
            grad_sync_axes=(("expert", "mean"),))
        state = init_fn(params)
        step = make_step(params)
        losses = [float(step(params, state, ids)[2]) for ids in batches]
        shard_shapes = [tuple(s.shape) for s in state.shards]
        final = params_to_jax(unshard_tree(params, specs))

        whole = params_from_jax(np_tree, noisy_cfg, device="cpu")
        whole_specs = bloom_moe.moe_specs(whole)
        fits, trunk = [], None
        for seed in (5, 5, 6):
            trainer = Trainer(_moe_loss(noisy_cfg, ep), whole, whole_specs,
                              DistributedOptimizer(adam(1e-3), axis_name="data"), ctx,
                              batch_spec=BATCH_SPEC, loss_axis=("data", "expert"),
                              grad_sync_axes=(("expert", "mean"),), with_rng=True)
            st = trainer.fit(iter(fit_batches), rng=seed)
            fits.append([float(x) for x in st.losses])
            if trunk is None:
                p = trainer.params
                trunk = [t.detach().clone() for t in
                         tree_leaves({"embed": p["embed"], "ln_f": p["ln_f"],
                                      "attn": p["blocks"][0]["attn"],
                                      "router": p["blocks"][-1]["router"]})]
        return losses, final, shard_shapes, fits, trunk
    finally:
        ctx.destroy()
