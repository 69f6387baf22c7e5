"""The per-rank bodies of the port's DiLoCo gloo tests.

``run_ranks`` pickles a rank body into spawned processes, which import this
module by name: it imports torch, numpy and the port only, never JAX. The
JAX side of each comparison lives in ``test_torch_diloco.py``. Each body
returns, per inner step, the loss, and per round the worker's parameters
before the sync, the anchor after it and the worker after it, in the JAX
layout (gathered whole where the worker's ranks shard them).
"""
import numpy as np
import torch

from pipegoose_tpu_torch.distributed import ParallelContext


def _jax_tree(params, specs=None):
    from pipegoose_tpu_torch.models.weights import params_to_jax
    from pipegoose_tpu_torch.nn.parallel import unshard_tree

    return params_to_jax(params if specs is None else unshard_tree(params, specs))


def diloco_plain_rank(rank, world, np_tree, cfg, ids, rounds, sync_every):
    """:class:`DiLoCo` at data ``world`` (Adam 1e-3 inside, the default
    outer optimizer) on BLOOM: each worker trains on its rows of ``ids``."""
    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.optim import DiLoCo, adam, outer_optimizer

    torch.manual_seed(0)
    ctx = ParallelContext(data_parallel_size=world, device="cpu")
    try:
        anchor = params_from_jax(np_tree, cfg, device="cpu")
        dl = DiLoCo(lambda p, batch: bloom.loss_fn(p, batch, None, batch, cfg), adam(1e-3),
                    outer_optimizer(lr=0.7), sync_every=sync_every)
        wp, inner, outer = dl.init(anchor)
        step, sync = dl.make_inner_step(wp), dl.make_sync_step(anchor)
        losses, workers, anchors, after = [], [], [], []
        for _ in range(rounds):
            for _ in range(dl.sync_every):
                wp, inner, loss = step(wp, inner, ids)
                losses.append(loss.item())
            workers.append(_jax_tree(wp))
            anchor, wp, outer = sync(anchor, wp, outer)
            anchors.append(_jax_tree(anchor))
            after.append(_jax_tree(wp))
        return dict(losses=losses, workers=workers, anchors=anchors, after=after)
    finally:
        ctx.destroy()


def diloco_hybrid_bloom_rank(rank, world, np_tree, cfg, batches, metric_pmeans):
    """:class:`DiLoCoHybrid` at diloco 2 x data 2 on BLOOM (ZeRO-1 Adam 1e-3
    over "data" inside each worker), one round of ``len(batches)`` inner
    steps and a sync, for each ``metric_pmean``; then the same inner steps
    as the plain hybrid step on this worker's rows (the standalone
    worker), whose parameters the round's must equal bit for bit."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.optim import DiLoCoHybrid, DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step

    torch.set_num_threads(1)
    ctx = ParallelContext(diloco_parallel_size=2, data_parallel_size=2, device="cpu")
    try:
        def lf(p, batch):
            return bloom.loss_fn(p, batch, None, batch, cfg)

        out = {"worker": axis_index("diloco"), "runs": []}
        for metric_pmean in metric_pmeans:
            anchor = params_from_jax(np_tree, cfg, device="cpu")
            specs = bloom.tp_specs(anchor)
            dl = DiLoCoHybrid(lf, specs, DistributedOptimizer(adam(1e-3), axis_name="data"),
                              metric_pmean=metric_pmean)
            wp, inner, outer = dl.init(anchor)
            step = dl.make_inner_step(wp)
            losses = [step(wp, inner, b)[2] for b in batches]
            worker = _jax_tree(wp)
            anchor, wp, outer = dl.make_sync_step(anchor)(anchor, wp, outer)
            out["runs"].append(dict(losses=np.stack([x.numpy() for x in losses]),
                                    worker=worker, anchor=_jax_tree(anchor),
                                    after=_jax_tree(wp)))
        # the standalone worker: the plain hybrid step on this worker's rows
        params = params_from_jax(np_tree, cfg, device="cpu")
        init_fn, make_step = make_hybrid_train_step(
            lf, bloom.tp_specs(params), DistributedOptimizer(adam(1e-3), axis_name="data"),
            batch_spec=(("diloco", "data"),))
        state, step = init_fn(params), make_step(params)
        for b in batches:
            params, state, _ = step(params, state, b)
        out["standalone"] = _jax_tree(params)
        return out
    finally:
        ctx.destroy()


def diloco_hybrid_mixtral_rank(rank, world, np_tree, cfg, batches):
    """:class:`DiLoCoHybrid` at diloco 2 x expert 2 on Mixtral: each worker's
    experts over "expert" (its half of the batch routed over ``all_to_all``),
    the batch cut over ("diloco", "expert"), the trunk gradients averaged
    over "expert", ZeRO-1 Adam 1e-3 (one data rank); one round and a sync."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models import mixtral
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.optim import DiLoCoHybrid, DistributedOptimizer, adam

    torch.set_num_threads(1)
    ctx = ParallelContext(diloco_parallel_size=2, expert_parallel_size=2, device="cpu")
    try:
        anchor = params_from_jax(np_tree, cfg, device="cpu", specs=mixtral.specs(np_tree))
        specs = mixtral.specs(anchor)

        def lf(p, batch):
            return mixtral.loss_fn(p, batch, None, batch, cfg, tp_axis="tensor",
                                   ep_axis="expert", train=False)

        dl = DiLoCoHybrid(lf, specs, DistributedOptimizer(adam(1e-3), axis_name="data"),
                          batch_spec=(("diloco", "expert"),), loss_axis=("expert",),
                          grad_sync_axes=(("expert", "mean"),))
        wp, inner, outer = dl.init(anchor)
        step = dl.make_inner_step(wp)
        losses = [step(wp, inner, b)[2].item() for b in batches]
        worker = _jax_tree(wp, specs)
        anchor, wp, outer = dl.make_sync_step(anchor)(anchor, wp, outer)
        return dict(worker_index=axis_index("diloco"), losses=losses, worker=worker,
                    anchor=_jax_tree(anchor, specs), after=_jax_tree(wp, specs))
    finally:
        ctx.destroy()


def diloco_layout_rank(rank, world, w, dp, tp):
    """The context at diloco ``w`` x data ``dp`` x tensor ``tp``: every
    mode's local rank, group, first/last flags, and an all_reduce of the
    global rank over each group."""
    from pipegoose_tpu_torch.distributed import ParallelMode
    from pipegoose_tpu_torch.distributed import functional as F

    ctx = ParallelContext(diloco_parallel_size=w, data_parallel_size=dp,
                          tensor_parallel_size=tp, device="cpu")
    try:
        row = {}
        for mode in ParallelMode:
            axis = None if mode == ParallelMode.GLOBAL else mode.axis_name
            total = (F.all_reduce(torch.tensor([float(rank)]), axis) if axis
                     else torch.tensor([float(sum(range(world)))]))
            row[mode.value] = (ctx.get_local_rank(mode), ctx.get_ranks_in_group(mode),
                               float(total[0]), ctx.is_first_rank(mode),
                               ctx.is_last_rank(mode))
        return row
    finally:
        ctx.destroy()
