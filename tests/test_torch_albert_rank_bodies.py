"""The per-rank bodies of the port's ALBERT gloo tests.

``run_ranks`` pickles a rank body into spawned processes, which import this
module by name: it imports torch, numpy and the port only, never JAX. The
JAX side of each comparison lives in ``test_torch_albert_ranks.py``. Inputs
arrive as numpy arrays (ids, the attention mask and the label mask of the
whole batch); each body returns losses and gradients (or parameters) in the
JAX layout.
"""
import numpy as np
import torch

from pipegoose_tpu_torch.distributed import ParallelContext


def _t(x):
    return torch.from_numpy(np.array(x)).long()


def _trainable(np_tree, cfg, specs=None):
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    params = params_from_jax(np_tree, cfg, device="cpu", specs=specs)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _synced_grads(params, axes):
    """Every gradient summed over ``axes`` (each parameter is replicated
    there), in the JAX layout."""
    from pipegoose_tpu_torch.models import albert
    from pipegoose_tpu_torch.models.weights import grads_of, params_to_jax
    from pipegoose_tpu_torch.parallel.hybrid import sync_replicated_grads

    return params_to_jax(sync_replicated_grads(grads_of(params), albert.tp_specs(params),
                                               tuple((ax, "sum") for ax in axes)))


def albert_tp_dp_rank(rank, world, np_tree, cfg, ids, mask_id, masked, steps):
    """TP2 x DP2: ``fill_mask`` on this rank's tensor shard of the tree
    (``tp_axis="tensor"``), then ``steps`` hybrid steps (ZeRO-1 Adam 1e-3
    over "data", the batch cut over "data"). The filled ids, the losses
    and the whole tree after the steps, gathered from the shards."""
    from pipegoose_tpu_torch.models import albert
    from pipegoose_tpu_torch.models.weights import params_from_jax, params_to_jax
    from pipegoose_tpu_torch.nn.parallel import unshard_tree
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step

    torch.manual_seed(0)
    ctx = ParallelContext(tensor_parallel_size=2, data_parallel_size=2, device="cpu")
    try:
        params = params_from_jax(np_tree, cfg, device="cpu", specs=albert.tp_specs(np_tree))
        specs = albert.tp_specs(params)
        filled = albert.fill_mask(params, _t(masked), mask_id, cfg, tp_axis="tensor")

        def lf(p, batch):
            return albert.loss_fn(p, batch, None, batch, cfg, tp_axis="tensor")

        init_fn, make_step = make_hybrid_train_step(
            lf, specs, DistributedOptimizer(adam(1e-3), axis_name="data"))
        state = init_fn(params)
        step = make_step(params)
        losses = []
        for _ in range(steps):
            params, state, loss = step(params, state, ids)
            losses.append(loss.item())
        return dict(filled=filled, losses=losses,
                    params=params_to_jax(unshard_tree(params, specs)))
    finally:
        ctx.destroy()


def albert_pp_rank(rank, world, np_tree, cases, ids, mask, lmask):
    """pp 2: each case ((config, "gpipe" | "1f1b", M, stage_layer_counts))
    on the whole (pipe-replicated) tree; the loss and the gradients summed
    over "pipe"."""
    from pipegoose_tpu_torch.models import albert

    ctx = ParallelContext(pipeline_parallel_size=world, device="cpu")
    try:
        out = []
        for cfg, kind, M, counts in cases:
            params = _trainable(np_tree, cfg)
            fn = albert.loss_fn_pp if kind == "gpipe" else albert.loss_fn_1f1b
            loss = fn(params, _t(ids), _t(mask), _t(ids), cfg, M,
                      stage_layer_counts=counts, label_mask=_t(lmask))
            loss.backward()
            out.append(dict(loss=loss.item(), grads=_synced_grads(params, ("pipe",))))
        return out
    finally:
        ctx.destroy()


def _chunk(a, r, n):
    s = a.shape[1] // n
    return _t(a[:, r * s:(r + 1) * s])


def albert_sp_rank(rank, world, np_tree, cases, ids, mask, lmask):
    """sp 2: each case ((config, variant)) on this rank's chunk of the
    sequence through ``loss_fn_sp``; the loss and the gradients summed over
    "seq"."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models import albert

    ctx = ParallelContext(sequence_parallel_size=world, device="cpu")
    try:
        r = axis_index("seq")
        t, m, lm = (_chunk(a, r, world) for a in (ids, mask, lmask))
        out = []
        for cfg, variant in cases:
            params = _trainable(np_tree, cfg)
            loss = albert.loss_fn_sp(params, t, m, t, cfg, label_mask=lm, variant=variant)
            loss.backward()
            out.append(dict(loss=loss.item(), grads=_synced_grads(params, ("seq",))))
        return out
    finally:
        ctx.destroy()


def albert_pp_sp_rank(rank, world, np_tree, cfg, ids, mask, lmask, M):
    """PP2 x SP2: ``loss_fn_pp_sp`` on this rank's sequence chunk; the loss
    and the gradients summed over "pipe" and "seq"."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models import albert

    ctx = ParallelContext(pipeline_parallel_size=2, sequence_parallel_size=2, device="cpu")
    try:
        r = axis_index("seq")
        t, m, lm = (_chunk(a, r, 2) for a in (ids, mask, lmask))
        params = _trainable(np_tree, cfg)
        loss = albert.loss_fn_pp_sp(params, t, m, t, cfg, M, label_mask=lm)
        loss.backward()
        return dict(loss=loss.item(), grads=_synced_grads(params, ("pipe", "seq")))
    finally:
        ctx.destroy()
