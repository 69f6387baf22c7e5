"""The per-rank bodies of the port's tensor x data parallel tests.

``run_ranks`` pickles a rank body into spawned processes, which import this
module by name: it imports torch, numpy and the port only, never JAX. The
JAX side of each comparison lives in ``test_torch_hybrid_layers.py`` and
``test_torch_hybrid_step.py``. Inputs arrive as numpy arrays; a per-rank
input is stacked on a leading axis of the world size and each rank takes
its row.
"""
import numpy as np
import torch

from pipegoose_tpu_torch.distributed import ParallelContext

V_GLOBAL = 32      # the layer cases' whole vocabulary
VALID_CUT = 8      # the "_valid" cases: the last VALID_CUT vocabulary slots are padding
CHUNKS = 3         # the "chunked" case's sequence chunks


# -- the layers under an axis -----------------------------------------------------------


def layer_case(kind, x, axis):
    """One layer of ``nn.tensor_parallel.layers`` (or the fused CE) on this
    rank's inputs ``x`` (dict of numpy arrays): its output and the
    gradients of ``sum(output * ct)`` (for the losses, the loss itself)
    with respect to every float input but ``ct``."""
    from pipegoose_tpu_torch.models.bloom import logits_fn
    from pipegoose_tpu_torch.nn.tensor_parallel import layers as L
    from pipegoose_tpu_torch.ops.fused_ce import fused_ce_shifted_loss

    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in x.items()}
    grad_of = [k for k, v in t.items() if v.is_floating_point() and k != "ct"]
    for k in grad_of:
        t[k].requires_grad_(True)
    lin = {k: t[k] for k in ("kernel", "bias") if k in t}
    valid = V_GLOBAL - VALID_CUT if kind.endswith("_valid") else None
    base = kind.removesuffix("_valid")
    if base == "column":
        y = L.column_parallel_linear(lin, t["x"], axis)
    elif base == "row":
        y = L.row_parallel_linear(lin, t["x"], axis)
    elif base == "embedding":
        y = L.vocab_parallel_embedding({"weight": t["weight"]}, t["ids"].long(), axis)
    elif base == "ce":
        y = L.vocab_parallel_cross_entropy(t["logits"], t["targets"].long(), axis,
                                           valid_size=valid)
    elif base == "chunked":
        params = {"embed": {"weight": t["weight"]}}
        tot, cnt = L.chunked_ce_sums(t["hidden"], t["labels"].long(), t["w"],
                                     lambda h: logits_fn(params, h, axis), axis,
                                     valid, CHUNKS)
        y = tot / cnt
    elif base == "fused":
        y = fused_ce_shifted_loss(t["hidden"], t["weight"], t["labels"].long(),
                                  t["mask"], axis, valid)
    else:
        raise ValueError(kind)
    (y * t["ct"]).sum().backward() if "ct" in t else y.backward()
    return y.detach(), {k: t[k].grad for k in grad_of}


def tp_layers_rank(rank, world, cases):
    """Every (kind, stacked inputs) case over a "tensor" axis of ``world``."""
    ctx = ParallelContext(tensor_parallel_size=world, device="cpu")
    try:
        return [layer_case(kind, {k: v[rank] for k, v in xs.items()}, "tensor")
                for kind, xs in cases]
    finally:
        ctx.destroy()


# -- BLOOM under tensor x sequence parallelism -------------------------------------------


def sp_tp_loss_rank(rank, world, np_tree, cases):
    """``loss_fn_sp`` at sp 2 x tp 2 on this rank's sequence chunk and
    tensor shard: the loss and every gradient, summed over "seq" and
    gathered whole over "tensor", in the JAX layout."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models.bloom import loss_fn_sp, tp_specs
    from pipegoose_tpu_torch.models.weights import grads_of, params_from_jax, params_to_jax
    from pipegoose_tpu_torch.nn.parallel import unshard_tree
    from pipegoose_tpu_torch.parallel.hybrid import sync_replicated_grads
    from pipegoose_tpu_torch.trainer.step import make_optimizer

    ctx = ParallelContext(tensor_parallel_size=2, sequence_parallel_size=world // 2,
                          device="cpu")
    try:
        out = []
        sp = world // 2
        seq_rank = axis_index("seq")
        for cfg, ids, mask, labels, variant in cases:
            sl = ids.shape[1] // sp
            part = slice(seq_rank * sl, (seq_rank + 1) * sl)
            params = params_from_jax(np_tree, cfg, device="cpu", specs=tp_specs(np_tree))
            specs = tp_specs(params)
            make_optimizer(params, 1e-3)
            loss = loss_fn_sp(params, torch.from_numpy(ids[:, part]).long(),
                              None if mask is None else torch.from_numpy(mask[:, part]),
                              torch.from_numpy(labels[:, part]).long(), cfg,
                              tp_axis="tensor", sp_axis="seq", variant=variant)
            loss.backward()
            grads = sync_replicated_grads(grads_of(params), specs, (("seq", "sum"),))
            out.append((float(loss), params_to_jax(unshard_tree(grads, specs))))
        return out
    finally:
        ctx.destroy()


# -- the hybrid step ------------------------------------------------------------------------


def _hybrid_params(np_tree, cfg, tp):
    from pipegoose_tpu_torch.models.bloom import tp_specs
    from pipegoose_tpu_torch.models.weights import params_from_jax

    params = params_from_jax(np_tree, cfg, device="cpu", specs=tp_specs(np_tree))
    return params, tp_specs(params)


def hybrid_rank(rank, world, np_tree, runs, tp):
    """Each run ``(cfg, batches, lr, n_accum)`` of the hybrid step at tp x
    (world / tp) with ZeRO-1 over "data": the losses, the whole params
    after the last step (JAX layout), the first step's global gradients
    (mean over "data", gathered whole over "tensor", before any update)
    and loss, and this rank's inner-state elements per leaf."""
    from pipegoose_tpu_torch.distributed.functional import all_reduce
    from pipegoose_tpu_torch.models.bloom import loss_fn
    from pipegoose_tpu_torch.models.weights import grads_of, params_to_jax
    from pipegoose_tpu_torch.nn.data_parallel import average_gradients
    from pipegoose_tpu_torch.nn.parallel import tree_leaves, unshard_tree
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step
    from pipegoose_tpu_torch.parallel.hybrid import _local_batch

    ctx = ParallelContext(tensor_parallel_size=tp, data_parallel_size=world // tp,
                          device="cpu")
    try:
        out = [_wrappers_agree(np_tree, runs[0][0], tp)]
        for cfg, batches, lr, n_accum in runs:
            def lf(p, ids, cfg=cfg):
                return loss_fn(p, ids, None, ids, cfg, tp_axis="tensor")

            # the first step's gradients, from a copy of the params
            params, specs = _hybrid_params(np_tree, cfg, tp)
            for p in tree_leaves(params):
                p.requires_grad_(True)
            loss0 = lf(params, _local_batch(batches[0], ("data",), ctx, "cpu"))
            loss0.backward()
            g0 = average_gradients(grads_of(params), "data")
            g0 = params_to_jax(unshard_tree(g0, specs))
            loss0 = float(all_reduce(loss0.detach(), "data", "mean"))

            params, specs = _hybrid_params(np_tree, cfg, tp)
            opt = DistributedOptimizer(adam(lr), axis_name="data")
            init_fn, make_step = make_hybrid_train_step(lf, specs, opt, ctx,
                                                        n_accum=n_accum)
            state = init_fn(params)
            step = make_step(params)
            losses = []
            for ids in batches:
                params, state, loss = step(params, state, ids)
                losses.append(float(loss))
            final = params_to_jax(unshard_tree(params, specs))
            out.append(dict(losses=losses, params=final, grads0=g0, loss0=loss0,
                            state_elems=[sum(v.numel() for k, v in state.inner.state[sh].items()
                                             if k != "step") for sh in state.shards],
                            shard_shapes=[tuple(s.shape) for s in state.shards]))
        return out
    finally:
        ctx.destroy()


def _wrappers_agree(np_tree, cfg, tp):
    """Whether ``TensorParallel(tp_mapping())`` gives this rank the shards
    and specs that ``params_from_jax(specs=tp_specs(np_tree))`` gives, its
    ``deparallelize`` the whole tree back, and ``DataParallel`` every leaf
    whole with empty specs."""
    from pipegoose_tpu_torch.models.bloom import tp_mapping
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.data_parallel import DataParallel
    from pipegoose_tpu_torch.nn.parallel import tree_leaves
    from pipegoose_tpu_torch.nn.tensor_parallel import TensorParallel

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    whole = params_from_jax(np_tree, cfg, device="cpu")
    tpar = TensorParallel(tp_mapping())
    shards, specs = tpar.parallelize(whole)
    want, want_specs = _hybrid_params(np_tree, cfg, tp)
    dp, dp_specs = DataParallel().parallelize(whole)
    return (specs == want_specs and same(shards, want)
            and same(tpar.deparallelize(shards, specs), whole) and same(dp, whole)
            and set(tree_leaves(dp_specs)) == {()}
            and DataParallel().batch_spec() == ("data",))


# -- ZeRO-1 alone ---------------------------------------------------------------------------


def zero_rank(rank, world, leaves, grads, lr):
    """``DistributedOptimizer(adam(lr))`` over "data" of ``world`` ranks on a
    dict of leaves, one step per entry of ``grads`` (each (world, *shape):
    rank r's local gradient is row r): the final leaves, and per leaf the
    shape of this rank's shard and its Adam moments' elements."""
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam

    ctx = ParallelContext(data_parallel_size=world, device="cpu")
    try:
        params = {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}
        opt = DistributedOptimizer(adam(lr), axis_name="data")
        state = opt.init(params)
        for g in grads:
            local = {k: torch.from_numpy(np.array(v[rank])) for k, v in g.items()}
            params, state = opt.step(local, state, params)
        moments = {k: state.inner.state[sh]["exp_avg"].numel()
                   for k, sh in zip(params, state.shards)}
        return (params, {k: tuple(sh.shape) for k, sh in zip(params, state.shards)},
                moments)
    finally:
        ctx.destroy()


def rng_rank(rank, world, np_tree, cfg, ids, seed):
    """One step with ``with_rng=True`` and ``n_accum=2`` at tp 2 x dp
    (world / 2): the seeds each microbatch's loss saw, and whether a call
    without the rng raises."""
    from pipegoose_tpu_torch.models.bloom import loss_fn
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step

    ctx = ParallelContext(tensor_parallel_size=2, data_parallel_size=world // 2,
                          device="cpu")
    try:
        seen = []

        def lf(p, batch, rng):
            seen.append(rng)
            return loss_fn(p, batch, None, batch, cfg, tp_axis="tensor")

        params, specs = _hybrid_params(np_tree, cfg, 2)
        init_fn, make_step = make_hybrid_train_step(
            lf, specs, DistributedOptimizer(adam(1e-3)), with_rng=True, n_accum=2)
        state, step = init_fn(params), make_step(params)
        step(params, state, ids, seed)
        try:
            step(params, state, ids)
            refused = False
        except TypeError:
            refused = True
        return seen, refused
    finally:
        ctx.destroy()


def step_rank(rank, world, np_tree, runs, tp, zero_case, rng_case):
    """One spawn of ``world`` ranks for the hybrid step's file: the runs of
    :func:`hybrid_rank` at tp x (world / tp), :func:`zero_rank` at dp =
    world on ``zero_case`` (leaves, grads, lr), and :func:`rng_rank` on
    ``rng_case`` (cfg, ids, seed)."""
    return (hybrid_rank(rank, world, np_tree, runs, tp),
            zero_rank(rank, world, *zero_case),
            rng_rank(rank, world, np_tree, *rng_case))


# -- the auto-parallel step (DTensor) -----------------------------------------------------


def auto_rank(rank, world, np_tree, cfg, batches, lr, tp):
    """``parallel.make_auto_train_step`` at tp x (world / tp): the single-
    device ``loss_fn`` on DTensor params, Adam; then the hybrid step
    (ZeRO-1 over "data") on the same batches. Each: the losses and the
    whole params after the last step (JAX layout), and for the auto step
    this rank's local shape of the qkv kernel."""
    from pipegoose_tpu_torch.models.bloom import loss_fn, tp_specs
    from pipegoose_tpu_torch.models.weights import params_from_jax, params_to_jax
    from pipegoose_tpu_torch.nn.parallel import tree_map, unshard_tree
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_auto_train_step, make_hybrid_train_step

    ctx = ParallelContext(tensor_parallel_size=tp, data_parallel_size=world // tp,
                          device="cpu")
    try:
        whole = params_from_jax(np_tree, cfg, device="cpu")
        init_fn, step = make_auto_train_step(
            lambda p, ids: loss_fn(p, ids, None, ids, cfg),      # single-device code
            tp_specs(whole), adam(lr), ctx)
        params, opt = init_fn(whole)
        qkv_local = tuple(params["blocks"][0]["attn"]["qkv"]["kernel"].to_local().shape)
        auto_losses = []
        for ids in batches:
            params, opt, loss = step(params, opt, ids)
            auto_losses.append(float(loss))
        auto = params_to_jax(tree_map(lambda p: p.detach().full_tensor(), params))

        params, specs = _hybrid_params(np_tree, cfg, tp)
        init_fn, make_step = make_hybrid_train_step(
            lambda p, ids: loss_fn(p, ids, None, ids, cfg, tp_axis="tensor"), specs,
            DistributedOptimizer(adam(lr), axis_name="data"), ctx)
        state = init_fn(params)
        hstep = make_step(params)
        hybrid_losses = []
        for ids in batches:
            params, state, loss = hstep(params, state, ids)
            hybrid_losses.append(float(loss))
        hybrid = params_to_jax(unshard_tree(params, specs))
        return dict(auto_losses=auto_losses, auto=auto, qkv_local=qkv_local,
                    hybrid_losses=hybrid_losses, hybrid=hybrid)
    finally:
        ctx.destroy()
