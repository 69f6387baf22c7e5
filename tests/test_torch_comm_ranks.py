"""The per-rank bodies of the port's comm-engine tests: the compressed
gradient reduction (``test_torch_compressed.py``), the ring
collective-matmul (``test_torch_overlap.py``) and both through the hybrid
step (``test_torch_comm_hybrid.py``).

``run_ranks`` pickles a rank body into spawned processes, which import this
module by name: it imports torch, numpy and the port only, never JAX. A
per-rank input is stacked on a leading axis of the world size and each rank
takes its row.
"""
import numpy as np
import torch

from pipegoose_tpu_torch.distributed import ParallelContext


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))   # a copy; 0-d stays 0-d


# -- the compressed reduction ------------------------------------------------------------


def compressed_rank(rank, world, reduce_cases, avg_cases, opt_case):
    """Over a "data" axis of ``world`` ranks: each ``(kind, mode, g, res)``
    case of ``compressed_reduce_scatter_mean`` ("rs") or
    ``compressed_all_reduce_mean`` ("ar") on this rank's row, each
    ``(mode, tree)`` case of ``average_gradients`` (leaf "expert/w" marked
    expert, no expert axis), and 3 steps of ``DistributedOptimizer`` over
    "data" at ``opt_case``'s mode and error feedback."""
    from pipegoose_tpu_torch.distributed.compressed import (
        compressed_all_reduce_mean,
        compressed_reduce_scatter_mean,
    )
    from pipegoose_tpu_torch.nn.data_parallel import average_gradients
    from pipegoose_tpu_torch.nn.parallel_mapping import Expert, ParallelMapping
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam

    ctx = ParallelContext(data_parallel_size=world, device="cpu")
    try:
        out = []
        for kind, mode, g, res in reduce_cases:
            fn = compressed_reduce_scatter_mean if kind == "rs" else compressed_all_reduce_mean
            out.append(fn(_t(g[rank]), "data", mode,
                          None if res is None else _t(res[rank])))
        experts = ParallelMapping([(r"expert/w", Expert())])
        avg = [average_gradients({k: _t(v[rank]) for k, v in tree.items()}, "data",
                                 expert_mapping=experts, grad_comm=mode)
               for mode, tree in avg_cases]
        mode, ef, leaves, grads, lr = opt_case
        params = {k: _t(v).clone() for k, v in leaves.items()}
        opt = DistributedOptimizer(adam(lr), "data", grad_comm=mode, error_feedback=ef)
        state = opt.init(params)
        for g in grads:
            params, state = opt.step({k: _t(v[rank]) for k, v in g.items()}, state, params)
        return out, avg, (params, None if state.ef is None else list(state.ef))
    finally:
        ctx.destroy()


# -- the ring collective-matmul ------------------------------------------------------------


def overlap_rank(rank, world, case):
    """Over a "tensor" axis of ``world``: the two ring functions on this
    rank's shards of ``case``; the column -> gelu -> row MLP through the
    monolithic and the overlap layers, its loss and the gradients of every
    input (the kernels and biases as this rank's shards, x whole); and a
    replicated scale used on this rank's token chunk through
    ``replicated_for_overlap``, its gradient."""
    from pipegoose_tpu_torch.distributed.functional import (
        axis_index,
        gather_from_tensor_group,
        reduce_from_tensor_group,
        scatter_to_tensor_group,
    )
    from pipegoose_tpu_torch.nn.tensor_parallel.layers import (
        column_parallel_linear,
        row_parallel_linear,
    )
    from pipegoose_tpu_torch.nn.tensor_parallel.overlap import (
        replicated_for_overlap,
        ring_all_gather_matmul,
        ring_matmul_reduce_scatter,
    )

    ctx = ParallelContext(tensor_parallel_size=world, device="cpu")
    try:
        r = axis_index("tensor")
        x, w_col = _t(case["x"]), _t(case["w_col"])
        m = x.shape[1] // world
        gathered = ring_all_gather_matmul(x[:, r * m:(r + 1) * m], w_col, "tensor")
        x_full, w_row = _t(case["x_full"]), _t(case["w_row"])
        k = w_row.shape[0] // world
        reduced = ring_matmul_reduce_scatter(x_full[..., r * k:(r + 1) * k],
                                             w_row[r * k:(r + 1) * k], "tensor")
        mlp = case["mlp"]
        mlp_out = []
        for overlap in (False, True):
            col = {k: _t(v[r]).clone().requires_grad_(True) for k, v in mlp["col"].items()}
            row = {k: _t(v[r]).clone().requires_grad_(True) for k, v in mlp["row"].items()}
            xin = _t(mlp["x"]).clone().requires_grad_(True)
            h = scatter_to_tensor_group(xin, "tensor", dim=1) if overlap else xin
            h = column_parallel_linear(col, h, "tensor", overlap=overlap)
            y = row_parallel_linear(row, gelu_tanh(h), "tensor", overlap=overlap)
            if overlap:
                y = gather_from_tensor_group(y, "tensor", dim=1)
            loss = (y.float() ** 2).sum()
            loss.backward()
            mlp_out.append((loss.detach(), col["kernel"].grad, col["bias"].grad,
                            row["kernel"].grad, row["bias"].grad, xin.grad))
        xs = _t(case["xs"])
        scale = _t(case["scale"]).clone().requires_grad_(True)
        ms = xs.shape[1] // world
        s = replicated_for_overlap({"s": scale}, "tensor")["s"]
        part = ((xs[:, r * ms:(r + 1) * ms] * s).float() ** 2).sum()
        reduce_from_tensor_group(part, "tensor").backward()
        return gathered, reduced, mlp_out, scale.grad
    finally:
        ctx.destroy()


def gelu_tanh(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


# -- the hybrid step with the comm engine --------------------------------------------------


def _params(np_tree, cfg):
    from pipegoose_tpu_torch.models.bloom import tp_specs
    from pipegoose_tpu_torch.models.weights import params_from_jax

    return params_from_jax(np_tree, cfg, device="cpu", specs=tp_specs(np_tree))


def comm_hybrid_rank(rank, world, np_tree, runs, batches, lr, ckpt_dir, short_ids):
    """At TP2 x DP2: each run ``(name, cfg, grad_comm, error_feedback)`` of
    ``make_hybrid_train_step`` with ZeRO-1 over "data" (``overlap_tp`` when
    the config says so): the losses and the whole params after the last
    step (JAX layout). Then the indivisible-sequence probe of the overlap
    path, and a checkpoint round trip of the last run's state: its
    residuals bit for bit into a fresh state, and a restore at tp 1 x dp 4
    raising."""
    from pipegoose_tpu_torch.models.bloom import loss_fn, tp_specs
    from pipegoose_tpu_torch.models.weights import params_to_jax
    from pipegoose_tpu_torch.nn.parallel import unshard_tree
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step
    from pipegoose_tpu_torch.utils import checkpoint as ckpt

    ctx = ParallelContext(tensor_parallel_size=2, data_parallel_size=world // 2,
                          device="cpu")
    out = {}
    try:
        for name, cfg, grad_comm, ef in runs:
            def lf(p, ids, cfg=cfg):
                return loss_fn(p, ids, None, ids, cfg, tp_axis="tensor")

            params = _params(np_tree, cfg)
            specs = tp_specs(params)
            opt = DistributedOptimizer(adam(lr), "data", error_feedback=ef,
                                       grad_comm="int8" if ef else "fp32")
            init_fn, make_step = make_hybrid_train_step(lf, specs, opt, ctx,
                                                        grad_comm=grad_comm,
                                                        overlap_tp=cfg.overlap_tp)
            state = init_fn(params)
            step = make_step(params)
            losses = []
            for ids in batches:
                params, state, loss = step(params, state, ids)
                losses.append(float(loss))
            out[name] = dict(losses=losses,
                             params=params_to_jax(unshard_tree(params, specs)))
            if cfg.overlap_tp:
                out["probe"] = None
                try:   # 7 tokens over a tensor axis of 2
                    step(params, state, short_ids)
                except ValueError as e:
                    out["probe"] = str(e)

        saved_ef = [e.clone() for e in state.ef]
        ckpt.save_train_state(ckpt_dir, 1, params, state, specs=specs)
        fresh = _params(np_tree, runs[-1][1])
        opt = DistributedOptimizer(adam(lr), "data", grad_comm=runs[-1][2],
                                   error_feedback=True)
        fresh_state = opt.init(fresh)
        ckpt.restore_train_state(ckpt_dir, 1, {"params": fresh, "opt_state": fresh_state},
                                 specs=specs, inplace=True)
        out["ef_equal"] = (all(torch.equal(a, b) for a, b in zip(saved_ef, fresh_state.ef))
                           and any(bool(e.abs().max() > 0) for e in saved_ef))
    finally:
        ctx.destroy()
    ctx = ParallelContext(tensor_parallel_size=1, data_parallel_size=world, device="cpu")
    try:
        params = _params(np_tree, runs[-1][1])
        opt = DistributedOptimizer(adam(lr), "data", grad_comm="int8", error_feedback=True)
        state = opt.init(params)
        try:
            ckpt.restore_train_state(ckpt_dir, 1, {"params": params, "opt_state": state},
                                     specs=tp_specs(params), inplace=True)
            out["other_dp"] = None
        except ValueError as e:
            out["other_dp"] = str(e)
    finally:
        ctx.destroy()
    return out
