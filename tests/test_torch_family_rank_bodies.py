"""The per-rank bodies of the port's Llama and Mixtral gloo tests and of the
1F1B ``with_aux`` tests.

``run_ranks`` pickles a rank body into spawned processes, which import this
module by name: it imports torch, numpy and the port only, never JAX. The
JAX side of each comparison lives in ``test_torch_family_ranks.py`` and
``test_torch_pipeline.py``. Inputs arrive as numpy arrays; each body returns
the loss and this rank's gradients (or parameter moves) in the JAX layout.
"""
import numpy as np
import torch

from pipegoose_tpu_torch.distributed import ParallelContext


def _t(x):
    return torch.from_numpy(np.array(x))


def _module(family):
    from pipegoose_tpu_torch.models import llama, mixtral

    return {"llama": llama, "mixtral": mixtral}[family]


def _stacked(tree):
    """A port tree (or part of one) in the JAX layout, gradients included."""
    from pipegoose_tpu_torch.models.weights import params_to_jax

    return params_to_jax(tree)


def _grads(params):
    from pipegoose_tpu_torch.models.weights import grads_of

    return grads_of(params)


# -- tensor x data parallel (the hybrid step) ---------------------------------------


def llama_tp_dp_rank(rank, world, cases, ids):
    """Llama at TP2 x DP2 through ``make_hybrid_train_step``: this rank's
    shard of the whole tree by ``llama.specs``, the batch cut over "data",
    ZeRO-1 over "data" around SGD at lr 1, so that one step moves every
    parameter by the data-mean gradient. Per case: the step's loss and the
    whole tree before and after, gathered from the shards."""
    from pipegoose_tpu_torch.models import llama
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import shard_tree, unshard_tree
    from pipegoose_tpu_torch.optim import DistributedOptimizer
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step

    ctx = ParallelContext(tensor_parallel_size=2, data_parallel_size=world // 2,
                          device="cpu")
    try:
        out = []
        for np_tree, cfg in cases:
            whole = params_from_jax(np_tree, cfg, device="cpu")
            specs = llama.specs(whole)
            params = shard_tree(whole, specs)

            def lf(p, batch, cfg=cfg):
                return llama.loss_fn(p, batch, None, batch, cfg, tp_axis="tensor")

            init_fn, make_step = make_hybrid_train_step(
                lf, specs, DistributedOptimizer(lambda leaves: torch.optim.SGD(leaves, lr=1.0),
                                                axis_name="data"))
            state = init_fn(params)
            step = make_step(params)
            before = _stacked(unshard_tree(params, specs))
            params, state, loss = step(params, state, ids)
            out.append(dict(loss=loss.item(), before=before,
                            after=_stacked(unshard_tree(params, specs))))
        return out
    finally:
        ctx.destroy()


# -- expert x tensor parallel --------------------------------------------------------


def mixtral_ep_tp_rank(rank, world, np_tree, cfg, ids):
    """Mixtral at EP2 x TP2: this rank's shard of the weights
    (``params_from_jax(specs=mixtral.specs(np_tree))``), its expert
    coordinate's half of the batch, the loss and its backward with no
    gradient sync. Returns (expert index, tensor index, loss, the local
    gradients in the JAX layout)."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models import mixtral
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    ctx = ParallelContext(tensor_parallel_size=2, expert_parallel_size=2, device="cpu")
    try:
        params = params_from_jax(np_tree, cfg, device="cpu", specs=mixtral.specs(np_tree))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        e = axis_index("expert")
        half = ids.shape[0] // 2
        local = _t(ids[e * half:(e + 1) * half]).long()
        loss = mixtral.loss_fn(params, local, None, local, cfg, tp_axis="tensor",
                               ep_axis="expert", train=False)
        loss.backward()
        return e, axis_index("tensor"), float(loss), _stacked(_grads(params))
    finally:
        ctx.destroy()


# -- pipeline ------------------------------------------------------------------------


def _stage_params(family, np_tree, cfg, counts):
    """This rank's params: even stages from ``params_from_jax(specs=
    pp_specs(np_tree))``, uneven ones the stage's slice of the whole list."""
    from pipegoose_tpu_torch.distributed.functional import axis_index, axis_size
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    module = _module(family)
    if counts is None:
        params = params_from_jax(np_tree, cfg, device="cpu", specs=module.pp_specs(np_tree))
        assert len(params["blocks"]) == cfg.n_layer // axis_size("pipe")
    else:
        params = params_from_jax(np_tree, cfg, device="cpu")
        start = int(sum(counts[:axis_index("pipe")]))
        params["blocks"] = params["blocks"][start:start + counts[axis_index("pipe")]]
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _pp_case(family, np_tree, cfg, ids, mask, kind, M, counts):
    from pipegoose_tpu_torch.parallel.hybrid import sync_replicated_grads

    module = _module(family)
    params = _stage_params(family, np_tree, cfg, counts)
    fn = module.loss_fn_pp if kind == "gpipe" else module.loss_fn_1f1b
    t = _t(ids).long()
    kw = {} if family == "llama" else {"train": False}
    loss = fn(params, t, _t(mask), t, cfg, M, stage_layer_counts=counts, **kw)
    loss.backward()
    g = sync_replicated_grads(_grads(params), module.pp_specs(params), ("pipe",))
    return dict(loss=float(loss), blocks=_stacked({"blocks": g["blocks"]})["blocks"],
                rest=_stacked({k: v for k, v in g.items() if k != "blocks"}))


def pipeline_rank(rank, world, cases):
    """Every case ((family, numpy tree, config, ids, mask, "gpipe" | "1f1b",
    M, stage_layer_counts or None)) at pp 2: the loss and this stage's block
    gradients, the replicated leaves' summed over "pipe"."""
    ctx = ParallelContext(pipeline_parallel_size=world, device="cpu")
    try:
        return [_pp_case(*case) for case in cases]
    finally:
        ctx.destroy()


# -- sequence parallel ---------------------------------------------------------------


def _sp_grads(module, params, axes):
    from pipegoose_tpu_torch.parallel.hybrid import sync_replicated_grads

    piped = any(ax == "pipe" for ax, _ in axes)
    specs = module.pp_specs(params) if piped else module.specs(params)
    return sync_replicated_grads(_grads(params), specs, axes)


def sp_rank(rank, world, cases):
    """Every case ((family, numpy tree, config, ids, mask, variant)) at sp 2:
    this rank's chunk of the sequence through ``loss_fn_sp``; the loss and
    the gradients summed over "seq"."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    ctx = ParallelContext(sequence_parallel_size=world, device="cpu")
    try:
        out = []
        for family, np_tree, cfg, ids, mask, variant in cases:
            module = _module(family)
            params = params_from_jax(np_tree, cfg, device="cpu")
            for p in tree_leaves(params):
                p.requires_grad_(True)
            s = ids.shape[1] // world
            r = axis_index("seq")
            t, m = (_t(a[:, r * s:(r + 1) * s]) for a in (ids, mask))
            kw = {} if family == "llama" else {"train": False}
            loss = module.loss_fn_sp(params, t.long(), m, t.long(), cfg, variant=variant,
                                     **kw)
            loss.backward()
            out.append(dict(loss=loss.item(),
                            grads=_stacked(_sp_grads(module, params, (("seq", "sum"),)))))
        return out
    finally:
        ctx.destroy()


def mixtral_pp_sp_rank(rank, world, np_tree, cfg, ids, mask, M):
    """Mixtral ``loss_fn_pp_sp`` at PP2 x SP2: this stage's blocks
    (``pp_specs``), this rank's sequence chunk; the loss and the gradients
    summed over "pipe" (replicated leaves) and "seq"."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models import mixtral
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    ctx = ParallelContext(pipeline_parallel_size=2, sequence_parallel_size=2, device="cpu")
    try:
        params = params_from_jax(np_tree, cfg, device="cpu", specs=mixtral.pp_specs(np_tree))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        s = ids.shape[1] // 2
        r = axis_index("seq")
        t, m = (_t(a[:, r * s:(r + 1) * s]) for a in (ids, mask))
        loss = mixtral.loss_fn_pp_sp(params, t.long(), m, t.long(), cfg, M, train=False)
        loss.backward()
        g = _sp_grads(mixtral, params, (("pipe", "sum"), ("seq", "sum")))
        return dict(loss=loss.item(), stage=axis_index("pipe"), seq=r,
                    blocks=_stacked({"blocks": g["blocks"]})["blocks"],
                    rest=_stacked({k: v for k, v in g.items() if k != "blocks"}))
    finally:
        ctx.destroy()


# -- one_f_one_b, generic -------------------------------------------------------------


def one_f_one_b_rank(rank, world, case, with_aux):
    """A stack of tanh layers (``case``: w (L, D, D), b (L, D), x (M, mb, D),
    side (M, D)) through the port's ``one_f_one_b`` at pp 2, the head the
    mean square of the last stage's output, with ``with_aux`` each stage's
    own aux scalar (0.1 x the mean square of its output). Returns the loss
    sum, this stage's dW and db, and (first stage) d_inputs."""
    from pipegoose_tpu_torch.distributed.functional import axis_index, axis_size
    from pipegoose_tpu_torch.nn.pipeline_parallel import one_f_one_b

    ctx = ParallelContext(pipeline_parallel_size=world, device="cpu")
    try:
        P, stage = axis_size("pipe"), axis_index("pipe")
        L = case["w"].shape[0]
        k = L // P
        ws = [_t(case["w"][i]).requires_grad_(True) for i in range(stage * k, (stage + 1) * k)]
        bs = [_t(case["b"][i]).requires_grad_(True) for i in range(stage * k, (stage + 1) * k)]

        def stage_fn(params, h, side):
            for w, b in zip(*params):
                h = torch.tanh(h @ w + b) + side["s"]
            return (h, 0.1 * (h ** 2).mean()) if with_aux else h

        def head_fn(hp, h, side):
            return (h * hp["scale"]).pow(2).mean()

        loss, dx, dp, dh = one_f_one_b(
            stage_fn, [ws, bs], head_fn, {"scale": _t(case["scale"]).requires_grad_(True)},
            _t(case["x"]),
            {"s": _t(case["side"])}, "pipe", with_aux=with_aux)
        return dict(loss=float(loss), w=dp[:k], b=dp[k:], x=dx,
                    scale=dh[0] if stage == P - 1 else None)
    finally:
        ctx.destroy()
