"""The port's pipeline parallelism on gloo ranks, held against the JAX
package on the CPU.

- ``gpipe`` at pp 2 and 4 (8 tanh layers, M = 6 microbatches, with side
  inputs and a per-stage aux loss, remat on): the outputs, the loss and the
  gradients of every layer and of the inputs against JAX's ``gpipe`` under
  a pipe mesh (``tests/nn/pipeline_parallel/test_pipeline.py``'s rtol
  1e-4, atol 1e-6; outputs 1e-5 / 1e-6).
- BLOOM ``loss_fn_pp`` and ``loss_fn_1f1b`` at M 2 and 4, even stages at pp
  2 and 4 and uneven ones (3 + 1 layers) at pp 2: the loss (2e-6 relative)
  and every gradient (1e-4 of each leaf's largest value, the replicated
  leaves summed over "pipe", the blocks gathered stage by stage) against
  JAX's under a pipe mesh, with the uneven JAX run on its padded
  ``repartition_blocks`` layout. Each rank's blocks come from
  ``params_from_jax(specs=pp_specs(...))`` (the padded tree's live slots
  with ``stage_layer_counts``) and equal ``repartition_blocks``' stage.
- The 3D step (``make_hybrid_train_step`` with ZeRO-1 and
  ``grad_sync_axes=("pipe",)``): GPipe at TP2 x PP2 and 1F1B at PP2 x DP2,
  3 Adam steps on one batch, against the JAX single-device steps with
  ``tests/test_3d_parallel.py``'s bounds (losses rtol 5e-3, atol 5e-4;
  params rtol 1e-2, atol 1e-3). The PP2 x DP2 params, checkpointed by
  stage (each block under its global layer index), restore bit for bit
  at dp 4 with no pipeline.
- ``loss_fn_pp_sp`` at PP2 x SP2: the loss against JAX's dense loss_fn
  (3e-4) and 3 steps with ``grad_sync_axes=(("pipe", "sum"), ("seq",
  "sum"))`` against the JAX single-device steps (losses rtol 2e-3, atol
  2e-4; params rtol 5e-3, atol 5e-4: ``tests/models/test_bloom_sp.py``).

Tiny BLOOM: vocab 128, hidden 64, 4 heads; weights from
``init_params_numpy``, ids from numpy seeds, float32. ``run_ranks`` pickles
a rank body into spawned processes, which import this module by name: its
top level imports torch, numpy and the port only; the JAX side is imported
inside the tests. One spawn per test.
"""
import numpy as np
import pytest
import torch

from pipegoose_tpu_torch.distributed import ParallelContext
from pipegoose_tpu_torch.testing.dist import run_ranks

SIZE = dict(vocab_size=128, hidden_size=64, n_head=4)
L_GEN, M_GEN, MB, D = 8, 6, 2, 16     # the generic gpipe case
UNEVEN = (3, 1)
LOSS_REL, GRAD_REL = 2e-6, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


# -- rank bodies -----------------------------------------------------------------------------


def _gpipe_generic(case):
    """The tanh stack through ``gpipe`` on this rank's stage."""
    from pipegoose_tpu_torch.distributed.functional import (
        axis_index,
        axis_size,
        reduce_from_tensor_group,
    )
    from pipegoose_tpu_torch.nn.pipeline_parallel import gpipe, last_stage_value

    P, stage = axis_size("pipe"), axis_index("pipe")
    k = L_GEN // P
    ws = [_t(case["w"][i]).requires_grad_(True) for i in range(stage * k, (stage + 1) * k)]
    bs = [_t(case["b"][i]).requires_grad_(True) for i in range(stage * k, (stage + 1) * k)]
    x = _t(case["x"]).requires_grad_(True)

    def stage_fn(params, h, s):
        for w, b in zip(*params):
            h = torch.tanh(h @ w + b) + s
        return h, (h ** 2).mean()

    outs, aux = gpipe(stage_fn, (ws, bs), x, side_inputs=_t(case["side"]),
                      axis_name="pipe", remat=True, with_aux=True)
    loss = (last_stage_value((outs ** 2).mean(), "pipe")
            + reduce_from_tensor_group(aux, "pipe"))
    loss.backward()
    return dict(outs=outs.detach() if stage == P - 1 else None, loss=float(loss),
                w=[w.grad for w in ws], b=[b.grad for b in bs],
                x=x.grad if stage == 0 else None)


def _stage_params(np_tree, cfg, counts, padded):
    """This rank's BLOOM params: the stage's blocks from ``params_from_jax``
    with ``pp_specs`` (on the padded tree with the counts when uneven), and
    whether they equal ``repartition_blocks``' stage of the whole list."""
    from pipegoose_tpu_torch.distributed.functional import axis_index, axis_size
    from pipegoose_tpu_torch.models.bloom import pp_specs
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import tree_leaves
    from pipegoose_tpu_torch.nn.pipeline_parallel.partitioner import repartition_blocks

    tree = np_tree if counts is None else padded
    params = params_from_jax(tree, cfg, device="cpu", specs=pp_specs(tree),
                             stage_layer_counts=counts)
    whole = params_from_jax(np_tree, cfg, device="cpu")
    P = axis_size("pipe")
    counts_ = list(counts) if counts is not None else [cfg.n_layer // P] * P
    starts = np.cumsum([0, *counts_])
    ranges = [range(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]
    mine = repartition_blocks(whole["blocks"], ranges)[0][axis_index("pipe")]
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(mine),
                                                tree_leaves(params["blocks"])))
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params, same and len(mine) == len(params["blocks"])


def _bloom_case(np_tree, cfg, ids, kind, M, counts, padded, tp_axis=None):
    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models.weights import grads_of
    from pipegoose_tpu_torch.parallel.hybrid import sync_replicated_grads

    params, same = _stage_params(np_tree, cfg, counts, padded)
    fn = bloom.loss_fn_pp if kind == "pp" else bloom.loss_fn_1f1b
    t = _t(ids).long()
    loss = fn(params, t, None, t, cfg, M, tp_axis=tp_axis, stage_layer_counts=counts)
    loss.backward()
    g = sync_replicated_grads(grads_of(params), bloom.pp_specs(params), ("pipe",))
    return dict(loss=float(loss), same=same, blocks=g["blocks"],
                rest={k: g[k] for k in ("embed", "embed_ln", "ln_f")})


def pipeline_rank(rank, world, generic, np_tree, cfg, ids, bloom_cases, padded):
    ctx = ParallelContext(pipeline_parallel_size=world, device="cpu")
    try:
        out = [_gpipe_generic(generic)]
        for kind, M, counts in bloom_cases:
            out.append(_bloom_case(np_tree, cfg, ids, kind, M, counts, padded))
        return out
    finally:
        ctx.destroy()


def _train(ctx, np_tree, cfg, ids, steps, lr, loss_fn, grad_sync_axes, batch_spec,
           tp_axis, ckpt_dir=None):
    """``steps`` hybrid steps on one batch: the losses and this rank's whole
    (tensor-gathered) params, the blocks its stage's only."""
    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.nn.parallel import unshard_tree
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.parallel import make_hybrid_train_step

    params = params_from_jax(np_tree, cfg, device="cpu", specs=bloom.pp_specs(np_tree))
    specs = bloom.pp_specs(params)
    init_fn, make_step = make_hybrid_train_step(
        loss_fn, specs, DistributedOptimizer(adam(lr), "data"), ctx,
        batch_spec=batch_spec, grad_sync_axes=grad_sync_axes)
    state = init_fn(params)
    step = make_step(params)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, ids)
        losses.append(float(loss))
    if ckpt_dir is not None:   # saved by stage, each block under its global index
        from pipegoose_tpu_torch.utils.checkpoint import save_pretrained

        save_pretrained(params, ckpt_dir, specs=specs)
    whole = unshard_tree(params, bloom.tp_specs(params)) if tp_axis else params
    return dict(losses=losses, params=whole)


def steps_rank(rank, world, np_tree, cfg, ids, sp_case, steps, lr, ckpt_dir):
    """GPipe at TP2 x PP2, 1F1B at PP2 x DP2 (its params then checkpointed
    and restored whole at dp 4, no pipeline), and PP2 x SP2 (the loss, then
    the steps), each on its own context over the 4 ranks."""
    from pipegoose_tpu_torch.distributed.functional import axis_index
    from pipegoose_tpu_torch.models import bloom

    out = {}
    ctx = ParallelContext(tensor_parallel_size=2, pipeline_parallel_size=2, device="cpu")
    try:
        out["tp2_pp2"] = _train(
            ctx, np_tree, cfg, ids, steps, lr,
            lambda p, b: bloom.loss_fn_pp(p, b, None, b, cfg, 2, tp_axis="tensor"),
            ("pipe",), ("data",), "tensor")
        out["tp2_pp2"]["stage"] = axis_index("pipe")
    finally:
        ctx.destroy()
    ctx = ParallelContext(pipeline_parallel_size=2, data_parallel_size=2, device="cpu")
    try:
        out["pp2_dp2"] = _train(
            ctx, np_tree, cfg, ids, steps, lr,
            lambda p, b: bloom.loss_fn_1f1b(p, b, None, b, cfg, 2),
            ("pipe",), ("data",), None, ckpt_dir)
        out["pp2_dp2"]["stage"] = axis_index("pipe")
    finally:
        ctx.destroy()
    ctx = ParallelContext(data_parallel_size=4, device="cpu")
    try:
        from pipegoose_tpu_torch.models.weights import params_from_jax
        from pipegoose_tpu_torch.utils.checkpoint import from_pretrained

        like = params_from_jax(np_tree, cfg, device="cpu")
        out["restored"] = from_pretrained(ckpt_dir, like, specs=bloom.tp_specs(like))
    finally:
        ctx.destroy()
    sp_tree, sp_cfg, sp_ids = sp_case
    ctx = ParallelContext(pipeline_parallel_size=2, sequence_parallel_size=2, device="cpu")
    try:
        from pipegoose_tpu_torch.models.weights import params_from_jax

        s = sp_ids.shape[1] // 2
        part = _t(sp_ids[:, axis_index("seq") * s:(axis_index("seq") + 1) * s]).long()
        params = params_from_jax(sp_tree, sp_cfg, device="cpu",
                                 specs=bloom.pp_specs(sp_tree))
        with torch.no_grad():
            loss = bloom.loss_fn_pp_sp(params, part, None, part, sp_cfg, 2)
        out["pp2_sp2"] = _train(
            ctx, sp_tree, sp_cfg, sp_ids, steps, lr,
            lambda p, b: bloom.loss_fn_pp_sp(p, b, None, b, sp_cfg, 2),
            (("pipe", "sum"), ("seq", "sum")), (None, "seq"), None)
        out["pp2_sp2"]["loss0"] = float(loss)
        out["pp2_sp2"]["stage"] = axis_index("pipe")
    finally:
        ctx.destroy()
    return out


# -- the JAX side ------------------------------------------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    return jax, jnp, P


def _pipe_mesh(pp):
    jax, _, _ = _jax()
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:pp]).reshape(pp, 1), ("pipe", "tensor"))


def _generic_case():
    rng = np.random.default_rng(0)
    return dict(w=(rng.standard_normal((L_GEN, D, D)) * 0.3).astype(np.float32),
                b=(rng.standard_normal((L_GEN, D)) * 0.1).astype(np.float32),
                x=rng.standard_normal((M_GEN, MB, D)).astype(np.float32),
                side=(rng.standard_normal((M_GEN, D)) * 0.1).astype(np.float32))


def _jax_generic(case, pp):
    """JAX's gpipe on the same stack under a pipe mesh: outputs, loss and
    gradients (w, b stacked; x)."""
    jax, jnp, P = _jax()
    from pipegoose_tpu.distributed.compat import shard_map
    from pipegoose_tpu.distributed.functional import reduce_from_tensor_group
    from pipegoose_tpu.nn.pipeline_parallel import gpipe, last_stage_value

    def stage_fn(blocks, h, s):
        for i in range(blocks["w"].shape[0]):
            h = jnp.tanh(h @ blocks["w"][i] + blocks["b"][i]) + s
        return h, (h ** 2).mean()

    def loss(params, x, side):
        outs, aux = gpipe(stage_fn, params, x, side_inputs=side, axis_name="pipe",
                          remat=True, with_aux=True)
        total = last_stage_value((outs ** 2).mean(), "pipe") + \
            reduce_from_tensor_group(aux, "pipe")
        return total, last_stage_value(outs, "pipe")

    spec = {"w": P("pipe"), "b": P("pipe")}
    f = shard_map(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
                  mesh=_pipe_mesh(pp), in_specs=(spec, P(), P()),
                  out_specs=((P(), P()), (spec, P())), check_vma=False)
    (total, outs), (gp, gx) = f({"w": jnp.asarray(case["w"]), "b": jnp.asarray(case["b"])},
                                jnp.asarray(case["x"]), jnp.asarray(case["side"]))
    return float(total), np.asarray(outs), np.asarray(gp["w"]), np.asarray(gp["b"]), \
        np.asarray(gx)


def _check_generic(ranks, case, pp):
    total, outs, gw, gb, gx = _jax_generic(case, pp)
    last = ranks[-1][0]
    np.testing.assert_allclose(last["outs"], outs, rtol=1e-5, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r[0]["loss"], total, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate([np.stack(r[0]["w"]) for r in ranks]), gw,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([np.stack(r[0]["b"]) for r in ranks]), gb,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ranks[0][0]["x"], gx, rtol=1e-4, atol=1e-6)


def _bloom_setup(n_layer):
    from pipegoose_tpu_torch.models import bloom

    cfg = bloom.BloomConfig(**SIZE, n_layer=n_layer)
    np_tree = bloom.init_params_numpy(cfg, seed=0)
    ids = np.random.RandomState(3).randint(0, 128, (8, 12)).astype(np.int32)
    return cfg, np_tree, ids


def _padded(np_tree, counts):
    """JAX's ``repartition_blocks`` layout of the numpy tree, leaf by leaf
    (the port's tree keeps its dicts' key order; JAX's tree_map sorts it)."""
    from pipegoose_tpu.nn.pipeline_parallel.partitioner import repartition_blocks
    from pipegoose_tpu_torch.nn.parallel import tree_map

    starts = np.cumsum([0, *counts])
    ranges = [range(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]
    return {**np_tree, "blocks": tree_map(
        lambda x: np.asarray(repartition_blocks(x, ranges)[0]), np_tree["blocks"])}


def _jax_bloom(np_tree, ids, kind, M, counts, pp, n_layer):
    """JAX's loss_fn_pp / loss_fn_1f1b under a pipe mesh: the loss and the
    gradients (replicated leaves summed over "pipe"), blocks per layer."""
    jax, jnp, P = _jax()
    from pipegoose_tpu.distributed.compat import shard_map
    from pipegoose_tpu.models import bloom as jbloom
    from pipegoose_tpu.parallel.hybrid import sync_replicated_grads

    cfg = jbloom.BloomConfig(**SIZE, n_layer=n_layer)
    tree = np_tree if counts is None else _padded(np_tree, counts)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    specs = jbloom.pp_specs(params)
    fn = jbloom.loss_fn_pp if kind == "pp" else jbloom.loss_fn_1f1b
    kw = {} if counts is None else {"stage_layer_counts": tuple(counts)}

    def vg(p, i):
        loss, g = jax.value_and_grad(lambda p: fn(p, i, None, i, cfg, M, **kw))(p)
        return loss, sync_replicated_grads(g, specs, ("pipe",))

    loss, g = jax.jit(shard_map(vg, mesh=_pipe_mesh(pp), in_specs=(specs, P()),
                                out_specs=(P(), specs), check_vma=False))(
        params, jnp.asarray(ids))
    g = jax.tree_util.tree_map(np.asarray, g)
    if counts is not None:   # the live slots, in layer order
        lmax = max(counts)
        live = [p * lmax + j for p, c in enumerate(counts) for j in range(c)]
        g["blocks"] = jax.tree_util.tree_map(lambda a: a[live], g["blocks"])
    return float(loss), g


def _stack_blocks(per_rank):
    """The ranks' per-layer block gradients (stage order) stacked on a
    leading layer dim, as the JAX tree holds them."""
    blocks = [b for r in per_rank for b in r]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    return stack(*blocks)


def _check_grads(got, want, what):
    jax, _, _ = _jax()
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths), what
    for (path, w), g in zip(paths, flat):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_REL * float(np.abs(w).max()),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _bloom_cases(pp):
    cases = [(kind, M, None) for kind in ("pp", "1f1b") for M in (2, 4)]
    if pp == 2:
        cases += [(kind, M, UNEVEN) for kind in ("pp", "1f1b") for M in (2, 4)]
    return cases


@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_losses_and_gradients_match_jax(devices, pp):
    generic = _generic_case()
    cfg, np_tree, ids = _bloom_setup(4)
    cases = _bloom_cases(pp)
    padded = _padded(np_tree, UNEVEN)
    ranks = run_ranks(pipeline_rank, pp, generic, np_tree, cfg, ids, cases, padded,
                      timeout=600)
    _check_generic(ranks, generic, pp)
    for i, (kind, M, counts) in enumerate(cases, start=1):
        what = f"{kind} M={M} counts={counts} pp={pp}"
        loss, want = _jax_bloom(np_tree, ids, kind, M, counts, pp, 4)
        for r in ranks:
            assert r[i]["same"], what
            assert abs(r[i]["loss"] - loss) <= LOSS_REL * abs(loss), (what, r[i]["loss"], loss)
            for k in ("embed", "embed_ln", "ln_f"):
                _check_grads(r[i]["rest"][k], want[k], f"{what} {k}")
        _check_grads(_stack_blocks([r[i]["blocks"] for r in ranks]), want["blocks"],
                     f"{what} blocks")


def _jax_single_device(np_tree, n_layer, ids, steps, lr):
    """JAX loss_fn + optax.adam on one device: losses and final params."""
    jax, jnp, _ = _jax()
    import optax

    from pipegoose_tpu.models import bloom as jbloom

    cfg = jbloom.BloomConfig(**SIZE, n_layer=n_layer)
    p = jax.tree_util.tree_map(jnp.asarray, np_tree)
    opt = optax.adam(lr)
    state = opt.init(p)

    @jax.jit
    def step(p, s, i):
        loss, g = jax.value_and_grad(jbloom.loss_fn)(p, i, None, i, cfg)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state, jnp.asarray(ids))
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, p), \
        float(jbloom.loss_fn(jax.tree_util.tree_map(jnp.asarray, np_tree),
                             jnp.asarray(ids), None, jnp.asarray(ids), cfg))


def _gathered(ranks, key):
    """The whole params of a run: the replicated leaves from rank 0, the
    blocks of each stage (one rank per stage) stacked in layer order."""
    by_stage = {}
    for r in ranks:
        by_stage.setdefault(r[key]["stage"], r[key]["params"])
    p0 = by_stage[0]
    blocks = [b for s in sorted(by_stage) for b in by_stage[s]["blocks"]]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    return {"embed": p0["embed"], "embed_ln": p0["embed_ln"], "blocks": stack(*blocks),
            "ln_f": p0["ln_f"]}


def _check_params(got, want, rtol, atol, what):
    jax, _, _ = _jax()
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(paths, jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_3d_and_pp_sp_steps_match_single_device(devices, tmp_path):
    steps, lr = 3, 1e-3
    cfg, np_tree, ids = _bloom_setup(4)
    sp_ids = np.random.RandomState(12).randint(0, 128, (4, 32)).astype(np.int32)
    ranks = run_ranks(steps_rank, 4, np_tree, cfg, ids, (np_tree, cfg, sp_ids), steps,
                      lr, str(tmp_path / "pp_ckpt"), timeout=600)
    ref_losses, ref_params, _ = _jax_single_device(np_tree, 4, ids, steps, lr)
    assert ref_losses[-1] < ref_losses[0]
    for key in ("tp2_pp2", "pp2_dp2"):   # tests/test_3d_parallel.py's bounds
        for r in ranks:
            np.testing.assert_allclose(r[key]["losses"], ref_losses, rtol=5e-3, atol=5e-4,
                                       err_msg=key)
        _check_params(_gathered(ranks, key), ref_params, 1e-2, 1e-3, key)
    # a checkpoint saved by pipeline stage restores whole without a pipeline
    trained = _gathered(ranks, "pp2_dp2")
    for r in ranks:
        restored = dict(r["restored"], blocks=_stack_blocks([r["restored"]["blocks"]]))
        _check_params(restored, trained, 0, 0, "restored at dp 4")
    sp_losses, sp_params, sp_loss0 = _jax_single_device(np_tree, 4, sp_ids, steps, lr)
    for r in ranks:   # tests/models/test_bloom_sp.py's bounds
        assert abs(r["pp2_sp2"]["loss0"] - sp_loss0) < 3e-4
        np.testing.assert_allclose(r["pp2_sp2"]["losses"], sp_losses, rtol=2e-3, atol=2e-4)
    _check_params(_gathered(ranks, "pp2_sp2"), sp_params, 5e-3, 5e-4, "pp2_sp2")
