"""The port's ALBERT on gloo ranks, held against the JAX functions under
``shard_map`` on the fake devices.

- TP2 x DP2: ``fill_mask`` with ``tp_axis="tensor"`` (tokens equal), then 3
  hybrid steps (ZeRO-1 Adam 1e-3 over "data") against JAX's
  ``make_hybrid_train_step``: the losses and the whole tree after the steps;
- pp 2: GPipe and 1F1B at M = 2, and uneven 3 + 1 stages on both runtimes:
  the loss and the gradients summed over "pipe";
- sp 2: the bidirectional ring, Ulysses, and Ulysses with flash (the JAX
  kernels as its tests run them on the CPU, the port's plain versions): the
  loss and the gradients summed over "seq";
- PP2 x SP2: ``loss_fn_pp_sp`` at M = 2.

Tolerances, those of ``tests/models/test_albert.py`` and
``test_albert_pp_sp.py``: the pipeline and sequence losses 2e-5 absolute
(2e-4 for flash), their gradients ``rtol 2e-3, atol 2e-5`` (``atol 2e-4``
for flash); the TP2 x DP2 losses 2e-4 and parameters ``rtol 5e-3, atol
5e-4``. Config as ``test_torch_albert.py``'s; one spawn per test, the rank
bodies in ``test_torch_albert_rank_bodies.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, PartitionSpec as P

from pipegoose_tpu.distributed.compat import shard_map
from pipegoose_tpu.models import albert as ja
from pipegoose_tpu_torch.models import albert as ta
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_albert import IDS, LMASK, MASK, SIZE
from test_torch_albert_rank_bodies import (
    albert_pp_rank,
    albert_pp_sp_rank,
    albert_sp_rank,
    albert_tp_dp_rank,
)

TREE = ta.init_params_numpy(ta.AlbertConfig(**SIZE), seed=0)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, rtol, atol, what):
    flat = jax.tree_util.tree_leaves(got)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _mesh(names, shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _summed(loss_fn, axes, mesh, in_specs):
    """jit(shard_map(value_and_grad(loss_fn))) with the gradients summed
    over ``axes``, the loss and the gradients replicated out."""
    def body(p, *args):
        loss, grads = jax.value_and_grad(loss_fn)(p, *args)
        for ax in axes:
            grads = jax.tree_util.tree_map(lambda g, ax=ax: jax.lax.psum(g, ax), grads)
        return loss, grads

    return jax.jit(shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=(P(), P()),
                             check_vma=False))


def test_tp2_dp2_fill_mask_and_hybrid_steps_match_jax(devices):
    from pipegoose_tpu.optim.zero import DistributedOptimizer
    from pipegoose_tpu.parallel import make_hybrid_train_step

    jcfg, tcfg = ja.AlbertConfig(**SIZE), ta.AlbertConfig(**SIZE)
    ids = np.random.RandomState(11).randint(0, SIZE["vocab_size"] - 1, (4, 16))
    mask_id = SIZE["vocab_size"] - 1
    masked = np.where(LMASK > 0, mask_id, IDS)
    mesh = _mesh(("data", "tensor"), (2, 2))
    from pipegoose_tpu.distributed import ParallelContext as JaxContext

    ctx = JaxContext.from_mesh(mesh)
    try:
        specs = ja.tp_specs(_j(TREE))
        want_filled = jax.jit(shard_map(
            lambda p, i: ja.fill_mask(p, i, mask_id, jcfg, tp_axis="tensor"), mesh=mesh,
            in_specs=(specs, P()), out_specs=P(), check_vma=False))(_j(TREE),
                                                                     jnp.asarray(masked))
        init_fn, make_step = make_hybrid_train_step(
            lambda p, i: ja.loss_fn(p, i, None, i, jcfg, tp_axis="tensor"), specs,
            DistributedOptimizer(optax.adam(1e-3), axis_name="data"), ctx,
            batch_spec=P("data"))
        p = _j(TREE)
        state = init_fn(p)
        step = make_step(p)
        want_losses = []
        for _ in range(3):
            p, state, loss = step(p, state, jnp.asarray(ids))
            want_losses.append(float(loss))
        want_params = jax.tree_util.tree_map(np.asarray, p)
    finally:
        ctx.destroy()
    ranks = run_ranks(albert_tp_dp_rank, 4, TREE, tcfg, ids, mask_id, masked, 3)
    for r in ranks:
        np.testing.assert_array_equal(r["filled"], np.asarray(want_filled))
        np.testing.assert_allclose(r["losses"], want_losses, rtol=0, atol=2e-4)
        _close(r["params"], want_params, 5e-3, 5e-4, "tp2 x dp2")
    assert want_losses[-1] < want_losses[0]


def test_pp2_gpipe_1f1b_and_uneven_stages_match_jax(devices):
    mesh = _mesh(("pipe",), (2,))
    cases, want = [], []
    args = tuple(jnp.asarray(a) for a in (IDS, MASK, LMASK))
    for kind, counts in (("gpipe", None), ("1f1b", None), ("gpipe", (3, 1)),
                         ("1f1b", (3, 1))):
        jcfg = ja.AlbertConfig(**SIZE)
        jfn = ja.loss_fn_pp if kind == "gpipe" else ja.loss_fn_1f1b
        f = _summed(lambda p, i, m, l, jfn=jfn, counts=counts: jfn(
            p, i, m, i, jcfg, 2, stage_layer_counts=counts, label_mask=l),
            ("pipe",), mesh, (P(), P(), P(), P()))
        loss, grads = f(_j(TREE), *args)
        want.append((float(loss), jax.tree_util.tree_map(np.asarray, grads)))
        cases.append((ta.AlbertConfig(**SIZE), kind, 2, counts))
    ranks = run_ranks(albert_pp_rank, 2, TREE, cases, IDS, MASK, LMASK)
    for i, (loss, grads) in enumerate(want):
        for r in ranks:
            assert abs(r[i]["loss"] - loss) < 2e-5, (cases[i], r[i]["loss"], loss)
            _close(r[i]["grads"], grads, 2e-3, 2e-5, cases[i])


def test_sp2_ring_ulysses_and_flash_ulysses_match_jax(devices):
    mesh = _mesh(("seq",), (2,))
    cases, want = [], []
    args = tuple(jnp.asarray(a) for a in (IDS, MASK, LMASK))
    seq = P(None, "seq")
    for variant, flash in (("ring", False), ("ulysses", False), ("ulysses", True)):
        jcfg = ja.AlbertConfig(**SIZE, use_flash=flash)
        f = _summed(lambda p, i, m, l, jcfg=jcfg, variant=variant: ja.loss_fn_sp(
            p, i, m, i, jcfg, sp_axis="seq", label_mask=l, variant=variant),
            ("seq",), mesh, (P(), seq, seq, seq))
        loss, grads = f(_j(TREE), *args)
        want.append((float(loss), jax.tree_util.tree_map(np.asarray, grads)))
        cases.append((ta.AlbertConfig(**SIZE, use_flash=flash), variant))
    ranks = run_ranks(albert_sp_rank, 2, TREE, cases, IDS, MASK, LMASK)
    for i, (loss, grads) in enumerate(want):
        flash = cases[i][0].use_flash
        for r in ranks:
            assert abs(r[i]["loss"] - loss) < (2e-4 if flash else 2e-5), (cases[i], loss)
            _close(r[i]["grads"], grads, 2e-3, 2e-4 if flash else 2e-5, cases[i])


def test_pp2_sp2_matches_jax(devices):
    jcfg = ja.AlbertConfig(**SIZE)
    mesh = _mesh(("pipe", "seq"), (2, 2))
    seq = P(None, "seq")
    f = _summed(lambda p, i, m, l: ja.loss_fn_pp_sp(p, i, m, i, jcfg, 2, label_mask=l),
                ("pipe", "seq"), mesh, (P(), seq, seq, seq))
    loss, grads = f(_j(TREE), *(jnp.asarray(a) for a in (IDS, MASK, LMASK)))
    grads = jax.tree_util.tree_map(np.asarray, grads)
    ranks = run_ranks(albert_pp_sp_rank, 4, TREE, ta.AlbertConfig(**SIZE), IDS, MASK,
                      LMASK, 2)
    for r in ranks:
        assert abs(r["loss"] - float(loss)) < 2e-5, (r["loss"], float(loss))
        _close(r["grads"], grads, 2e-3, 2e-5, "pp2 x sp2")
