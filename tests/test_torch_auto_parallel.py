"""The port's auto-parallel step (``parallel.make_auto_train_step``, the
single-device ``loss_fn`` on DTensor parameters) held against the JAX
package on the CPU: ``tests/test_auto_parallel.py``'s case (vocab 128,
hidden 64, 2 layers, 4 heads, B = 8 x S = 12, full logits, the plain
attention, 3 Adam steps at 1e-3) at TP2 x DP2 on 4 gloo ranks. Its losses
and final params (gathered whole) against the JAX ``make_auto_train_step``
on a (data 2, tensor 2) mesh and against the port's hybrid step
(``make_hybrid_train_step`` with ZeRO-1 over "data") in the same spawn, to
``tests/test_auto_parallel.py``'s tolerances: losses rtol 2e-3 / atol
2e-4, params rtol 5e-3 / atol 5e-4. Weights from ``init_params_numpy``
seed 0, float32. The rank body lives in ``test_torch_hybrid_ranks.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax

from pipegoose_tpu.distributed import ParallelContext as JaxContext
from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.parallel import make_auto_train_step as jax_auto_step
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_hybrid_ranks import auto_rank

SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
STEPS, LR = 3, 1e-3
LOSS_TOL = dict(rtol=2e-3, atol=2e-4)       # tests/test_auto_parallel.py
PARAM_TOL = dict(rtol=5e-3, atol=5e-4)


def _jax_auto(np_tree, batches):
    cfg = jbloom.BloomConfig(**SIZE)
    params = jax.tree_util.tree_map(jnp.asarray, np_tree)
    ctx = JaxContext(tensor_parallel_size=2, data_parallel_size=2)
    try:
        init_fn, step = jax_auto_step(lambda p, b: jbloom.loss_fn(p, b, None, b, cfg),
                                      jbloom.tp_specs(params), optax.adam(LR), ctx)
        p, s = init_fn(params)
        losses = []
        for ids in batches:
            p, s, loss = step(p, s, jnp.asarray(ids))
            losses.append(float(loss))
        return losses, jax.tree_util.tree_map(np.asarray, p)
    finally:
        ctx.destroy()


def _close(got, want, what):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        np.testing.assert_allclose(g, np.asarray(w), **PARAM_TOL,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_auto_step_at_tp2_dp2_matches_jax_auto_and_the_hybrid_step(devices):
    np_tree = tbloom.init_params_numpy(tbloom.BloomConfig(**SIZE), seed=0)
    ids = np.random.RandomState(0).randint(0, 128, (8, 12))
    batches = [ids] * STEPS            # tests/test_auto_parallel.py repeats one batch
    ranks = run_ranks(auto_rank, 4, np_tree, tbloom.BloomConfig(**SIZE), batches, LR, 2,
                      timeout=300)
    want_losses, want = _jax_auto(np_tree, batches)
    for rank, got in enumerate(ranks):
        # the params really are sharded: qkv's out dim over "tensor"
        assert got["qkv_local"] == (64, 96), rank
        np.testing.assert_allclose(got["auto_losses"], want_losses, **LOSS_TOL)
        np.testing.assert_allclose(got["auto_losses"], got["hybrid_losses"], **LOSS_TOL)
        _close(got["auto"], want, f"rank {rank}: auto vs JAX auto")
        _close(got["auto"], got["hybrid"], f"rank {rank}: auto vs hybrid")
    # the steps moved the params (Adam: ~lr a step) past the tolerance, and
    # the loss fell
    moved = max(float(np.abs(np.asarray(w) - np.asarray(i)).max()) for w, i in zip(
        jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(np_tree)))
    assert moved > 5 * PARAM_TOL["atol"]
    assert want_losses[0] > want_losses[1] > want_losses[2]
