"""The port's ``torch.distributed`` context and collectives held against
the JAX package on the CPU.

- A wrong world size raises, as does a context without a process group
  or with a diloco size below 1; at diloco 2 x data 2 x tensor 2 the
  DiLoCo groups equal the JAX mesh's (the body in
  ``test_torch_diloco_rank_bodies.py``).
- The rank layout: for (tp, pp, dp, sp) = (2, 1, 2, 2) and (1, 2, 1, 4),
  every mode's local rank, group and first/last flags of each of 8 gloo
  ranks equal the JAX context's mesh coordinates over 8 fake devices, and
  an all_reduce of the global rank over each group sums exactly that
  group.
- Every collective of ``functional`` over 2 and 4 gloo ranks equals the
  JAX one under ``shard_map``, and the vjps of the shifts, ``ppermute``,
  ``all_to_all`` and the f/g operators equal ``jax.vjp``'s.

The ranks run in spawned processes (``testing.dist.run_ranks``); their
bodies live in ``test_torch_sp_ranks.py``, which imports no JAX. Inputs
come from a numpy seed. Tolerance 1e-6 absolute: moves are exact, but
gloo and XLA add the 2 or 4 float32 values of order 1 of a sum in another
order, a few ulps apart.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from pipegoose_tpu.distributed import ParallelContext as JaxContext
from pipegoose_tpu.distributed import ParallelMode as JaxMode
from pipegoose_tpu.distributed import functional as jF
from pipegoose_tpu.distributed.compat import shard_map
from pipegoose_tpu_torch.distributed import ParallelContext
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_diloco_rank_bodies import diloco_layout_rank
from test_torch_sp_ranks import GRAD_OPS, collectives_rank, layout_rank, wrong_world_size_rank

SIZES = [(2, 1, 2, 2), (1, 2, 1, 4)]   # (tp, pp, dp, sp), 8 ranks each
SHAPE = (4, 8)
ATOL = 1e-6


def test_rank_layout_matches_the_jax_mesh(devices):
    port = run_ranks(layout_rank, 8, SIZES)
    for i, (tp, pp, dp, sp) in enumerate(SIZES):
        ctx = JaxContext(tensor_parallel_size=tp, pipeline_parallel_size=pp,
                         data_parallel_size=dp, sequence_parallel_size=sp,
                         devices=devices[:8])
        try:
            for rank, dev in enumerate(ctx.mesh.devices.flat):
                assert ctx.get_global_rank(dev) == rank
                for mode in JaxMode:
                    if mode == JaxMode.DILOCO:
                        continue
                    local, group, total, first, last = port[rank][i][mode.value]
                    want_group = ctx.get_ranks_in_group(dev, mode)
                    assert local == ctx.get_local_rank(dev, mode), (rank, mode)
                    assert list(group) == want_group, (rank, mode)
                    assert total == sum(want_group), (rank, mode)
                    assert first == ctx.is_first_rank(dev, mode)
                    assert last == ctx.is_last_rank(dev, mode)
        finally:
            ctx.destroy()


def test_context_raises_on_a_wrong_world_size():
    with pytest.raises(RuntimeError, match="world size 2 is not"):
        run_ranks(wrong_world_size_rank, 2)


def test_context_needs_a_process_group_and_rejects_diloco(devices):
    """Without a process group the context raises, as it does for a diloco
    size below 1; at diloco 2 x data 2 x tensor 2 (DiLoCo's outermost
    worker axis, ``optim.diloco``) every mode's local rank, group and
    first/last flags of each of 8 gloo ranks equal the JAX mesh's, and an
    all_reduce over each group sums exactly that group."""
    with pytest.raises(RuntimeError, match="no default process group"):
        ParallelContext(device="cpu")
    with pytest.raises(ValueError, match="diloco parallel size must be >= 1"):
        ParallelContext(diloco_parallel_size=0, device="cpu")
    port = run_ranks(diloco_layout_rank, 8, 2, 2, 2)
    ctx = JaxContext(diloco_parallel_size=2, data_parallel_size=2, tensor_parallel_size=2,
                     devices=devices[:8])
    try:
        for rank, dev in enumerate(ctx.mesh.devices.flat):
            assert ctx.get_global_rank(dev) == rank
            for mode in JaxMode:
                local, group, total, first, last = port[rank][mode.value]
                want_group = ctx.get_ranks_in_group(dev, mode)
                assert local == ctx.get_local_rank(dev, mode), (rank, mode)
                assert list(group) == want_group, (rank, mode)
                assert total == sum(want_group), (rank, mode)
                assert first == ctx.is_first_rank(dev, mode)
                assert last == ctx.is_last_rank(dev, mode)
        assert [int(r) for r in port[5]["diloco"][1]] == [1, 5]   # strided by 4
    finally:
        ctx.destroy()


def _jax_collectives(world):
    perm = [(i, (i + 2) % world) for i in range(world)] if world > 2 else [(0, 1)]
    return {
        "all_reduce_sum": lambda x: jF.all_reduce(x, "seq"),
        "all_reduce_max": lambda x: jF.all_reduce(x, "seq", "max"),
        "all_reduce_min": lambda x: jF.all_reduce(x, "seq", "min"),
        "all_reduce_mean": lambda x: jF.all_reduce(x, "seq", "mean"),
        "all_gather_0": lambda x: jF.all_gather(x, "seq", dim=0),
        "all_gather_1": lambda x: jF.all_gather(x, "seq", dim=-1),
        "scatter": lambda x: jF.scatter(x, "seq", dim=0),
        "reduce_scatter": lambda x: jF.reduce_scatter(x, "seq", dim=0),
        "broadcast": lambda x: jF.broadcast(x, "seq", src=1),
        "reduce": lambda x: jF.reduce(x, "seq", dst=1),
        "all_to_all": lambda x: jF.all_to_all(x, "seq", split_dim=1, concat_dim=0),
        "ppermute": lambda x: jF.ppermute(x, "seq", perm),
        "shift_right": lambda x: jF.shift_right(x, "seq"),
        "shift_left": lambda x: jF.shift_left(x, "seq"),
        "copy_to_tensor_group": lambda x: jF.copy_to_tensor_group(x, "seq"),
        "reduce_from_tensor_group": lambda x: jF.reduce_from_tensor_group(x, "seq"),
        "gather_from_tensor_group": lambda x: jF.gather_from_tensor_group(x, "seq", dim=0),
        "scatter_to_tensor_group": lambda x: jF.scatter_to_tensor_group(x, "seq", dim=0),
    }


def _inputs(world):
    """Each rank's (4, 8) input and, for the ops of GRAD_OPS, a cotangent of
    each rank's output shape."""
    rng = np.random.default_rng(world)
    xs = rng.standard_normal((world, *SHAPE), dtype=np.float32)
    cts = {name: rng.standard_normal(_shard(fn, world)(xs).shape, dtype=np.float32)
           for name, fn in _jax_collectives(world).items() if name in GRAD_OPS}
    return xs, cts


def _shard(body, world):
    """``body`` on each device's slice of a leading (world, ...) axis, its
    outputs stacked back on that axis."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    return jax.jit(shard_map(lambda *xs: jax.tree_util.tree_map(
        lambda y: y[None], body(*(x[0] for x in xs))), mesh=mesh,
        in_specs=P("seq"), out_specs=P("seq"), check_vma=False))


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_and_their_vjps_match_shard_map(devices, world):
    xs, cts = _inputs(world)
    port = run_ranks(collectives_rank, world, xs, cts)
    fns = _jax_collectives(world)
    for name, fn in fns.items():
        want = np.asarray(_shard(fn, world)(xs))
        got = np.stack([r[name] for r in port])
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=name)
    for name in GRAD_OPS:
        def vjp(x, ct, fn=fns[name]):
            return jax.vjp(fn, x)[1](ct)[0]
        want = np.asarray(_shard(vjp, world)(xs, cts[name]))
        got = np.stack([r[name + "/grad"] for r in port])
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=f"{name} vjp")
