"""The port's ring collective-matmul held against the JAX package on the CPU
(``nn/tensor_parallel/overlap.py``): the cases of
``tests/nn/tensor_parallel/test_overlap.py`` at tp 2 and 4 over gloo ranks.

- ``ring_all_gather_matmul``: every rank's full product against ``x @ w``
  (1e-6, as JAX's test).
- ``ring_matmul_reduce_scatter``: each rank's token chunk of the summed
  product against ``x @ w`` (1e-5).
- The column -> gelu -> row MLP on the token-sharded stream (overlap) and
  on the replicated one (monolithic): the loss (1e-5 relative) and the
  gradients of both kernels, both biases and x against each other (rtol
  1e-4, atol 1e-4, as JAX's test: float32 summation order, values of
  O(1e2)) and against the JAX overlap and monolithic layers under
  ``shard_map`` (2e-6 of each gradient's largest value: float32 sums in two
  libraries, the largest near 1e3).
- ``replicated_for_overlap``: a scale used on 1/tp of the tokens gets the
  full-sequence gradient (1e-5 relative, 1e-6 absolute).
- At tp = 1 and with ``axis_name=None`` the overlap layers are the plain
  product; a quantized leaf is refused as JAX refuses it.

One spawn per world size; the ranks' bodies live in
``test_torch_comm_ranks.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pipegoose_tpu.distributed.compat import shard_map
from pipegoose_tpu.distributed.functional import (
    gather_from_tensor_group,
    scatter_to_tensor_group,
)
from pipegoose_tpu.nn.tensor_parallel import layers as jlayers
from pipegoose_tpu_torch.nn.tensor_parallel import layers as tlayers
from pipegoose_tpu_torch.nn.tensor_parallel import overlap as tover
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_comm_ranks import overlap_rank

B, S, K, O = 2, 8, 16, 24
JAX_REL = 2e-6   # port vs JAX: of each gradient's largest value (float32 sums, two libraries)


def _rand(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


@functools.lru_cache(maxsize=None)
def _case(tp):
    col = {"kernel": _rand(5, (K, O)), "bias": _rand(6, (O,)) * 0.1}
    row = {"kernel": _rand(7, (O, K)), "bias": _rand(8, (K,)) * 0.1}
    o = O // tp
    mlp = {"x": _rand(4, (B, S, K)),
           # each rank's shards: column kernel/bias by OUT, row kernel by IN
           "col": {"kernel": np.stack([col["kernel"][:, r * o:(r + 1) * o] for r in range(tp)]),
                   "bias": np.stack([col["bias"][r * o:(r + 1) * o] for r in range(tp)])},
           "row": {"kernel": np.stack([row["kernel"][r * o:(r + 1) * o] for r in range(tp)]),
                   "bias": np.stack([row["bias"]] * tp)}}
    return dict(x=_rand(0, (B, S, K)), w_col=_rand(1, (K, O)),
                x_full=_rand(2, (B, S, K * tp)), w_row=_rand(3, (K * tp, O)),
                mlp=mlp, xs=_rand(9, (B, S, K)), scale=_rand(10, (K,))), col, row


def _jax_mlp(tp, col, row, x, overlap):
    """JAX's loss and gradients of the MLP under shard_map on a (data,
    tensor) mesh (tests/nn/tensor_parallel/test_overlap.py)."""
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8 // tp, tp), ("data", "tensor"))
    col_spec = {"kernel": P(None, "tensor"), "bias": P("tensor")}
    row_spec = {"kernel": P("tensor", None), "bias": P()}

    def loss(col, row, x):
        if overlap:
            xl = scatter_to_tensor_group(x, "tensor", dim=1)
            h = jlayers.column_parallel_linear(col, xl, "tensor", overlap=True)
            y = jlayers.row_parallel_linear(row, jax.nn.gelu(h), "tensor", overlap=True)
            y = gather_from_tensor_group(y, "tensor", dim=1)
        else:
            h = jlayers.column_parallel_linear(col, x, "tensor")
            y = jlayers.row_parallel_linear(row, jax.nn.gelu(h), "tensor")
        return (y.astype(jnp.float32) ** 2).sum()

    f = shard_map(jax.value_and_grad(loss, argnums=(0, 1, 2)), mesh=mesh,
                  in_specs=(col_spec, row_spec, P()),
                  out_specs=(P(), (col_spec, row_spec, P())), check_vma=False)
    tree = jax.tree_util.tree_map(jnp.asarray, (col, row, x))
    loss, (gc, gr, gx) = f(*tree)
    return float(loss), [np.asarray(a) for a in (gc["kernel"], gc["bias"], gr["kernel"],
                                                 gr["bias"], gx)]


def _whole(per_rank, kind):
    """The ranks' gradient shards put back whole (column: OUT, row: IN)."""
    if kind in ("col_kernel",):
        return np.concatenate(per_rank, axis=1)
    if kind in ("col_bias", "row_kernel"):
        return np.concatenate(per_rank, axis=0)
    return per_rank[0]


@pytest.mark.parametrize("tp", [2, 4])
def test_ring_overlap_matches_dense_and_jax(devices, tp):
    case, col, row = _case(tp)
    ranks = run_ranks(overlap_rank, tp, case, timeout=240)
    want_gather = case["x"] @ case["w_col"]
    want_reduce = case["x_full"] @ case["w_row"]
    m = S // tp
    for r, (gathered, reduced, mlp, scale_grad) in enumerate(ranks):
        np.testing.assert_allclose(gathered, want_gather, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(reduced, want_reduce[:, r * m:(r + 1) * m],
                                   rtol=1e-5, atol=1e-5)
    kinds = ("col_kernel", "col_bias", "row_kernel", "row_bias", "x")
    jax_runs = {ov: _jax_mlp(tp, col, row, case["mlp"]["x"], ov) for ov in (False, True)}
    for i, kind in enumerate(kinds):   # the port's overlap vs its monolithic
        mono, ovl = (_whole([r[2][idx][i + 1] for r in ranks], kind) for idx in (0, 1))
        np.testing.assert_allclose(ovl, mono, rtol=1e-4, atol=1e-4, err_msg=kind)
    for idx, overlap in enumerate((False, True)):
        loss = float(ranks[0][2][idx][0])
        for ov in (False, True):
            np.testing.assert_allclose(loss, jax_runs[ov][0], rtol=1e-5)
        for i, kind in enumerate(kinds):
            got = _whole([r[2][idx][i + 1] for r in ranks], kind)
            for ov in (False, True):
                want = jax_runs[ov][1][i]
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=JAX_REL * float(np.abs(want).max()),
                                           err_msg=f"overlap={overlap} vs jax {ov}: {kind}")
    # replicated_for_overlap: the full-sequence gradient on every rank
    want = jax.grad(lambda s, x: ((x * s).astype(jnp.float32) ** 2).sum())(
        jnp.asarray(case["scale"]), jnp.asarray(case["xs"]))
    for r in ranks:
        np.testing.assert_allclose(r[3], np.asarray(want), rtol=1e-5, atol=1e-6)


def test_overlap_without_an_axis_is_the_plain_product():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, S, K)).astype(np.float32))
    col = {"kernel": torch.from_numpy(rng.standard_normal((K, O)).astype(np.float32)),
           "bias": torch.from_numpy(rng.standard_normal(O).astype(np.float32))}
    row = {"kernel": torch.from_numpy(rng.standard_normal((O, K)).astype(np.float32)),
           "bias": torch.from_numpy(rng.standard_normal(K).astype(np.float32))}
    h = tlayers.column_parallel_linear(col, x, None, overlap=True)
    assert torch.equal(h, tlayers.column_parallel_linear(col, x, None))
    y = tlayers.row_parallel_linear(row, h, None, overlap=True)
    assert torch.equal(y, tlayers.row_parallel_linear(row, h, None))
    assert tover.replicated_for_overlap(col, None) is col
    assert torch.equal(tover.ring_all_gather_matmul(x, col["kernel"], None),
                       x @ col["kernel"])


@pytest.mark.parametrize("layer", ["column", "row"])
def test_overlap_refuses_a_quantized_leaf_as_jax_does(layer):
    leaf = {"q": np.zeros((4, 4), np.int8), "scale": np.ones(4, np.float32)}
    fn = {"column": jlayers.column_parallel_linear, "row": jlayers.row_parallel_linear}
    with pytest.raises(ValueError) as want:
        fn[layer]({k: jnp.asarray(v) for k, v in leaf.items()}, jnp.zeros((2, 4, 4)),
                  "tensor", overlap=True)
    tfn = {"column": tlayers.column_parallel_linear, "row": tlayers.row_parallel_linear}
    with pytest.raises(ValueError) as got:
        tfn[layer]({k: torch.from_numpy(v) for k, v in leaf.items()},
                   torch.zeros(2, 4, 4), "tensor", overlap=True)
    assert str(got.value) == str(want.value)
