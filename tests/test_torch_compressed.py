"""The port's compressed gradient reduction held against the JAX package on
the CPU (``distributed/compressed.py``).

- ``_quantize_chunks`` / ``_dequantize``: int8 payloads and float32 scales
  bit for bit against JAX's, on chunks with half-step ties (both round half
  to even), an all-zero chunk (the ``tiny`` floor) and random values.
- ``compressed_reduce_scatter_mean`` and ``compressed_all_reduce_mean``
  for each mode, with and without a residual, at dp 2 and 4 over gloo ranks
  against the JAX functions under ``shard_map`` over "data" on the same
  per-rank inputs:
  - fp32 means within 1e-6 of the largest value (float32 sums, another
    order);
  - int8: the residuals bit for bit (the same payloads and scales), the
    means within 1e-6 of the largest (float32 sums of the same dequantized
    values, another order);
  - bf16: the wire sums in bf16 on both sides, in another order, so each of
    the n - 1 adds may round once more: the means within n x 2^-8 of the
    sum of the ranks' magnitudes (over n), the residuals bit for bit.
- ``average_gradients(grad_comm=)`` against JAX's (an expert leaf stays
  local in every mode), ``DistributedOptimizer`` at dp 2 with int8 and
  error feedback, 3 steps, against JAX's (params 1e-6; residuals 2^-21 of
  the largest gradient: the jitted JAX step fuses ``g - q x scale`` into one
  FMA, the port rounds the product first), and at dp 1, where both still round every gradient to
  int8 (the update differs from the float32 one).
- ``wire_itemsize``, ``grad_comm_bytes_saved`` and the mode errors equal
  JAX's.

One spawn per world size; the ranks' bodies live in
``test_torch_comm_ranks.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pipegoose_tpu.distributed import compressed as jc
from pipegoose_tpu.distributed.compat import shard_map
from pipegoose_tpu.nn import parallel_mapping as jpm
from pipegoose_tpu.nn.data_parallel import average_gradients as javg
from pipegoose_tpu.optim.zero import DistributedOptimizer as JaxZero
from pipegoose_tpu_torch.distributed import compressed as tc
from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_comm_ranks import compressed_rank

MODES = ("fp32", "bf16", "int8")
LR = 1e-3
OPT_LEAVES = {"a": (5, 3), "b": (7,), "c": ()}


def _mesh(dp):
    return Mesh(np.asarray(jax.devices()[:dp]), ("data",))


def _tie_chunks():
    """Chunks whose scale is exactly 1 (max 127) with half-step ties, an
    all-zero chunk, and a random one."""
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5], np.float32)
    rnd = np.random.default_rng(0).standard_normal(8).astype(np.float32) * 3
    return np.stack([ties, np.zeros(8, np.float32), rnd])


def test_quantize_chunks_bit_for_bit():
    flat = _tie_chunks()
    jq, js = jc._quantize_chunks(jnp.asarray(flat))
    tq, ts = tc._quantize_chunks(torch.from_numpy(flat))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert list(tq.numpy()[0, 1:4]) == [0, 2, 2]   # half to even
    assert (tc._dequantize(tq, ts).numpy()[1] == 0).all()
    np.testing.assert_array_equal(tc._dequantize(tq, ts).numpy(),
                                  np.asarray(jc._dequantize(jq, js)))


@functools.lru_cache(maxsize=None)
def _cases(dp):
    """(reduce cases, average cases, optimizer case) at ``dp`` ranks."""
    rng = np.random.default_rng(10 + dp)

    def g(shape):
        return rng.standard_normal((dp, *shape)).astype(np.float32)

    reduce_cases = []
    for mode in MODES:
        for with_res in (False, True):
            res = (lambda s: g(s) * 0.01) if with_res else (lambda s: None)
            reduce_cases.append(("rs", mode, g((8, 6)), res((8, 6))))
            for shape in ((5, 3), ()):
                # a residual has the padded shape the reduce-scatter sees
                d0 = shape[0] if shape else 1
                padded = (-(-d0 // dp) * dp, *shape[1:])
                reduce_cases.append(("ar", mode, g(shape), res(padded)))
    avg_cases = [(mode, {"w": g((6, 4)), "v": g((5,)), "expert/w": g((3, 2))})
                 for mode in MODES]
    opt_rng = np.random.default_rng(3)
    leaves = {k: opt_rng.standard_normal(s).astype(np.float32)
              for k, s in OPT_LEAVES.items()}
    grads = [{k: opt_rng.standard_normal((dp, *s)).astype(np.float32)
              for k, s in OPT_LEAVES.items()} for _ in range(3)]
    return reduce_cases, avg_cases, ("int8", True, leaves, grads, LR)


def _jax_reduce(kind, mode, g, res, dp):
    fn = jc.compressed_reduce_scatter_mean if kind == "rs" else jc.compressed_all_reduce_mean

    def body(g, r):
        out, nr = fn(g[0], "data", mode, None if res is None else r[0])
        return out[None], (jnp.zeros((1,)) if nr is None else nr[None])

    r_in = np.zeros((dp,), np.float32) if res is None else res
    out, nr = shard_map(body, mesh=_mesh(dp), in_specs=(P("data"), P("data")),
                        out_specs=(P("data"), P("data")), check_vma=False)(
        jnp.asarray(g), jnp.asarray(r_in))
    return np.asarray(out), (None if res is None else np.asarray(nr))


def _check_reduce(case, got, dp):
    kind, mode, g, res = case
    want, want_res = _jax_reduce(kind, mode, g, res, dp)
    name = f"{kind} {mode} {'res' if res is not None else ''} shape {g.shape[1:]}"
    mine = np.stack([r[0] for r in got])
    big = float(np.abs(want).max()) or 1.0
    if mode == "bf16":
        shape = g.shape[1:]
        gp = g.reshape(dp, -1, *shape[1:]) if shape else g.reshape(dp, 1)
        pad = (-gp.shape[1]) % dp
        gp = np.concatenate([gp, np.zeros((dp, pad, *gp.shape[2:]), gp.dtype)], axis=1)
        mags = np.abs(gp + (0 if res is None else res)).sum(axis=0) / dp
        mags = (np.stack(np.split(mags, dp)) if kind == "rs"
                else np.broadcast_to(mags[:shape[0]] if shape else mags[0], want.shape))
        bound = dp * 2.0 ** -8 * mags + 1e-7
        assert (np.abs(mine - want) <= bound).all(), name
    else:
        np.testing.assert_allclose(mine, want, rtol=0, atol=1e-6 * big, err_msg=name)
    if res is None:
        assert all(r[1] is None for r in got), name
    else:
        np.testing.assert_array_equal(np.stack([r[1] for r in got]), want_res,
                                      err_msg=name)


def _check_avg(case, got, dp):
    mode, tree = case
    experts = jpm.ParallelMapping([(r"expert/w", jpm.Expert())])
    stacked = {k: jnp.asarray(v) for k, v in tree.items()}

    def body(t):
        out = javg({k: v[0] for k, v in t.items()}, "data", expert_mapping=experts,
                   grad_comm=mode)
        return {k: v[None] for k, v in out.items()}

    want = shard_map(body, mesh=_mesh(dp), in_specs=(P("data"),),
                     out_specs=P("data"), check_vma=False)(stacked)
    for k in tree:
        mine, w = np.stack([r[k] for r in got]), np.asarray(want[k])
        if mode == "bf16":   # as in _check_reduce
            bound = dp * 2.0 ** -8 * np.abs(tree[k]).sum(axis=0) / dp + 1e-7
            assert (np.abs(mine - w) <= bound).all(), f"{mode} {k}"
        else:
            np.testing.assert_allclose(mine, w, rtol=0, atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=f"{mode} {k}")
    np.testing.assert_array_equal(np.stack([r["expert/w"] for r in got]),
                                  tree["expert/w"])   # local, never averaged


def _run_jax_zero(case, dp):
    mode, ef, leaves, grads, lr = case
    opt = JaxZero(optax.adam(lr), axis_name="data", grad_comm=mode, error_feedback=ef)
    mesh = _mesh(dp)
    from pipegoose_tpu.parallel.hybrid import zero_state_spec

    params = {k: jnp.asarray(v) for k, v in leaves.items()}
    specs = {k: P() for k in leaves}
    st_spec = zero_state_spec(opt, params, specs, mesh)
    state = shard_map(opt.init, mesh=mesh, in_specs=(specs,), out_specs=st_spec,
                      check_vma=False)(params)

    def step(gs, p, st):
        return opt.step({k: v[0] for k, v in gs.items()}, st, p)

    f = jax.jit(shard_map(step, mesh=mesh, in_specs=(P("data"), specs, st_spec),
                          out_specs=(specs, st_spec), check_vma=False))
    for g in grads:
        params, state = f({k: jnp.asarray(v) for k, v in g.items()}, params, state)
    return params, state.ef


def _ef_atol(case):
    """The residuals' tolerance: the jitted JAX step fuses ``g - q * scale``
    into one FMA, the port rounds the product first, so a residual may
    differ by the product's rounding: a few ulps of the largest gradient."""
    return 2.0 ** -21 * max(float(np.abs(v).max()) for g in case[3] for v in g.values())


def _check_opt(case, got, dp):
    want_p, want_ef = _run_jax_zero(case, dp)
    for params, ef in got:
        for k in OPT_LEAVES:
            np.testing.assert_allclose(params[k], np.asarray(want_p[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    for r, (_, ef) in enumerate(got):
        for i, k in enumerate(OPT_LEAVES):
            np.testing.assert_allclose(ef[i][0], np.asarray(want_ef[k])[r], rtol=0,
                                       atol=_ef_atol(case), err_msg=f"ef {k} rank {r}")


@pytest.mark.parametrize("dp", [2, 4])
def test_compressed_reductions_match_jax(devices, dp):
    reduce_cases, avg_cases, opt_case = _cases(dp)
    ranks = run_ranks(compressed_rank, dp, reduce_cases, avg_cases, opt_case,
                      timeout=240)
    for i, case in enumerate(reduce_cases):
        _check_reduce(case, [r[0][i] for r in ranks], dp)
    for i, case in enumerate(avg_cases):
        _check_avg(case, [r[1][i] for r in ranks], dp)
    _check_opt(opt_case, [r[2] for r in ranks], dp)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_one_rank_still_rounds_every_gradient(devices, tmp_path, mode):
    """dp = 1: JAX's all_to_all and psum_scatter are the identity, yet the
    gradients are still rounded to the wire's precision; the port's
    one-rank ZeRO step does the same: equal to JAX's, and not the float32
    step."""
    import torch.distributed as dist

    from pipegoose_tpu_torch.distributed import ParallelContext

    case = _cases(1)[2]
    case = (mode, True, *case[2:])
    want_p, want_ef = _run_jax_zero(case, 1)
    fp32_p, _ = _run_jax_zero(("fp32", False, *case[2:]), 1)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cpu",
                                         data_parallel_size=1)
    try:
        _, _, leaves, grads, lr = case
        params = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
        opt = DistributedOptimizer(adam(lr), "data", grad_comm=mode, error_feedback=True)
        state = opt.init(params)
        for g in grads:
            params, state = opt.step({k: torch.from_numpy(np.array(v[0])) for k, v in g.items()},
                                     state, params)
    finally:
        ctx.destroy()
    for i, k in enumerate(OPT_LEAVES):
        np.testing.assert_allclose(params[k].numpy(), np.asarray(want_p[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(state.ef[i][0].numpy(), np.asarray(want_ef[k])[0],
                                   rtol=0, atol=_ef_atol(case))
    assert any(float(e.abs().max()) > 0 for e in state.ef)   # something was rounded
    assert any(float(np.abs(params[k].numpy() - np.asarray(fp32_p[k])).max()) > 0
               for k in OPT_LEAVES), "the compressed step equals the float32 one"


def test_wire_sizes_and_bytes_saved_equal_jax():
    tree = {"emb": np.zeros((10, 4)), "blocks": {"w": np.zeros((3, 5, 2)),
                                                 "b": np.zeros((3,))}, "s": np.zeros(())}
    for mode in MODES:
        assert tc.wire_itemsize(mode) == jc.wire_itemsize(mode)
        for n in (1, 2, 3, 4):
            assert tc.grad_comm_bytes_saved(tree, n, mode) == \
                jc.grad_comm_bytes_saved(tree, n, mode), (mode, n)
    assert tc.check_grad_comm(None) == jc.check_grad_comm(None) == "fp32"


def _error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("probe", ["mode", "ef_fp32", "ef_no_axis", "wire"])
def test_mode_errors_equal_jax(probe):
    if probe == "mode":
        got = _error(lambda: tc.check_grad_comm("fp8"))
        want = _error(lambda: jc.check_grad_comm("fp8"))
    elif probe == "ef_fp32":
        got = _error(lambda: DistributedOptimizer(adam(LR), error_feedback=True))
        want = _error(lambda: JaxZero(optax.adam(LR), error_feedback=True))
    elif probe == "ef_no_axis":
        got = _error(lambda: DistributedOptimizer(adam(LR), None, "int8", True))
        want = _error(lambda: JaxZero(optax.adam(LR), None, "int8", True))
    else:
        got = _error(lambda: tc.wire_itemsize("int4"))
        want = _error(lambda: jc.wire_itemsize("int4"))
    assert got == want


def test_replace_keeps_the_other_fields():
    opt = DistributedOptimizer(adam(LR), "data", "int8", True)
    bf = opt.replace(grad_comm="bf16")
    assert (bf.grad_comm, bf.error_feedback, bf.axis_name, bf.inner) == \
        ("bf16", True, "data", opt.inner)
    assert opt.grad_comm == "int8"
    with pytest.raises(ValueError, match="error_feedback"):
        opt.replace(grad_comm="fp32")


EF_SPECS = [(), ("tensor",), (None, "tensor"), ("tensor", None), (("tensor", "seq"), None)]


@pytest.mark.parametrize("spec", EF_SPECS, ids=str)
@pytest.mark.parametrize("ndim", [0, 1, 2])
def test_ef_param_spec_equals_jax(spec, ndim):
    from pipegoose_tpu.optim import zero as jzero
    from pipegoose_tpu_torch.optim import zero as tzero

    assert tzero.ef_param_spec(spec, ndim) == tuple(jzero.ef_param_spec(P(*spec), ndim))
    with pytest.raises(ValueError) as got:
        tzero.ef_param_spec(("data",), 1)
    with pytest.raises(ValueError) as want:
        jzero.ef_param_spec(P("data"), 1)
    assert str(got.value) == str(want.value).replace("PartitionSpec('data',)", "('data',)")


def test_zero_state_spec_carries_the_ef_specs():
    from pipegoose_tpu_torch.parallel import hybrid as thybrid

    params = {"w": torch.zeros(6, 4), "b": torch.zeros(4)}
    specs = {"w": (None, "tensor"), "b": ("tensor",)}
    plain = thybrid.zero_state_spec(DistributedOptimizer(adam(LR)), params, specs)
    ef = thybrid.zero_state_spec(DistributedOptimizer(adam(LR), "data", "int8", True),
                                 params, specs)
    assert ef == {"inner": plain, "ef": {"w": ("data", None, "tensor"),
                                         "b": ("data", "tensor")}}
