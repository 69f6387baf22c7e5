"""The port's expert layer held against the JAX package on the CPU.

- ``expert_mlp`` with the default GELU (``jax.nn.gelu``'s tanh form) and
  with BLOOM's ``bloom_gelu``, against the JAX function (1e-6);
- ``moe_layer`` at ep = 1 (no axis), top-1 and top-2, ample and dropping
  capacity, and with an ``mlp_fn`` (a SwiGLU, as Mixtral passes one),
  against JAX (1e-6), and against a per-token loop of the dense experts;
  a dropped token's output is zero;
- the gradients reach only the routed experts
  (``tests/nn/expert_parallel/test_experts.py:88-104``); the gradients of
  the experts, the gate and the tokens equal ``jax.grad``'s (within 1e-6 of
  max(1, the leaf's largest value));
- ``ExpertLoss`` against JAX's over a tree of per-layer losses;
- ``ExpertParallel`` on a one-rank context: ``expand_mlp`` exact tiles;
  ``from_dense`` on the port's per-layer tree at jitter 0 equal, through
  ``params_to_jax``, to JAX's upcycling (the stacked tree refused),
  jittered copies that differ and repeat by seed, ``init_router``'s shape,
  scale and device; ``parallelize`` gives ``moe_specs``;
- ``expert_mlp_specs`` and ``moe_specs`` equal JAX's, on the stacked numpy
  tree and (leading None dropped) on the port's per-layer tree.

H = 8, E = 4, T = 16, FFN 32 as the JAX tests; float32, numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import bloom as jbloom_dense
from pipegoose_tpu.models import bloom_moe as jmoe
from pipegoose_tpu.nn.expert_parallel import experts as jex
from pipegoose_tpu.nn.expert_parallel import loss as jloss
from pipegoose_tpu.nn.expert_parallel import routers as jr
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models import bloom_moe as tmoe
from pipegoose_tpu_torch.models.weights import params_from_jax, params_to_jax
from pipegoose_tpu_torch.nn.expert_parallel import (
    ExpertLoss,
    ExpertParallel,
    TopKRouter,
    expert_mlp,
    init_experts,
    moe_layer,
)
from pipegoose_tpu_torch.nn.expert_parallel.experts import expert_mlp_specs

H, E, T, FFN = 8, 4, 16, 32
TOL = 1e-6


def _experts_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "up": {"kernel": rng.standard_normal((E, H, FFN)).astype(np.float32) * 0.3,
               "bias": rng.standard_normal((E, FFN)).astype(np.float32) * 0.1},
        "down": {"kernel": rng.standard_normal((E, FFN, H)).astype(np.float32) * 0.3,
                 "bias": rng.standard_normal((E, H)).astype(np.float32) * 0.1},
    }


def _gate_np(seed=1, bias=None):
    rng = np.random.default_rng(seed)
    gate = {"gate": {"kernel": rng.standard_normal((H, E)).astype(np.float32)}}
    if bias is not None:
        gate["gate"]["bias"] = np.asarray(bias, np.float32)
    return gate


def _x_np(seed=2, shape=(T, H)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _t(v, grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).requires_grad_(grad)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def _close_grad(got, want, tol=TOL):
    """A gradient within ``tol`` of max(1, its largest |value|)."""
    want = np.asarray(want)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())))


def _close_trees(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_trees(got[k], want[k], tol)
    else:
        _close_grad(got.detach().numpy() if torch.is_tensor(got) else got, want, tol)


@pytest.mark.parametrize("act", ["default", "bloom_gelu"])
def test_expert_mlp_matches_jax(act):
    ex = _experts_np()
    x = _x_np(shape=(E, 5, H))
    jact = jax.nn.gelu if act == "default" else jbloom_dense.bloom_gelu
    want = jex.expert_mlp(_j(ex), jnp.asarray(x), jact)
    kw = {} if act == "default" else {"act": tbloom.bloom_gelu}
    got = expert_mlp(_t(ex), torch.from_numpy(x), **kw)
    _close(got.numpy(), want)


def _swiglu_np():
    rng = np.random.default_rng(9)
    return {"gate": rng.standard_normal((E, H, FFN)).astype(np.float32) * 0.3,
            "up": rng.standard_normal((E, H, FFN)).astype(np.float32) * 0.3,
            "down": rng.standard_normal((E, FFN, H)).astype(np.float32) * 0.3}


def _jax_swiglu(p, x, tp_axis):
    g = jnp.einsum("esh,ehf->esf", x, p["gate"])
    u = jnp.einsum("esh,ehf->esf", x, p["up"])
    return jnp.einsum("esf,efh->esh", jax.nn.silu(g) * u, p["down"])


def _port_swiglu(p, x, tp_axis):
    g = torch.bmm(x, p["gate"])
    u = torch.bmm(x, p["up"])
    return torch.bmm(torch.nn.functional.silu(g) * u, p["down"])


MOE_CASES = {   # name -> (top_k, capacity factor, mlp_fn)
    "top1": (1, 10.0, False), "top2": (2, 10.0, False), "top1_drop": (1, 0.5, False),
    "top2_drop": (2, 0.5, False), "swiglu": (2, 1.25, True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_layer_matches_jax(case):
    """The output, and the gradients of sum(output * ct) with respect to
    the experts, the gate and the tokens."""
    k, cf, swiglu = MOE_CASES[case]
    ex = _swiglu_np() if swiglu else _experts_np()
    gate, x = _gate_np(), _x_np(shape=(2, T // 2, H))
    ct = _x_np(seed=8, shape=x.shape)
    jfn = _jax_swiglu if swiglu else None

    def jfwd(ex, gate, x):
        routing = jr.TopKRouter(num_experts=E, top_k=k, capacity_factor=cf, noise=None)(
            gate, x.reshape(-1, H))
        return jex.moe_layer(ex, x, routing, axis_name=None, mlp_fn=jfn)

    want = jfwd(_j(ex), _j(gate), jnp.asarray(x))
    jgrads = jax.grad(lambda *a: (jfwd(*a) * jnp.asarray(ct)).sum(), argnums=(0, 1, 2))(
        _j(ex), _j(gate), jnp.asarray(x))
    tex, tgate, tx = _t(ex, grad=True), _t(gate, grad=True), _t(x, grad=True)
    routing = TopKRouter(num_experts=E, top_k=k, capacity_factor=cf, noise=None)(
        tgate, tx.reshape(-1, H))
    got = moe_layer(tex, tx, routing, axis_name=None,
                    mlp_fn=_port_swiglu if swiglu else None)
    assert got.shape == x.shape
    _close(got.detach().numpy(), want)
    (got * torch.from_numpy(ct)).sum().backward()
    grad = {"ex": jax.tree_util.tree_map(lambda t: t.grad, tex,
                                         is_leaf=torch.is_tensor),
            "gate": tgate["gate"]["kernel"].grad, "x": tx.grad}
    _close_trees(grad["ex"], jax.tree_util.tree_map(np.asarray, jgrads[0]))
    _close_grad(grad["gate"].numpy(), jgrads[1]["gate"]["kernel"])
    _close_grad(grad["x"].numpy(), jgrads[2])
    got = got.detach()
    dropped = (routing.dispatch.sum(dim=(1, 2)) == 0).numpy()
    if cf < 1:
        assert dropped.any()
    _close(got.reshape(-1, H).numpy()[dropped], 0.0, 0.0)   # a dropped token adds nothing


def test_moe_layer_matches_a_loop_over_tokens():
    """ep = 1, top-1, ample capacity: each token's expert MLP times its gate."""
    ex, gate, x = _experts_np(), _gate_np(), _x_np()
    tx = torch.from_numpy(x)
    routing = TopKRouter(num_experts=E, top_k=1, noise=None, capacity_factor=10.0)(
        _t(gate), tx)
    out = moe_layer(_t(ex), tx, routing, axis_name=None)
    probs = torch.softmax(tx @ _t(gate)["gate"]["kernel"], dim=-1)
    ref = np.zeros((T, H), np.float32)
    for t in range(T):
        e = int(probs[t].argmax())
        h1 = torch.nn.functional.gelu(tx[t] @ torch.from_numpy(ex["up"]["kernel"][e])
                                      + torch.from_numpy(ex["up"]["bias"][e]),
                                      approximate="tanh")
        y = h1 @ torch.from_numpy(ex["down"]["kernel"][e]) + torch.from_numpy(
            ex["down"]["bias"][e])
        ref[t] = (y * probs[t].max()).numpy()
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=1e-5)


def test_grads_flow_only_to_routed_experts_and_match_jax():
    ex, x = _experts_np(), _x_np()
    bias = np.zeros(E, np.float32)
    bias[0] = 10.0   # every token to expert 0
    gate = {"gate": {"kernel": np.zeros((H, E), np.float32), "bias": bias}}

    def jloss_fn(experts, gate):
        routing = jr.TopKRouter(num_experts=E, top_k=1, noise=None, capacity_factor=10.0)(
            gate, jnp.asarray(x))
        return (jex.moe_layer(experts, jnp.asarray(x), routing, axis_name=None) ** 2).sum()

    jg_ex = jax.grad(jloss_fn)(_j(ex), _j(gate))
    tex, tgate = _t(ex, grad=True), _t(gate, grad=True)
    routing = TopKRouter(num_experts=E, top_k=1, noise=None, capacity_factor=10.0)(
        tgate, torch.from_numpy(x))
    (moe_layer(tex, torch.from_numpy(x), routing, axis_name=None) ** 2).sum().backward()
    gu = tex["up"]["kernel"].grad.numpy()
    assert np.abs(gu[0]).max() > 0
    np.testing.assert_array_equal(gu[1:], 0.0)
    _close_trees({k: {n: v.grad for n, v in d.items()} for k, d in tex.items()},
                 jax.tree_util.tree_map(np.asarray, jg_ex))
    # (the gate's gradient here runs through softmax at p ~ 1 - e^-10, whose
    # float32 cancellation differs by framework: test_moe_layer_matches_jax
    # holds the gate gradient on an unsaturated gate)
    assert np.isfinite(tgate["gate"]["kernel"].grad.numpy()).all()


def test_expert_loss_matches_jax():
    rng = np.random.default_rng(3)
    aux = {"a": rng.random(3).astype(np.float32), "b": [rng.random(2).astype(np.float32)]}
    z = (rng.random(4).astype(np.float32),)
    task = np.float32(2.5)
    want = jloss.ExpertLoss(0.02, 0.003)(jnp.asarray(task), _j(aux), _j(z))
    got = ExpertLoss(0.02, 0.003)(torch.tensor(task), _t(aux), [torch.tensor(x) for x in z])
    assert abs(float(got) - float(want)) <= TOL
    assert ExpertLoss() == ExpertLoss(0.01, 0.001)


def test_init_experts_shapes_and_seed():
    a = init_experts(4, 3, H, FFN, device="cpu")
    b = init_experts(4, 3, H, FFN, device="cpu", dtype=torch.bfloat16)
    assert a["up"]["kernel"].shape == (3, H, FFN) and a["down"]["kernel"].shape == (3, FFN, H)
    assert b["up"]["kernel"].dtype == torch.bfloat16
    assert torch.equal(a["up"]["kernel"], init_experts(4, 3, H, FFN, device="cpu")["up"]["kernel"])
    assert not torch.equal(a["up"]["kernel"], init_experts(5, 3, H, FFN, device="cpu")["up"]["kernel"])
    assert float(a["up"]["bias"].abs().max()) == 0.0
    assert 0.01 < float(a["up"]["kernel"].std()) < 0.03


# -- ExpertParallel ---------------------------------------------------------------------


@pytest.fixture()
def one_rank(tmp_path):
    import torch.distributed as dist

    from pipegoose_tpu_torch.distributed import ParallelContext

    ctx = ParallelContext.init_multihost(store=dist.FileStore(str(tmp_path / "store"), 1),
                                         world_size=1, rank=0, device="cpu",
                                         expert_parallel_size=1)
    yield ctx
    ctx.destroy()


DENSE = dict(vocab_size=64, hidden_size=16, n_layer=2, n_head=2)


def _dense_np():
    return tbloom.init_params_numpy(tbloom.BloomConfig(**DENSE), seed=0)


def test_from_dense_tiles_exactly_on_both_tree_forms(one_rank):
    dense = _dense_np()
    ep = ExpertParallel(num_experts=4)
    params = params_from_jax(dense, tbloom.BloomConfig(**DENSE), device="cpu")
    moe = ep.from_dense(params, key=1)
    for i, blk in enumerate(moe["blocks"]):
        assert "mlp" not in blk
        assert blk["moe"]["up"]["kernel"].shape == (4, 16, 64)
        assert blk["router"]["gate"]["kernel"].shape == (16, 4)
        assert blk["attn"]["qkv"]["kernel"] is params["blocks"][i]["attn"]["qkv"]["kernel"]
    # the port's per-layer result in the stacked layout against the JAX
    # upcycling of the same weights: every leaf but the fresh gate exact
    got = params_to_jax(moe)
    want = jax.tree_util.tree_map(np.asarray, _jax_from_dense(dense))
    gate_got = got["blocks"].pop("router")["gate"]["kernel"]
    gate_want = want["blocks"].pop("router")["gate"]["kernel"]
    assert gate_got.shape == gate_want.shape == (2, 16, 4)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    # the stacked JAX-layout tree is refused, not upcycled differently
    with pytest.raises(TypeError, match="per-layer"):
        ep.from_dense(_t(dense), key=1)


def _jax_from_dense(dense):
    from pipegoose_tpu.distributed import ParallelContext as JaxContext
    from pipegoose_tpu.nn.expert_parallel import ExpertParallel as JaxEP

    ctx = JaxContext()
    try:
        return JaxEP(num_experts=4, parallel_context=ctx).from_dense(_j(dense),
                                                                  jax.random.PRNGKey(1))
    finally:
        ctx.destroy()


def test_jitter_and_router_init(one_rank):
    params = params_from_jax(_dense_np(), tbloom.BloomConfig(**DENSE), device="cpu")
    ep = ExpertParallel(num_experts=4, jitter=0.01)
    a, b, c = (ep.from_dense(params, key=k) for k in (3, 3, 4))
    up_a = a["blocks"][0]["moe"]["up"]["kernel"]
    assert not torch.equal(up_a[0], up_a[1])   # the experts diverge
    dense_up = params["blocks"][0]["mlp"]["up"]["kernel"]
    rel = ((up_a - dense_up) / dense_up).abs().max()
    assert 0 < float(rel) < 0.1
    assert torch.equal(up_a, b["blocks"][0]["moe"]["up"]["kernel"])
    assert not torch.equal(up_a, c["blocks"][0]["moe"]["up"]["kernel"])
    gate = ep.init_router(5, 24, 64, device="cpu")["gate"]["kernel"]
    assert gate.shape == (24, 64, 4) and 0.018 < float(gate.std()) < 0.022
    assert gate.device.type == "cpu"
    g = torch.Generator().manual_seed(5)
    assert torch.equal(ep.init_router(g, 24, 64, device="cpu")["gate"]["kernel"], gate)


def test_expand_mlp_exact_tiles(one_rank):
    mlp = _t(jax.tree_util.tree_map(lambda x: x[1], _dense_np()["blocks"]["mlp"]))
    ep = ExpertParallel(num_experts=3)
    out = ep.expand_mlp(mlp)
    assert out["up"]["kernel"].shape == (3, 16, 64)
    for e in range(3):
        assert torch.equal(out["up"]["kernel"][e], mlp["up"]["kernel"])
        assert torch.equal(out["down"]["bias"][e], mlp["down"]["bias"])
    out["up"]["kernel"][0, 0, 0] += 1   # owns its storage
    assert not torch.equal(out["up"]["kernel"][1], out["up"]["kernel"][0])


def test_parallelize_gives_moe_specs(one_rank):
    cfg = tmoe.BloomMoEConfig(**DENSE, num_experts=4)
    params = params_from_jax(tmoe.init_params_numpy(cfg, 0), cfg, device="cpu")
    local, specs = ExpertParallel(num_experts=4).parallelize(params)
    assert specs == tmoe.moe_specs(params)
    assert torch.equal(local["blocks"][1]["moe"]["up"]["kernel"],
                       params["blocks"][1]["moe"]["up"]["kernel"])
    assert ExpertParallel(num_experts=4).expert_specs() == expert_mlp_specs()


# -- the spec tables --------------------------------------------------------------------


def _spec(p):
    return tuple(p)


def test_expert_mlp_specs_equal_jax():
    for axes in (("expert", "tensor"), ("ep", None)):
        want = jax.tree_util.tree_map(_spec, jex.expert_mlp_specs(*axes),
                                      is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        assert expert_mlp_specs(*axes) == want


def _flatten_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten_specs(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_moe_specs_equal_jax_on_both_tree_forms():
    cfg = tmoe.BloomMoEConfig(vocab_size=64, hidden_size=16, n_layer=3, n_head=2,
                              num_experts=4)
    np_tree = tmoe.init_params_numpy(cfg, 0)
    want = jax.tree_util.tree_map(_spec, jmoe.moe_specs(np_tree),
                                  is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert tmoe.moe_specs(np_tree) == want   # the stacked numpy tree
    port = tmoe.moe_specs(params_from_jax(np_tree, cfg, device="cpu"))
    flat_want = _flatten_specs(want["blocks"])
    for blk in port["blocks"]:
        got = _flatten_specs(blk)
        assert set(got) == set(flat_want)
        for path, spec in flat_want.items():
            assert got[path] == spec[1:], path   # no layer dim on a per-layer leaf
    for key in ("embed", "embed_ln", "ln_f"):
        assert port[key] == want[key]
    assert port["blocks"][0]["moe"]["up"]["kernel"] == ("expert", None, "tensor")
    assert port["blocks"][0]["router"]["gate"]["kernel"] == ()
