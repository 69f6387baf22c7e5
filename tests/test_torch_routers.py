"""The port's MoE router held against the JAX package on the CPU.

``nn.expert_parallel.TopKRouter`` against ``pipegoose_tpu``'s on the same
numpy inputs (H = 8, E = 4, T = 16 or an odd 17, float32), for top_k in
{1, 2, 3}, capacity factor in {0.5, 1.25, 10} (0.5 drops tokens), with and
without a gate bias, and with an explicit ``capacity=``: ``dispatch``
equal, ``combine`` within 1e-6, aux and z within 1e-6 of max(1, |value|)
(z reaches 25 here, where a float32 step is 1.9e-6). Then the cases of
``tests/nn/expert_parallel/test_routers.py``, the top-k tie rule of
``jax.lax.top_k``, and the noise: within [1 - eps, 1 + eps] of the clean
logits, reproduced by its seed (integer or ``torch.Generator``) and changed
by another, absent unless ``train``, refused without a seed, and uniform by
a chi-square test (p > 1e-3), as ``tests/test_torch_sampling.py`` tests its
sampler. The draws cannot match ``jax.random``'s (ROADMAP.md § C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from pipegoose_tpu.nn.expert_parallel import routers as jr
from pipegoose_tpu_torch.nn.expert_parallel import (
    SwitchNoisePolicy,
    Top1Router,
    Top2Router,
    TopKRouter,
)
from pipegoose_tpu_torch.nn.expert_parallel.routers import top_k as port_top_k

H, E, T = 8, 4, 16
TOL = 1e-6
P_MIN = 1e-3


def _inputs(t=T, bias=False, seed=0):
    rng = np.random.default_rng(seed)
    gate = {"gate": {"kernel": rng.standard_normal((H, E)).astype(np.float32)}}
    if bias:
        gate["gate"]["bias"] = rng.standard_normal(E).astype(np.float32)
    x = rng.standard_normal((t, H)).astype(np.float32)
    return gate, x


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _both(kw, gate, x, capacity=None):
    jout = jr.TopKRouter(num_experts=E, noise=None, **kw)(
        jax.tree_util.tree_map(jnp.asarray, gate), jnp.asarray(x), capacity=capacity)
    tout = TopKRouter(num_experts=E, noise=None, **kw)(_torch(gate), torch.from_numpy(x),
                                                         capacity=capacity)
    return jout, tout


def _assert_same(jout, tout):
    np.testing.assert_array_equal(tout.dispatch.numpy(), np.asarray(jout.dispatch))
    np.testing.assert_allclose(tout.combine.numpy(), np.asarray(jout.combine), rtol=0,
                               atol=TOL)
    for got, want in ((tout.aux_loss, jout.aux_loss), (tout.z_loss, jout.z_loss)):
        want = float(want)
        assert abs(float(got) - want) <= TOL * max(1.0, abs(want)), (float(got), want)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("cf", [0.5, 1.25, 10.0])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_matches_jax(k, cf, bias):
    gate, x = _inputs(bias=bias, seed=10 * k + int(cf * 4))
    jout, tout = _both(dict(top_k=k, capacity_factor=cf), gate, x)
    assert tout.dispatch.shape == (T, E, TopKRouter(E, k, cf).capacity(T))
    _assert_same(jout, tout)
    if cf == 0.5:   # the case that drops: a dropped token's rows stay zero
        dropped = tout.dispatch.sum(dim=(1, 2)) < k
        assert dropped.any()


@pytest.mark.parametrize("capacity", [1, 3, 7])
@pytest.mark.parametrize("k", [1, 2])
def test_router_explicit_capacity_matches_jax(k, capacity):
    gate, x = _inputs(seed=capacity)
    jout, tout = _both(dict(top_k=k), gate, x, capacity=capacity)
    assert tout.dispatch.shape == (T, E, capacity)
    _assert_same(jout, tout)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_odd_token_count_matches_jax(k):
    gate, x = _inputs(t=17, bias=True, seed=17)
    jout, tout = _both(dict(top_k=k, capacity_factor=1.25), gate, x)
    assert tout.dispatch.shape[2] == TopKRouter(E, k).capacity(17)
    _assert_same(jout, tout)


def test_top_k_keeps_jax_tie_rule():
    """Equal probabilities: the lower expert index first, as lax.top_k."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2], [0.0, 0.5, 0.5, 0.0]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = port_top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_tied_logits_route_as_jax():
    """A zero gate: every token ties on every expert; both frameworks send
    each token to the lowest indices and fill the slots in token order."""
    gate = {"gate": {"kernel": np.zeros((H, E), np.float32)}}
    _, x = _inputs()
    for k in (1, 2):
        jout, tout = _both(dict(top_k=k, capacity_factor=1.0), gate, x)
        _assert_same(jout, tout)


# -- the JAX router tests' cases, on the port -----------------------------------------


def _t_inputs():
    gate, x = _inputs(seed=3)
    return _torch(gate), torch.from_numpy(x)


def test_top1_dispatch_shape_and_onehot():
    gate, x = _t_inputs()
    r = Top1Router(E, capacity_factor=10.0)
    out = r(gate, x)
    assert out.dispatch.shape == (T, E, r.capacity(T))
    np.testing.assert_allclose(out.dispatch.sum(dim=(1, 2)).numpy(), np.ones(T))
    probs = torch.softmax(x @ gate["gate"]["kernel"], dim=-1)
    np.testing.assert_array_equal(out.dispatch.sum(dim=2).argmax(dim=1).numpy(),
                                  probs.argmax(dim=1).numpy())


def test_combine_weights_are_gate_probs():
    gate, x = _t_inputs()
    out = Top1Router(E, capacity_factor=10.0)(gate, x)
    probs = torch.softmax(x @ gate["gate"]["kernel"], dim=-1)
    np.testing.assert_allclose(out.combine.sum(dim=(1, 2)).numpy(),
                               probs.max(dim=1).values.numpy(), rtol=1e-5)


def test_capacity_truncation():
    gate, x = _t_inputs()
    out = TopKRouter(num_experts=E, top_k=1)(gate, x, capacity=1)
    assert (out.dispatch.sum(dim=(0, 2)).numpy() <= 1).all()
    dropped = out.dispatch.sum(dim=(1, 2)).numpy() == 0
    assert dropped.any()
    np.testing.assert_allclose(out.combine.sum(dim=(1, 2)).numpy()[dropped], 0)


def test_top2_two_slots_and_normalized_gates():
    gate, x = _t_inputs()
    out = Top2Router(E, capacity_factor=10.0)(gate, x)
    np.testing.assert_allclose(out.dispatch.sum(dim=(1, 2)).numpy(), 2 * np.ones(T))
    np.testing.assert_allclose(out.combine.sum(dim=(1, 2)).numpy(), np.ones(T), rtol=1e-5)


def test_aux_and_z_losses():
    gate, x = _t_inputs()
    out = Top1Router(E, capacity_factor=10.0)(gate, x)
    logits = x @ gate["gate"]["kernel"]
    probs = torch.softmax(logits, dim=-1)
    f = np.zeros(E)
    for e in probs.argmax(dim=1).numpy():
        f[e] += 1 / T
    expected_aux = E * float((f * probs.mean(dim=0).numpy()).sum())
    assert abs(float(out.aux_loss) - expected_aux) < 1e-5
    expected_z = float((torch.logsumexp(logits, dim=-1) ** 2).mean())
    assert abs(float(out.z_loss) - expected_z) < 1e-4
    # perfectly balanced routing gives aux_loss ~ 1
    ids = torch.eye(E).repeat_interleave(T // E, dim=0) * 10
    outb = TopKRouter(num_experts=E, top_k=1, noise=None)(
        {"gate": {"kernel": torch.eye(E)}}, ids, capacity=T)
    assert abs(float(outb.aux_loss) - 1.0) < 0.05


# -- the noise ------------------------------------------------------------------------


def test_noise_stays_in_its_band_and_follows_its_seed():
    eps = 0.3
    pol = SwitchNoisePolicy(eps)
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal((64, E))
                              .astype(np.float32)) + 3.0   # nonzero everywhere
    noisy = pol.apply(11, logits)
    ratio = (noisy / logits).numpy()
    assert ratio.min() >= 1 - eps - 1e-6 and ratio.max() <= 1 + eps + 1e-6
    assert torch.equal(pol.apply(11, logits), noisy)
    assert not torch.equal(pol.apply(12, logits), noisy)
    gen = torch.Generator().manual_seed(11)
    assert torch.equal(pol.apply(gen, logits), noisy)   # a generator seeded alike


def test_noise_changes_routing_only_in_train():
    gate, x = _t_inputs()
    r = TopKRouter(num_experts=E, top_k=1, noise=SwitchNoisePolicy(0.5))
    clean = TopKRouter(num_experts=E, top_k=1, noise=None)(gate, x)
    for out in (r(gate, x, train=False), r(gate, x, key=5, train=False)):
        assert torch.equal(out.dispatch, clean.dispatch)
        assert torch.equal(out.combine, clean.combine)
    o1 = r(gate, x, key=11, train=True)
    o2 = r(gate, x, key=12, train=True)
    assert not torch.equal(o1.combine, o2.combine)
    assert torch.equal(r(gate, x, key=11, train=True).combine, o1.combine)
    with pytest.raises(ValueError):
        r(gate, x, train=True)   # needs a seed


def test_noise_is_uniform():
    """200 000 draws of U[1 - eps, 1 + eps] in 20 equal bins against the
    uniform counts (chi-square, p > 1e-3)."""
    eps, n, bins = 0.1, 200_000, 20
    draws = SwitchNoisePolicy(eps).apply(7, torch.ones(n)).numpy().astype(np.float64)
    assert draws.min() >= 1 - eps and draws.max() <= 1 + eps
    counts, _ = np.histogram(draws, bins=bins, range=(1 - eps, 1 + eps))
    _, p = stats.chisquare(counts, np.full(bins, n / bins))
    assert p > P_MIN, p
