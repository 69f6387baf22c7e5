"""The port's flash attention held against the JAX package on the CPU.

Each plain kernel version (``flash_fwd_reference``, ``flash_dq_reference``,
``flash_dkv_reference``) against its Pallas function run as the JAX tests
run it, ``interpret=True`` with blocks from ``_pick_block``; then the
public ``flash_attention`` and its autograd gradients against
``jax.grad`` of the JAX ``flash_attention``. Inputs come from a numpy seed
and go to both as numpy arrays, in float32.

Tolerance 2e-5 absolute: the two sides sum the same float32 products in
another order (the Pallas bodies block by block, the plain versions over
the whole row); with ALiBi scores of order 10 and outputs and gradients
of order 1 that moves results by a few ulps of the scores.

On the card, the bf16 forward takes the tensor-core route (``fwd_plan``),
which walks 64-key tiles with the online softmax, sums l from the float32
p and rounds P once to bf16 before the PV product, every sum in float32. A
test-local emulation of exactly those roundings is held against the Pallas
forward in interpret mode on bf16 inputs within the card tests' bound for
that route, 1e-5 + 2^-7 of the largest |out| (lse 1e-5 + 2^-21 of the
largest), so the tolerance is checked here before the card checks the
kernel. The bf16 backward takes the tensor-core route too (``bwd_plan``):
its blocks walk the tiles a test-local mirror of the kernels' walk names,
test the causal and window masks per element only on the tiles that
straddle them, and round P and dS once to bf16 before the second product;
that emulation is held against the Pallas dQ and dK/dV kernels within the
same bound, and the walk itself against the visible pairs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models.bloom import alibi_slopes
from pipegoose_tpu.ops import flash_attention as jfa
from pipegoose_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5

# name -> (B, S, nh, nkv, hd, causal, window, pad): pad trailing keys of
# batch row 0 are masked out (right padding)
CASES = {
    "causal_alibi": (2, 64, 2, 2, 32, True, None, 0),
    "right_padding": (2, 64, 2, 2, 32, True, None, 13),
    "s96": (1, 96, 2, 2, 64, True, None, 0),
    "noncausal": (2, 64, 2, 2, 32, False, None, 0),
    "gqa_g2": (2, 64, 4, 2, 32, True, None, 0),
    "window": (2, 64, 2, 2, 32, True, 16, 0),
}


def _inputs(name, seed=0, cases=CASES):
    """Flattened kernel operands as numpy: q (BH, S, hd), k/v (BH/g, S,
    hd), slopes (BH,), kv_pos/kv_neg (BH/g, S), dO, and the config."""
    b, s, nh, nkv, hd, causal, window, pad = cases[name]
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    mask = np.ones((b, s), np.float32)
    if pad:
        mask[0, s - pad:] = 0
    kpos = (np.cumsum(mask, -1) - 1) * mask
    kneg = (1 - mask) * np.float32(-1e9)
    g = nh // nkv
    return {
        "q": f(b * nh, s, hd), "k": f(b * nkv, s, hd), "v": f(b * nkv, s, hd),
        "do": f(b * nh, s, hd),
        "slopes": np.tile(alibi_slopes(nh), b),
        "kpos": np.repeat(kpos, nkv, 0), "kneg": np.repeat(kneg, nkv, 0),
        "scale": hd ** -0.5, "causal": causal, "g": g, "window": window,
        "blocks": (jfa._pick_block(s, 128), jfa._pick_block(s, 512)),
    }


def _jax_fwd(x):
    return jfa._flash_fwd_pallas(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "slopes", "kpos", "kneg")),
        x["scale"], x["causal"], *x["blocks"], True, x["g"], x["window"])


def _torch(x, *names):
    return tuple(torch.from_numpy(x[n]) for n in names)


def _close(t, j, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol, err_msg=err_msg)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Inputs of one case with the JAX forward's out and lse, and the
    delta = rowsum(dO * O) both backward kernels take."""
    x = _inputs(request.param)
    out, lse = _jax_fwd(x)
    x["out"], x["lse"] = np.array(out), np.array(lse)
    x["delta"] = (x["do"] * x["out"]).sum(-1)
    return x


def _bwd_args(x):
    return _torch(x, "q", "k", "v", "do", "lse", "delta", "slopes", "kpos", "kneg")


def _jax_bwd_args(x):
    return tuple(jnp.asarray(x[n]) for n in (
        "q", "k", "v", "do", "lse", "delta", "slopes", "kpos", "kneg"))


def test_fwd_reference_matches_pallas(case):
    x = case
    out, lse = tfa.flash_fwd_reference(
        *_torch(x, "q", "k", "v", "slopes", "kpos", "kneg"), x["scale"],
        x["causal"], x["g"], x["window"])
    _close(out, x["out"], err_msg="out")
    _close(lse, x["lse"], err_msg="lse")


def test_dq_reference_matches_pallas(case):
    x = case
    want = jfa._flash_dq_pallas(*_jax_bwd_args(x), x["scale"], x["causal"],
                                *x["blocks"], True, x["g"], x["window"])
    got = tfa.flash_dq_reference(*_bwd_args(x), x["scale"], x["causal"],
                                 x["g"], x["window"])
    _close(got, want)


def test_dkv_reference_matches_pallas(case):
    x = case
    wk, wv = jfa._flash_dkv_pallas(*_jax_bwd_args(x), x["scale"], x["causal"],
                                   *x["blocks"], True, x["g"], x["window"])
    dk, dv = tfa.flash_dkv_reference(*_bwd_args(x), x["scale"], x["causal"],
                                     x["g"], x["window"])
    _close(dk, wk, err_msg="dk")
    _close(dv, wv, err_msg="dv")


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing(case):
    x = case
    before = (tfa.flash_fwd.launches, tfa.flash_dq.launches, tfa.flash_dkv.launches)
    routes = [dict(f.routes) for f in (tfa.flash_fwd, tfa.flash_dq, tfa.flash_dkv)]
    out, lse = tfa.flash_fwd(*_torch(x, "q", "k", "v", "slopes", "kpos", "kneg"),
                             x["scale"], x["causal"], x["g"], x["window"])
    dq = tfa.flash_dq(*_bwd_args(x), x["scale"], x["causal"], x["g"], x["window"])
    dk, _ = tfa.flash_dkv(*_bwd_args(x), x["scale"], x["causal"], x["g"], x["window"])
    _close(out, x["out"])
    assert dq.shape == out.shape and dk.shape == out.shape   # dk per query head
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches,
            tfa.flash_dkv.launches) == before
    assert [f.routes for f in (tfa.flash_fwd, tfa.flash_dq, tfa.flash_dkv)] == routes


# (B, S, nh, nkv, hd, causal, window, masked): the public function with
# a BLOOM-style attention_mask (right-padded row 1) or without one
PUBLIC = {
    "bloom_causal_mask": (2, 32, 4, 4, 16, True, None, True),
    "gqa_noncausal": (2, 32, 4, 2, 16, False, None, False),
    "window_gqa": (1, 48, 4, 1, 16, True, 8, False),
}


@pytest.mark.parametrize("name", sorted(PUBLIC))
def test_flash_attention_and_grads_match_jax(name):
    b, s, nh, nkv, hd, causal, window, masked = PUBLIC[name]
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((b, s, h, hd), dtype=np.float32)
               for h in (nh, nkv, nkv))
    w = rng.standard_normal((b, s, nh, hd), dtype=np.float32)
    slopes = alibi_slopes(nh)
    mask = None
    if masked:
        mask = np.ones((b, s), np.int32)
        mask[1, s - 9:] = 0

    def jloss(q, k, v):
        out = jfa.flash_attention(
            q, k, v, jnp.asarray(slopes),
            None if mask is None else jnp.asarray(mask), causal=causal,
            window=window, interpret=True)
        return (out * w).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = tfa.flash_attention(
        tq, tk, tv, torch.from_numpy(slopes),
        None if mask is None else torch.from_numpy(mask), causal=causal,
        window=window)
    (tout * torch.from_numpy(w)).sum().backward()
    _close(tout, jout, err_msg="out")
    for t, j, n in zip((tq, tk, tv), jgrads, "qkv"):
        _close(t.grad, j, err_msg=f"d{n}")


def test_mask_to_kv_bias_matches_jax():
    mask = np.array([[1, 1, 1, 0, 0], [0, 1, 1, 1, 1]], np.int32)
    for t, j in zip(tfa.mask_to_kv_bias(torch.from_numpy(mask)),
                    jfa.mask_to_kv_bias(jnp.asarray(mask))):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_matches_xla_reference(causal):
    x = _inputs("causal_alibi")
    want = jfa._xla_reference(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "slopes")), x["scale"],
        causal, jnp.asarray(x["kpos"]), jnp.asarray(x["kneg"]))
    got = tfa.attention_reference(*_torch(x, "q", "k", "v", "slopes"), x["scale"],
                                  causal, *_torch(x, "kpos", "kneg"))
    _close(got, want)


def test_gqa_head_count_must_divide():
    q = torch.zeros(1, 8, 3, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="multiple of n_kv_head"):
        tfa.flash_attention(q, kv, kv)


# -- the forward's routes ---------------------------------------------------

@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_fwd_plan_routes_bf16_to_the_tensor_cores(hd):
    plan = tfa.fwd_plan(torch.bfloat16, hd, 200, 200)
    assert plan["route"] == "mma" and plan["threads"] == 128
    assert plan["grid_tiles"] == 4
    assert plan["q_tiles_reversed"] == {"fwd": True, "chunk_fwd": True}
    # Q + a two-deep ring of (K and V tiles, kpos and kneg), bf16 rows + 16 bytes
    mat = 64 * (2 * hd + 16)
    assert plan["smem_bytes"] == {"fwd": 5 * mat + 1024, "chunk_fwd": 5 * mat + 1024}
    # the blocks an SM is built for fit its 228 KB (1 KB reserved a block)
    assert plan["blocks_per_sm"] * (plan["smem_bytes"]["fwd"] + 1024) <= 228 * 1024
    assert plan["blocks_per_sm"] == (4 if hd <= 64 else 2)


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_fwd_plan_keeps_float32_on_the_fma_kernels(hd):
    plan = tfa.fwd_plan(torch.float32, hd, 8192, 130)
    assert plan["route"] == "fma" and plan["threads"] == 256
    assert plan["grid_tiles"] == 128 and plan["blocks_per_sm"] is None
    assert plan["q_tiles_reversed"] == {"fwd": True, "chunk_fwd": False}
    rows, score = 64 * (hd + 1), 64 * 65
    assert plan["smem_bytes"] == {"fwd": 4 * (3 * rows + score + 128),
                                  "chunk_fwd": 4 * (3 * rows + score + 192)}
    assert max(plan["smem_bytes"].values()) <= 227 * 1024


def test_fwd_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.fwd_plan(torch.float16, 64, 64, 64)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.fwd_plan(torch.bfloat16, 48, 64, 64)
    with pytest.raises(ValueError, match="tiles"):
        tfa.fwd_plan(torch.bfloat16, 64, 64 * tfa.MAX_TILES + 1, 64 * tfa.MAX_TILES + 1)
    with pytest.raises(ValueError, match="tiles"):
        tfa.fwd_plan(torch.float32, 64, 64, 64 * tfa.MAX_TILES + 1)


TC_RTOL = 2.0 ** -7     # the tensor-core route's bound on out, of the largest value
LSE_RTOL = 2.0 ** -21

# the bf16 forward's cases, as EMU_CASES[name] = CASES' tuple
EMU_CASES = {
    "causal": (2, 128, 2, 2, 32, True, None, 0),
    "right_padded": (2, 128, 2, 2, 32, True, None, 29),
    "s100": (1, 100, 2, 2, 64, True, None, 0),
    "gqa_g2": (2, 128, 4, 2, 32, True, None, 0),
    "window64": (1, 192, 2, 2, 32, True, 64, 0),
    "noncausal": (2, 128, 2, 2, 32, False, None, 0),
}


def _tc_fwd_rounded(q, k, v, slopes, kpos, kneg, scale, causal, g, window):
    """(out, lse) as the tensor-core forward rounds them: each 64-query
    tile walks the 64-key tiles the kernel walks (from the window's first
    tile to the diagonal's), with the online softmax in float32, l summing
    the float32 p, and P rounded once to bf16 before the PV product."""
    bh, s, hd = q.shape
    sc = tfa._scores(q, k, slopes, kpos, kneg, scale, causal, g, window)
    vf = tfa._expand(v, g).float()
    out = torch.empty(bh, s, hd)
    lse = torch.empty(bh, s)
    for q0 in range(0, s, 64):
        rows = slice(q0, min(q0 + 64, s))
        end = min(q0 + 64, s) if causal else s
        first = max(0, q0 - window + 1) // 64 * 64 if window else 0
        m = torch.full((bh, rows.stop - q0), -1e9)
        l = torch.zeros_like(m)
        acc = torch.zeros(bh, rows.stop - q0, hd)
        for k0 in range(first, end, 64):
            keys = slice(k0, min(k0 + 64, s))
            t = sc[:, rows, keys]
            m_new = torch.maximum(m, t.amax(-1))
            p = torch.exp(t - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqk,bkd->bqd", p.to(torch.bfloat16).float(), vf[:, keys])
            m = m_new
        lv = torch.clamp_min(l, 1e-30)
        out[:, rows] = acc / lv[..., None]
        lse[:, rows] = m + torch.log(lv)
    return out.to(q.dtype), lse


@pytest.mark.parametrize("name", sorted(EMU_CASES))
def test_tensor_core_forward_roundings_stay_within_tolerance_of_jax(name):
    """bf16 inputs: the emulated tensor-core forward against
    ``_flash_fwd_pallas`` in interpret mode, out within 1e-5 + 2^-7 and lse
    within 1e-5 + 2^-21 of their largest values; and out not bit for bit,
    so the check sees the rounding."""
    x = _inputs(name, seed=3, cases=EMU_CASES)
    bf = lambda a: np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    for n in ("q", "k", "v"):
        x[n] = bf(x[n])
    want_out, want_lse = jfa._flash_fwd_pallas(
        *(jnp.asarray(x[n], jnp.bfloat16) for n in ("q", "k", "v")),
        *(jnp.asarray(x[n]) for n in ("slopes", "kpos", "kneg")),
        x["scale"], x["causal"], *x["blocks"], True, x["g"], x["window"])
    q, k, v = (torch.from_numpy(x[n]).to(torch.bfloat16) for n in ("q", "k", "v"))
    got_out, got_lse = _tc_fwd_rounded(q, k, v, *_torch(x, "slopes", "kpos", "kneg"),
                                       x["scale"], x["causal"], x["g"], x["window"])
    want_out = np.asarray(want_out.astype(jnp.float32))
    err = np.abs(got_out.float().numpy() - want_out).max()
    tol = 1e-5 + TC_RTOL * np.abs(want_out).max()
    assert 0 < err <= tol, f"out: {err} vs {tol}"
    want_lse = np.asarray(want_lse)
    err = np.abs(got_lse.numpy() - want_lse).max()
    assert err <= 1e-5 + LSE_RTOL * np.abs(want_lse).max(), f"lse: {err}"


# -- the backward's routes -------------------------------------------------

@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_bwd_plan_routes_bf16_to_the_tensor_cores(hd):
    plan = tfa.bwd_plan(torch.bfloat16, hd, 200)
    assert plan["route"] == "mma" and plan["threads"] == 128
    assert plan["grid_tiles"] == 4 and plan["dq_tiles_reversed"]
    # resident tiles + a two-deep ring of (two bf16 tiles, three float32 vectors)
    mat = 64 * (2 * hd + 16)
    assert plan["smem_bytes"] == {"dq": 6 * mat + 1536, "dkv": 6 * mat + 1536}
    # the blocks an SM is built for fit its 228 KB (1 KB reserved a block)
    assert plan["blocks_per_sm"] * (plan["smem_bytes"]["dq"] + 1024) <= 228 * 1024
    assert plan["blocks_per_sm"] == (4 if hd <= 64 else 2)
    assert plan["dkv_pass_queries"] == 16
    # the launch of the ring-chunk backward, whose main loops it shares
    assert plan == {**tfa.chunk_bwd_plan(torch.bfloat16, hd, 200, 200), "grid_tiles": 4}


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_bwd_plan_keeps_float32_on_the_fma_kernels(hd):
    plan = tfa.bwd_plan(torch.float32, hd, 8192)
    assert plan["route"] == "fma" and plan["threads"] == 256
    assert plan["grid_tiles"] == 128 and plan["dq_tiles_reversed"]
    assert plan["blocks_per_sm"] is None and plan["dkv_pass_queries"] == 64
    rows, score = 64 * (hd + 1), 64 * 65
    assert plan["smem_bytes"] == {"dq": 4 * (4 * rows + score + 128),
                                  "dkv": 4 * (4 * rows + 2 * score + 128)}
    assert max(plan["smem_bytes"].values()) <= 227 * 1024


def test_bwd_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.bwd_plan(torch.float16, 64, 64)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.bwd_plan(torch.bfloat16, 96, 64)
    with pytest.raises(ValueError, match="tiles"):
        tfa.bwd_plan(torch.bfloat16, 64, 64 * tfa.MAX_TILES + 1)
    with pytest.raises(ValueError, match="tiles"):
        tfa.bwd_plan(torch.float32, 64, -1)


def _bwd_walk(kind, own0, s, causal, window):
    """The tiles a tensor-core backward block walks, as (tile start,
    tested), mirroring flash_attention.cu: dq's block at query tile own0
    walks the key tiles of ``key_range``; dkv's block at key tile own0 the
    query tiles [q_first, q_end); a pair is tested per element when it
    ``straddles`` the causal or the window mask."""
    last = min(own0 + 64, s) - 1
    if kind == "dq":
        first = max(0, own0 - window + 1) if window else 0
        end = last + 1 if causal else s
    else:
        first = own0 if causal else 0
        end = min(s, last + window) if window else s
    walk = []
    for t0 in range(first // 64 * 64, end, 64):
        q0, k0 = (own0, t0) if kind == "dq" else (t0, own0)
        tested = (causal and k0 + 63 > q0) or bool(window and q0 + 63 - k0 >= window)
        walk.append((t0, tested))
    return walk


def _keep(s, causal, window):
    """(S, S) bool: query i may see key j under the index tests."""
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= i - j < window
    return keep


@pytest.mark.parametrize("name", sorted(EMU_CASES))
def test_bwd_walk_visits_exactly_the_visible_tiles(name):
    """For every block of both backward kernels: the walk visits exactly
    the tiles that hold a visible (query, key) pair, in order, and every
    tile it does not test per element is visible throughout."""
    _, s, _, _, _, causal, window, _ = EMU_CASES[name]
    keep = _keep(s, causal, window)
    for kind in ("dq", "dkv"):
        for own0 in range(0, s, 64):
            walk = _bwd_walk(kind, own0, s, causal, window)
            own = keep[own0:own0 + 64] if kind == "dq" else keep[:, own0:own0 + 64].T
            want = [t0 for t0 in range(0, s, 64) if own[:, t0:t0 + 64].any()]
            assert [t0 for t0, _ in walk] == want, (kind, own0)
            for t0, tested in walk:
                assert tested or own[:, t0:t0 + 64].all(), (kind, own0, t0)


def _tc_bwd_rounded(q, k, v, do, lse, delta, slopes, kpos, kneg, scale, causal, g,
                    window):
    """(dq, dk, dv) as the tensor-core backward rounds them: each kernel's
    blocks take the pairs of the tiles ``_bwd_walk`` names (the mask on the
    index only on a tested tile, the plain ALiBi + padding term elsewhere),
    P and dS come from float32 scores and are rounded once to bf16 before
    the second product, every sum is float32, and each result is rounded
    to bf16 as the kernels write it."""
    s = q.shape[1]
    masked = tfa._scores(q, k, slopes, kpos, kneg, scale, causal, g, window)
    plain = tfa._scores(q, k, slopes, kpos, kneg, scale, False, g, None)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), tfa._expand(v, g).float())

    def rounded(kind):
        visit = torch.zeros(s, s, dtype=torch.bool)
        test = torch.zeros(s, s, dtype=torch.bool)
        for own0 in range(0, s, 64):
            for t0, tested in _bwd_walk(kind, own0, s, causal, window):
                q0, k0 = (own0, t0) if kind == "dq" else (t0, own0)
                visit[q0:q0 + 64, k0:k0 + 64] = True
                test[q0:q0 + 64, k0:k0 + 64] = tested
        p = torch.where(visit, torch.exp(torch.where(test, masked, plain) - lse[..., None]), 0.0)
        ds = p * (dp - delta[..., None])
        return p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()

    _, ds = rounded("dq")
    dq = scale * torch.einsum("bqk,bkd->bqd", ds, tfa._expand(k, g).float())
    p, ds = rounded("dkv")
    dk = scale * torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


@pytest.fixture(scope="module", params=sorted(EMU_CASES))
def bf16_case(request):
    """A bf16 case with the Pallas forward's lse and delta = rowsum(dO *
    out), out rounded to bf16 as the forward writes it."""
    x = _inputs(request.param, seed=5, cases=EMU_CASES)
    for n in ("q", "k", "v", "do"):
        x[n] = np.array(jnp.asarray(x[n], jnp.bfloat16).astype(jnp.float32))
    bf = {n: jnp.asarray(x[n], jnp.bfloat16) for n in ("q", "k", "v", "do")}
    out, lse = jfa._flash_fwd_pallas(
        bf["q"], bf["k"], bf["v"], *(jnp.asarray(x[n]) for n in ("slopes", "kpos", "kneg")),
        x["scale"], x["causal"], *x["blocks"], True, x["g"], x["window"])
    x["lse"] = np.array(lse)
    x["delta"] = (x["do"] * np.asarray(out.astype(jnp.float32))).sum(-1)
    x["bf"] = bf
    return x


@pytest.mark.parametrize("kind", ["dq", "dkv"])
def test_tensor_core_backward_roundings_stay_within_tolerance_of_jax(bf16_case, kind):
    """bf16 inputs: the emulated tensor-core dQ or dK/dV against
    ``_flash_dq_pallas`` / ``_flash_dkv_pallas`` in interpret mode, each
    output within 1e-5 + 2^-7 of its largest value; and not bit for bit,
    so the check sees the rounding."""
    x = bf16_case
    rest = tuple(jnp.asarray(x[n]) for n in ("lse", "delta", "slopes", "kpos", "kneg"))
    jax_args = (x["bf"]["q"], x["bf"]["k"], x["bf"]["v"], x["bf"]["do"], *rest, x["scale"],
                x["causal"], *x["blocks"], True, x["g"], x["window"])
    if kind == "dq":
        want = {"dq": jfa._flash_dq_pallas(*jax_args)}
    else:
        want = dict(zip(("dk", "dv"), jfa._flash_dkv_pallas(*jax_args)))
    q, k, v, do = (torch.from_numpy(x[n]).to(torch.bfloat16) for n in ("q", "k", "v", "do"))
    got = dict(zip(("dq", "dk", "dv"), _tc_bwd_rounded(
        q, k, v, do, *_torch(x, "lse", "delta", "slopes", "kpos", "kneg"), x["scale"],
        x["causal"], x["g"], x["window"])))
    for what, w in want.items():
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(got[what].float().numpy() - w).max()
        tol = 1e-5 + TC_RTOL * np.abs(w).max()
        assert 0 < err <= tol, f"{what}: {err} vs {tol}"
