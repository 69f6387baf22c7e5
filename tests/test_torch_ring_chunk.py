"""The plain versions of the ring-attention chunk kernels (B7
``flash_ring_chunk_reference``, B8 ``flash_chunk_dq_reference``, B9
``flash_chunk_dkv_reference``) held against the JAX package's
``flash_ring_chunk``, ``flash_chunk_dq`` and ``flash_chunk_dkv``, their
Pallas kernels run with ``interpret=True`` as the JAX tests run them.

One sequence of S = 64 is split over sp = 4 chunks and every (rank,
kv_rank) pair is taken in ring order, the state carried from step to step
(the fully-future pairs included), with unpadded, right-padded and
left-padded masks (the last with the mask-aware ALiBi correction folded
into the per-head key bias, as ``_key_bias`` folds it), GQA g = 2, and
float32 and bf16 inputs. Inputs come from a numpy seed.

The Pallas kernels skip a block whose keys all lie in the future of all
its queries, the plain versions compute every pair: the two may differ
only on a query row that has seen no unmasked key (a left-padded query,
m still near NEG_INF). The forward is compared on the rows that have seen
one; on those, a fully-future pair must leave the plain state bit for bit
as it was. The backward takes the plain chain's final lse and zero dO on
padded queries, as the models give it, and is compared everywhere.

Tolerance 2e-5 absolute: both sides sum the same float32 products in
another order (bf16 inputs are converted exactly), with scores, states
and gradients of order 10 and below.

On the card, bf16 inputs take the tensor-core route (``fwd_plan``,
``chunk_bwd_plan``): the forward walks 64-key tiles with the online
softmax, sums l from the float32 p and rounds P once to bf16 before the PV
product; dQ and dK/dV round P and dS once to bf16 before the second
product; every sum is float32. A test-local emulation of exactly those
roundings is held against the same JAX kernels within the card tests'
tolerance for that route, 1e-5 + 2^-7 of the largest |JAX| value (the
forward's m and l to 2e-5, as the plain versions), so the tolerance is
checked here before the card checks the kernels.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.ops import flash_attention as jfa
from pipegoose_tpu_torch.ops import flash_attention as tfa

ATOL = 2e-5
TC_RTOL = 2.0 ** -7   # the tensor-core route's tolerance, of the largest value
SP, B, S, HD = 4, 2, 64, 32
SL = S // SP
SEEN = -1e8   # m above this: the row has seen an unmasked key

CASES = {   # name -> (nh, nkv, pad)
    "unpadded": (4, 4, None),
    "right_pad": (4, 4, "right"),
    "left_pad_alibi_pos": (4, 4, "left"),
    "gqa_g2": (4, 2, "right"),
}


def _case(name, dtype, seed=0):
    nh, nkv, pad = CASES[name]
    rng = np.random.default_rng(seed)
    f = lambda rows: rng.standard_normal((rows, S, HD), dtype=np.float32)  # noqa: E731
    q, do, k, v = f(B * nh), f(B * nh), f(B * nkv), f(B * nkv)
    mask = np.ones((B, S), np.float32)
    if pad == "right":
        mask[1, S - 13:] = 0
    elif pad == "left":
        mask[0, :21] = 0
        mask[1, :3] = 0
    slopes = np.tile(np.array([2.0 ** -(2 * (h + 1)) for h in range(nh)], np.float32), B)
    kneg = np.repeat((1 - mask) * np.float32(-1e9), nkv, 0)
    if pad == "left":
        apos = (np.cumsum(mask, -1) - 1) * mask
        kneg = kneg + slopes[:, None] * (np.repeat(apos, nh, 0) - np.arange(S, dtype=np.float32))
    do = do * np.repeat(mask, nh, 0)[..., None]
    if dtype == "bf16":   # round the inputs once; both sides read the same values
        q, k, v, do = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                       for x in (q, k, v, do))
    return {"q": q, "k": k, "v": v, "do": do, "slopes": slopes,
            "kneg": kneg.astype(np.float32), "g": nh // nkv, "scale": HD ** -0.5}


def _pair(case, rank, kv_rank):
    qs, ks = slice(rank * SL, (rank + 1) * SL), slice(kv_rank * SL, (kv_rank + 1) * SL)
    pos = lambda r, rows: np.broadcast_to(r * SL + np.arange(SL, dtype=np.float32), (rows, SL)).copy()  # noqa: E731
    bh, bkv = case["q"].shape[0], case["k"].shape[0]
    return (case["q"][:, qs], case["k"][:, ks], case["v"][:, ks], case["do"][:, qs],
            case["slopes"], pos(rank, bh), pos(kv_rank, bkv), case["kneg"][:, ks])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@functools.lru_cache(maxsize=None)
def _jax_fns(scale, g):
    kw = dict(scale=scale, interpret=True, g=g)
    return (jax.jit(functools.partial(jfa.flash_ring_chunk, **kw)),
            jax.jit(functools.partial(jfa.flash_chunk_dq, **kw)),
            jax.jit(functools.partial(jfa.flash_chunk_dkv, **kw)))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_chunk_kernels_match_jax_for_every_ring_pair(name, dtype):
    case = _case(name, dtype)
    g, scale = case["g"], case["scale"]
    j_fwd, j_dq, j_dkv = _jax_fns(scale, g)
    bh = case["q"].shape[0]
    as_dtype = (lambda x: _t(x).to(torch.bfloat16)) if dtype == "bf16" else _t
    finals = []
    for rank in range(SP):
        m = np.full((bh, SL), -1e9, np.float32)
        l = np.zeros((bh, SL), np.float32)
        acc = np.zeros((bh, SL, HD), np.float32)
        for t in range(SP):
            kv_rank = (rank - t) % SP
            q, k, v, _, slopes, qpos, kpos, kneg = _pair(case, rank, kv_rank)
            want = j_fwd(*(jnp.asarray(x, jnp.bfloat16) if dtype == "bf16" else x
                           for x in (q, k, v)), slopes, qpos, kpos, kneg, m, l, acc)
            got = tfa.flash_ring_chunk(as_dtype(q), as_dtype(k), as_dtype(v), _t(slopes),
                                       _t(qpos), _t(kpos), _t(kneg), _t(m), _t(l),
                                       _t(acc), scale, g)
            got = [x.numpy() for x in got]
            seen = np.asarray(want[0]) > SEEN
            for what, a, b_ in zip(("m", "l", "acc"), got, want):
                _close(a[seen], np.asarray(b_)[seen], f"B7 {what} ({rank}, {kv_rank})")
            if kv_rank > rank:   # fully future: the seen rows pass through untouched
                for a, b_ in zip(got, (m, l, acc)):
                    assert np.array_equal(a[seen], b_[seen])
            m, l, acc = got
        l = np.maximum(l, 1e-30)
        finals.append((acc / l[..., None], m + np.log(l)))
    for rank in range(SP):
        out, lse = finals[rank]
        if dtype == "bf16":
            out = np.asarray(jnp.asarray(out, jnp.bfloat16).astype(jnp.float32))
        for kv_rank in range(SP):
            q, k, v, do, slopes, qpos, kpos, kneg = _pair(case, rank, kv_rank)
            delta = (do * out).sum(-1).astype(np.float32)
            jx = [jnp.asarray(x, jnp.bfloat16) if dtype == "bf16" else x
                  for x in (q, k, v, do)]
            tx = [as_dtype(x) for x in (q, k, v, do)]
            rest = (lse, delta, slopes, qpos, kpos, kneg)
            _close(tfa.flash_chunk_dq(*tx, *map(_t, rest), scale, g),
                   j_dq(*jx, *rest), f"B8 ({rank}, {kv_rank})")
            for what, a, b_ in zip(("dk", "dv"),
                                   tfa.flash_chunk_dkv(*tx, *map(_t, rest), scale, g),
                                   j_dkv(*jx, *rest)):
                _close(a, b_, f"B9 {what} ({rank}, {kv_rank})")


def test_plain_chunk_forward_matches_xla_chunk_with_random_state():
    """The dense mirror ``_xla_chunk`` (g = 1) with a non-trivial incoming
    state, queries ahead of the keys and random padding: equal on every
    row, since the dense forms have no skip."""
    rng = np.random.default_rng(5)
    bh, sq, skv, hd = 4, 32, 48, 64
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    q, k, v = f(bh, sq, hd), f(bh, skv, hd), f(bh, skv, hd)
    slopes = (rng.uniform(size=bh) * 0.1).astype(np.float32)
    qpos = np.broadcast_to(np.arange(sq, dtype=np.float32) + 20, (bh, sq)).copy()
    kpos = np.broadcast_to(np.arange(skv, dtype=np.float32), (bh, skv)).copy()
    kneg = np.where(rng.uniform(size=(bh, skv)) < 0.2, -1e9, 0.0).astype(np.float32)
    m0, l0, acc0 = f(bh, sq) * 0.5, np.abs(f(bh, sq)) + 0.5, f(bh, sq, hd)
    want = jfa._xla_chunk(q, k, v, slopes, qpos, kpos, kneg, m0, l0, acc0, hd ** -0.5)
    got = tfa.flash_ring_chunk(*map(_t, (q, k, v, slopes, qpos, kpos, kneg, m0, l0, acc0)),
                               hd ** -0.5)
    for what, a, b_ in zip(("m", "l", "acc"), got, want):
        _close(a.numpy(), b_, what)


def _tc_rounded(q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, scale, g):
    """dq, dk, dv as the tensor-core kernels round them: P and dS from
    float32 scores, each rounded once to bf16 before the second product,
    every sum in float32."""
    p, ds = tfa._chunk_p_ds(q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, scale, g)
    p, ds = (x.to(torch.bfloat16).float() for x in (p, ds))
    dq = scale * torch.einsum("bqk,bkd->bqd", ds, tfa._expand(k, g).float())
    dk = scale * torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    return dq, dk, dv


def _tc_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 1e-5 + TC_RTOL * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: {err} > {tol}"
    return err / tol


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_core_roundings_stay_within_tolerance_of_jax(name):
    """Every (rank, kv_rank) pair of the sp = 4 split, bf16 inputs, the
    final lse of the plain forward chain: the emulated tensor-core
    roundings against ``flash_chunk_dq``/``flash_chunk_dkv`` in interpret
    mode, within 1e-5 + 2^-7 of the largest value; and not bit for bit,
    so the check sees the rounding."""
    case = _case(name, "bf16")
    g, scale = case["g"], case["scale"]
    _, j_dq, j_dkv = _jax_fns(scale, g)
    bh = case["q"].shape[0]
    worst = 0.0
    for rank in range(SP):
        state = (_t(np.full((bh, SL), -1e9, np.float32)), _t(np.zeros((bh, SL), np.float32)),
                 _t(np.zeros((bh, SL, HD), np.float32)))
        for t in range(SP):
            q, k, v, _, slopes, qpos, kpos, kneg = map(_t, _pair(case, rank, (rank - t) % SP))
            state = tfa.flash_ring_chunk_reference(q, k, v, slopes, qpos, kpos, kneg, *state,
                                                   scale, g)
        m, l, acc = (x.numpy() for x in state)
        l = np.maximum(l, 1e-30)
        out = np.asarray(jnp.asarray(acc / l[..., None], jnp.bfloat16).astype(jnp.float32))
        lse = m + np.log(l)
        for kv_rank in range(SP):
            q, k, v, do, slopes, qpos, kpos, kneg = _pair(case, rank, kv_rank)
            delta = (do * out).sum(-1).astype(np.float32)
            rest = (lse, delta, slopes, qpos, kpos, kneg)
            jx = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
            want = (j_dq(*jx, *rest), *j_dkv(*jx, *rest))
            got = _tc_rounded(*(_t(x).to(torch.bfloat16) for x in (q, k, v, do)),
                              *map(_t, rest), scale, g)
            for what, a, b_ in zip(("dq", "dk", "dv"), got, want):
                worst = max(worst, _tc_close(a.numpy(), b_, f"{what} ({rank}, {kv_rank})"))
    assert worst > 0


def test_tensor_core_roundings_at_s1024_stay_within_tolerance_of_jax():
    """One diagonal chunk of S = 1024 (sp = 1, 16 x 16 tiles of 64), bf16,
    ALiBi and a right-padded row, the lse of the plain forward: as the sp
    = 4 cases, at a length where each row sums over hundreds of keys."""
    rng = np.random.default_rng(8)
    bh, s, hd = 2, 1024, 64
    bf = lambda x: np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q, k, v, do = (bf(rng.standard_normal((bh, s, hd), dtype=np.float32)) for _ in range(4))
    slopes = np.array([2.0 ** -1, 2.0 ** -5], np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.float32), (bh, s)).copy()
    kneg = np.zeros((bh, s), np.float32)
    kneg[1, s - 200:] = -1e9
    do[1, s - 200:] = 0
    scale = hd ** -0.5
    state = tfa.flash_ring_chunk_reference(
        *map(_t, (q, k, v, slopes, pos, pos, kneg)), _t(np.full((bh, s), -1e9, np.float32)),
        _t(np.zeros((bh, s), np.float32)), _t(np.zeros((bh, s, hd), np.float32)), scale)
    m, l, acc = (x.numpy() for x in state)
    out = bf(acc / l[..., None])
    lse = m + np.log(l)
    rest = (lse, (do * out).sum(-1).astype(np.float32), slopes, pos, pos, kneg)
    _, j_dq, j_dkv = _jax_fns(scale, 1)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    want = (j_dq(*jx, *rest), *j_dkv(*jx, *rest))
    got = _tc_rounded(*(_t(x).to(torch.bfloat16) for x in (q, k, v, do)), *map(_t, rest),
                      scale, 1)
    for what, a, b_ in zip(("dq", "dk", "dv"), got, want):
        _tc_close(a.numpy(), b_, what)


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_chunk_bwd_plan_routes_bf16_to_the_tensor_cores(hd):
    plan = tfa.chunk_bwd_plan(torch.bfloat16, hd, 200, 8192)
    assert plan["route"] == "mma" and plan["threads"] == 128
    assert plan["grid_tiles"] == {"dq": 4, "dkv": 128} and plan["dq_tiles_reversed"]
    # resident tiles + a two-deep ring of (two bf16 tiles, three float32 vectors)
    mat = 64 * (2 * hd + 16)
    assert plan["smem_bytes"] == {"dq": 6 * mat + 1536, "dkv": 6 * mat + 1536}
    assert max(plan["smem_bytes"].values()) <= 227 * 1024
    # the blocks an SM is built for fit its 228 KB (1 KB reserved a block)
    assert plan["blocks_per_sm"] * (plan["smem_bytes"]["dq"] + 1024) <= 228 * 1024
    assert plan["blocks_per_sm"] == (4 if hd <= 64 else 2)
    assert plan["dkv_pass_queries"] == 16


@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_chunk_bwd_plan_keeps_float32_on_the_fma_kernels(hd):
    plan = tfa.chunk_bwd_plan(torch.float32, hd, 8192, 130)
    assert plan["route"] == "fma" and plan["threads"] == 256
    assert plan["grid_tiles"] == {"dq": 128, "dkv": 3} and not plan["dq_tiles_reversed"]
    assert plan["blocks_per_sm"] is None and plan["dkv_pass_queries"] == 64
    rows, score = 64 * (hd + 1), 64 * 65
    assert plan["smem_bytes"] == {"dq": 4 * (4 * rows + score + 192),
                                  "dkv": 4 * (4 * rows + 2 * score + 256)}
    assert max(plan["smem_bytes"].values()) <= 227 * 1024


def test_chunk_bwd_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.chunk_bwd_plan(torch.float16, 64, 64, 64)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.chunk_bwd_plan(torch.bfloat16, 96, 64, 64)
    with pytest.raises(ValueError, match="tiles"):
        tfa.chunk_bwd_plan(torch.bfloat16, 64, 64 * tfa.MAX_TILES + 1, 64)
    with pytest.raises(ValueError, match="tiles"):
        tfa.chunk_bwd_plan(torch.float32, 64, 64, -1)


def _tc_chunk_fwd_rounded(q, k, v, slopes, qpos, kpos, kneg, m, l, acc, scale, g):
    """The state (m, l, acc) as the tensor-core forward rounds it: 64 x 64
    tile pairs, a pair skipped when its smallest key position exceeds its
    largest query position, the online softmax in float32 with l summing
    the float32 p, and P rounded once to bf16 before the PV product."""
    sc = tfa._chunk_scores(q, k, slopes, qpos, kpos, kneg, scale, g)
    kp = tfa._expand(kpos, g)
    vf = tfa._expand(v, g).float()
    m, l, acc = m.clone(), l.clone(), acc.clone()
    sq, skv = sc.shape[1:]
    for q0 in range(0, sq, 64):
        rows = slice(q0, min(q0 + 64, sq))
        for k0 in range(0, skv, 64):
            keys = slice(k0, min(k0 + 64, skv))
            visit = kp[:, keys].amin(-1) <= qpos[:, rows].amax(-1)    # (BH,)
            t = sc[:, rows, keys]
            m_new = torch.maximum(m[:, rows], t.amax(-1))
            p = torch.exp(t - m_new[..., None])
            alpha = torch.exp(m[:, rows] - m_new)
            l_new = l[:, rows] * alpha + p.sum(-1)
            acc_new = acc[:, rows] * alpha[..., None] + torch.einsum(
                "bqk,bkd->bqd", p.to(torch.bfloat16).float(), vf[:, keys])
            m[:, rows] = torch.where(visit[:, None], m_new, m[:, rows])
            l[:, rows] = torch.where(visit[:, None], l_new, l[:, rows])
            acc[:, rows] = torch.where(visit[:, None, None], acc_new, acc[:, rows])
    return m, l, acc


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_core_forward_roundings_stay_within_tolerance_of_jax(name):
    """Every (rank, kv_rank) pair of the sp = 4 split in ring order, bf16
    inputs, each step from the state JAX carried into it: the emulated
    tensor-core forward against ``flash_ring_chunk`` in interpret mode on
    the rows that have seen an unmasked key, acc within 1e-5 + 2^-7 of its
    largest value, m and l within 2e-5; and acc not bit for bit, so the
    check sees the rounding."""
    case = _case(name, "bf16")
    g, scale = case["g"], case["scale"]
    j_fwd = _jax_fns(scale, g)[0]
    bh = case["q"].shape[0]
    worst = 0.0
    for rank in range(SP):
        state = (np.full((bh, SL), -1e9, np.float32), np.zeros((bh, SL), np.float32),
                 np.zeros((bh, SL, HD), np.float32))
        for t in range(SP):
            kv_rank = (rank - t) % SP
            q, k, v, _, slopes, qpos, kpos, kneg = _pair(case, rank, kv_rank)
            want = [np.asarray(x) for x in j_fwd(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                                 slopes, qpos, kpos, kneg, *state)]
            got = _tc_chunk_fwd_rounded(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                                        *map(_t, (slopes, qpos, kpos, kneg, *state)), scale, g)
            seen = want[0] > SEEN
            _close(got[0].numpy()[seen], want[0][seen], f"m ({rank}, {kv_rank})")
            _close(got[1].numpy()[seen], want[1][seen], f"l ({rank}, {kv_rank})")
            worst = max(worst, _tc_close(got[2].numpy()[seen], want[2][seen],
                                         f"acc ({rank}, {kv_rank})"))
            state = want
    assert worst > 0


def test_chunk_forward_on_cpu_takes_the_plain_version_and_counts_nothing():
    case = _case("gqa_g2", "bf16")
    q, k, v, _, slopes, qpos, kpos, kneg = map(_t, _pair(case, 2, 1))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    bh = q.shape[0]
    state = (torch.full((bh, SL), -1e9), torch.zeros(bh, SL), torch.zeros(bh, SL, HD))
    args = (q, k, v, slopes, qpos, kpos, kneg, *state, case["scale"], case["g"])
    before = (tfa.flash_ring_chunk.launches, dict(tfa.flash_ring_chunk.routes))
    for a, b_ in zip(tfa.flash_ring_chunk(*args), tfa.flash_ring_chunk_reference(*args)):
        assert torch.equal(a, b_)
    assert (tfa.flash_ring_chunk.launches, dict(tfa.flash_ring_chunk.routes)) == before


def test_chunk_backward_on_cpu_takes_the_plain_versions_and_counts_nothing():
    case = _case("gqa_g2", "bf16")
    q, k, v, do, slopes, qpos, kpos, kneg = map(_t, _pair(case, 1, 0))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    bh = q.shape[0]
    lse, delta = torch.zeros(bh, SL), torch.zeros(bh, SL)
    args = (q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, case["scale"], case["g"])
    counts = [(fn.launches, dict(fn.routes)) for fn in (tfa.flash_chunk_dq, tfa.flash_chunk_dkv)]
    assert torch.equal(tfa.flash_chunk_dq(*args), tfa.flash_chunk_dq_reference(*args))
    for a, b_ in zip(tfa.flash_chunk_dkv(*args), tfa.flash_chunk_dkv_reference(*args)):
        assert torch.equal(a, b_)
    assert counts == [(fn.launches, dict(fn.routes))
                      for fn in (tfa.flash_chunk_dq, tfa.flash_chunk_dkv)]
