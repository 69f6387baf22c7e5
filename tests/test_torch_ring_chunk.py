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
