"""The ring-attention chunk kernels (B7 forward, B8 dQ, B9 dK/dV) against
their plain PyTorch versions, on the card, and ``ring_flash_attention`` at
sp = 1 on the card against the CPU. Skips without a card: the kernels have
no CPU mode.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_ring_chunk_cuda.py

Each case splits one sequence into sp chunks and walks every (rank,
kv_rank) pair in ring order, carrying the state from step to step, as the
ring does. The kernels skip a 64 x 64 tile pair whose keys all lie in the
future of all its queries; the plain versions do not. The two may differ
only on a query row that has seen no unmasked key yet, so the forward is
compared on the rows that have (m above NEG_INF / 10), and a fully-future
pair must leave the state bit for bit as it was. The backward takes the
final lse of the plain chain and zero dO on padded queries, as the models
give it, and is compared everywhere.

Tolerance, on max |kernel - plain| against the largest |plain| value M:
m, a maximum of scores, 1e-5 + 2^-21 * M (four ulps) in both input dtypes;
l and, from float32 inputs (the FMA route), acc, dq, dk and dv 1e-5 + 2e-4
* M, as the flash kernels' float32 outputs: both sides sum float32 products
in another order and ALiBi scores reach slope * S, whose float32 ulp P
inherits. bf16 inputs take the tensor-core route (``fwd_plan``,
``chunk_bwd_plan``), which rounds P (and dS) once to bf16 (a relative 2^-9
each) before the second product, every sum in float32: acc, dq, dk and dv
hold to 1e-5 + 2^-7 * M, as the flash kernels' bf16 outputs
(``FLASH_RTOL[bfloat16]`` in chip_smoke.py); l sums the float32 p and keeps
2e-4.
"""
import numpy as np
import pytest
import torch

from pipegoose_tpu_torch.ops import flash_attention as fa

RTOL = 2e-4
BWD_RTOL = {torch.float32: RTOL, torch.bfloat16: 2.0 ** -7}   # acc, dq, dk, dv by input dtype
ROUTE = {torch.float32: "fma", torch.bfloat16: "mma"}
ATOL = 1e-5
M_RTOL = 2.0 ** -21
SEEN = fa.NEG_INF / 10   # m above this: the row has seen an unmasked key


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def sp_case(dev, dtype, *, b=2, nh=4, nkv=4, s=256, hd=64, pad=None, seed=0):
    """One sequence's flattened operands: q, dO (B*nh, S, hd), k, v (B*nkv,
    S, hd), ALiBi slopes (B*nh,), and the key bias (B*nkv, S): padding
    NEG_INF, plus under left padding the mask-aware ALiBi correction
    slope * (alibi_pos - pos) per head (which needs nh == nkv)."""
    gen = torch.Generator().manual_seed(seed)
    f = lambda rows: torch.randn(rows, s, hd, generator=gen)  # noqa: E731
    q, do, k, v = f(b * nh), f(b * nh), f(b * nkv), f(b * nkv)
    mask = torch.ones(b, s)
    if pad == "right":
        mask[-1, s - s // 5:] = 0
    elif pad == "left":
        mask[0, :s // 5] = 0
        mask[-1, :3] = 0
    slopes = torch.tensor([2.0 ** -(8 * (h + 1) / nh) for h in range(nh)]).repeat(b)
    heads = lambda x, h: x[:, None].expand(b, h, s).reshape(b * h, s)  # noqa: E731
    kneg = heads((1 - mask) * fa.NEG_INF, nkv)
    if pad == "left":
        apos = (torch.cumsum(mask, -1) - 1) * mask
        kneg = kneg + slopes[:, None] * (heads(apos, nh) - torch.arange(s).float())
    do = do * heads(mask, nh)[..., None]          # padded queries get no gradient
    cast = lambda t: t.to(dev, dtype).contiguous()  # noqa: E731
    f32 = lambda t: t.to(dev, torch.float32).contiguous()  # noqa: E731
    return {"q": cast(q), "k": cast(k), "v": cast(v), "do": cast(do),
            "slopes": f32(slopes), "kneg": f32(kneg), "g": nh // nkv,
            "scale": hd ** -0.5}


def chunk_args(case, sp, rank, kv_rank):
    """(q, k, v, do, slopes, qpos, kpos, kneg) of one (rank, kv_rank) pair.
    With ``case["perm"]`` (a permutation of a chunk's indices) the positions
    of each chunk are permuted, so no tile of positions is in order."""
    s = case["q"].shape[1]
    sl = s // sp
    qs, ks = slice(rank * sl, (rank + 1) * sl), slice(kv_rank * sl, (kv_rank + 1) * sl)
    order = case.get("perm")
    if order is None:
        order = torch.arange(sl, device=case["q"].device)
    pos = lambda r, rows: (r * sl + order).float()[None].expand(rows, sl).contiguous()  # noqa: E731
    c = lambda t, part: t[:, part].contiguous()  # noqa: E731
    bh, bkv = case["q"].shape[0], case["k"].shape[0]
    return (c(case["q"], qs), c(case["k"], ks), c(case["v"], ks), c(case["do"], qs),
            case["slopes"], pos(rank, bh), pos(kv_rank, bkv), c(case["kneg"], ks))


def _err(got, want, rtol):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got - want).abs().max().item() if want.numel() else 0.0
    return err, ATOL + rtol * (want.abs().max().item() if want.numel() else 0.0)


def check_ring(case, sp):
    """Walk every (rank, kv_rank) pair in ring order through B7, then B8
    and B9 from the plain chain's lse; fail on any disagreement. Returns
    the worst error of each kernel."""
    bh, s, hd = case["q"].shape
    sl, g, scale = s // sp, case["g"], case["scale"]
    bwd_rtol = BWD_RTOL[case["q"].dtype]   # also the forward's acc
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    dev = case["q"].device
    finals = []
    for rank in range(sp):
        m = torch.full((bh, sl), fa.NEG_INF, device=dev)
        l = torch.zeros((bh, sl), device=dev)
        acc = torch.zeros((bh, sl, hd), device=dev)
        for t in range(sp):
            kv_rank = (rank - t) % sp
            q, k, v, _, slopes, qpos, kpos, kneg = chunk_args(case, sp, rank, kv_rank)
            state = (m, l, acc)
            got = fa.flash_ring_chunk(q, k, v, slopes, qpos, kpos, kneg, *state, scale, g)
            want = fa.flash_ring_chunk_reference(q, k, v, slopes, qpos, kpos, kneg,
                                                 *state, scale, g)
            if kv_rank > rank:   # fully future: the state passes through untouched
                for a, b_ in zip(got, state):
                    assert torch.equal(a, b_), f"pair ({rank}, {kv_rank}) moved the state"
            seen = want[0] > SEEN
            for name, a, b_, rtol in (("m", got[0], want[0], M_RTOL),
                                      ("l", got[1], want[1], RTOL),
                                      ("acc", got[2], want[2], bwd_rtol)):
                err, tol = _err(a[seen], b_[seen], rtol)
                assert err <= tol, f"B7 {name} pair ({rank}, {kv_rank}): {err} > {tol}"
                worst["fwd"] = max(worst["fwd"], err)
            m, l, acc = want
        l = torch.clamp_min(l, 1e-30)
        finals.append(((acc / l[..., None]).to(case["q"].dtype), m + torch.log(l)))
    for rank in range(sp):
        out, lse = finals[rank]
        for kv_rank in range(sp):
            q, k, v, do, slopes, qpos, kpos, kneg = chunk_args(case, sp, rank, kv_rank)
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, scale, g)
            err, tol = _err(fa.flash_chunk_dq(*args), fa.flash_chunk_dq_reference(*args),
                            bwd_rtol)
            assert err <= tol, f"B8 pair ({rank}, {kv_rank}): {err} > {tol}"
            worst["dq"] = max(worst["dq"], err)
            for got, want in zip(fa.flash_chunk_dkv(*args), fa.flash_chunk_dkv_reference(*args)):
                err, tol = _err(got, want, bwd_rtol)
                assert err <= tol, f"B9 pair ({rank}, {kv_rank}): {err} > {tol}"
                worst["dkv"] = max(worst["dkv"], err)
    torch.cuda.synchronize()
    return worst


CASES = {   # name -> (sp_case kwargs, sp)
    "s256_sp4": (dict(), 4),
    "right_pad": (dict(pad="right"), 4),
    "left_pad_alibi_pos": (dict(pad="left"), 4),
    "gqa_g2": (dict(nkv=2, pad="right"), 4),
    "ragged_s200_sp2": (dict(s=200), 2),
    "hd32_sp1": (dict(hd=32, s=130), 1),
    "hd128": (dict(hd=128, nh=2, nkv=2, pad="left"), 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chunk_kernels_match_plain_versions_on_card(dtype, name):
    dev = _needs_card()
    kw, sp = CASES[name]
    fns = (fa.flash_ring_chunk, fa.flash_chunk_dq, fa.flash_chunk_dkv)
    counts = [fn.launches for fn in fns]
    routes = [fn.routes[ROUTE[dtype]] for fn in fns]
    check_ring(sp_case(dev, dtype, **kw), sp)
    moved = [fn.launches - c for fn, c in zip(fns, counts)]
    assert moved == [sp * sp] * 3
    assert [fn.routes[ROUTE[dtype]] - c for fn, c in zip(fns, routes)] == [sp * sp] * 3


@pytest.mark.cuda
def test_tensor_core_route_at_the_sp_training_shape():
    """bf16 B*nh = 16, S = 8192, hd = 64, the diagonal chunk from zero state
    and, for the backward, the plain forward's lse (the shape of
    chip_smoke.py's timed SP step), left-padded with the ALiBi correction:
    B7, B8 and B9 on the tensor cores against their plain versions."""
    dev = _needs_card()
    case = sp_case(dev, torch.bfloat16, b=1, nh=16, nkv=16, s=8192, pad="left", seed=8)
    fns = (fa.flash_ring_chunk, fa.flash_chunk_dq, fa.flash_chunk_dkv)
    before = [fn.routes["mma"] for fn in fns]
    worst = check_ring(case, 1)
    assert [fn.routes["mma"] - c for fn, c in zip(fns, before)] == [1, 1, 1]
    assert min(worst.values()) > 0   # bf16 operands: not bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sp", [1, 2])
def test_skip_does_not_assume_ordered_positions(dtype, sp):
    """Each chunk's positions permuted (so a tile's positions are neither
    sorted nor contiguous): every kernel still equals its plain version,
    which computes every pair, and a fully-future pair still leaves the
    forward state as it was."""
    dev = _needs_card()
    case = sp_case(dev, dtype, s=384, pad="right", seed=11)
    gen = torch.Generator().manual_seed(12)
    case["perm"] = torch.randperm(384 // sp, generator=gen).to(dev)
    check_ring(case, sp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernels_repeat_bit_for_bit(dtype):
    """No atomics and a fixed order of every sum: two calls on the same
    inputs give the same bits (GQA g = 2, ragged tiles, a padded mask)."""
    dev = _needs_card()
    case = sp_case(dev, dtype, nkv=2, s=200, pad="right", seed=13)
    q, k, v, do, slopes, qpos, kpos, kneg = chunk_args(case, 1, 0, 0)
    bh, s, _ = q.shape
    gen = torch.Generator().manual_seed(14)
    lse = (torch.rand(bh, s, generator=gen) * 4).to(dev)
    delta = torch.randn(bh, s, generator=gen).to(dev)
    args = (q, k, v, do, lse, delta, slopes, qpos, kpos, kneg, case["scale"], case["g"])
    first = (fa.flash_chunk_dq(*args), *fa.flash_chunk_dkv(*args))
    second = (fa.flash_chunk_dq(*args), *fa.flash_chunk_dkv(*args))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_forward_kernel_repeats_bit_for_bit(hd):
    """B7 on the tensor cores: a fixed order of every sum, so two calls on
    the same inputs and a carried random state give the same bits (GQA
    g = 2, ragged tiles, queries ahead of the keys, a padded mask)."""
    dev = _needs_card()
    case = sp_case(dev, torch.bfloat16, nkv=2, s=200, hd=hd, pad="right", seed=16)
    q, k, v, _, slopes, qpos, kpos, kneg = chunk_args(case, 2, 1, 0)
    bh, sq, _ = q.shape
    gen = torch.Generator().manual_seed(17)
    state = ((torch.randn(bh, sq, generator=gen) * 0.5).to(dev),
             (torch.rand(bh, sq, generator=gen) + 0.5).to(dev),
             torch.randn(bh, sq, hd, generator=gen).to(dev))
    args = (q, k, v, slopes, qpos, kpos, kneg, *state, case["scale"], case["g"])
    before = fa.flash_ring_chunk.routes["mma"]
    first, second = fa.flash_ring_chunk(*args), fa.flash_ring_chunk(*args)
    assert fa.flash_ring_chunk.routes["mma"] - before == 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_float32_forward_stays_on_the_fma_route():
    """float32 inputs never round to bf16: B7 launches the FMA kernel
    (route counter) and keeps 1e-5 + 2e-4 * M on acc against the plain
    version, on every pair of an sp = 2 split."""
    dev = _needs_card()
    before = dict(fa.flash_ring_chunk.routes)
    worst = check_ring(sp_case(dev, torch.float32, s=256, pad="right", seed=18), 2)
    assert fa.flash_ring_chunk.routes["fma"] - before["fma"] == 4
    assert fa.flash_ring_chunk.routes["mma"] == before["mma"]
    assert worst["fwd"] > 0


@pytest.mark.cuda
def test_float32_backward_stays_on_the_fma_route():
    """float32 inputs never round to bf16: B8 and B9 launch the FMA kernels
    (route counters) and keep 1e-5 + 2e-4 * M against the plain versions."""
    dev = _needs_card()
    before = {r: [fn.routes[r] for fn in (fa.flash_chunk_dq, fa.flash_chunk_dkv)]
              for r in ("fma", "mma")}
    check_ring(sp_case(dev, torch.float32, s=256, pad="left", seed=15), 2)
    after = {r: [fn.routes[r] for fn in (fa.flash_chunk_dq, fa.flash_chunk_dkv)]
             for r in ("fma", "mma")}
    assert [a - b for a, b in zip(after["fma"], before["fma"])] == [4, 4]
    assert after["mma"] == before["mma"]


@pytest.mark.cuda
def test_chunk_wrappers_reject_what_the_kernels_do_not_take():
    dev = _needs_card()
    case = sp_case(dev, torch.float32)
    q, k, v, do, slopes, qpos, kpos, kneg = chunk_args(case, 1, 0, 0)
    bh, s, hd = q.shape
    m = torch.full((bh, s), fa.NEG_INF, device=dev)
    l, acc = torch.zeros((bh, s), device=dev), torch.zeros((bh, s, hd), device=dev)
    fwd = lambda **kw: fa.flash_ring_chunk(*{**dict(q=q, k=k, v=v, slopes=slopes, qpos=qpos, kpos=kpos, kneg=kneg, m=m, l=l, acc=acc), **kw}.values(), 0.125)  # noqa: E731
    with pytest.raises(TypeError):
        fwd(q=q.half(), k=k.half(), v=v.half())
    with pytest.raises(TypeError):
        fwd(k=k.to(torch.bfloat16))
    with pytest.raises(TypeError):
        fwd(m=m.double())
    with pytest.raises(ValueError, match="head_dim"):
        fwd(q=q[..., :48].contiguous(), k=k[..., :48].contiguous(),
            v=v[..., :48].contiguous(), acc=acc[..., :48].contiguous())
    with pytest.raises(ValueError, match="qpos must be"):
        fwd(qpos=qpos[:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fwd(kneg=kneg.t().contiguous().t())
    with pytest.raises(ValueError, match="is on cpu"):
        fwd(l=l.cpu())
    lse = torch.zeros((bh, s), device=dev)
    with pytest.raises(ValueError, match="multiple of g"):
        fa.flash_chunk_dq(q, k, v, do, lse, lse, slopes, qpos, kpos, kneg, 0.125, 3)
    with pytest.raises(TypeError, match="lse"):
        fa.flash_chunk_dkv(q, k, v, do, lse.double(), lse, slopes, qpos, kpos, kneg, 0.125)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    shifted = torch.empty(bf[0].numel() + 8, dtype=torch.bfloat16, device=dev)[8:]
    shifted = shifted.view(bf[0].shape).copy_(bf[0])   # contiguous, 16-byte offset + 16
    odd = torch.empty(bf[0].numel() + 1, dtype=torch.bfloat16, device=dev)[1:]
    odd = odd.view(bf[0].shape).copy_(bf[0])           # contiguous, 2 bytes off
    fa.flash_chunk_dq(shifted, *bf[1:], lse, lse, slopes, qpos, kpos, kneg, 0.125)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_chunk_dq(odd, *bf[1:], lse, lse, slopes, qpos, kpos, kneg, 0.125)
    # the bf16 forward: q, k, v on 16 bytes and acc on 8
    fa.flash_ring_chunk(shifted, *bf[1:3], slopes, qpos, kpos, kneg, m, l, acc, 0.125)
    for name in ("q", "k", "v"):
        with pytest.raises(ValueError, match="16-byte"):
            fwd(**{**dict(zip("qkv", bf[:3])), name: odd})
    acc_odd = torch.empty(acc.numel() + 1, device=dev)[1:].view(acc.shape).copy_(acc)
    with pytest.raises(ValueError, match="8-byte"):
        fwd(q=bf[0], k=bf[1], v=bf[2], acc=acc_odd)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [None, "left"])
def test_ring_flash_at_sp1_on_card_equals_the_cpu(pad):
    """``ring_flash_attention`` and its q/k/v gradients at sp = 1 (axis
    None), float32: the kernels on the card against the plain versions on
    the CPU; padded query rows are zeroed as the models zero them."""
    from pipegoose_tpu_torch.nn.sequence_parallel import ring_flash_attention

    dev = _needs_card()
    from pipegoose_tpu_torch import resolve_device

    resolve_device(dev)
    rng = np.random.default_rng(3)
    b, s, nh, hd = 2, 192, 4, 64
    x = {n: rng.standard_normal((b, s, nh, hd), dtype=np.float32) for n in "qkvo"}
    mask = np.ones((b, s), np.float32)
    if pad == "left":
        mask[0, :40] = 0
    apos = ((np.cumsum(mask, -1) - 1) * mask).astype(np.float32)
    slopes = np.array([2.0 ** -(2 * (h + 1)) for h in range(nh)], np.float32)
    runs = []
    for where in ("cpu", dev):
        t = {n: torch.from_numpy(a).to(where) for n, a in x.items()}
        q, k, v = (t[n].requires_grad_() for n in "qkv")
        w = torch.from_numpy(mask).to(where)
        out = ring_flash_attention(q, k, v, None, alibi_slopes=torch.from_numpy(slopes).to(where),
                                   kv_side=w, alibi_pos=torch.from_numpy(apos).to(where))
        out = out * w[:, :, None, None]
        (out * t["o"]).sum().backward()
        runs.append([y.detach().cpu() for y in (out, q.grad, k.grad, v.grad)])
    for name, got, want in zip(("out", "dq", "dk", "dv"), runs[1], runs[0]):
        err, tol = _err(got, want, RTOL)
        assert err <= tol, f"{name}: card vs CPU {err} > {tol}"
