"""The flash-attention CUDA kernels (forward, dQ, dK/dV) against their
plain PyTorch versions, on the card. Skips without one: the kernels have
no CPU mode.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_cuda.py

Tolerance, on max |kernel - plain| against the largest |plain| value M:
- float32 outputs: 1e-5 + 2e-4 * M. Both sides compute in float32 but sum
  q.k, P.V and dS.K in another order; ALiBi scores reach slope * S (~128
  here), where a float32 ulp is 1.5e-5, and P inherits that relative
  error; the backward multiplies it by dO.V (~8).
- bf16 outputs: 1e-5 + 2^-7 * M. Each side rounds a float32 value that
  differs from the other's in its last bits, so the two may land one bf16
  ulp apart, and a bf16 ulp is at most 2^-7 of the value. The bf16 kernels
  run on the tensor cores (``fwd_plan``, ``bwd_plan``), which also round P
  (and, in the backward, dS) once to bf16 (a relative 2^-9) before the
  second product, every sum in float32: out, dq, dk and dv keep the same
  bound.
- lse (float32 in both dtypes): 1e-5 + 2^-21 * M, four float32 ulps of
  the largest value.
"""
import numpy as np
import pytest
import torch

from pipegoose_tpu_torch.ops import flash_attention as fa

RTOL = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -7}
ROUTE = {torch.float32: "fma", torch.bfloat16: "mma"}   # every kernel's route
ATOL = 1e-5
LSE_RTOL = 2.0 ** -21

# (g, causal, window, pad): GQA group size, causal mask, sliding window,
# right-padded keys at the end of kv row 0
VARIANTS = {
    "causal": (1, True, None, 0),
    "gqa_g2_padded": (2, True, None, 9),
    "noncausal": (1, False, None, 0),
    "window64": (1, True, 64, 0),
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(s, dtype, g, pad, dev, bh=4, hd=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    f = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    q, do = f(bh, s, hd), f(bh, s, hd)
    k, v = f(bh // g, s, hd), f(bh // g, s, hd)
    slopes = torch.tensor([2.0 ** -(i + 1) for i in range(bh)])
    mask = torch.ones(bh // g, s)
    if pad and s > pad:
        mask[0, s - pad:] = 0
    kpos, kneg = fa.mask_to_kv_bias(mask)
    cast = lambda t: t.to(dev, dtype)  # noqa: E731
    f32 = lambda t: t.to(dev).contiguous()  # noqa: E731
    return (cast(q), cast(k), cast(v), cast(do), f32(slopes), f32(kpos),
            f32(kneg), hd ** -0.5)


def _assert_close(got, want, rtol, what):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all(), what
    err = (got - want).abs().max().item()
    tol = ATOL + rtol * want.abs().max().item()
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("s", [1, 100, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernels_match_plain_versions_on_card(dtype, s, variant):
    """S=100 ends on a ragged 64-position tile; S=256 spans four."""
    dev = _needs_card()
    g, causal, window, pad = VARIANTS[variant]
    q, k, v, do, slopes, kpos, kneg, scale = _case(s, dtype, g, pad, dev)
    mode = (scale, causal, g, window)
    counts = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    kernels = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)
    routes = [dict(f.routes) for f in kernels]
    out, lse = fa.flash_fwd(q, k, v, slopes, kpos, kneg, *mode)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, slopes, kpos, kneg, *mode)
    delta = (do.float() * ref_out.float()).sum(-1)
    bwd = (q, k, v, do, ref_lse, delta, slopes, kpos, kneg, *mode)
    dq = fa.flash_dq(*bwd)
    dk, dv = fa.flash_dkv(*bwd)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(c + 1 for c in counts)
    for f, before in zip(kernels, routes):
        assert {r: f.routes[r] - before[r] for r in before} == {
            r: int(r == ROUTE[dtype]) for r in before}
    assert out.dtype == dq.dtype == dk.dtype == dtype and lse.dtype == torch.float32
    _assert_close(out, ref_out, RTOL[dtype], "out")
    _assert_close(lse, ref_lse, LSE_RTOL, "lse")
    _assert_close(dq, fa.flash_dq_reference(*bwd), RTOL[dtype], "dq")
    ref_dk, ref_dv = fa.flash_dkv_reference(*bwd)
    _assert_close(dk, ref_dk, RTOL[dtype], "dk")
    _assert_close(dv, ref_dv, RTOL[dtype], "dv")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tensor_core_forward_at_other_head_dims(variant, hd):
    """The bf16 forward at head_dim 32 and 128 (S = 200, four tiles, the
    last ragged) on the tensor-core route against its plain version."""
    dev = _needs_card()
    g, causal, window, pad = VARIANTS[variant]
    q, k, v, _, slopes, kpos, kneg, scale = _case(200, torch.bfloat16, g, pad, dev, hd=hd,
                                                  seed=hd)
    mode = (hd ** -0.5, causal, g, window)
    before = fa.flash_fwd.routes["mma"]
    out, lse = fa.flash_fwd(q, k, v, slopes, kpos, kneg, *mode)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, slopes, kpos, kneg, *mode)
    torch.cuda.synchronize()
    assert fa.flash_fwd.routes["mma"] - before == 1
    _assert_close(out, ref_out, RTOL[torch.bfloat16], "out")
    _assert_close(lse, ref_lse, LSE_RTOL, "lse")


@pytest.mark.cuda
def test_tensor_core_forward_at_the_training_shape():
    """bf16 B*nh = 128, S = 1024, hd = 64, causal with BLOOM's ALiBi (the
    shape of chip_smoke.py's timed training step): on the tensor cores,
    within the bf16 bound of its plain version, and not bit for bit."""
    dev = _needs_card()
    gen = torch.Generator().manual_seed(21)
    bh, s, hd = 128, 1024, 64
    q, k, v = (torch.randn(bh, s, hd, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    slopes = torch.tensor([2.0 ** -(8 * (h % 16 + 1) / 16) for h in range(bh)], device=dev)
    kpos, kneg = (t.to(dev).contiguous() for t in fa.mask_to_kv_bias(torch.ones(bh, s)))
    mode = (hd ** -0.5, True, 1, None)
    before = fa.flash_fwd.routes["mma"]
    out, lse = fa.flash_fwd(q, k, v, slopes, kpos, kneg, *mode)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, slopes, kpos, kneg, *mode)
    torch.cuda.synchronize()
    assert fa.flash_fwd.routes["mma"] - before == 1
    _assert_close(out, ref_out, RTOL[torch.bfloat16], "out")
    _assert_close(lse, ref_lse, LSE_RTOL, "lse")
    assert not torch.equal(out, ref_out)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tensor_core_forward_repeats_bit_for_bit(variant):
    """No atomics and a fixed order of every sum: two bf16 forward calls on
    the same inputs give the same bits."""
    dev = _needs_card()
    g, causal, window, pad = VARIANTS[variant]
    q, k, v, _, slopes, kpos, kneg, scale = _case(200, torch.bfloat16, g, pad, dev, seed=22)
    args = (q, k, v, slopes, kpos, kneg, scale, causal, g, window)
    first, second = fa.flash_fwd(*args), fa.flash_fwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_forward_needs_16_byte_aligned_operands():
    """The tensor-core route copies 16 bytes at a time: a bf16 q, k or v
    that starts 2 bytes off raises before any launch; one 16 bytes off
    launches."""
    dev = _needs_card()
    q, k, v, _, slopes, kpos, kneg, scale = _case(64, torch.bfloat16, 1, 0, dev)

    def shifted(t, elems):
        return torch.empty(t.numel() + elems, dtype=t.dtype, device=dev)[elems:].view(
            t.shape).copy_(t)

    args = {"q": q, "k": k, "v": v}
    fa.flash_fwd(*{**args, "q": shifted(q, 8)}.values(), slopes, kpos, kneg, scale, True)
    launches = fa.flash_fwd.launches
    for name in args:
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_fwd(*{**args, name: shifted(args[name], 1)}.values(), slopes, kpos,
                         kneg, scale, True)
    assert fa.flash_fwd.launches == launches


def _bwd_case(s, g, causal, window, pad, dev, hd, seed):
    """bf16 backward operands with the plain forward's lse and delta."""
    q, k, v, do, slopes, kpos, kneg, scale = _case(s, torch.bfloat16, g, pad, dev, hd=hd,
                                                   seed=seed)
    mode = (scale, causal, g, window)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, slopes, kpos, kneg, *mode)
    delta = (do.float() * ref_out.float()).sum(-1)
    return (q, k, v, do, ref_lse, delta, slopes, kpos, kneg, *mode)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tensor_core_backward_at_other_head_dims(variant, hd):
    """The bf16 dQ and dK/dV at head_dim 32 and 128 (S = 200, four tiles,
    the last ragged) on the tensor-core route against their plain versions."""
    dev = _needs_card()
    g, causal, window, pad = VARIANTS[variant]
    bwd = _bwd_case(200, g, causal, window, pad, dev, hd, seed=hd + 1)
    before = (fa.flash_dq.routes["mma"], fa.flash_dkv.routes["mma"])
    dq = fa.flash_dq(*bwd)
    dk, dv = fa.flash_dkv(*bwd)
    torch.cuda.synchronize()
    assert (fa.flash_dq.routes["mma"], fa.flash_dkv.routes["mma"]) == tuple(
        b + 1 for b in before)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    _assert_close(dq, fa.flash_dq_reference(*bwd), RTOL[torch.bfloat16], "dq")
    ref_dk, ref_dv = fa.flash_dkv_reference(*bwd)
    _assert_close(dk, ref_dk, RTOL[torch.bfloat16], "dk")
    _assert_close(dv, ref_dv, RTOL[torch.bfloat16], "dv")


@pytest.mark.cuda
def test_tensor_core_backward_at_the_training_shape():
    """bf16 B*nh = 128, S = 1024, hd = 64, causal with BLOOM's ALiBi (the
    shape of chip_smoke.py's timed training step): dQ and dK/dV on the
    tensor cores, within the bf16 bound of their plain versions, and not
    bit for bit."""
    dev = _needs_card()
    gen = torch.Generator().manual_seed(23)
    bh, s, hd = 128, 1024, 64
    q, k, v, do = (torch.randn(bh, s, hd, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(4))
    slopes = torch.tensor([2.0 ** -(8 * (h % 16 + 1) / 16) for h in range(bh)], device=dev)
    kpos, kneg = (t.to(dev).contiguous() for t in fa.mask_to_kv_bias(torch.ones(bh, s)))
    mode = (hd ** -0.5, True, 1, None)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, slopes, kpos, kneg, *mode)
    bwd = (q, k, v, do, ref_lse, (do.float() * ref_out.float()).sum(-1), slopes, kpos, kneg,
           *mode)
    before = (fa.flash_dq.routes["mma"], fa.flash_dkv.routes["mma"])
    dq = fa.flash_dq(*bwd)
    dk, dv = fa.flash_dkv(*bwd)
    torch.cuda.synchronize()
    assert (fa.flash_dq.routes["mma"], fa.flash_dkv.routes["mma"]) == tuple(
        b + 1 for b in before)
    ref_dq = fa.flash_dq_reference(*bwd)
    _assert_close(dq, ref_dq, RTOL[torch.bfloat16], "dq")
    ref_dk, ref_dv = fa.flash_dkv_reference(*bwd)
    _assert_close(dk, ref_dk, RTOL[torch.bfloat16], "dk")
    _assert_close(dv, ref_dv, RTOL[torch.bfloat16], "dv")
    assert not torch.equal(dq, ref_dq)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tensor_core_backward_repeats_bit_for_bit(variant):
    """No atomics and a fixed order of every sum: two bf16 dQ and two dK/dV
    calls on the same inputs give the same bits."""
    dev = _needs_card()
    g, causal, window, pad = VARIANTS[variant]
    bwd = _bwd_case(200, g, causal, window, pad, dev, 64, seed=24)
    assert torch.equal(fa.flash_dq(*bwd), fa.flash_dq(*bwd))
    for a, b in zip(fa.flash_dkv(*bwd), fa.flash_dkv(*bwd)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_backward_needs_16_byte_aligned_operands():
    """The tensor-core backward copies 16 bytes at a time: a bf16 q, k, v
    or dO that starts 2 bytes off raises before any launch of dQ or dK/dV;
    one 16 bytes off launches."""
    dev = _needs_card()
    q, k, v, do, *rest = _bwd_case(64, 1, True, None, 0, dev, 64, seed=25)

    def shifted(t, elems):
        return torch.empty(t.numel() + elems, dtype=t.dtype, device=dev)[elems:].view(
            t.shape).copy_(t)

    args = {"q": q, "k": k, "v": v, "do": do}
    fa.flash_dq(*{**args, "do": shifted(do, 8)}.values(), *rest)
    fa.flash_dkv(*{**args, "do": shifted(do, 8)}.values(), *rest)
    counts = (fa.flash_dq.launches, fa.flash_dkv.launches)
    for name in args:
        for kernel in (fa.flash_dq, fa.flash_dkv):
            with pytest.raises(ValueError, match="16-byte"):
                kernel(*{**args, name: shifted(args[name], 1)}.values(), *rest)
    assert (fa.flash_dq.launches, fa.flash_dkv.launches) == counts


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_cannot_take():
    """Wrong dtype, a non-contiguous operand or an odd head_dim raises
    before any launch."""
    dev = _needs_card()
    q, k, v, do, slopes, kpos, kneg, scale = _case(64, torch.float32, 1, 0, dev)
    counts = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_fwd(q.half(), k.half(), v.half(), slopes, kpos, kneg, scale, True)
    with pytest.raises(TypeError, match="kv_pos"):
        fa.flash_fwd(q, k, v, slopes, kpos.double(), kneg, scale, True)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                     slopes, kpos, kneg, scale, True)
    lse = torch.zeros(q.shape[:2], device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_dq(q, k, v, do.transpose(1, 2).contiguous().transpose(1, 2),
                    lse, lse, slopes, kpos, kneg, scale, True)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_dkv(q[..., :48].contiguous(), k[..., :48].contiguous(),
                     v[..., :48].contiguous(), do[..., :48].contiguous(), lse,
                     lse, slopes, kpos, kneg, scale, True)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == counts


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_autograd_launches_each_kernel_once_and_matches_cpu(dtype):
    """flash_attention forward + backward on the card: fwd, dq and dkv
    launch once each, and the grads agree with the same function on the
    CPU (which runs the plain versions), GQA g=2 with a padded row. The
    tolerance is three times the kernels' own: in bf16 the backward also
    takes delta from a rounded output, and dK/dV of a GQA group is a sum
    of per-head values each rounded to bf16."""
    dev = _needs_card()
    gen = torch.Generator().manual_seed(3)
    b, s, nh, nkv, hd = 2, 100, 4, 2, 64
    host = [torch.randn(b, s, h, hd, generator=gen) for h in (nh, nkv, nkv)]
    w = torch.randn(b, s, nh, hd, generator=gen)
    slopes = torch.tensor([2.0 ** -(i + 1) for i in range(nh)])
    mask = torch.ones(b, s, dtype=torch.int32)
    mask[1, 80:] = 0
    results = {}
    for where in ("cpu", dev):
        leaves = [x.to(where, dtype, copy=True).requires_grad_() for x in host]
        counts = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
        out = fa.flash_attention(*leaves, slopes.to(where), mask.to(where))
        (out.float() * w.to(where)).sum().backward()
        moved = tuple(n - c for n, c in zip(
            (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches),
            counts))
        results[str(where)] = (out, [x.grad for x in leaves], moved)
    assert results["cpu"][2] == (0, 0, 0)
    assert results["cuda"][2] == (1, 1, 1)
    _assert_close(results["cuda"][0].cpu(), results["cpu"][0], RTOL[dtype], "out")
    for got, want, n in zip(results["cuda"][1], results["cpu"][1], "qkv"):
        _assert_close(got.cpu(), want, 3 * RTOL[dtype], f"d{n}")
    np.testing.assert_array_equal(results["cuda"][0].shape, (b, s, nh, hd))
