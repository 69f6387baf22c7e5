"""The fused cross-entropy CUDA kernels (forward, d-hidden, d-weight)
against their plain PyTorch versions, on the card. Skips without one: the
kernels have no CPU mode.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_ce_cuda.py

Tolerance, on max |kernel - plain| against the largest |plain| value M
(entries that are exactly NEG_INF, a masked target's logit, must agree to
the same tolerance but are left out of M):
- lse and target logit (float32 in both dtypes): 1e-5 + 2^-18 * M. bf16
  products are exact in float32 and only the summation order differs; in
  float32 the kernels multiply in split TF32, which drops the lo * lo term
  (2^-22 of each product), over H products in another order.
- float32 dh, dw: 1e-5 + 1e-4 * M: split-TF32 products summed over the
  vocabulary (dh) or the tokens (dw) in another order.
- bf16 dh, dw: 1e-5 + 2^-6 * M, two bf16 ulps of the largest value: one for
  the final rounding of float32 values that differ in their last bits, one
  for the dlogits tile that the kernels round to bf16 (2^-9 of each term)
  before the second product.

Routes (``fused_ce_dh.routes`` / ``fused_ce_dw.routes``, by ``card_plan``):
bf16 with H <= 4096 on "mma" (``csrc/fused_ce_mma.cu``, a cluster splits
H), float32, and bf16 above H = 4096, on "wmma" (``csrc/fused_ce.cu``);
``.layouts`` count the launches by weight layout.
"""
import pytest
import torch

from pipegoose_tpu_torch.ops import fused_ce as fce

ATOL = 1e-5
STAT_RTOL = 2.0 ** -18
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}

# name -> (T, H, V, offset, valid): ragged token and vocab tiles, a shard
# that starts at a nonzero offset with its last columns masked, an H that
# is not a multiple of the staging chunk (64 bf16 or 32 float32 columns),
# and one above the WMMA kernel's 1024-wide H slice (on "mma": a cluster
# of 8 ranks of 128-144 columns); BLOOM's width with T and V ragged against
# the "mma" tiles (128 resident rows, 64 streamed) and the target of some
# rows in another rank's H slice; Llama-3 8B's width, 4096 (on "mma": a
# cluster of 8 ranks of 512 columns, 64 resident rows); and 4112, above the
# "mma" route's 4096 (bf16 on "wmma")
CASES = {
    "t24_v128": (24, 32, 128, 0, None),
    "t100_v1000_offset_valid": (100, 64, 1000, 300, 1283),
    "t37_h48_v70": (37, 48, 70, 5, 60),
    "t64_h1040_v300": (64, 1040, 300, 0, None),
    "t300_h1024_v1000_offset_valid": (300, 1024, 1000, 7, 990),
    "t200_h4096_v300": (200, 4096, 300, 0, None),
    "t40_h4112_v100": (40, 4112, 100, 0, None),
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(name, dtype, vh, dev, seed=0):
    t, hd, v, offset, valid = CASES[name]
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(t, hd, generator=gen) * 0.5
    w = torch.randn(v, hd, generator=gen) * 0.5
    if not vh:
        w = w.t().contiguous()
    targets = torch.randint(0, offset + v, (t,), generator=gen, dtype=torch.int32)
    g = torch.randn(t, generator=gen)
    return (h.to(dev, dtype), w.to(dev, dtype), targets.to(dev), g.to(dev), offset,
            valid, vh)


def _assert_close(got, want, rtol, what):
    got, want = got.float(), want.float()
    assert got.shape == want.shape and torch.isfinite(got).all(), what
    finite = want.abs() < 1e8
    scale = want[finite].abs().max().item() if finite.any() else 0.0
    err = (got - want).abs().max().item()
    tol = ATOL + rtol * scale
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _counts():
    return (fce.fused_ce_fwd.launches, fce.fused_ce_dh.launches,
            fce.fused_ce_dw.launches)


def _routes():
    return {k: (fce.fused_ce_dh.routes[k], fce.fused_ce_dw.routes[k]) for k in ("mma", "wmma")}


def _layouts():
    return {k: (fce.fused_ce_dh.layouts[k], fce.fused_ce_dw.layouts[k]) for k in ("vh", "hv")}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vh", "hv"])
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_match_plain_versions_on_card(dtype, name, layout):
    dev = _needs_card()
    h, w, targets, g, offset, valid, vh = _case(name, dtype, layout == "vh", dev)
    t, hd = h.shape
    route = fce.card_plan(h, w, "dh", vh)["route"]
    assert route == ("mma" if dtype == torch.bfloat16 and hd <= 4096 else "wmma")
    before, routes, layouts = _counts(), _routes(), _layouts()
    lse, tl = fce.fused_ce_fwd(h, w, targets, offset, valid, vh)
    ref_lse, ref_tl = fce.fused_ce_fwd_reference(h, w, targets, offset, valid, vh)
    bwd = (h, w, targets, ref_lse, g, offset, valid, vh)
    dh = fce.fused_ce_dh(*bwd)
    dw = fce.fused_ce_dw(*bwd)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before)
    assert _routes() == {k: tuple(c + (k == route) for c in n) for k, n in routes.items()}
    assert _layouts() == {k: tuple(c + (k == layout) for c in n) for k, n in layouts.items()}
    assert lse.dtype == tl.dtype == torch.float32 and dh.dtype == dw.dtype == dtype
    _assert_close(lse, ref_lse, STAT_RTOL, "lse")
    _assert_close(tl, ref_tl, STAT_RTOL, "target logit")
    _assert_close(dh, fce.fused_ce_dh_reference(*bwd), GRAD_RTOL[dtype], "dh")
    _assert_close(dw, fce.fused_ce_dw_reference(*bwd), GRAD_RTOL[dtype], "dw")


@pytest.mark.cuda
def test_float32_kernels_repeat_exactly():
    """No atomics: two runs of each kernel give the same bits."""
    dev = _needs_card()
    h, w, targets, g, offset, valid, vh = _case("t100_v1000_offset_valid",
                                                torch.float32, True, dev)
    runs = []
    for _ in range(2):
        lse, tl = fce.fused_ce_fwd(h, w, targets, offset, valid, vh)
        bwd = (h, w, targets, lse, g, offset, valid, vh)
        runs.append((lse, tl, fce.fused_ce_dh(*bwd), fce.fused_ce_dw(*bwd)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["t300_h1024_v1000_offset_valid", "t200_h4096_v300"])
@pytest.mark.parametrize("layout", ["vh", "hv"])
def test_bf16_backward_kernels_repeat_exactly(name, layout):
    """The tensor-core route sums the cluster's partial logits in rank
    order and the streamed tiles in a fixed order, with no atomics: two
    calls give the same bits."""
    dev = _needs_card()
    h, w, targets, g, offset, valid, vh = _case(name, torch.bfloat16, layout == "vh", dev)
    lse, _ = fce.fused_ce_fwd(h, w, targets, offset, valid, vh)
    bwd = (h, w, targets, lse, g, offset, valid, vh)
    routes = _routes()["mma"]
    runs = [(fce.fused_ce_dh(*bwd), fce.fused_ce_dw(*bwd)) for _ in range(2)]
    assert _routes()["mma"] == (routes[0] + 2, routes[1] + 2)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vh", "hv"])
def test_card_plan_sizes_dh_by_the_clusters_the_card_holds(layout):
    """On the card, dh's plan takes the count of clusters the card holds at
    once from the kernel's own query (fused_ce_mma_resident_clusters), at
    least one; dw's plan does not depend on it."""
    dev = _needs_card()
    vh = layout == "vh"
    h = torch.zeros(300, 1024, dtype=torch.bfloat16, device=dev)
    w = torch.zeros((1000, 1024) if vh else (1024, 1000), dtype=torch.bfloat16, device=dev)
    held = fce._resident_on(h.device, vh)(128, 4)
    assert held >= 1
    for kind in ("dh", "dw"):
        want = fce.bwd_plan(torch.bfloat16, 300, 1024, 1000, kind, lambda bm, c: held)
        assert fce.card_plan(h, w, kind, vh) == want


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_cannot_take():
    """A CPU/CUDA mix, a bad dtype, a non-contiguous operand or an H that
    is not a multiple of 16 raises before any launch."""
    dev = _needs_card()
    h, w, targets, g, offset, valid, vh = _case("t24_v128", torch.float32, True, dev)
    lse = torch.zeros_like(g)
    before = _counts()
    with pytest.raises(ValueError, match="targets is on cpu"):
        fce.fused_ce_fwd(h, w, targets.cpu())
    with pytest.raises(ValueError, match="w is on cpu"):
        fce.fused_ce_dh(h, w.cpu(), targets, lse, g)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fce.fused_ce_fwd(h.half(), w.half(), targets)
    with pytest.raises(TypeError, match="w must be"):
        fce.fused_ce_fwd(h, w.to(torch.bfloat16), targets)
    with pytest.raises(TypeError, match="targets"):
        fce.fused_ce_fwd(h, w, targets.long())
    with pytest.raises(TypeError, match="g must be"):
        fce.fused_ce_dw(h, w, targets, lse, g.double())
    with pytest.raises(ValueError, match="contiguous"):
        fce.fused_ce_dw(h, w.t().contiguous().t(), targets, lse, g)
    with pytest.raises(ValueError, match="multiple of 16"):
        fce.fused_ce_fwd(h[:, :24].contiguous(), w[:, :24].contiguous(), targets)
    assert _counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_autograd_launches_each_kernel_once_and_matches_cpu(dtype):
    """fused_ce_sums forward + backward on the card launches fwd, dh and dw
    once each, and the sums and gradients agree with the same function on
    the CPU (the plain versions), weight-0 pad tokens included."""
    dev = _needs_card()
    h, w, targets, _, _, _, _ = _case("t100_v1000_offset_valid", dtype, True, "cpu")
    token_w = (torch.arange(h.shape[0]) % 5 != 0).float()
    results = {}
    for where in ("cpu", dev):
        hh = h.to(where).clone().requires_grad_()
        ww = w.to(where).clone().requires_grad_()
        before = _counts()
        tot, cnt = fce.fused_ce_sums(hh, ww, targets.to(where), token_w.to(where),
                                     valid_size=900)
        (tot / cnt).backward()
        moved = tuple(n - c for n, c in zip(_counts(), before))
        results[str(where)] = (tot.detach(), cnt, hh.grad, ww.grad, moved)
    assert results["cpu"][4] == (0, 0, 0)
    assert results["cuda"][4] == (1, 1, 1)
    _assert_close(results["cuda"][0].cpu(), results["cpu"][0], STAT_RTOL, "loss sum")
    assert results["cuda"][1].item() == results["cpu"][1].item()
    _assert_close(results["cuda"][2].cpu(), results["cpu"][2], GRAD_RTOL[dtype], "dh")
    _assert_close(results["cuda"][3].cpu(), results["cpu"][3], GRAD_RTOL[dtype], "dw")
