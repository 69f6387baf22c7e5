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
the forward (``fused_ce_fwd.routes``, by ``card_fwd_plan``): bf16 that TMA
can address on "wgmma" (``csrc/fused_ce_fwd_wgmma.cu``), float32, and an
(H, V) bf16 weight with V not a multiple of 8, on "wmma"; ``.layouts``
count the launches by weight layout.

The "wgmma" product alone (``fused_ce_fwd_wgmma_logits``: one block's 128 x
BN logits tile from TMA-loaded stages) is held to 1e-5 + 2^-14 of the
largest value of the float32 product: a wrong swizzle, descriptor or
fragment layout moves whole values, far above that; the tensor cores'
float32 sums, in another order and not rounded to nearest, stay far below.

With ``FUSED_CE_PARENT`` set to a checkout of the parent revision, the
float32 forward is also compared with the parent's ``fused_ce.cu`` build,
bit for bit.
"""
import ctypes
import os
import subprocess
from pathlib import Path

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
    fwd_route = fce.card_fwd_plan(h, w, vh)["route"]
    tma = dtype == torch.bfloat16 and (vh or w.shape[1] % 8 == 0)
    assert fwd_route == ("wgmma" if tma else "wmma")
    before, routes, layouts = _counts(), _routes(), _layouts()
    fwd_before = (dict(fce.fused_ce_fwd.routes), dict(fce.fused_ce_fwd.layouts))
    lse, tl = fce.fused_ce_fwd(h, w, targets, offset, valid, vh)
    assert fce.fused_ce_fwd.routes == {k: n + (k == fwd_route)
                                       for k, n in fwd_before[0].items()}
    assert fce.fused_ce_fwd.layouts == {k: n + (k == layout)
                                        for k, n in fwd_before[1].items()}
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


# -- the bf16 forward on warpgroup MMAs (fused_ce_fwd_wgmma.cu) ----------------------

# name -> (T, H, V, token tile, vocab tile): a whole 128 x 256 tile; the last,
# ragged tiles of T and V (TMA's zero fill); H not a multiple of the 64-column
# stage; H above the 1024 columns of one chain (BN = 128, chains added in
# float32), and the widest H of the card tests
LOGITS_CASES = {
    "t128_h1024_v256": (128, 1024, 256, 0, 0),
    "t300_h1024_v1000_last": (300, 1024, 1000, 2, 3),
    "t37_h48_v72": (37, 48, 72, 0, 0),
    "t130_h1040_v304_last": (130, 1040, 304, 1, 2),
    "t200_h4096_v304": (200, 4096, 304, 0, 1),
}


def _wgmma_entry(name, n_ptr, n_int):
    from pipegoose_tpu_torch.ops import _build

    fn = getattr(_build.load("fused_ce_fwd_wgmma"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vh", "hv"])
@pytest.mark.parametrize("name", sorted(LOGITS_CASES))
def test_wgmma_logits_tile_matches_matmul(name, layout):
    """One block's logits tile through the forward's producer and products
    (TMA, the 128-byte swizzle, the descriptors, the accumulator's fragment
    layout, K-major and MN-major B) against torch.matmul in float32 of the
    same zero-padded operands."""
    dev = _needs_card()
    t, hd, v, ti, vi = LOGITS_CASES[name]
    vh = layout == "vh"
    gen = torch.Generator().manual_seed(hd + v)
    h = (torch.randn(t, hd, generator=gen) * 0.5).to(dev, torch.bfloat16)
    w = (torch.randn(v, hd, generator=gen) * 0.5).to(dev, torch.bfloat16)
    wv = w if vh else w.t().contiguous()
    bn = fce.fwd_plan(torch.bfloat16, t, hd, v, vh)["bn"]
    out = torch.full((128, bn), float("nan"), device=dev)
    fn = _wgmma_entry("fused_ce_fwd_wgmma_logits", 3, 7)
    err = fn(h.data_ptr(), wv.data_ptr(), out.data_ptr(), t, hd, v, int(vh), 128 * ti, vi, bn,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"cudaError {err}"
    torch.cuda.synchronize()
    hp = torch.zeros(128, hd, device=dev)
    rows = h[128 * ti:128 * ti + 128].float()
    hp[:rows.shape[0]] = rows
    wp = torch.zeros(bn, hd, device=dev)
    cols = w[bn * vi:bn * vi + bn].float()
    wp[:cols.shape[0]] = cols
    want = hp @ wp.t()
    assert torch.isfinite(out).all()
    err = (out - want).abs().max().item()
    assert err <= 1e-5 + 2.0 ** -14 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["t300_h1024_v1000_offset_valid", "t64_h1040_v300",
                                  "t200_h4096_v300"])
@pytest.mark.parametrize("layout", ["vh", "hv"])
def test_bf16_forward_repeats_exactly(name, layout):
    """The forward's splits are combined in split order, with no atomics:
    two calls give the same bits, on the route the plan names."""
    dev = _needs_card()
    h, w, targets, _, offset, valid, vh = _case(name, torch.bfloat16, layout == "vh", dev)
    route = fce.card_fwd_plan(h, w, vh)["route"]
    before = fce.fused_ce_fwd.routes[route]
    runs = [fce.fused_ce_fwd(h, w, targets, offset, valid, vh) for _ in range(2)]
    assert fce.fused_ce_fwd.routes[route] == before + 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [1001, 1004])
def test_hv_weight_that_tma_cannot_address_takes_the_wmma_route(v):
    """An (H, V) bf16 weight whose rows are not a multiple of 16 bytes (V
    not a multiple of 8) cannot be a TMA tensor: the plan, and the launch,
    take fused_ce.cu's WMMA kernel, and it agrees with the plain version."""
    dev = _needs_card()
    gen = torch.Generator().manual_seed(v)
    h = (torch.randn(100, 1024, generator=gen) * 0.5).to(dev, torch.bfloat16)
    w = (torch.randn(1024, v, generator=gen) * 0.5).to(dev, torch.bfloat16)
    targets = torch.randint(0, v, (100,), generator=gen, dtype=torch.int32).to(dev)
    assert fce.card_fwd_plan(h, w, False)["route"] == "wmma"
    before = dict(fce.fused_ce_fwd.routes)
    lse, tl = fce.fused_ce_fwd(h, w, targets, 0, None, False)
    assert fce.fused_ce_fwd.routes == {"wgmma": before["wgmma"], "wmma": before["wmma"] + 1}
    ref_lse, ref_tl = fce.fused_ce_fwd_reference(h, w, targets, 0, None, False)
    _assert_close(lse, ref_lse, STAT_RTOL, "lse")
    _assert_close(tl, ref_tl, STAT_RTOL, "target logit")


@pytest.mark.cuda
def test_card_fwd_plan_reads_the_card():
    """On the card the plan counts the card's SMs and the operands'
    alignment: a view that starts 2 bytes in is not TMA's."""
    dev = _needs_card()
    h = torch.zeros(8184, 1024, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(250880, 1024, dtype=torch.bfloat16, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fce.card_fwd_plan(h, w, True) == fce.fwd_plan(torch.bfloat16, 8184, 1024, 250880,
                                                         True, True, sms)
    hs = torch.zeros(8185 * 1024, dtype=torch.bfloat16, device=dev)[1:1 + 8184 * 1024]
    assert fce.card_fwd_plan(hs.view(8184, 1024), w, True)["route"] == "wmma"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vh", "hv"])
def test_float32_forward_equals_the_parent_build(layout):
    """The float32 forward stays on fused_ce.cu's split-TF32 WMMA kernel: its
    outputs equal those of the parent revision's fused_ce.cu (built here
    from FUSED_CE_PARENT, a checkout of it) bit for bit."""
    dev = _needs_card()
    parent = os.environ.get("FUSED_CE_PARENT")
    if not parent:
        pytest.skip("FUSED_CE_PARENT names no checkout of the parent revision")
    from pipegoose_tpu_torch.ops import _build

    out = _build.BUILD_DIR.parent / "parent-kernels"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "fused_ce.so"
    if not so.exists():
        src = Path(parent) / _build.SRC_DIR.relative_to(_build.SRC_DIR.parents[2]) / "fused_ce.cu"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)], check=True,
                       capture_output=True, timeout=_build.BUILD_TIMEOUT_S)
    fn = getattr(ctypes.CDLL(str(so)), "fused_ce_fwd_f32")
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("t300_h1024_v1000_offset_valid", "t64_h1040_v300"):
        h, w, targets, _, offset, valid, vh = _case(name, torch.float32, layout == "vh", dev)
        t, hd = h.shape
        v = w.shape[0] if vh else w.shape[1]
        lse, tl = fce.fused_ce_fwd(h, w, targets, offset, valid, vh)
        splits = fce.fwd_plan(torch.float32, t, hd, v, vh)["splits"]
        part = torch.empty(3, splits, t, device=dev)
        old = torch.empty(2, t, device=dev)
        err = fn(h.data_ptr(), w.data_ptr(), targets.data_ptr(), part.data_ptr(),
                 old[0].data_ptr(), old[1].data_ptr(), t, hd, v, offset,
                 fce.NO_VALID if valid is None else valid, int(vh), splits,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"cudaError {err}"
        torch.cuda.synchronize()
        assert torch.equal(lse, old[0]) and torch.equal(tl, old[1]), name
