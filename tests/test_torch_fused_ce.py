"""The port's fused cross entropy held against the JAX package on the CPU.

Each plain kernel version (``fused_ce_fwd_reference``,
``fused_ce_dh_reference``, ``fused_ce_dw_reference``) against its Pallas
function run in interpret mode with an explicit ``offset`` array, in both
weight layouts, with ``valid_size`` on and off and a nonzero offset; then
``fused_ce_sums`` and the gradients of hidden and weight against
``jax.value_and_grad`` of the JAX ``fused_ce_sums(interpret=True)``, in
float32 and bf16, the shifted and masked entry points, the weight-0 pad
tokens and the probes. Inputs come from a numpy seed and go to both sides
as numpy arrays.

Tolerances:
- float32, 2e-5 absolute on lse, target logits, dh and dw and on the loss
  sums: both sides compute the same float32 logits and sums over the
  vocabulary (H = 32 products per logit, up to 1000 terms per lse) in
  another order; values are of order 1 to 10 (a sum over 24 tokens of
  losses near log V), a few float32 ulps of which stay below 2e-5.
- bf16 inputs: the logits are exact float32 products of bf16 values, so
  the float32 outputs (lse, the sums) keep the float32 tolerance; dh and
  dw are rounded to bf16 on both sides from float32 values that may differ
  in their last bits, so they may land one bf16 ulp apart: 2^-8 of the
  largest value, plus 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.ops import fused_ce as jce
from pipegoose_tpu_torch.ops import fused_ce as tce

ATOL = 2e-5
BF16_RTOL = 2.0 ** -8

# name -> (T, H, V, offset, valid, block_t, block_v): ``valid`` masks the
# last columns of the shard; a nonzero offset puts the shard later in the
# global vocabulary, so some targets fall outside it
CASES = {
    "t24_v128": (24, 32, 128, 0, None, 8, 64),
    "t24_v128_valid": (24, 32, 128, 0, 121, 8, 64),
    "t100_v1000_offset_valid": (100, 32, 1000, 300, 1283, 20, 200),
    "t100_v1000_offset": (100, 32, 1000, 300, None, 20, 200),
}


def _inputs(name, vh, seed=0):
    t, hd, v, offset, valid, block_t, block_v = CASES[name]
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, hd), dtype=np.float32) * 0.5
    w = rng.standard_normal((v, hd), dtype=np.float32) * 0.5
    targets = rng.integers(0, offset + v, t).astype(np.int32)
    g = rng.standard_normal(t, dtype=np.float32)
    return {"h": h, "w": w if vh else np.ascontiguousarray(w.T), "targets": targets,
            "g": g, "offset": offset, "valid": valid, "vh": vh,
            "blocks": (block_t, block_v)}


def _jax_args(x, *names):
    return tuple(jnp.asarray(x[n]) for n in names)


def _torch_args(x, *names):
    return tuple(torch.from_numpy(x[n]) for n in names)


def _close(t, j, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, dtype=np.float32), rtol=0,
                               atol=atol, err_msg=err_msg)


@pytest.fixture(scope="module", params=[(c, vh) for c in sorted(CASES)
                                        for vh in (True, False)],
                ids=lambda p: f"{p[0]}-{'vh' if p[1] else 'hv'}")
def case(request):
    """One case's inputs with the Pallas forward's (lse, target logit)."""
    x = _inputs(*request.param)
    off = jnp.asarray([x["offset"]], jnp.int32)
    lse, tl = jce._fwd_pallas(*_jax_args(x, "h", "w", "targets"), off, x["valid"],
                              *x["blocks"], True, x["vh"])
    x["lse"], x["tl"], x["off"] = np.array(lse), np.array(tl), off
    return x


def test_fwd_reference_matches_pallas(case):
    x = case
    lse, tl = tce.fused_ce_fwd_reference(*_torch_args(x, "h", "w", "targets"),
                                         x["offset"], x["valid"], x["vh"])
    _close(lse, x["lse"], err_msg="lse")
    _close(tl, x["tl"], err_msg="target logit")


def test_dh_reference_matches_pallas(case):
    x = case
    want = jce._dh_pallas(*_jax_args(x, "h", "w", "targets", "lse", "g"), x["off"],
                          x["valid"], *x["blocks"], True, x["vh"])
    got = tce.fused_ce_dh_reference(*_torch_args(x, "h", "w", "targets", "lse", "g"),
                                    x["offset"], x["valid"], x["vh"])
    assert got.shape == x["h"].shape
    _close(got, want)


def test_dw_reference_matches_pallas(case):
    x = case
    want = jce._dw_pallas(*_jax_args(x, "h", "w", "targets", "lse", "g"), x["off"],
                          x["valid"], *x["blocks"], True, x["vh"])
    got = tce.fused_ce_dw_reference(*_torch_args(x, "h", "w", "targets", "lse", "g"),
                                    x["offset"], x["valid"], x["vh"])
    assert got.shape == x["w"].shape
    _close(got, want)


def _counters():
    """Every launch counter of the three wrappers, by route and layout too."""
    return (tce.fused_ce_fwd.launches, tce.fused_ce_dh.launches, tce.fused_ce_dw.launches,
            *(dict(getattr(f, c)) for f in (tce.fused_ce_dh, tce.fused_ce_dw)
              for c in ("routes", "layouts")))


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing(case):
    x = case
    before = _counters()
    args = _torch_args(x, "h", "w", "targets")
    lse, tl = tce.fused_ce_fwd(*args, x["offset"], x["valid"], x["vh"])
    bwd = args + (lse, torch.from_numpy(x["g"]), x["offset"], x["valid"], x["vh"])
    dh, dw = tce.fused_ce_dh(*bwd), tce.fused_ce_dw(*bwd)
    _close(lse, x["lse"])
    assert dh.shape == x["h"].shape and dw.shape == x["w"].shape
    assert _counters() == before


# -- the public sums ---------------------------------------------------------------

T, H, V = 24, 32, 128


def _sums_inputs(seed=0, t=T):
    rng = np.random.default_rng(seed)
    return {
        "h": rng.standard_normal((t, H), dtype=np.float32) * 0.3,
        "w": rng.standard_normal((V, H), dtype=np.float32) * 0.3,
        "targets": rng.integers(0, 100, t).astype(np.int32),
        "token_w": (rng.random(t) < 0.8).astype(np.float32),
    }


def _jax_sums(x, dtype, layout, valid=None):
    def loss(h, w):
        tot, cnt = jce.fused_ce_sums(h, w, jnp.asarray(x["targets"]),
                                     jnp.asarray(x["token_w"]), valid_size=valid,
                                     interpret=True, weight_layout=layout)
        return tot, cnt

    w = x["w"] if layout == "vh" else np.ascontiguousarray(x["w"].T)
    (tot, cnt), vjp = jax.vjp(loss, jnp.asarray(x["h"], dtype), jnp.asarray(w, dtype))
    dh, dw = vjp((jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32)))
    return float(tot), float(cnt), np.asarray(dh, np.float32), np.asarray(dw, np.float32)


def _torch_sums(x, dtype, layout, valid=None):
    w = x["w"] if layout == "vh" else np.ascontiguousarray(x["w"].T)
    h = torch.from_numpy(x["h"]).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).to(dtype).requires_grad_()
    tot, cnt = tce.fused_ce_sums(h, wt, torch.from_numpy(x["targets"]).long(),
                                 torch.from_numpy(x["token_w"]), valid_size=valid,
                                 weight_layout=layout)
    tot.backward()
    return tot.item(), cnt.item(), h.grad, wt.grad


@pytest.mark.parametrize("layout", ["vh", "hv"])
@pytest.mark.parametrize("valid", [None, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ce_sums_and_grads_match_jax(dtype, valid, layout):
    x = _sums_inputs()
    jtot, jcnt, jdh, jdw = _jax_sums(x, getattr(jnp, dtype), layout, valid)
    tot, cnt, dh, dw = _torch_sums(x, getattr(torch, dtype), layout, valid)
    assert abs(tot - jtot) <= ATOL and cnt == jcnt
    assert dh.dtype == dw.dtype == getattr(torch, dtype)
    for got, want, n in ((dh, jdh, "dh"), (dw, jdw, "dw")):
        atol = ATOL if dtype == "float32" else 1e-6 + BF16_RTOL * np.abs(want).max()
        _close(got, want, atol=atol, err_msg=n)


def test_zero_weight_pad_tokens_change_nothing():
    """Tokens of weight 0 add nothing to either sum, get a zero hidden
    gradient and leave the weight gradient as it was."""
    x = _sums_inputs(seed=1)
    padded = {k: np.concatenate([v, _sums_inputs(seed=2, t=7)[k]]) for k, v in x.items()
              if k != "w"}
    padded["token_w"][T:] = 0.0
    padded["w"] = x["w"]
    tot, cnt, dh, dw = _torch_sums(x, torch.float32, "vh")
    ptot, pcnt, pdh, pdw = _torch_sums(padded, torch.float32, "vh")
    assert pcnt == cnt and abs(ptot - tot) <= ATOL
    assert (pdh[T:] == 0).all()
    _close(pdh[:T], dh.numpy())
    _close(pdw, dw.numpy())


def test_shifted_and_masked_entry_points_match_jax():
    rng = np.random.default_rng(3)
    b, s = 2, 13
    hidden = rng.standard_normal((b, s, H), dtype=np.float32) * 0.3
    w = rng.standard_normal((V, H), dtype=np.float32) * 0.3
    labels = rng.integers(0, V, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 9:] = 0
    for m in (mask, None):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else torch.from_numpy(m)
        want = jce.fused_ce_shifted_loss(jnp.asarray(hidden), jnp.asarray(w),
                                         jnp.asarray(labels), jm)
        got = tce.fused_ce_shifted_loss(torch.from_numpy(hidden), torch.from_numpy(w),
                                        torch.from_numpy(labels), tm)
        assert abs(got.item() - float(want)) <= ATOL
    weights = mask.astype(np.float32)
    jtot, jcnt = jce.fused_ce_masked_sums(jnp.asarray(hidden), jnp.asarray(w),
                                          jnp.asarray(labels), jnp.asarray(weights))
    tot, cnt = tce.fused_ce_masked_sums(torch.from_numpy(hidden), torch.from_numpy(w),
                                        torch.from_numpy(labels),
                                        torch.from_numpy(weights))
    assert abs(tot.item() - float(jtot)) <= ATOL and cnt.item() == float(jcnt)


def test_weight_layout_and_axis_name_probes():
    x = _sums_inputs()
    args = (torch.from_numpy(x["h"]), torch.from_numpy(x["w"]),
            torch.from_numpy(x["targets"]), torch.from_numpy(x["token_w"]))
    with pytest.raises(ValueError, match="weight_layout"):
        tce.fused_ce_sums(*args, weight_layout="vhv")
    # a tensor axis needs a ParallelContext (the sharded runs are held in
    # test_torch_hybrid.py)
    with pytest.raises(RuntimeError, match="needs a ParallelContext"):
        tce.fused_ce_sums(*args, axis_name="tensor")


# -- the bf16 backward's plan and summation order ------------------------------------

@pytest.mark.parametrize("hd,bm,cluster", [
    (16, 128, 1), (32, 128, 1), (48, 128, 1), (256, 128, 1), (272, 128, 2),
    (1024, 128, 4), (1040, 128, 8), (2048, 128, 8), (2064, 64, 8), (4096, 64, 8)])
def test_bwd_plan_splits_h_over_a_cluster(hd, bm, cluster):
    """bf16: the first configuration whose widest slice, times a power-of-two
    cluster of at most 8 blocks, covers H; the ranks' slices are contiguous
    16-column multiples that cover H exactly, each within the widest slice
    and at most 16 columns apart."""
    for kind in ("dh", "dw"):
        plan = tce.bwd_plan(torch.bfloat16, 8184, hd, 250880, kind)
        assert plan["route"] == "mma"
        assert (plan["bm"], plan["cluster"], plan["bn"]) == (bm, cluster, bm // 2)
        widest = dict(tce.MMA_CONFIGS)[bm]
        starts = [s for s, _ in plan["slices"]]
        widths = [n for _, n in plan["slices"]]
        assert len(plan["slices"]) == cluster and starts[0] == 0
        assert all(a + n == b for (a, n), b in zip(plan["slices"], starts[1:] + [hd]))
        assert all(n % 16 == 0 and 0 < n <= widest for n in widths)
        assert max(widths) - min(widths) <= 16
        rows = 8184 if kind == "dh" else 250880
        assert plan["splits"] >= 1 and (kind == "dh" or plan["splits"] == 1)
        assert plan["grid"] == cluster * -(-rows // bm) * plan["splits"]


def test_bwd_plan_at_the_bench_shape_and_the_wmma_route():
    """Phase 13's shape (T = 8184, H = 1024, V = 250880): dh 64 row clusters
    of 4 in 5 splits of the vocabulary (320 clusters, 10.7 waves of the 30
    an H100 holds, with 5 float32 (T, H) sums for the combine), dw 1960 in
    one. float32, and bf16 above H = 4096, keep the WMMA kernel: a plan of
    its route alone."""
    dh = tce.bwd_plan(torch.bfloat16, 8184, 1024, 250880, "dh")
    dw = tce.bwd_plan(torch.bfloat16, 8184, 1024, 250880, "dw")
    assert (dh["route"], dh["grid"], dh["cluster"], dh["splits"]) == ("mma", 1280, 4, 5)
    assert dh["ws_bytes"] == 5 * 8184 * 1024 * 4
    assert (dw["route"], dw["grid"], dw["cluster"], dw["splits"]) == ("mma", 7840, 4, 1)
    assert dw["ws_bytes"] == 0
    assert dh["slices"] == [(0, 256), (256, 256), (512, 256), (768, 256)]
    assert tce.bwd_plan(torch.float32, 8184, 1024, 250880, "dh") == {"route": "wmma"}
    assert tce.bwd_plan(torch.bfloat16, 100, 4112, 1000, "dw") == {"route": "wmma"}
    with pytest.raises(ValueError, match="kind"):
        tce.bwd_plan(torch.bfloat16, 1, 16, 1, "fwd")


@pytest.mark.parametrize("held,splits", [(30, 5), (33, 1), (16, 1), (40, 3)])
def test_bwd_plan_sizes_dh_splits_by_the_clusters_the_card_holds(held, splits):
    """dh's splits fill the waves of as many clusters as ``resident`` says
    the card holds at once (a card with another SM count reports another
    count), asked once for the chosen configuration; dw never asks."""
    asked = []

    def resident(bm, cluster):
        asked.append((bm, cluster))
        return held

    dh = tce.bwd_plan(torch.bfloat16, 8184, 1024, 250880, "dh", resident)
    dw = tce.bwd_plan(torch.bfloat16, 8184, 1024, 250880, "dw", resident)
    assert (dh["splits"], dw["splits"]) == (splits, 1)
    assert dh["grid"] == 4 * 64 * splits
    assert asked == [(128, 4)]


@pytest.mark.parametrize("layout", ["vh", "hv"])
@pytest.mark.parametrize("kind", ["dh", "dw"])
def test_card_plan_of_cpu_tensors_is_the_default_plan(kind, layout):
    """Without a card, the wrapper's plan is bwd_plan's with an H100 SXM's
    resident clusters (RESIDENT_CLUSTERS)."""
    h = torch.zeros(300, 1024, dtype=torch.bfloat16)
    w = torch.zeros((1000, 1024) if layout == "vh" else (1024, 1000), dtype=torch.bfloat16)
    want = tce.bwd_plan(torch.bfloat16, 300, 1024, 1000, kind)
    assert tce.card_plan(h, w, kind, layout == "vh") == want
    assert tce.card_plan(h.float(), w.float(), kind, layout == "vh") == {"route": "wmma"}


@pytest.mark.parametrize("clusters,resident,tiles,splits", [
    (64, 30, 3920, 5),    # dh at the bench shape: 64 / 90 full in one split, 320 / 330 in 5
    (1960, 30, 128, 1),   # dw there: the last of 66 waves 1960 / 1980 full
    (128, 66, 3920, 1),   # 64 resident rows, clusters of 2
    (1, 30, 2, 2),        # a tiny T: as many splits as tiles, the fullest
    (2, 132, 100, 8),     # ... at most MAX_SPLITS
    (15, 15, 10, 1)])
def test_wave_splits_fill_the_last_wave(clusters, resident, tiles, splits):
    assert tce._wave_splits(clusters, resident, tiles) == splits


def _mma_order(kind, h, w, targets, lse, g, offset, valid, vh):
    """The bf16 tensor-core route's arithmetic, written out: the float32
    partial logits of each cluster rank's H slice, summed in rank order;
    dl from them, rounded once to bf16; then its product with the streamed
    operand in float32 (dh: one sum for each split of the vocabulary, by
    whole streamed tiles, added in split order), rounded to bf16."""
    t, hd = h.shape
    wf = (w if vh else w.t()).float()           # (V, H)
    hf = h.float()
    plan = tce.bwd_plan(torch.bfloat16, t, hd, wf.shape[0], kind)
    logits = None
    for a, n in plan["slices"]:
        part = hf[:, a:a + n] @ wf[:, a:a + n].t()
        logits = part if logits is None else logits + part
    col = offset + torch.arange(wf.shape[0])
    if valid is not None:
        logits = torch.where(col[None, :] >= valid, tce.NEG_INF, logits)
    hit = (targets.long()[:, None] == col[None, :]).float()
    dl = (g[:, None] * (torch.exp(logits - lse[:, None]) - hit)).bfloat16().float()
    if kind == "dh":
        tiles = -(-wf.shape[0] // plan["bn"])
        dh = None
        for sp in range(plan["splits"]):
            a = sp * tiles // plan["splits"] * plan["bn"]
            b = (sp + 1) * tiles // plan["splits"] * plan["bn"]
            part = dl[:, a:b] @ wf[a:b]
            dh = part if dh is None else dh + part
        return dh.bfloat16()
    dw = (dl.t() @ hf).bfloat16()
    return dw if vh else dw.t().contiguous()


# name -> (T, H, V, offset, valid, block_t, block_v): H = 48 (one block),
# 272 (two ranks of 144 and 128 columns), 1024 (four ranks, the bench
# width) and 1040 (eight), T and V ragged against the kernel's tiles (BM
# 128, BN 64), a target past the shard and masked columns
MMA_CASES = {
    "t37_h48_v70": (37, 48, 70, 5, 60, 37, 70),
    "t100_h272_v150_valid": (100, 272, 150, 300, 420, 20, 50),
    "t130_h1024_v150": (130, 1024, 150, 0, None, 26, 50),
    "t64_h1040_v96": (64, 1040, 96, 0, 90, 32, 48),
}


@pytest.mark.parametrize("layout", ["vh", "hv"])
@pytest.mark.parametrize("kind", ["dh", "dw"])
@pytest.mark.parametrize("name", sorted(MMA_CASES))
def test_mma_summation_order_holds_the_bf16_bound(name, kind, layout):
    """The tensor-core route's order of sums and roundings stays within
    1e-5 + 2^-6 of the largest value of the plain version and of the
    Pallas kernel in interpret mode, on bf16 inputs."""
    t, hd, v, offset, valid, block_t, block_v = MMA_CASES[name]
    vh = layout == "vh"
    rng = np.random.default_rng(hd + t)
    h = torch.from_numpy(rng.standard_normal((t, hd), dtype=np.float32) * 0.5).bfloat16()
    w = torch.from_numpy(rng.standard_normal((v, hd), dtype=np.float32) * 0.5).bfloat16()
    if not vh:
        w = w.t().contiguous()
    targets = torch.from_numpy(rng.integers(0, offset + v, t).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal(t, dtype=np.float32))
    lse, _ = tce.fused_ce_fwd_reference(h, w, targets, offset, valid, vh)
    got = _mma_order(kind, h, w, targets, lse, g, offset, valid, vh)
    ref = {"dh": tce.fused_ce_dh_reference, "dw": tce.fused_ce_dw_reference}[kind]
    plain = ref(h, w, targets, lse, g, offset, valid, vh)
    pallas_fn = {"dh": jce._dh_pallas, "dw": jce._dw_pallas}[kind]
    as_j = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    pallas = pallas_fn(as_j(h), as_j(w), jnp.asarray(targets.numpy()),
                       jnp.asarray(lse.numpy()), jnp.asarray(g.numpy()),
                       jnp.asarray([offset], jnp.int32), valid, block_t, block_v, True, vh)
    assert got.shape == plain.shape and got.dtype == torch.bfloat16
    for want, what in ((plain.float().numpy(), "plain"),
                       (np.asarray(pallas, dtype=np.float32), "pallas")):
        _close(got, want, atol=1e-5 + 2.0 ** -6 * np.abs(want).max(), err_msg=what)


# -- the bf16 forward's plan and order of sums (fused_ce_fwd_wgmma.cu) ----------------

@pytest.mark.parametrize("dtype,vh,v,aligned,route", [
    (torch.bfloat16, True, 250880, True, "wgmma"),
    (torch.bfloat16, False, 250880, True, "wgmma"),
    (torch.bfloat16, True, 1001, True, "wgmma"),      # (V, H): rows are H, any V
    (torch.bfloat16, False, 1001, True, "wmma"),      # (H, V) rows of 2002 bytes: not TMA's
    (torch.bfloat16, False, 1004, True, "wmma"),
    (torch.bfloat16, False, 1008, True, "wgmma"),
    (torch.bfloat16, True, 250880, False, "wmma"),    # a base off 16 bytes
    (torch.float32, True, 250880, True, "wmma"),
    (torch.float32, False, 250880, True, "wmma")])
def test_fwd_plan_route_by_dtype_layout_and_alignment(dtype, vh, v, aligned, route):
    """bf16 goes to the TMA-fed kernel wherever TMA can address the operands
    (16-byte aligned bases; an (H, V) weight's rows a multiple of 16 bytes);
    everything else, float32 always, to the WMMA kernel, whose plan holds
    only its splits."""
    plan = tce.fwd_plan(dtype, 8184, 1024, v, vh, aligned)
    assert plan["route"] == route
    if route == "wmma":
        assert set(plan) == {"route", "splits"}


def test_fwd_plan_at_the_bench_shape():
    """bench.py's shape (T = 8 x 1023, H = 1024, V = 250880): 64 token tiles
    of 128 by 33 vocab ranges of 256-column tiles, 2112 blocks, exactly 16
    waves of an H100 SXM's 132 SMs; a 4-deep ring of 48 KB stages within
    the 232,448 bytes a block may use."""
    plan = tce.fwd_plan(torch.bfloat16, 8184, 1024, 250880, True)
    assert (plan["bm"], plan["bn"], plan["bk"], plan["stages"]) == (128, 256, 64, 4)
    assert plan["splits"] == 33 and plan["grid"] == (64, 33)
    assert 64 * 33 == 16 * tce.SMS
    assert plan["smem_bytes"] == 4 * (128 + 256) * 64 * 2 + 4 * 16 + 1024 == 197696
    assert plan["smem_bytes"] <= tce.MAX_SMEM
    assert plan["part_bytes"] == 3 * 4 * 33 * 8184
    assert tce.fwd_plan(torch.bfloat16, 8184, 1024, 250880, False) == plan


@pytest.mark.parametrize("t", [1, 100, 128, 129, 4096, 8184, 8191, 65536])
@pytest.mark.parametrize("hd", [16, 1024, 1040, 4096])
def test_fwd_plan_splits_fill_waves(t, hd):
    """The fewest splits whose blocks fill FWD_WAVES waves of the SMs (the
    last, partial wave then costs at most 1/16), at most one a vocab tile;
    256-column tiles up to H = 1024, 128 above (the kernel adds chains of
    1024 columns in float32), each within the shared memory a block may
    use."""
    for sms in (132, 114):
        plan = tce.fwd_plan(torch.bfloat16, t, hd, 250880, True, sms=sms)
        assert plan["bn"] == (256 if hd <= 1024 else 128)
        t_tiles, v_tiles = -(-t // 128), -(-250880 // plan["bn"])
        splits = plan["splits"]
        assert plan["grid"] == (t_tiles, splits) and 1 <= splits <= v_tiles
        assert splits == v_tiles or t_tiles * splits >= tce.FWD_WAVES * sms
        assert splits == 1 or t_tiles * (splits - 1) < tce.FWD_WAVES * sms
        assert plan["smem_bytes"] <= tce.MAX_SMEM
    small = tce.fwd_plan(torch.bfloat16, t, hd, 100, True)
    assert small["splits"] == 1


def test_fwd_plan_wmma_splits_are_the_parents():
    """The WMMA route keeps its splits (64-token blocks, 128-column tiles,
    two blocks an SM of 132), so its float32 outputs keep their bits."""
    assert tce.fwd_plan(torch.float32, 8184, 1024, 250880, True)["splits"] == 33
    assert tce.fwd_plan(torch.float32, 100, 64, 1000, True)["splits"] == 8
    assert tce.fwd_plan(torch.float32, 100, 64, 1000, True, sms=1)["splits"] == 8


@pytest.mark.parametrize("layout", ["vh", "hv"])
def test_card_fwd_plan_of_cpu_tensors(layout):
    """Without a card, the wrapper's plan is fwd_plan's with an H100 SXM's
    SMs and the operands' own alignment: a view 2 bytes in is not TMA's."""
    vh = layout == "vh"
    h = torch.zeros(300, 1024, dtype=torch.bfloat16)
    w = torch.zeros((1000, 1024) if vh else (1024, 1000), dtype=torch.bfloat16)
    assert tce.card_fwd_plan(h, w, vh) == tce.fwd_plan(torch.bfloat16, 300, 1024, 1000, vh)
    off = torch.zeros(300 * 1024 + 1, dtype=torch.bfloat16)[1:].view(300, 1024)
    assert tce.card_fwd_plan(off, w, vh)["route"] == "wmma"


def test_cpu_forward_counts_no_route_or_layout():
    x = _sums_inputs()
    before = (dict(tce.fused_ce_fwd.routes), dict(tce.fused_ce_fwd.layouts))
    tce.fused_ce_fwd(torch.from_numpy(x["h"]).bfloat16(), torch.from_numpy(x["w"]).bfloat16(),
                     torch.from_numpy(x["targets"]))
    assert (tce.fused_ce_fwd.routes, tce.fused_ce_fwd.layouts) == before


def _wgmma_order(h, w, targets, offset, valid, vh, splits=None):
    """The "wgmma" route's arithmetic, written out: 128-row token tiles; per
    split, its range of BN-column vocab tiles in order; a tile's float32
    logits as chains of FWD_CHAIN_H H columns added in float32; the mask,
    then the target pick, then the online (m, l) update with exp2; then the
    splits combined per token in split order (max, rescaled sum, log)."""
    t, hd = h.shape
    wf = (w if vh else w.t()).float()                # (V, H)
    v = wf.shape[0]
    plan = tce.fwd_plan(torch.bfloat16, t, hd, v, vh)
    bn, splits = plan["bn"], splits or plan["splits"]
    n_tiles = -(-v // bn)
    log2e = 1.4426950408889634
    lse, tl = torch.empty(t), torch.empty(t)
    for t0 in range(0, t, plan["bm"]):
        hf = h[t0:t0 + plan["bm"]].float()
        tg = targets[t0:t0 + plan["bm"]].long()
        parts = []
        for s in range(splits):
            m = torch.full((hf.shape[0],), tce.NEG_INF)
            l, ts = torch.zeros(hf.shape[0]), torch.zeros(hf.shape[0])
            for tile in range(s * n_tiles // splits, (s + 1) * n_tiles // splits):
                wt = wf[tile * bn:(tile + 1) * bn]
                x = None
                for c0 in range(0, hd, tce.FWD_CHAIN_H):
                    chain = hf[:, c0:c0 + tce.FWD_CHAIN_H] @ wt[:, c0:c0 + tce.FWD_CHAIN_H].t()
                    x = chain if x is None else x + chain
                col = offset + tile * bn + torch.arange(wt.shape[0])
                if valid is not None:
                    x = torch.where(col[None, :] >= valid, torch.tensor(tce.NEG_INF), x)
                ts = ts + torch.where(tg[:, None] == col[None, :], x, 0.0).sum(1)
                mn = torch.maximum(m, x.amax(1))
                l = l * torch.exp2((m - mn) * log2e) + torch.exp2((x - mn[:, None]) * log2e).sum(1)
                m = mn
            parts.append((m, l, ts))
        mx = torch.full((hf.shape[0],), tce.NEG_INF)
        for m, _, _ in parts:
            mx = torch.maximum(mx, m)
        lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        lse[t0:t0 + hf.shape[0]] = mx + torch.log(torch.clamp_min(lsum, 1e-30))
        tl[t0:t0 + hf.shape[0]] = sum(ts for _, _, ts in parts)
    return lse, tl


# name -> (T, H, V, offset, valid, block_t, block_v): H = 16 (one k step)
# and 64 (one stage); 1024, the widest single chain, with T and V ragged
# against the 128 x 256 tiles; 1040 and 4096, chains added in float32 (BN
# = 128); a shard at an offset with masked columns, targets past it
WGMMA_CASES = {
    "t37_h16_v72": (37, 16, 72, 5, 60, 37, 72),
    "t100_h64_v1000_offset_valid": (100, 64, 1000, 300, 1283, 20, 200),
    "t130_h1024_v600": (130, 1024, 600, 0, None, 26, 120),
    "t64_h1040_v304_offset_valid": (64, 1040, 304, 7, 290, 32, 152),
    "t40_h4096_v264": (40, 4096, 264, 0, None, 40, 88),
}


@pytest.fixture(scope="module", params=[(c, vh) for c in sorted(WGMMA_CASES)
                                        for vh in (True, False)],
                ids=lambda p: f"{p[0]}-{'vh' if p[1] else 'hv'}")
def wgmma_case(request):
    """bf16 inputs of one case with the Pallas forward's (lse, target logit)
    in interpret mode."""
    name, vh = request.param
    t, hd, v, offset, valid, block_t, block_v = WGMMA_CASES[name]
    rng = np.random.default_rng(hd + v)
    h = torch.from_numpy(rng.standard_normal((t, hd), dtype=np.float32) * 0.5).bfloat16()
    w = torch.from_numpy(rng.standard_normal((v, hd), dtype=np.float32) * 0.5).bfloat16()
    if not vh:
        w = w.t().contiguous()
    targets = torch.from_numpy(rng.integers(0, offset + v, t).astype(np.int32))
    as_j = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    lse, tl = jce._fwd_pallas(as_j(h), as_j(w), jnp.asarray(targets.numpy()),
                              jnp.asarray([offset], jnp.int32), valid, block_t, block_v, True, vh)
    return h, w, targets, offset, valid, vh, np.array(lse), np.array(tl)


@pytest.mark.parametrize("splits", ["plan", 1, 2])
def test_wgmma_order_holds_the_stat_bound(wgmma_case, splits):
    """The route's tiles, chains, splits and combine keep lse and the target
    logit within 1e-5 + 2^-18 of the largest value of the Pallas forward in
    interpret mode and of the plain version (on the card the tensor cores'
    truncating sums add to this; the card tests hold the kernel itself)."""
    h, w, targets, offset, valid, vh, p_lse, p_tl = wgmma_case
    assert tce.fwd_plan(torch.bfloat16, *h.shape, w.shape[0 if vh else 1], vh)["route"] == "wgmma"
    lse, tl = _wgmma_order(h, w, targets, offset, valid, vh,
                           None if splits == "plan" else splits)
    r_lse, r_tl = tce.fused_ce_fwd_reference(h, w, targets, offset, valid, vh)
    for got, want, what in ((lse, p_lse, "lse pallas"), (tl, p_tl, "tl pallas"),
                            (lse, r_lse.numpy(), "lse plain"), (tl, r_tl.numpy(), "tl plain")):
        finite = np.abs(want) < 1e8
        scale = np.abs(want[finite]).max() if finite.any() else 0.0
        _close(got, want, atol=1e-5 + 2.0 ** -18 * scale, err_msg=what)
