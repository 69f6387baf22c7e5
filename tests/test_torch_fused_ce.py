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


def test_cpu_wrappers_take_the_plain_versions_and_count_nothing(case):
    x = case
    before = (tce.fused_ce_fwd.launches, tce.fused_ce_dh.launches,
              tce.fused_ce_dw.launches)
    args = _torch_args(x, "h", "w", "targets")
    lse, tl = tce.fused_ce_fwd(*args, x["offset"], x["valid"], x["vh"])
    bwd = args + (lse, torch.from_numpy(x["g"]), x["offset"], x["valid"], x["vh"])
    dh, dw = tce.fused_ce_dh(*bwd), tce.fused_ce_dw(*bwd)
    _close(lse, x["lse"])
    assert dh.shape == x["h"].shape and dw.shape == x["w"].shape
    assert (tce.fused_ce_fwd.launches, tce.fused_ce_dh.launches,
            tce.fused_ce_dw.launches) == before


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
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        tce.fused_ce_sums(*args, axis_name="tensor")
