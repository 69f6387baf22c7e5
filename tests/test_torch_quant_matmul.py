"""The plain quantized matmul held against ``pipegoose_tpu.quant.matmul``:
its XLA reference (``impl="xla"``) and its Pallas kernels run in interpret
mode (``impl="pallas", interpret=True``), as the JAX package's own tests
run them, on the same numpy inputs. int8 and int4, float32 and bf16
activations, T in {1, 5, 24}, leading batch dims, the shape errors, and
the K-split arithmetic of the CUDA kernels' wrapper.

Tolerance: max |port - JAX| <= 1e-6 + 1e-5 * max |JAX|, float32: the two
sides sum the same float32 products in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.quant import matmul as jmatmul
from pipegoose_tpu.quant import weights as jweights
from pipegoose_tpu_torch.quant import matmul as tmatmul
from pipegoose_tpu_torch.quant import weights as tweights

K, N = 64, 96
RTOL, ATOL = 1e-5, 1e-6
X_DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
            "bf16": (np.float32, torch.bfloat16, jnp.bfloat16)}


def _weight(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, N), dtype=np.float32) / 8.0).astype(np.float32)


def _leaf(kind, g=16, seed=0):
    """The same numpy kernel quantized by both packages (equal bit for bit,
    tests/test_torch_quant_weights.py): (torch q, torch scale, jax q,
    jax scale)."""
    w = _weight(seed)
    spec = (kind, g)
    tleaf = tweights._quantize_kernel(torch.from_numpy(w), tweights.QuantSpec(*spec))
    jleaf = jweights._quantize_kernel(jnp.asarray(w), jweights.QuantSpec(*spec))
    return tleaf["q"], tleaf["scale"], jleaf["q"], jleaf["scale"]


def _x(shape, x_dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, dtype=np.float32)
    _, tdt, jdt = X_DTYPES[x_dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max()
    tol = ATOL + RTOL * np.abs(want).max()
    assert err <= tol, f"max |diff| {err} > {tol}"


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("t", [1, 5, 24])
@pytest.mark.parametrize("x_dtype", sorted(X_DTYPES))
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_plain_version_matches_jax(kind, x_dtype, t, impl):
    tq, ts, jq, js = _leaf(kind)
    tx, jx = _x((t, K), x_dtype)
    kw = {"impl": impl} if impl == "xla" else {"impl": impl, "interpret": True}
    want = jmatmul.quantized_matmul(jx, jq, js, **kw)
    _close(tmatmul.quantized_matmul(tx, tq, ts), want)
    _close(tmatmul.quantized_matmul_reference(tx, tq, ts), want)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_leading_batch_dims_are_flattened_and_restored(kind):
    tq, ts, jq, js = _leaf(kind, g=32, seed=2)
    tx, jx = _x((2, 3, K), "f32", seed=3)
    got = tmatmul.quantized_matmul(tx, tq, ts)
    assert tuple(got.shape) == (2, 3, N)
    _close(got, jmatmul.quantized_matmul(jx, jq, js, impl="xla"))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_equals_fp_product_of_the_dequantized_weight(kind):
    """The matmul adds no error of its own: it is x @ dequantize(q, s)."""
    tq, ts, _, _ = _leaf(kind)
    tx, _ = _x((24, K), "f32")
    w = tmatmul.dequantize_weight(tq, ts)
    np.testing.assert_allclose(tmatmul.quantized_matmul(tx, tq, ts).numpy(),
                               (tx @ w).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_dequantize_weight_equals_jax(kind):
    tq, ts, jq, js = _leaf(kind)
    np.testing.assert_array_equal(tmatmul.dequantize_weight(tq, ts).numpy(),
                                  np.asarray(jmatmul.dequantize_weight(jq, js)))


@pytest.mark.parametrize("case, match", [
    ("int8 K mismatch", "int8 weight contraction dim"),
    ("int4 K mismatch", "int4-packed contraction dim"),
    ("scale rank", "matches neither"),
    ("groups", "not divisible"),
])
def test_shape_errors_as_jax(case, match):
    q8, s8, _, _ = _leaf("int8")
    q4, s4, _, _ = _leaf("int4")
    with pytest.raises(ValueError, match=match):
        if case == "int8 K mismatch":
            tmatmul.quantized_matmul(torch.zeros(3, K + 2), q8, s8)
        elif case == "int4 K mismatch":
            tmatmul.quantized_matmul(torch.zeros(3, K - 2), q4, s4)
        elif case == "scale rank":
            tmatmul.dequantize_weight(q8, s8[None, None])
        else:
            tmatmul.dequantize_weight(q4, torch.ones(3, N))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (tmatmul.quantized_matmul_int8.launches,
              tmatmul.quantized_matmul_int4.launches)
    for kind in ("int8", "int4"):
        tq, ts, _, _ = _leaf(kind)
        tx, _ = _x((5, K), "bf16")
        kernel = getattr(tmatmul, f"quantized_matmul_{kind}")
        assert torch.equal(kernel(tx, tq, ts), tmatmul.quantized_matmul_reference(tx, tq, ts))
    assert (tmatmul.quantized_matmul_int8.launches,
            tmatmul.quantized_matmul_int4.launches) == before


@pytest.mark.parametrize("t", [1, 5, 8, 128, 512, 1000])
@pytest.mark.parametrize("k, n", [(1024, 3072), (1024, 1024), (1024, 4096),
                                  (4096, 1024), (64, 200), (16, 16)])
@pytest.mark.parametrize("pack", [1, 2])
def test_k_split_covers_every_row_once(t, k, n, pack):
    """The wrapper's K split: every q row in exactly one split, each split
    a whole number of K-lane rows, and enough blocks to cover the SMs
    twice wherever K has rows enough."""
    units = k // pack
    splits, per = tmatmul.quant_splits(t, n, units)
    assert per % tmatmul.K_LANES == 0
    assert (splits - 1) * per < units <= splits * per
    tiles = -(-n // tmatmul.BLOCK_N) * -(-t // tmatmul.token_tile(t))
    assert (tiles * splits >= tmatmul.WAVES * tmatmul.SMS
            or per == tmatmul.K_LANES or splits == 1)


@pytest.mark.parametrize("t, tile", [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8), (128, 8)])
def test_token_tile(t, tile):
    assert tmatmul.token_tile(t) == tile
