"""``quant.matmul.quantized_linear`` and the tensor-core route's tiling
helpers on the CPU.

- The plain ``quantized_linear`` (and the port's parallel linears on a
  quantized leaf, which call it) against the JAX
  ``column_parallel_linear`` / ``row_parallel_linear`` with
  ``axis_name=None``, on the same numpy-seeded quantized weights and
  activations (XLA's quantized reference on the JAX side). Tolerance, on
  max |port - JAX| against the largest |JAX| value M: float32 outputs
  1e-6 + 1e-5 M (the same float32 products summed in another order);
  bf16 outputs 1e-6 + 2^-7 M, one bf16 ulp at M, since the two float32
  sums may round to neighbouring bf16 values before the bias is added.
- On CPU tensors ``quantized_linear`` is the unfused composite bit for
  bit and counts no launch.
- The route, token tile, block width and K split (one cluster of blocks)
  of the tensor-core kernel, over the grid that
  ``test_k_split_covers_every_row_once`` uses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.nn.tensor_parallel import layers as jlayers
from pipegoose_tpu.quant import weights as jweights
from pipegoose_tpu_torch.nn.tensor_parallel import layers as tlayers
from pipegoose_tpu_torch.quant import matmul as tmatmul
from pipegoose_tpu_torch.quant import weights as tweights

K, N = 64, 96
SPECS = {"int8": ("int8", 32), "int4-g16": ("int4", 16), "int4-g32": ("int4", 32)}
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
RTOL = {"f32": 1e-5, "bf16": 2.0 ** -7}


def _leaves(spec, x_dtype, bias, seed=0):
    """One numpy kernel (and bias) quantized by both packages: the port's
    leaf and the JAX leaf, the bias in the activation dtype as the
    models keep it."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N), dtype=np.float32) / 8.0).astype(np.float32)
    tleaf = tweights._quantize_kernel(torch.from_numpy(w), tweights.QuantSpec(*SPECS[spec]))
    jleaf = jweights._quantize_kernel(jnp.asarray(w), jweights.QuantSpec(*SPECS[spec]))
    if bias:
        b = rng.standard_normal(N, dtype=np.float32) * 0.5
        tdt, jdt = DTYPES[x_dtype]
        tleaf["bias"] = torch.from_numpy(b).to(tdt)
        jleaf["bias"] = jnp.asarray(b, jdt)
    return tleaf, jleaf


def _x(x_dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((2, 5, K), dtype=np.float32)
    tdt, jdt = DTYPES[x_dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("x_dtype", sorted(DTYPES))
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("layer", ["column_parallel_linear", "row_parallel_linear"])
def test_quantized_linear_matches_jax_parallel_linears(layer, spec, x_dtype, bias):
    tleaf, jleaf = _leaves(spec, x_dtype, bias)
    tx, jx = _x(x_dtype)
    want = np.asarray(getattr(jlayers, layer)(jleaf, jx, None).astype(jnp.float32))
    got = getattr(tlayers, layer)(tleaf, tx)
    direct = tmatmul.quantized_linear(tx, tleaf["q"], tleaf["scale"], tleaf.get("bias"))
    assert got.dtype == DTYPES[x_dtype][0] and tuple(got.shape) == want.shape
    assert torch.equal(got, direct)
    err = np.abs(got.float().numpy() - want).max()
    tol = 1e-6 + RTOL[x_dtype] * np.abs(want).max()
    assert err <= tol, f"max |port - JAX| {err} > {tol}"


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("x_dtype", sorted(DTYPES))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_cpu_quantized_linear_is_the_composite_and_counts_no_launch(spec, x_dtype, bias):
    tleaf, _ = _leaves(spec, x_dtype, bias, seed=2)
    tx, _ = _x(x_dtype, seed=3)
    wrappers = (tmatmul.quantized_matmul_int8, tmatmul.quantized_matmul_int4)
    before = [(w.launches, dict(w.routes)) for w in wrappers]
    got = tmatmul.quantized_linear(tx, tleaf["q"], tleaf["scale"], tleaf.get("bias"))
    want = tmatmul.quantized_matmul(tx, tleaf["q"], tleaf["scale"]).to(tx.dtype)
    if bias:
        want = want + tleaf["bias"]
    assert torch.equal(got, want)
    assert torch.equal(got, tmatmul.quantized_linear_reference(
        tx, tleaf["q"], tleaf["scale"], tleaf.get("bias")))
    assert [(w.launches, dict(w.routes)) for w in wrappers] == before


def test_layers_send_a_quantized_leaf_and_its_bias_through_quantized_linear(monkeypatch):
    calls = []

    def spy(x, q, scale, bias=None):
        calls.append(bias)
        return tmatmul.quantized_linear(x, q, scale, bias)

    monkeypatch.setattr(tlayers, "quantized_linear", spy)
    tleaf, _ = _leaves("int8", "f32", bias=True)
    tx, _ = _x("f32")
    tlayers.column_parallel_linear(tleaf, tx)
    tlayers.row_parallel_linear(tleaf, tx)
    assert len(calls) == 2 and all(b is tleaf["bias"] for b in calls)


@pytest.mark.parametrize("t", [1, 5, 8, 128, 512, 1000])
@pytest.mark.parametrize("k, n", [(1024, 3072), (1024, 1024), (1024, 4096),
                                  (4096, 1024), (64, 200), (16, 16)])
@pytest.mark.parametrize("pack", [1, 2])
def test_mma_split_covers_every_k_once(t, k, n, pack):
    """The tensor-core route's K split: every k row (every packed row for
    int4) in exactly one split, each split but the last a whole number of
    MMA_BK stages, at most one cluster's worth of splits, never more blocks
    than one wave (unless the tiles alone pass it), and a split wherever a
    second one fits in the wave and K has a second stage."""
    splits, per = tmatmul.mma_splits(t, k, n)
    tiles = -(-n // tmatmul.mma_block_n(t)) * -(-t // tmatmul.mma_token_tile(t))
    wave = tmatmul.SMS * tmatmul.mma_blocks_per_sm(t)
    stages = -(-k // tmatmul.MMA_BK)
    assert (splits - 1) * per < k <= splits * per
    assert 1 <= splits <= tmatmul.MMA_MAX_SPLITS
    assert tiles * splits <= max(tiles, wave)
    if splits == 1:
        assert per == k
        assert 2 * tiles > wave or stages == 1
    else:
        assert per % tmatmul.MMA_BK == 0 and per % (16 * pack) == 0


@pytest.mark.parametrize("t, tile, block_n", [(1, 8, 64), (5, 8, 64), (8, 8, 64), (9, 16, 64),
                                              (16, 16, 64), (17, 32, 128), (32, 32, 128),
                                              (33, 64, 128), (128, 64, 128), (512, 64, 128)])
def test_mma_token_tile(t, tile, block_n):
    assert tmatmul.mma_token_tile(t) == tile
    assert tmatmul.mma_block_n(t) == block_n


@pytest.mark.parametrize("dtype, k, group, ptr, route", [
    (torch.bfloat16, 1024, 0, 0, "mma"),        # int8
    (torch.bfloat16, 1024, 32, 256, "mma"),     # int4, G = 32
    (torch.bfloat16, 1024, 48, 0, "mma"),       # a group of three k16 steps
    (torch.bfloat16, 1024, 8, 0, "fma"),        # a group inside one k16 step
    (torch.float32, 1024, 0, 0, "fma"),         # float32 x stays float32
    (torch.float32, 1024, 32, 0, "fma"),
    (torch.bfloat16, 1000, 0, 0, "fma"),        # K not a whole number of k16 steps
    (torch.bfloat16, 1024, 0, 8, "fma"),        # x not 16-byte aligned
])
def test_kernel_route(dtype, k, group, ptr, route):
    assert tmatmul.kernel_route(dtype, k, group, ptr) == route
