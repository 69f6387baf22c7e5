"""The quantized-matmul CUDA kernels (B10 int8, B11 int4) against their
plain PyTorch version, on the card, on both routes: the tensor-core route
(bf16 x, ``mma.sync``) and the float32 route (float32 x, or a bf16 x the
tensor cores do not take). Skips without a card: the kernels have no CPU
mode.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_quant_matmul_cuda.py

Tolerance, on max |kernel - plain| against the largest |plain| value M:
1e-5 * M on both routes.
- Float32 route: the kernel and the plain version multiply the same
  float32 values (a bf16 x times an int8 weight is exact in float32; an
  int4 weight times its scale is rounded once on both sides) and differ
  only in the order of the sums, over at most 4096 products.
- Tensor-core route: a bf16 x times an int8 value (|q| <= 128) or an int4
  value (|q4| <= 8) is exact in float32, and bf16 holds those values
  exactly, so the MMA forms the same products as the plain version. Its
  sums run in another order: 16 products inside the tensor core, two
  k16 steps a fragment, then float32 adds across fragments, warps and K
  splits. For int4 the kernel multiplies each group's sum by the group's
  scale where the plain version multiplies each weight before the sum:
  one rounding moves from the weight to the group sum.
``quantized_linear`` is compared bit for bit with the unfused composite on
the same route, since both cast and add the same float32 y.
"""
import pytest
import torch

from pipegoose_tpu_torch.quant import matmul as qm
from pipegoose_tpu_torch.quant.weights import QuantSpec, _quantize_kernel
from pipegoose_tpu_torch.serving.kv_pool import quantize_kv

RTOL = 1e-5
BLOOM_KN = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(t, k, n, kind, g, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(t, k, generator=gen).to(dev, dtype)
    w = (torch.randn(k, n, generator=gen) * 0.02).to(dev)
    leaf = _quantize_kernel(w, QuantSpec(kind, g))
    return x, leaf["q"], leaf["scale"]


def _check(x, q, scale, kind, route=None):
    kernel = getattr(qm, f"quantized_matmul_{kind}")
    before, routes = kernel.launches, dict(kernel.routes)
    y = kernel(x, q, scale)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    if route is not None:
        assert kernel.routes[route] == routes[route] + 1, f"not the {route} route"
    ref = qm.quantized_matmul_reference(x, q, scale)
    assert y.dtype == torch.float32 and y.shape == ref.shape
    assert bool(torch.isfinite(y).all())
    err = (y - ref).abs().max().item()
    tol = RTOL * ref.abs().max().item()
    assert err <= tol, f"max |kernel - plain| {err} > {tol}"
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 5, 8, 128, 512])
@pytest.mark.parametrize("k, n", BLOOM_KN, ids=[f"{k}x{n}" for k, n in BLOOM_KN])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_kernel_matches_plain_at_bloom_560m_shapes(kind, k, n, t, dtype):
    dev = _needs_card()
    _check(*_case(t, k, n, kind, 32, dtype, dev), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [16, 32, 128])
@pytest.mark.parametrize("t, n", [(8, 200), (3, 1040), (128, 200), (1, 16)])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_ragged_n_and_int4_groups(kind, t, n, g):
    """N not a multiple of 16 (byte loads) or of the 256-column block."""
    dev = _needs_card()
    _check(*_case(t, 256, n, kind, g, torch.bfloat16, dev, seed=1), kind)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 5, 8, 64, 128, 512])
@pytest.mark.parametrize("k, n", BLOOM_KN, ids=[f"{k}x{n}" for k, n in BLOOM_KN])
@pytest.mark.parametrize("kind, g", [("int8", 32), ("int4", 16), ("int4", 32), ("int4", 128)],
                         ids=["int8", "int4-g16", "int4-g32", "int4-g128"])
def test_tensor_core_route_matches_plain(kind, g, k, n, t):
    dev = _needs_card()
    x, q, s = _case(t, k, n, kind, g, torch.bfloat16, dev, seed=t)
    assert qm.kernel_route(x.dtype, k, g if kind == "int4" else 0, x.data_ptr()) == "mma"
    _check(x, q, s, kind, route="mma")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 8, 128])
def test_group_of_8_takes_the_float32_route(t):
    """bf16 x with int4 groups of 8: the tensor cores take whole k16
    groups only, so the wrapper launches the float32-FMA kernel."""
    dev = _needs_card()
    x, q, s = _case(t, 256, 1024, "int4", 8, torch.bfloat16, dev, seed=7)
    assert qm.kernel_route(x.dtype, 256, 8, x.data_ptr()) == "fma"
    _check(x, q, s, "int4", route="fma")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_tensor_core_results_repeat_bit_for_bit(kind):
    """The last block of each tile adds the K splits in split order, so a
    split product repeats bit for bit."""
    dev = _needs_card()
    x, q, s = _case(8, 4096, 1024, kind, 32, torch.bfloat16, dev, seed=2)
    assert qm.mma_splits(8, 4096, 1024)[0] > 1
    kernel = getattr(qm, f"quantized_matmul_{kind}")
    first = kernel(x, q, s)
    for _ in range(3):
        assert torch.equal(kernel(x, q, s), first)


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("t", [1, 8, 128, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_linear_equals_the_unfused_composite(kind, dtype, t, bias):
    """``quantized_linear`` (one launch on the tensor-core route) is
    ``quantized_matmul(...).to(x.dtype) + bias`` from the same route, bit
    for bit, and each counts one launch."""
    dev = _needs_card()
    x, q, s = _case(t, 1024, 3072, kind, 32, dtype, dev, seed=5)
    b = (torch.randn(3072, generator=torch.Generator().manual_seed(6)) * 0.1).to(dev, dtype)
    b = b if bias else None
    kernel = getattr(qm, f"quantized_matmul_{kind}")
    before = kernel.launches
    got = qm.quantized_linear(x, q, s, b)
    assert kernel.launches == before + 1
    want = qm.quantized_matmul(x, q, s).to(dtype)
    want = want if b is None else want + b
    assert kernel.launches == before + 2
    assert got.dtype == dtype and torch.equal(got, want)
    plain = qm.quantized_linear_reference(x, q, s, b)
    err = (got.float() - plain.float()).abs().max().item()
    ulp = 2.0 ** -7 if dtype is torch.bfloat16 else 1e-5   # one bf16 ulp at M / the route's rtol
    assert err <= ulp * plain.float().abs().max().item()


@pytest.mark.cuda
def test_launch_counters_move_by_one_per_product():
    """Each entry point counts one launch a product on its kind and route:
    bf16 x on the tensor cores, float32 x on the float32 route."""
    dev = _needs_card()
    for kind in ("int8", "int4"):
        kernel = getattr(qm, f"quantized_matmul_{kind}")
        for dtype, route in ((torch.bfloat16, "mma"), (torch.float32, "fma")):
            x, q, s = _case(8, 1024, 1024, kind, 32, dtype, dev, seed=8)
            before, routes = kernel.launches, dict(kernel.routes)
            qm.quantized_matmul(x.reshape(2, 4, 1024), q, s)
            qm.quantized_linear(x, q, s)
            qm.quantized_linear(x, q, s, torch.zeros(1024, device=dev, dtype=dtype))
            assert kernel.launches == before + 3
            assert kernel.routes[route] == routes[route] + 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_results_repeat_bit_for_bit(kind):
    """No atomics: the K splits and lanes are added in a fixed order."""
    dev = _needs_card()
    x, q, s = _case(8, 4096, 1024, kind, 32, torch.float32, dev, seed=2)
    kernel = getattr(qm, f"quantized_matmul_{kind}")
    assert torch.equal(kernel(x, q, s), kernel(x, q, s))


@pytest.mark.cuda
def test_wrapper_routes_by_layout_and_restores_batch_dims():
    dev = _needs_card()
    x, q, s = _case(6, 1024, 1024, "int4", 32, torch.bfloat16, dev, seed=3)
    before = qm.quantized_matmul_int4.launches
    y = qm.quantized_matmul(x.reshape(2, 3, 1024), q, s)
    assert qm.quantized_matmul_int4.launches == before + 1
    assert y.shape == (2, 3, 1024)
    assert torch.equal(y.reshape(6, 1024), qm.quantized_matmul_int4(x, q, s))


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    """A CPU q with a CUDA x, a wrong dtype, a non-contiguous x or an odd
    int4 group raise before any launch."""
    dev = _needs_card()
    x, q, s = _case(8, 256, 256, "int8", 32, torch.float32, dev)
    x4, q4, s4 = _case(8, 256, 256, "int4", 32, torch.float32, dev)
    before = (qm.quantized_matmul_int8.launches, qm.quantized_matmul_int4.launches)
    with pytest.raises(ValueError, match="cpu"):
        qm.quantized_matmul_int8(x, q.cpu(), s)
    with pytest.raises(TypeError, match="int8"):
        qm.quantized_matmul_int8(x, q.to(torch.int16), s)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        qm.quantized_matmul_int8(x.half(), q, s)
    with pytest.raises(ValueError, match="contiguous"):
        qm.quantized_matmul_int8(x.t().contiguous().t(), q, s)
    with pytest.raises(ValueError, match="even size"):
        qm.quantized_matmul_int4(x4, q4, torch.ones(256, 256, device=dev))   # G = 1
    assert (qm.quantized_matmul_int8.launches, qm.quantized_matmul_int4.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [("int8", 32), ("int4", 32), ("int4", 16)])
def test_quantization_on_card_equals_cpu(spec):
    """q and scale bit for bit, weights and KV: CUDA's division by a CPU
    scalar multiplies by the reciprocal, which once made the card's scales
    differ from the CPU's by an ulp."""
    dev = _needs_card()
    w = torch.randn(1024, 3072, generator=torch.Generator().manual_seed(4)) * 0.02
    card, cpu = (_quantize_kernel(w.to(d), QuantSpec(*spec)) for d in (dev, "cpu"))
    for plane in ("q", "scale"):
        assert torch.equal(card[plane].cpu(), cpu[plane]), plane
    kv = torch.randn(64, 16, 64, generator=torch.Generator().manual_seed(5))
    for got, want in zip(quantize_kv(kv.to(dev)), quantize_kv(kv)):
        assert torch.equal(got.cpu(), want)
