"""The quantized-matmul CUDA kernels (B10 int8, B11 int4) against their
plain PyTorch version, on the card. Skips without one: the kernels have no
CPU mode.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_quant_matmul_cuda.py

Tolerance, on max |kernel - plain| against the largest |plain| value M:
1e-5 * M. The kernels and the plain version multiply the same float32
values (a bf16 x times an int8 weight is exact in float32; an int4 weight
times its scale is rounded once on both sides) and differ only in the
order of the sums, over at most 4096 products.
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


def _check(x, q, scale, kind):
    kernel = getattr(qm, f"quantized_matmul_{kind}")
    before = kernel.launches
    y = kernel(x, q, scale)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
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
