"""The port's paged attention held against the JAX package (the kernel
against its plain version on the card is in
test_torch_paged_attention_cuda.py).

On the CPU the wrapper runs the plain version (gather, then attend);
it is compared with the JAX ``paged_attention_reference`` and with the
Pallas kernel run in interpret mode, as tests/ops/test_paged_attention.py
runs it. Pages hold garbage everywhere, the NULL page included, so the
mask and not zeroed memory must keep invalid keys out. Tolerance 1e-5:
the Pallas kernel sums with an online softmax, page by page, and the
plain versions in one softmax; the reassociation moves float32 results
by ~1e-6 at these magnitudes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.ops.paged_attention import paged_attention as jpaged_attention
from pipegoose_tpu.ops.paged_attention import paged_attention_reference as jreference
from pipegoose_tpu.serving.kv_pool import quantize_kv as jquantize_kv
from pipegoose_tpu_torch.ops import _build
from pipegoose_tpu_torch.ops import paged_attention as tpa
from pipegoose_tpu_torch.serving.kv_pool import quantize_kv

PS, NH, HD = 4, 4, 16      # page_size, n_heads, head_dim
W, B = 5, 3                # table width, rows
ATOL = 1e-5


def _case(rng, c, quantized, ps=PS, hd=HD, width=W):
    """Numpy inputs: garbage pages, a permuted table with NULL entries
    beyond each row's live prefix, ragged starts (row 0 ends on the
    table's last key, row 1 starts mid-page, row 2 at 0)."""
    n_pages = B * width + 1
    k = rng.standard_normal((n_pages, ps, NH, hd), dtype=np.float32)
    v = rng.standard_normal((n_pages, ps, NH, hd), dtype=np.float32)
    table = rng.permutation(np.arange(1, n_pages)).reshape(B, width)
    start = np.array([ps * width - c, 6, 0], np.int32)
    for b in range(B):
        table[b, (start[b] + c - 1) // ps + 1:] = 0
    q = rng.standard_normal((B, c, NH, hd), dtype=np.float32)
    slopes = np.array([2.0 ** -(i + 1) for i in range(NH)], np.float32)
    if quantized:
        kq, ks = jquantize_kv(jnp.asarray(k))
        vq, vs = jquantize_kv(jnp.asarray(v))
        k = {"q": np.asarray(kq), "scale": np.asarray(ks)}
        v = {"q": np.asarray(vq), "scale": np.asarray(vs)}
    return q, k, v, table.astype(np.int32), start, slopes


def _to(x, fn):
    return {n: fn(a) for n, a in x.items()} if isinstance(x, dict) else fn(x)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("c", [1, 4])
def test_plain_version_matches_jax(quantized, c):
    q, k, v, table, start, slopes = _case(np.random.default_rng(c), c, quantized)
    jargs = [_to(a, jnp.asarray) for a in (q, k, v, table, start)]
    ref = jreference(*jargs, slopes=jnp.asarray(slopes))
    pallas = jpaged_attention(*jargs, slopes=jnp.asarray(slopes),
                              interpret=True)
    out = tpa.paged_attention(*[_to(a, torch.from_numpy) for a in
                                (q, k, v, table, start)],
                              slopes=torch.from_numpy(slopes))
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, c, NH, HD)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=0, atol=ATOL)


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 4, 16), dtype=np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row: the tiny clamp
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = jquantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)


def test_tile_guard_raises_instead_of_falling_back():
    """Keys are staged by logical position, so shared memory follows
    head_dim and the route, not page_size; a head_dim the source does not
    instantiate, or a page_size below 1, raises."""
    geom = tpa.check_paged_tile(16, 64, 128, route="mma")   # bloom-560m chunk
    assert geom["fits"] and geom["query_tile"] == 64
    assert geom["smem_bytes"] == 2 * 2 * 64 * (64 * 2 + 16)  # two (K, V) bf16 stages
    int8 = tpa.check_paged_tile(16, 64, 128, route="mma", page_bytes=1)
    assert int8["smem_bytes"] == 2 * (2 * 64 * 80 + 2 * 64 * 4) + 2 * 64 * 144
    assert tpa.check_paged_tile(16, 64, 1)["query_tile"] == 1
    assert tpa.check_paged_tile(16, 64, 4)["query_tile"] == 4
    assert tpa.check_paged_tile(512, 128, 64, route="mma")["fits"]
    with pytest.raises(ValueError, match="head_dim"):
        tpa.check_paged_tile(16, 96, 64)
    with pytest.raises(ValueError, match="page_size"):
        tpa.check_paged_tile(0, 64, 1)


BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize("shape, dtypes, want", [
    # bloom-560m decode: 128 (row, head) blocks, keys split over clusters of 2
    ((8, 1, 16, 64, 16, 64), (BF16, BF16), ("fma", 1, 2, 256, "paged_fma_bf16q_bf16")),
    ((8, 1, 16, 64, 16, 64), (BF16, I8), ("fma", 1, 2, 256, "paged_fma_bf16q_int8")),
    # bloom-560m chunked prefill: 2 query tiles x 16 heads, clusters of 8
    ((1, 128, 16, 64, 16, 64), (BF16, BF16), ("mma", 64, 8, 256, "paged_mma_bf16q_bf16")),
    ((1, 128, 16, 64, 16, 64), (BF16, I8), ("mma", 64, 8, 256, "paged_mma_bf16q_int8")),
    # the float32 engine's chunk stays on float32 FMAs, 512 blocks unsplit
    ((1, 128, 16, 64, 16, 64), (F32, F32), ("fma", 4, 1, 512, "paged_fma_f32q_f32")),
    ((1, 128, 16, 64, 16, 64), (BF16, F32), ("fma", 4, 1, 512, "paged_fma_bf16q_f32")),
    # below the tensor-core threshold
    ((1, 15, 16, 64, 16, 64), (BF16, BF16), ("fma", 4, 4, 256, "paged_fma_bf16q_bf16")),
    # a single long row: 16 blocks, the most splits
    ((1, 1, 16, 64, 16, 64), (F32, BF16), ("fma", 1, 8, 128, "paged_fma_f32q_bf16")),
    # a short table caps the splits at one per 32 keys
    ((1, 1, 16, 64, 16, 4), (BF16, BF16), ("fma", 1, 2, 32, "paged_fma_bf16q_bf16")),
])
def test_plan_picks_route_and_splits(shape, dtypes, want):
    """The wrapper's launch as a pure function of the shapes and dtypes."""
    plan = tpa.paged_plan(*shape, *dtypes)
    got = (plan["route"], plan["query_tile"], plan["splits"], plan["blocks"], plan["entry"])
    assert got == want
    assert plan["splits"] <= tpa.MAX_SPLITS and plan["fits"]


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("c", [1, 4])
def test_strided_bf16_q_view_matches_jax(quantized, c):
    """bf16 q as the q slice of a fused (B, C, nh, 3, hd) qkv tensor, the
    engine's view, through the CPU path: equal to the JAX reference and
    to the Pallas kernel in interpret mode on the same bf16 values."""
    rng = np.random.default_rng(10 + c)
    q, k, v, table, start, slopes = _case(rng, c, quantized)
    fused = rng.standard_normal((B, c, NH, 3, HD), dtype=np.float32)
    fused[..., 0, :] = q
    tq = torch.from_numpy(fused).to(torch.bfloat16)[..., 0, :]
    assert tq.stride(2) == 3 * HD and not tq.is_contiguous()
    jq = jnp.asarray(tq.float().numpy()).astype(jnp.bfloat16)
    jargs = [jq] + [_to(a, jnp.asarray) for a in (k, v, table, start)]
    ref = jreference(*jargs, slopes=jnp.asarray(slopes))
    pallas = jpaged_attention(*jargs, slopes=jnp.asarray(slopes), interpret=True)
    out = tpa.paged_attention(tq, *[_to(a, torch.from_numpy) for a in
                                    (k, v, table, start)],
                              slopes=torch.from_numpy(slopes))
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, c, NH, HD)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=0, atol=ATOL)


def test_wrapper_refuses_other_devices():
    q, k, v, table, start, slopes = _case(np.random.default_rng(0), 1, False)
    meta = [torch.empty(a.shape, device="meta") for a in (q, k, v)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        tpa.paged_attention(*meta, torch.from_numpy(table),
                            torch.from_numpy(start),
                            slopes=torch.from_numpy(slopes))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler means an error, never the plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("paged_attention")
