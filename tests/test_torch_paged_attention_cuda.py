"""The paged-attention CUDA kernel against its plain PyTorch version, on
the card. Skips without one: the kernel has no CPU mode.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_paged_attention_cuda.py
"""
import numpy as np
import pytest
import torch

from pipegoose_tpu_torch.ops import paged_attention as pa
from pipegoose_tpu_torch.serving.kv_pool import quantize_kv

B, NH, HD, PS, W = 3, 4, 64, 16, 8
ATOL = {"f32": 1e-4, "bf16": 2e-3, "int8": 1e-4}   # online-softmax reassociation
QDTYPES = {"qf32": torch.float32, "qbf16": torch.bfloat16}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(c, pool, dev, *, rows=B, width=W, starts=None, qdtype=torch.float32,
          strided=False):
    """Garbage pages (NULL page included), distinct random pages over each
    row's live prefix and NULL beyond it; by default row 0 ends on the
    table's last key, row 1 starts mid-page, row 2 at 0. ``strided`` takes
    q as the q slice of a fused (B, C, nh, 3, hd) tensor."""
    g = torch.Generator().manual_seed(c)
    n_pages = rows * width + 1
    k = torch.randn(n_pages, PS, NH, HD, generator=g)
    v = torch.randn(n_pages, PS, NH, HD, generator=g)
    table = torch.randperm(n_pages - 1, generator=g)[: rows * width].reshape(rows, width) + 1
    start = torch.tensor(starts or [PS * width - c, 6, 0][:rows], dtype=torch.int32)
    for b in range(rows):
        table[b, (int(start[b]) + c - 1) // PS + 1:] = 0
    q = torch.randn(rows, c, NH, *((3,) if strided else ()), HD, generator=g).to(qdtype)
    slopes = torch.tensor([2.0 ** -(i + 1) for i in range(NH)])
    if pool == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    elif pool == "int8":
        k, v = ({"q": qq, "scale": s} for qq, s in (quantize_kv(k), quantize_kv(v)))
    to = lambda x: ({n: t.to(dev) for n, t in x.items()} if isinstance(x, dict)  # noqa: E731
                    else x.to(dev))
    q = to(q)[..., 0, :] if strided else to(q)   # the view is taken on the card
    return (q, to(k), to(v), to(table.to(torch.int32)), to(start)), to(slopes)


def _check(args, slopes, pool):
    before = pa.paged_attention.launches
    out = pa.paged_attention(*args, slopes=slopes)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_reference(*args, slopes=slopes)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=ATOL[pool])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", sorted(QDTYPES))
@pytest.mark.parametrize("pool", sorted(ATOL))
@pytest.mark.parametrize("c", [1, 4, 16, 70, 128])
def test_kernel_matches_plain_version_on_card(pool, c, qdtype):
    """Every route: C = 1 and 4 on the FMA route, C >= 16 on the tensor
    cores for bf16 q over bf16 or int8 pages (C = 70 spans two query
    tiles), float32 q or pages on the FMA route at every C."""
    args, slopes = _case(c, pool, _card(), qdtype=QDTYPES[qdtype])
    _check(args, slopes, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", sorted(ATOL))
@pytest.mark.parametrize("c", [1, 128])
def test_long_row_runs_the_cluster_split(pool, c):
    """One row over W = 64 full pages: the plan splits its keys over the
    blocks of a cluster."""
    dev = _card()
    args, slopes = _case(c, pool, dev, rows=1, width=64, starts=[64 * PS - c],
                         qdtype=torch.bfloat16)
    pages = args[1]["q"] if pool == "int8" else args[1]
    plan = pa.paged_plan(1, c, NH, HD, PS, 64, torch.bfloat16, pages.dtype)
    assert plan["splits"] > 1
    _check(args, slopes, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", sorted(QDTYPES))
@pytest.mark.parametrize("pool", sorted(ATOL))
@pytest.mark.parametrize("c", [1, 128])
def test_strided_q_view_is_read_in_place(pool, c, qdtype):
    """q as the q slice of a fused qkv tensor (head stride 3 hd)."""
    args, slopes = _case(c, pool, _card(), qdtype=QDTYPES[qdtype], strided=True)
    assert not args[0].is_contiguous() and args[0].stride(2) == 3 * HD
    _check(args, slopes, pool)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", sorted(ATOL))
@pytest.mark.parametrize("c", [1, 70])
def test_calls_repeat_bit_for_bit(pool, c):
    """Splits and warps merge in a fixed order, with no atomics."""
    args, slopes = _case(c, pool, _card(), rows=1, width=64, starts=[1000 - c],
                         qdtype=torch.bfloat16)
    first = pa.paged_attention(*args, slopes=slopes)
    second = pa.paged_attention(*args, slopes=slopes)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    """Wrong dtype, a non-contiguous bank or head_dim axis, or a q dtype the
    kernel does not read raises before any launch."""
    (q, k, v, table, start), slopes = _case(1, "f32", _card())
    before = pa.paged_attention.launches
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, k, v, table.long(), start, slopes=slopes)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           v, table, start, slopes=slopes)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pa.paged_attention(q.half(), k, v, table, start, slopes=slopes)
    with pytest.raises(ValueError, match="head_dim axis"):
        pa.paged_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                           table, start, slopes=slopes)
    assert pa.paged_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("n", [1, 3, 7])
def test_speculative_verification_shape(pool, n):
    """The serving engine's verification call: B = 8 slots of C = n + 1
    bf16 queries from per-row starts (on page boundaries, inside pages,
    at 0 and on the table's last key), on the FMA route below
    MMA_MIN_QUERIES queries, counted under its query count."""
    c = n + 1
    starts = [0, 5, 16, 31, 47 - c, 60, 100, PS * 8 - c]
    args, slopes = _case(c, pool, _card(), rows=8, width=8, starts=starts,
                         qdtype=torch.bfloat16)
    pages = args[1]["q"] if pool == "int8" else args[1]
    assert pa.paged_plan(8, c, NH, HD, PS, 8, torch.bfloat16, pages.dtype)["route"] == "fma"
    before = pa.paged_attention.routes["fma"], pa.paged_attention.queries.get(c, 0)
    _check(args, slopes, pool)
    assert (pa.paged_attention.routes["fma"],
            pa.paged_attention.queries[c]) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
def test_copy_page_on_card_matches_cpu_bit_for_bit(pool):
    """Copy-on-write on the card: a chain of page copies (a copy of a copy,
    a page onto itself) over every layer's k and v planes, int8 scale
    planes included, equals the same chain on the CPU bit for bit."""
    from pipegoose_tpu_torch.serving.kv_pool import copy_page

    dev = _card()
    g = torch.Generator().manual_seed(5)
    shape = (3, 9, PS, NH, HD)
    banks = []
    for _ in range(2):
        x = torch.randn(shape, generator=g)
        if pool == "int8":
            qq, s = quantize_kv(x)
            banks.append({"q": qq, "scale": s})
        else:
            banks.append(x.to(torch.bfloat16) if pool == "bf16" else x)
    to = lambda b: ({n: t.to(dev) for n, t in b.items()} if isinstance(b, dict)  # noqa: E731
                    else b.to(dev))
    cpu = [({n: t.clone() for n, t in b.items()} if isinstance(b, dict) else b.clone())
           for b in banks]
    card = [to(b) for b in banks]
    for src, dst in [(3, 7), (7, 1), (5, 3), (2, 2)]:
        copy_page(*cpu, src, dst)
        copy_page(*card, src, dst)
    torch.cuda.synchronize()
    for c, d in zip(cpu, card):
        for name in (("q", "scale") if pool == "int8" else (None,)):
            a, b = (c, d) if name is None else (c[name], d[name])
            assert torch.equal(a, b.cpu())
