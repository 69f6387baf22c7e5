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


def _case(c, pool, dev):
    """Garbage pages (NULL page included), distinct random pages over each
    row's live prefix and NULL beyond it; row 0 ends on the table's last
    key, row 1 starts mid-page, row 2 at 0."""
    g = torch.Generator().manual_seed(c)
    n_pages = B * W + 1
    k = torch.randn(n_pages, PS, NH, HD, generator=g)
    v = torch.randn(n_pages, PS, NH, HD, generator=g)
    table = torch.randperm(n_pages - 1, generator=g)[: B * W].reshape(B, W) + 1
    start = torch.tensor([PS * W - c, 6, 0], dtype=torch.int32)
    for b in range(B):
        table[b, (int(start[b]) + c - 1) // PS + 1:] = 0
    q = torch.randn(B, c, NH, HD, generator=g)
    slopes = torch.tensor([2.0 ** -(i + 1) for i in range(NH)])
    if pool == "bf16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    elif pool == "int8":
        k, v = ({"q": qq, "scale": s} for qq, s in (quantize_kv(k), quantize_kv(v)))
    to = lambda x: ({n: t.to(dev) for n, t in x.items()} if isinstance(x, dict)  # noqa: E731
                    else x.to(dev))
    return (to(q), to(k), to(v), to(table.to(torch.int32)), to(start)), to(slopes)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", sorted(ATOL))
@pytest.mark.parametrize("c", [1, 4, 70])
def test_kernel_matches_plain_version_on_card(pool, c):
    """C=70 spans two query tiles of the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args, slopes = _case(c, pool, torch.device("cuda"))
    before = pa.paged_attention.launches
    out = pa.paged_attention(*args, slopes=slopes)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    ref = pa.paged_attention_reference(*args, slopes=slopes)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=ATOL[pool])


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    """Wrong dtype or a non-contiguous bank raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    (q, k, v, table, start), slopes = _case(1, "f32", torch.device("cuda"))
    before = pa.paged_attention.launches
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, k, v, table.long(), start, slopes=slopes)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           v, table, start, slopes=slopes)
    assert pa.paged_attention.launches == before
