"""The comm engine and the pipeline runtimes on the card against the same
calls on the CPU: the kernel-free checks ``chip_smoke.py`` phase 30 does
not make on its own. Skips without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_comm_cuda.py

- ``_quantize_chunks``: int8 payloads and float32 scales bit for bit, on
  chunks with half-step ties, an all-zero chunk and random values (every
  quotient is a true division on both devices: ``_device.true_div``).
- ``compressed_reduce_scatter_mean`` and ``compressed_all_reduce_mean`` on
  a one-rank NCCL "data" axis, each mode, with a residual: bit for bit
  (no wire on one rank; the same roundings).
- The overlap layers on a one-rank tensor axis (the ring is the plain
  float32 product): the output and every gradient within 1e-5 of its
  largest value (cuBLAS and the CPU's BLAS sum in other orders, and the
  backward's products run through tanh).
- ``gpipe`` and ``one_f_one_b`` at pp = 1 on a 4-layer tanh stack with
  side inputs: outputs, loss and gradients against the same calls on the
  CPU, 1e-5 of each value's largest.
"""
import tempfile

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

MODES = ("fp32", "bf16", "int8")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def one_rank():
    """A one-rank NCCL context with every axis named, torn down after."""
    import torch.distributed as dist

    from pipegoose_tpu_torch.distributed import ParallelContext

    _needs_card()
    store = dist.FileStore(tempfile.mkdtemp() + "/store", 1)
    ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cuda")
    yield ctx
    ctx.destroy()


def test_quantize_chunks_card_equals_cpu():
    from pipegoose_tpu_torch.distributed.compressed import _dequantize, _quantize_chunks

    dev = _needs_card()
    gen = torch.Generator().manual_seed(0)
    ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5] * 4)
    flat = torch.stack([ties, torch.zeros(32), torch.randn(32, generator=gen) * 3,
                        torch.randn(32, generator=gen) * 1e-30])
    q, s = _quantize_chunks(flat)
    qd, sd = _quantize_chunks(flat.to(dev))
    assert torch.equal(qd.cpu(), q) and torch.equal(sd.cpu(), s)
    assert torch.equal(_dequantize(qd, sd).cpu(), _dequantize(q, s))


@pytest.mark.parametrize("mode", MODES)
def test_compressed_reductions_card_equal_cpu(one_rank, mode):
    from pipegoose_tpu_torch.distributed.compressed import (
        compressed_all_reduce_mean,
        compressed_reduce_scatter_mean,
    )

    gen = torch.Generator().manual_seed(1)
    g = torch.randn(64, 33, generator=gen)
    res = torch.randn(64, 33, generator=gen) * 1e-3
    for fn, args in ((compressed_reduce_scatter_mean, (g, res)),
                     (compressed_all_reduce_mean, (g[:5], res[:5]))):
        cpu = fn(args[0], "data", mode, args[1])
        card = fn(args[0].cuda(), "data", mode, args[1].cuda())
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu()), (fn.__name__, mode)


def _leaf(t, dev):
    """A fresh leaf on ``dev`` that requires grad (never ``t`` itself)."""
    return t.detach().to(dev, copy=True).requires_grad_(True)


def test_overlap_at_one_rank_is_the_plain_product(one_rank):
    from pipegoose_tpu_torch.nn.tensor_parallel.overlap import (
        column_parallel_linear_overlap,
        row_parallel_linear_overlap,
    )

    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 16, 64, generator=gen)
    col = {"kernel": torch.randn(64, 96, generator=gen), "bias": torch.randn(96, generator=gen)}
    row = {"kernel": torch.randn(96, 64, generator=gen), "bias": torch.randn(64, generator=gen)}
    outs = []
    for dev in ("cpu", "cuda"):
        xs = _leaf(x, dev)
        c = {k: _leaf(v, dev) for k, v in col.items()}
        r = {k: _leaf(v, dev) for k, v in row.items()}
        y = row_parallel_linear_overlap(
            r, torch.tanh(column_parallel_linear_overlap(c, xs, "tensor")), "tensor")
        (y ** 2).sum().backward()
        outs.append([t.detach().cpu() for t in (y, xs.grad, c["kernel"].grad,
                                                r["kernel"].grad, r["bias"].grad)])
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def _stack_case(dev, seed=3):
    gen = torch.Generator().manual_seed(seed)
    ws = [(torch.randn(16, 16, generator=gen) * 0.3).to(dev) for _ in range(4)]
    x = torch.randn(4, 2, 16, generator=gen).to(dev)
    side = (torch.randn(4, 16, generator=gen) * 0.1).to(dev)
    return ws, x, side


def _stage(ws, h, s):
    for w in ws:
        h = torch.tanh(h @ w) + s
    return h


def test_pipelines_at_one_stage_card_equal_cpu(one_rank):
    from pipegoose_tpu_torch.nn.pipeline_parallel import gpipe, one_f_one_b

    runs = []
    for dev in ("cpu", "cuda"):
        ws, x, side = _stack_case(dev)
        ws = [w.requires_grad_(True) for w in ws]
        out = gpipe(_stage, ws, x, side_inputs=side, remat=True)
        (out ** 2).mean().backward()
        g_pipe = [w.grad.detach().cpu() for w in ws]
        loss, dx, dws, _ = one_f_one_b(
            _stage, ws, lambda hp, h, s: (h ** 2).mean(), [], x, side)
        runs.append([out.detach().cpu(), *g_pipe, loss.cpu(), dx.cpu(),
                     *[g.cpu() for g in dws]])
    for a, b in zip(*runs):
        assert float((a - b).abs().max()) <= 1e-5 * max(float(a.abs().max()), 1e-30)
