"""The per-rank bodies of the port's multi-rank tests, and the tests of the
harness that runs them (``pipegoose_tpu_torch.testing.dist.run_ranks``).

``run_ranks`` pickles a rank body into spawned processes, which import
this module by name: it imports torch, numpy and the port only, never
JAX, so a rank starts in about a second. The JAX side of each comparison
lives in the test files that call these bodies
(``test_torch_parallel_context.py``, ``test_torch_ring_attention.py``,
``test_torch_sp_train.py``).
"""
import time

import pytest
import torch

from pipegoose_tpu_torch.distributed import ParallelContext, ParallelMode
from pipegoose_tpu_torch.distributed import functional as F
from pipegoose_tpu_torch.testing.dist import run_ranks

MODES = [m for m in ParallelMode if m != ParallelMode.DILOCO]


# -- parallel context ---------------------------------------------------------------

def layout_rank(rank, world, sizes_list):
    """For each (tp, pp, dp, sp): every mode's local rank and group, and
    the sum of the global ranks over each group (an all_reduce on it)."""
    out = []
    for tp, pp, dp, sp in sizes_list:
        ctx = ParallelContext(tensor_parallel_size=tp, pipeline_parallel_size=pp,
                              data_parallel_size=dp, sequence_parallel_size=sp,
                              device="cpu")
        try:
            row = {}
            for mode in MODES:
                total = F.all_reduce(torch.tensor([float(rank)]), mode.axis_name)
                row[mode.value] = (ctx.get_local_rank(mode),
                                   ctx.get_ranks_in_group(mode), float(total[0]),
                                   ctx.is_first_rank(mode), ctx.is_last_rank(mode))
            out.append(row)
        finally:
            ctx.destroy()
    return out


# -- collectives ---------------------------------------------------------------------

def _collective_fns(world):
    perm = [(i, (i + 2) % world) for i in range(world)] if world > 2 else [(0, 1)]
    return {
        "all_reduce_sum": lambda x: F.all_reduce(x, "seq"),
        "all_reduce_max": lambda x: F.all_reduce(x, "seq", "max"),
        "all_reduce_min": lambda x: F.all_reduce(x, "seq", "min"),
        "all_reduce_mean": lambda x: F.all_reduce(x, "seq", "mean"),
        "all_gather_0": lambda x: F.all_gather(x, "seq", dim=0),
        "all_gather_1": lambda x: F.all_gather(x, "seq", dim=-1),
        "scatter": lambda x: F.scatter(x, "seq", dim=0),
        "reduce_scatter": lambda x: F.reduce_scatter(x, "seq", dim=0),
        "broadcast": lambda x: F.broadcast(x, "seq", src=1),
        "reduce": lambda x: F.reduce(x, "seq", dst=1),
        "all_to_all": lambda x: F.all_to_all(x, "seq", split_dim=1, concat_dim=0),
        "ppermute": lambda x: F.ppermute(x, "seq", perm),
        "shift_right": lambda x: F.shift_right(x, "seq"),
        "shift_left": lambda x: F.shift_left(x, "seq"),
        "copy_to_tensor_group": lambda x: F.copy_to_tensor_group(x, "seq"),
        "reduce_from_tensor_group": lambda x: F.reduce_from_tensor_group(x, "seq"),
        "gather_from_tensor_group": lambda x: F.gather_from_tensor_group(x, "seq", dim=0),
        "scatter_to_tensor_group": lambda x: F.scatter_to_tensor_group(x, "seq", dim=0),
    }


GRAD_OPS = ("shift_right", "shift_left", "all_to_all", "ppermute",
            "copy_to_tensor_group", "reduce_from_tensor_group",
            "gather_from_tensor_group", "scatter_to_tensor_group")


def collectives_rank(rank, world, xs, cts):
    """Every collective over "seq" on this rank's slice ``xs[rank]``; for
    the ops of GRAD_OPS also the vjp against ``cts[name][rank]``."""
    ctx = ParallelContext(sequence_parallel_size=world, device="cpu")
    try:
        out = {}
        for name, fn in _collective_fns(world).items():
            x = torch.from_numpy(xs[rank]).requires_grad_(name in GRAD_OPS)
            y = fn(x)
            out[name] = y.detach()
            if name in GRAD_OPS:
                y.backward(torch.from_numpy(cts[name][rank]))
                out[name + "/grad"] = x.grad
        F.barrier("seq")
        return out
    finally:
        ctx.destroy()


# -- ring attention ------------------------------------------------------------------

def ring_case(case, axis_name, rank, world):
    """One case through the port on this rank's sequence chunk: (out, dq,
    dk, dv) of the local loss sum((out * w)^2), the global loss being the
    sum over ranks. ``case["kind"]``: "dense" (``ring_attention`` with the
    causal ALiBi bias), "bidirectional", "flash" (``ring_flash_attention``),
    "ulysses" or "ulysses_flash" (``ulysses_causal_attention``)."""
    from pipegoose_tpu_torch.nn.sequence_parallel.ring_attention import (
        make_bidirectional_bias_fn,
        make_causal_alibi_bias_fn,
        ring_attention,
        ring_flash_attention,
    )
    from pipegoose_tpu_torch.nn.sequence_parallel.ulysses import ulysses_causal_attention

    sl = case["q"].shape[1] // world
    part = slice(rank * sl, (rank + 1) * sl)
    q, k, v = (torch.from_numpy(case[n][:, part]).requires_grad_() for n in ("q", "k", "v"))
    pad = torch.from_numpy(case["pad"][:, part])
    slopes = torch.from_numpy(case["slopes"]) if case["slopes"] is not None else None
    apos = torch.from_numpy(case["apos"][:, part]) if case["apos"] is not None else None
    kind = case["kind"]
    if kind == "flash":
        o = ring_flash_attention(q, k, v, axis_name, alibi_slopes=slopes, kv_side=pad,
                                 alibi_pos=apos)
    elif kind.startswith("ulysses"):
        o = ulysses_causal_attention(q, k, v, axis_name, pad, alibi_slopes=slopes,
                                     use_flash=kind == "ulysses_flash",
                                     alibi_pos_local=apos)
    else:
        if kind == "bidirectional":
            bias_fn = make_bidirectional_bias_fn()
        else:
            bias_fn = make_causal_alibi_bias_fn(sl, axis_name, alibi_slopes=slopes,
                                                window=case["window"])
        side = (pad, apos) if apos is not None else pad
        o = ring_attention(q, k, v, axis_name, bias_fn, kv_side=side)
    ((o * pad.float()[:, :, None, None]) ** 2).sum().backward()
    return o.detach(), q.grad, k.grad, v.grad


def ring_rank(rank, world, cases):
    """Every case through ``ring_case`` over the "seq" axis."""
    ctx = ParallelContext(sequence_parallel_size=world, device="cpu")
    try:
        return [ring_case(case, "seq", rank, world) for case in cases]
    finally:
        ctx.destroy()


# -- BLOOM sequence-parallel training --------------------------------------------------

def sp_loss_rank(rank, world, np_tree, cases):
    """Each case's ``loss_fn_sp`` on this rank's chunk and every gradient
    summed over "seq" (``sync_replicated_grads``), as numpy trees in the
    JAX layout."""
    from pipegoose_tpu_torch.models.bloom import loss_fn_sp
    from pipegoose_tpu_torch.models.weights import grads_of, params_from_jax, params_to_jax
    from pipegoose_tpu_torch.parallel.hybrid import sync_replicated_grads
    from pipegoose_tpu_torch.trainer.step import make_optimizer

    ctx = ParallelContext(sequence_parallel_size=world, device="cpu")
    try:
        results = []
        for cfg, ids, mask, labels, variant in cases:
            sl = ids.shape[1] // world
            part = slice(rank * sl, (rank + 1) * sl)
            params = params_from_jax(np_tree, cfg, device="cpu")
            make_optimizer(params, 1e-3)
            loss = loss_fn_sp(
                params, torch.from_numpy(ids[:, part]).long(),
                None if mask is None else torch.from_numpy(mask[:, part]),
                torch.from_numpy(labels[:, part]).long(), cfg, variant=variant)
            loss.backward()
            grads = sync_replicated_grads(grads_of(params), None, (("seq", "sum"),))
            results.append((float(loss), params_to_jax(grads)))
        return results
    finally:
        ctx.destroy()


def sp_train_rank(rank, world, np_tree, cfg, batch, steps, lr, variant):
    """``steps`` calls of ``sp_train_step`` on the full batch; the losses
    and the final params in the JAX layout."""
    from pipegoose_tpu_torch.models.weights import params_from_jax, params_to_jax
    from pipegoose_tpu_torch.trainer import make_optimizer, sp_train_step

    ctx = ParallelContext(sequence_parallel_size=world, device="cpu")
    try:
        params = params_from_jax(np_tree, cfg, device="cpu")
        opt = make_optimizer(params, lr)
        ids, mask, labels = batch
        losses = [float(sp_train_step(params, opt, ids, mask, labels, cfg,
                                      variant=variant, device="cpu"))
                  for _ in range(steps)]
        return losses, params_to_jax(params)
    finally:
        ctx.destroy()


# -- the harness itself -----------------------------------------------------------------

def _hang_on_rank_one(rank, world):
    if rank == 1:
        time.sleep(60)
    return rank


def _raise_on_rank_zero(rank, world):
    if rank == 0:
        raise ValueError("planted failure")
    return torch.ones(2, dtype=torch.bfloat16)


def wrong_world_size_rank(rank, world):
    ParallelContext(sequence_parallel_size=world + 1, device="cpu")


def test_run_ranks_kills_a_hung_rank_and_fails():
    """Rank 1 sleeps 60 s: the 20 s timeout kills it and fails, long before
    the sleep would end (rank 0 may also miss it on a loaded machine)."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] of 2 did not finish"):
        run_ranks(_hang_on_rank_one, 2, timeout=20)
    assert time.monotonic() - t0 < 45


def test_run_ranks_reports_a_rank_failure_with_its_traceback():
    with pytest.raises(RuntimeError, match="planted failure"):
        run_ranks(_raise_on_rank_zero, 2)


def test_collectives_are_no_ops_without_an_axis():
    x = torch.arange(6.0).reshape(2, 3)
    for name in ("all_reduce", "all_gather", "reduce_scatter", "scatter"):
        assert getattr(F, name)(x, None) is x
    assert F.shift_right(x, None) is x and F.all_to_all(x, None, 0, 1) is x
    assert F.axis_size(None) == 1 and F.axis_index(None) == 0
    with pytest.raises(RuntimeError, match="needs a ParallelContext"):
        F.all_reduce(x, "seq")
