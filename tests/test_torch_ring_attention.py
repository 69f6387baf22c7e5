"""The port's sequence-parallel attention held against the JAX package on
the CPU: ``ring_attention`` (dense, plain autograd through the ring),
``ring_flash_attention`` (the chunk kernels' plain versions, with the
``_RingFlash`` gradient ring) and ``ulysses_causal_attention``, forward
and q/k/v gradients, at ``axis_name=None`` and over 2 and 4 ranks.

The cases mirror ``tests/nn/sequence_parallel/test_ring_attention.py``:
ALiBi with right padding, left padding with mask-aware ``alibi_pos``, GQA
(with a sliding window on the dense ring), ``make_bidirectional_bias_fn``,
and Ulysses dense and flash. The port runs on gloo ranks
(``testing.dist.run_ranks``, bodies in ``test_torch_sp_ranks.py``), JAX
under ``shard_map`` on the fake CPU devices with the Pallas kernels in
interpret mode. The loss is sum((out * mask)^2), each rank's over its own
queries; outputs are compared on unpadded queries (a padded query's row
is finite garbage that the models zero), gradients everywhere.

Tolerance 2e-5 absolute: the same float32 products summed in another
order, outputs and gradients of order 1-10.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from pipegoose_tpu.distributed.compat import shard_map
from pipegoose_tpu.models.bloom import alibi_slopes
from pipegoose_tpu.nn.sequence_parallel.ring_attention import (
    make_bidirectional_bias_fn,
    make_causal_alibi_bias_fn,
    ring_attention,
    ring_flash_attention,
)
from pipegoose_tpu.nn.sequence_parallel.ulysses import ulysses_causal_attention
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_sp_ranks import ring_case, ring_rank

ATOL = 2e-5
B, S, NH = 2, 32, 4

CASES = {   # name -> (kind, nkv, hd, pad, window, alibi)
    "dense_alibi_right_pad": ("dense", 4, 8, "right", None, True),
    "dense_alibi_left_pad": ("dense", 4, 8, "left", None, True),
    "dense_gqa_window": ("dense", 2, 8, "right", 12, False),
    "bidirectional": ("bidirectional", 4, 8, "right", None, False),
    "flash_alibi_right_pad": ("flash", 4, 64, "right", None, True),
    "flash_alibi_left_pad": ("flash", 4, 64, "left", None, True),
    "flash_gqa": ("flash", 2, 64, "right", None, False),
    "ulysses_alibi": ("ulysses", 4, 8, "right", None, True),
    "ulysses_flash_left_pad": ("ulysses_flash", 4, 64, "left", None, True),
}
NAMES = sorted(CASES)


def _case(name, seed=0):
    kind, nkv, hd, pad, window, alibi = CASES[name]
    rng = np.random.default_rng(seed)
    f = lambda h: rng.standard_normal((B, S, h, hd), dtype=np.float32)  # noqa: E731
    mask = np.ones((B, S), np.int32)
    if pad == "right":
        mask[1, S - 6:] = 0
    else:
        mask[0, :5] = 0
        mask[1, :2] = 0
    apos = ((np.cumsum(mask, -1) - 1) * mask).astype(np.float32) if pad == "left" else None
    return {"kind": kind, "q": f(NH), "k": f(nkv), "v": f(nkv), "pad": mask,
            "slopes": alibi_slopes(NH) if alibi else None, "apos": apos,
            "window": window}


def _jax_attn(case, q, k, v, pad, apos, axis, s_local):
    kind = case["kind"]
    slopes = None if case["slopes"] is None else jnp.asarray(case["slopes"])
    apos = apos if case["apos"] is not None else None
    if kind == "flash":
        return ring_flash_attention(q, k, v, axis, alibi_slopes=slopes, kv_side=pad,
                                    interpret=True, alibi_pos=apos)
    if kind.startswith("ulysses"):
        return ulysses_causal_attention(q, k, v, axis, pad, alibi_slopes=slopes,
                                        use_flash=kind == "ulysses_flash",
                                        alibi_pos_local=apos)
    if kind == "bidirectional":
        bias_fn = make_bidirectional_bias_fn()
    else:
        bias_fn = make_causal_alibi_bias_fn(s_local, axis, alibi_slopes=slopes,
                                            window=case["window"])
    side = (pad, apos) if apos is not None else pad
    return ring_attention(q, k, v, axis, bias_fn, kv_side=side)


def _jax_run(case, world):
    """JAX (out, dq, dk, dv) of the summed per-rank losses."""
    apos = case["apos"] if case["apos"] is not None else np.zeros((B, S), np.float32)

    def body(q, k, v, pad, apos, axis, s_local):
        def loss(qkv):
            o = _jax_attn(case, *qkv, pad, apos, axis, s_local)
            return ((o * pad.astype(o.dtype)[:, :, None, None]) ** 2).sum(), o
        (_, o), grads = jax.value_and_grad(loss, has_aux=True)((q, k, v))
        return (o, *grads)

    args = (case["q"], case["k"], case["v"], case["pad"], apos)
    if world is None:
        return jax.jit(functools.partial(body, axis=None, s_local=S))(*args)
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    f = shard_map(functools.partial(body, axis="seq", s_local=S // world), mesh=mesh,
                  in_specs=(P(None, "seq"),) * 5, out_specs=(P(None, "seq"),) * 4,
                  check_vma=False)
    return jax.jit(f)(*args)


def _port(world):
    """The port's (out, dq, dk, dv) per case, the ranks' chunks joined."""
    cases = [_case(n) for n in NAMES]
    if world is None:
        return [tuple(t.numpy() for t in ring_case(c, None, 0, 1)) for c in cases]
    per_rank = run_ranks(ring_rank, world, cases)
    return [tuple(np.concatenate([r[i][j] for r in per_rank], axis=1) for j in range(4))
            for i in range(len(cases))]


@pytest.mark.parametrize("world", [None, 2, 4], ids=["single", "sp2", "sp4"])
def test_ring_attention_and_grads_match_jax(devices, world):
    """Every case; the ranks of one world run in one spawn. Ulysses needs a
    named axis (in JAX as here), so it has no single-device case."""
    port = _port(world)
    for name, got in zip(NAMES, port):
        case = _case(name)
        if world is None and case["kind"].startswith("ulysses"):
            continue
        want = [np.asarray(x) for x in _jax_run(case, world)]
        valid = case["pad"].astype(bool)
        np.testing.assert_allclose(got[0][valid], want[0][valid], rtol=0, atol=ATOL,
                                   err_msg=f"{name} out")
        for what, a, b_ in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            assert np.isfinite(a).all(), f"{name} {what}"
            np.testing.assert_allclose(a, b_, rtol=0, atol=ATOL, err_msg=f"{name} {what}")
