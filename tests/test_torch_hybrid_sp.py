"""The port's ``loss_fn_sp`` under sequence x tensor parallelism held against
the JAX package on the CPU: sp 2 x tp 2 on 4 gloo ranks, the loss and every
gradient, summed over "seq" and gathered whole over "tensor", against JAX
``loss_fn_sp`` under ``shard_map`` on a (seq, tensor) mesh with the same
sync, as ``tests/models/test_bloom_sp.py`` composes it, and against the
port's single-device ``loss_fn``. Cases: the dense ring on a right-padded
mask; the flash ring with fused CE and full remat on a left-padded mask
(remat reruns the forward's tensor all-reduce in backward); flash Ulysses
with no mask.

Tiny BLOOM (vocab 128, hidden 64, 2 layers, 4 heads: 2 a tensor rank),
B = 2 x S = 16, with nonzero LayerNorm and bias leaves, float32. Loss and
gradients 2e-6 absolute, as ``test_torch_sp_train.py``'s. The ranks' body
lives in ``test_torch_hybrid_ranks.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pipegoose_tpu.distributed.compat import shard_map
from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.parallel.hybrid import sync_replicated_grads
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import grads_of, params_from_jax, params_to_jax
from pipegoose_tpu_torch.testing.dist import run_ranks
from pipegoose_tpu_torch.trainer import make_optimizer
from test_torch_hybrid_ranks import sp_tp_loss_rank

LOSS_ATOL = 2e-6
GRAD_ATOL = 2e-6
SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)

SP_TP_CASES = {   # name -> (config options, mask, variant)
    "dense_right_pad": (dict(), "right", "ring"),
    "flash_fused_ce_remat_left_pad": (dict(use_flash=True, fused_ce=True, remat=True),
                                      "left", "ring"),
    "ulysses_flash_no_mask": (dict(use_flash=True), None, "ulysses"),
}
SP_TP_NAMES = sorted(SP_TP_CASES)
SB, SS = 2, 16


@functools.lru_cache(maxsize=None)
def _sp_data():
    np_tree = tbloom.init_params_numpy(tbloom.BloomConfig(**SIZE), seed=0)
    rng = np.random.default_rng(1)
    for ln in (np_tree["embed_ln"], np_tree["ln_f"], np_tree["blocks"]["ln_1"],
               np_tree["blocks"]["ln_2"]):
        for name in ("scale", "bias"):
            ln[name] += rng.standard_normal(ln[name].shape, dtype=np.float32) * 0.1
    for group, subs in (("attn", ("qkv", "out")), ("mlp", ("up", "down"))):
        for sub in subs:
            b = np_tree["blocks"][group][sub]["bias"]
            b += rng.standard_normal(b.shape, dtype=np.float32) * 0.1
    ids = rng.integers(0, SIZE["vocab_size"], (SB, SS)).astype(np.int32)
    labels = rng.integers(0, SIZE["vocab_size"], (SB, SS)).astype(np.int32)
    right = np.ones((SB, SS), np.int32)
    right[1, SS - 5:] = 0
    left = np.ones((SB, SS), np.int32)
    left[0, :6] = 0
    return np_tree, ids, labels, {None: None, "right": right, "left": left}


def _jax_sp_tp_fn(jcfg, variant, with_mask, np_tree):
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("seq", "tensor"))
    specs = jbloom.tp_specs(np_tree)

    def body(p, ids, labels, *mask):
        m = mask[0] if with_mask else None
        loss, g = jax.value_and_grad(jbloom.loss_fn_sp)(
            p, ids, m, labels, jcfg, tp_axis="tensor", sp_axis="seq", variant=variant)
        return loss, sync_replicated_grads(g, specs, (("seq", "sum"),))

    seq = P(None, "seq")
    return jax.jit(shard_map(body, mesh=mesh,
                             in_specs=(specs, seq, seq) + ((seq,) if with_mask else ()),
                             out_specs=(P(), specs), check_vma=False))


def _close_trees(got, want, atol, what):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_sp_tp_loss_and_every_grad_match_jax_and_the_single_device_loss(devices):
    np_tree, ids, labels, masks = _sp_data()
    cases = [(tbloom.BloomConfig(**SIZE, **SP_TP_CASES[n][0]), ids,
              masks[SP_TP_CASES[n][1]], labels, SP_TP_CASES[n][2]) for n in SP_TP_NAMES]
    ranks = run_ranks(sp_tp_loss_rank, 4, np_tree, cases)
    jtree = jax.tree_util.tree_map(jnp.asarray, np_tree)
    for i, name in enumerate(SP_TP_NAMES):
        opts, mask_name, variant = SP_TP_CASES[name]
        mask = masks[mask_name]
        loss, grads = ranks[0][i]
        for r in ranks[1:]:
            assert r[i][0] == loss, name   # every rank returns the global loss
            _close_trees(r[i][1], grads, 0.0, f"{name}: a rank vs rank 0")
        jloss, jgrads = _jax_sp_tp_fn(jbloom.BloomConfig(**SIZE, **opts), variant,
                                      mask is not None, np_tree)(
            jtree, ids, labels, *([mask] if mask is not None else []))
        assert abs(loss - float(jloss)) <= LOSS_ATOL, (name, loss, float(jloss))
        _close_trees(grads, jgrads, GRAD_ATOL, f"{name} vs JAX")
        tcfg = tbloom.BloomConfig(**SIZE, **opts)
        params = params_from_jax(np_tree, tcfg, device="cpu")
        make_optimizer(params, 1e-3)
        ref = tbloom.loss_fn(params, torch.from_numpy(ids).long(),
                             None if mask is None else torch.from_numpy(mask),
                             torch.from_numpy(labels).long(), tcfg)
        ref.backward()
        assert abs(loss - ref.item()) <= LOSS_ATOL, (name, loss, ref.item())
        _close_trees(grads, params_to_jax(grads_of(params)), GRAD_ATOL,
                     f"{name} vs loss_fn")
