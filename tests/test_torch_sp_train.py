"""The port's sequence-parallel BLOOM training held against the JAX package
on the CPU, at sp = 2 on gloo ranks:

- ``loss_fn_sp`` and every gradient, summed over "seq" by
  ``sync_replicated_grads``, against JAX ``loss_fn_sp`` under ``shard_map``
  with the same sync, and against the port's single-device ``loss_fn`` on
  the whole sequence. Cases: the dense and the flash ring, ``fused_ce`` on
  and off, full remat, no mask, a right-padded and a left-padded mask, and
  ``variant="ulysses"`` dense and flash;
- three ``sp_train_step`` calls against three JAX steps of the same
  composition (``value_and_grad(loss_fn_sp)``, the sync, ``optax.adam``):
  the losses and the final params.

Tiny BLOOM (vocab 128, hidden 64, 2 layers, 4 heads), B = 2 x S = 16, with
nonzero LayerNorm and bias leaves; weights and data from a numpy seed,
float32 throughout. The ranks' bodies live in ``test_torch_sp_ranks.py``.

Tolerances, as ``test_torch_train.py``'s: loss and gradients 2e-6
absolute (the same float32 products summed in another order); after three
Adam steps the params 2e-5 (lr / 50) and the losses 1e-5, since Adam
divides a gradient near zero by its own small root-mean-square.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pipegoose_tpu.distributed.compat import shard_map
from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.parallel.hybrid import sync_replicated_grads
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import grads_of, params_from_jax, params_to_jax
from pipegoose_tpu_torch.testing.dist import run_ranks
from pipegoose_tpu_torch.trainer import make_optimizer
from test_torch_sp_ranks import sp_loss_rank, sp_train_rank

LOSS_ATOL = 2e-6
GRAD_ATOL = 2e-6
ADAM_PARAM_ATOL = 2e-5
ADAM_LOSS_ATOL = 1e-5
LR = 1e-3
SP = 2
SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
B, S = 2, 16

CASES = {   # name -> (config options, mask, variant)
    "dense_right_pad": (dict(), "right", "ring"),
    "flash_right_pad": (dict(use_flash=True), "right", "ring"),
    "flash_fused_ce_no_mask": (dict(use_flash=True, fused_ce=True), None, "ring"),
    "dense_fused_ce_remat_left_pad": (dict(fused_ce=True, remat=True), "left", "ring"),
    "flash_remat_left_pad": (dict(use_flash=True, remat=True), "left", "ring"),
    "ulysses_dense_right_pad": (dict(), "right", "ulysses"),
    "ulysses_flash_left_pad": (dict(use_flash=True), "left", "ulysses"),
}
NAMES = sorted(CASES)
TRAIN = (dict(use_flash=True, fused_ce=True, remat=True), "right", "ring")


@functools.lru_cache(maxsize=None)
def _data():
    """Weights with nonzero LayerNorm and bias leaves, ids, labels, and
    the masks by name."""
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
    ids = rng.integers(0, SIZE["vocab_size"], (B, S)).astype(np.int32)
    labels = rng.integers(0, SIZE["vocab_size"], (B, S)).astype(np.int32)
    right = np.ones((B, S), np.int32)
    right[1, S - 5:] = 0
    left = np.ones((B, S), np.int32)
    left[0, :6] = 0
    left[1, :1] = 0
    return np_tree, ids, labels, {None: None, "right": right, "left": left}


def _cfgs(opts):
    return jbloom.BloomConfig(**SIZE, **opts), tbloom.BloomConfig(**SIZE, **opts)


def _close_trees(got, want, atol, what):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _jax_sp_fn(jcfg, variant, with_mask):
    """jit(shard_map) of (loss, grads summed over "seq") of JAX loss_fn_sp."""
    mesh = Mesh(np.array(jax.devices()[:SP]), ("seq",))
    specs = jax.tree_util.tree_map(lambda _: P(), _data()[0])

    def body(p, ids, labels, *mask):
        m = mask[0] if with_mask else None
        loss, g = jax.value_and_grad(jbloom.loss_fn_sp)(p, ids, m, labels, jcfg,
                                                        sp_axis="seq", variant=variant)
        return loss, sync_replicated_grads(g, specs, (("seq", "sum"),))

    seq = P(None, "seq")
    return jax.jit(shard_map(body, mesh=mesh,
                             in_specs=(specs, seq, seq) + ((seq,) if with_mask else ()),
                             out_specs=(P(), specs), check_vma=False))


def test_sp_loss_and_every_grad_match_jax_and_the_single_device_loss(devices):
    """Every case of CASES; the two ranks run all of them in one spawn."""
    np_tree, ids, labels, masks = _data()
    cases = [(_cfgs(CASES[n][0])[1], ids, masks[CASES[n][1]], labels, CASES[n][2])
             for n in NAMES]
    ranks = run_ranks(sp_loss_rank, SP, np_tree, cases)
    jtree = jax.tree_util.tree_map(jnp.asarray, np_tree)
    for i, name in enumerate(NAMES):
        opts, mask_name, variant = CASES[name]
        mask = masks[mask_name]
        jcfg, tcfg = _cfgs(opts)
        (loss, grads), (loss1, grads1) = (r[i] for r in ranks)
        assert loss == loss1, name   # every rank returns the global loss
        _close_trees(grads1, grads, 0.0, f"{name}: rank 1 vs rank 0")
        jloss, jgrads = _jax_sp_fn(jcfg, variant, mask is not None)(
            jtree, ids, labels, *([mask] if mask is not None else []))
        assert abs(loss - float(jloss)) <= LOSS_ATOL, (name, loss, float(jloss))
        _close_trees(grads, jgrads, GRAD_ATOL, f"{name} vs JAX")
        # the port's single-device loss on the whole sequence
        params = params_from_jax(np_tree, tcfg, device="cpu")
        make_optimizer(params, LR)
        ref = tbloom.loss_fn(params, torch.from_numpy(ids).long(),
                             None if mask is None else torch.from_numpy(mask),
                             torch.from_numpy(labels).long(), tcfg)
        ref.backward()
        assert abs(loss - ref.item()) <= LOSS_ATOL, (name, loss, ref.item())
        _close_trees(grads, params_to_jax(grads_of(params)), GRAD_ATOL,
                     f"{name} vs loss_fn")


def test_three_sp_train_steps_match_jax_adam(devices):
    np_tree, ids, labels, masks = _data()
    opts, mask_name, variant = TRAIN
    mask = masks[mask_name]
    jcfg, tcfg = _cfgs(opts)
    step_fn = _jax_sp_fn(jcfg, variant, True)
    opt = optax.adam(LR)
    p = jax.tree_util.tree_map(jnp.asarray, np_tree)
    state = opt.init(p)
    want_losses = []
    for _ in range(3):
        loss, g = step_fn(p, ids, labels, mask)
        updates, state = opt.update(g, state, p)
        p = optax.apply_updates(p, updates)
        want_losses.append(float(loss))
    ranks = run_ranks(sp_train_rank, SP, np_tree, tcfg, (ids, mask, labels), 3, LR,
                      variant)
    for losses, params in ranks:
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=ADAM_LOSS_ATOL)
        _close_trees(params, p, ADAM_PARAM_ATOL, "params after 3 steps")
    assert want_losses[-1] < want_losses[0]
