"""The port's BLOOM-MoE held against the JAX package on the CPU.

``bloom_moe.loss_fn`` and every parameter gradient against
``jax.value_and_grad(bloom_moe.loss_fn)``, and ``forward_hidden``'s per-layer
aux and z losses against JAX's, on ``tests/models/test_bloom_moe.py``'s
config (vocab 128, hidden 64, 2 layers, 4 heads, 4 experts), B = 8 x S = 12
with row 1 right-padded (its pads route and take capacity, as in JAX), for
top-1 and top-2, capacity factor 4.0 and 1.0 (tokens drop, counted), remat
on and off, no mask, and flash attention (the JAX kernels in interpret
mode); ``tests/test_torch_train.py``'s tolerances (loss and gradients 2e-6
absolute). No router noise there: its draws cannot match JAX's. With
noise: the same seed gives the same loss, another seed another, and remat
gives the gradients of no remat bit for bit (the noise is drawn inside the
rematerialized block from its seed). Also: ``params_from_jax`` /
``params_to_jax`` round-trip the MoE tree exactly; ``fused_ce`` or
``ce_chunks`` on the config raise, and so does ``train=True`` with noise
and no rng.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import bloom_moe as jmoe
from pipegoose_tpu_torch.models import bloom_moe as tmoe
from pipegoose_tpu_torch.models.weights import (
    grads_of,
    param_leaves,
    params_from_jax,
    params_to_jax,
)

LOSS_ATOL = 2e-6   # tests/test_torch_train.py
GRAD_ATOL = 2e-6
SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4, num_experts=4)
B, S, PAD = 8, 12, 5


def _tree():
    """MoE weights with nonzero LayerNorm and bias leaves."""
    tree = tmoe.init_params_numpy(tmoe.BloomMoEConfig(**SIZE), seed=0)
    rng = np.random.default_rng(1)
    blocks = tree["blocks"]
    for ln in (tree["embed_ln"], tree["ln_f"], blocks["ln_1"], blocks["ln_2"]):
        for name in ("scale", "bias"):
            ln[name] += rng.standard_normal(ln[name].shape, dtype=np.float32) * 0.1
    for b in (blocks["attn"]["qkv"]["bias"], blocks["attn"]["out"]["bias"],
              blocks["moe"]["up"]["bias"], blocks["moe"]["down"]["bias"]):
        b += rng.standard_normal(b.shape, dtype=np.float32) * 0.1
    return tree


TREE = _tree()
IDS = np.random.RandomState(5).randint(0, SIZE["vocab_size"], (B, S)).astype(np.int32)
MASK = np.ones((B, S), np.int32)
MASK[1, S - PAD:] = 0


def _cfgs(**kw):
    kw = dict(SIZE, router_noise_eps=0.0, **kw)
    return jmoe.BloomMoEConfig(**kw), tmoe.BloomMoEConfig(**kw)


def _port(cfg, mask, monkeypatch=None, rng=None, train=False):
    """The port's loss, gradients (JAX layout) and the tokens each layer's
    router dropped."""
    dropped = []
    if monkeypatch is not None:
        inner = tmoe.moe_layer

        def recording(expert_params, x, routing, *a, **kw):
            dropped.append(int((routing.dispatch.sum(dim=(1, 2)) < cfg.top_k).sum()))
            return inner(expert_params, x, routing, *a, **kw)

        monkeypatch.setattr(tmoe, "moe_layer", recording)
    params = params_from_jax(TREE, cfg, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_(True)
    loss = tmoe.loss_fn(params, torch.from_numpy(IDS).long(),
                        None if mask is None else torch.from_numpy(mask),
                        torch.from_numpy(IDS).long(), cfg, rng=rng, train=train)
    loss.backward()
    return loss.item(), params_to_jax(grads_of(params)), dropped


def _assert_trees_close(got, want, atol):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


CASES = {   # name -> (config options, mask)
    **{f"top{k}_cf{cf}{'_remat' if remat else ''}":
       (dict(top_k=k, capacity_factor=cf, remat=remat), MASK)
       for k in (1, 2) for cf in (4.0, 1.0) for remat in (False, True)},
    "top2_cf1.0_nomask": (dict(top_k=2, capacity_factor=1.0), None),
    "top2_cf1.0_remat_flash": (dict(top_k=2, capacity_factor=1.0, remat=True,
                                    use_flash=True), MASK),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_every_grad_and_router_losses_match_jax(case, monkeypatch):
    opts, mask = CASES[case]
    jcfg, tcfg = _cfgs(**opts)
    jmask = None if mask is None else jnp.asarray(mask)
    jparams = jax.tree_util.tree_map(jnp.asarray, TREE)
    jloss, jgrads = jax.value_and_grad(jmoe.loss_fn)(
        jparams, jnp.asarray(IDS), jmask, jnp.asarray(IDS), jcfg, train=False)
    loss, grads, dropped = _port(tcfg, mask, monkeypatch)
    assert abs(loss - float(jloss)) <= LOSS_ATOL, (loss, float(jloss))
    _assert_trees_close(grads, jgrads, GRAD_ATOL)
    # the backward's recompute routes every rematerialized block again, the
    # last layer first, and drops the same tokens
    assert len(dropped) == SIZE["n_layer"] * (2 if opts.get("remat") else 1)
    if opts.get("remat"):
        assert dropped[SIZE["n_layer"]:] == dropped[:SIZE["n_layer"]][::-1]
    dropped = dropped[:SIZE["n_layer"]]
    if opts["capacity_factor"] < 4:   # the case meant to drop does
        assert sum(dropped) > 0, dropped
    else:
        assert sum(dropped) == 0, dropped
    # forward_hidden's per-layer router losses
    _, jaux, jz = jmoe.forward_hidden(jparams, jnp.asarray(IDS), jmask, jcfg)
    params = params_from_jax(TREE, tcfg, device="cpu")
    with torch.no_grad():
        hidden, aux, z = tmoe.forward_hidden(
            params, torch.from_numpy(IDS).long(),
            None if mask is None else torch.from_numpy(mask), tcfg)
    assert hidden.shape == (B, S, SIZE["hidden_size"])
    assert aux.shape == z.shape == (SIZE["n_layer"],)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0,
                               atol=LOSS_ATOL * float(np.abs(np.asarray(jz)).max()))


def test_router_noise_follows_the_seed_and_survives_remat():
    _, cfg = _cfgs(top_k=2, capacity_factor=1.0)
    cfg = dataclasses.replace(cfg, router_noise_eps=0.5)
    clean, _, _ = _port(dataclasses.replace(cfg, router_noise_eps=0.0), MASK)
    a, ga, _ = _port(cfg, MASK, rng=3, train=True)
    b, _, _ = _port(cfg, MASK, rng=3, train=True)
    c, _, _ = _port(cfg, MASK, rng=4, train=True)
    assert a == b and a != c and a != clean
    # the rematerialized blocks draw the same noise in the backward's recompute
    r, gr, _ = _port(dataclasses.replace(cfg, remat=True), MASK, rng=3, train=True)
    assert r == a
    for x, y in zip(jax.tree_util.tree_leaves(gr), jax.tree_util.tree_leaves(ga)):
        np.testing.assert_array_equal(x, y)
    # train=False routes without noise whatever the rng
    d, _, _ = _port(cfg, MASK, rng=3, train=False)
    assert d == clean


def test_params_round_trip_the_moe_tree_exactly():
    _, cfg = _cfgs()
    params = params_from_jax(TREE, cfg, device="cpu")
    assert len(params["blocks"]) == SIZE["n_layer"]
    blk = params["blocks"][1]
    assert set(blk) == {"ln_1", "attn", "ln_2", "moe", "router"}
    assert blk["moe"]["up"]["kernel"].shape == (4, 64, 256)
    assert blk["router"]["gate"]["kernel"].shape == (64, 4)
    back = params_to_jax(params)
    paths = jax.tree_util.tree_flatten_with_path(TREE)[0]
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(paths)
    for (path, w), g in zip(paths, got):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    # the params own their storage
    blk["moe"]["up"]["kernel"].add_(1.0)
    assert float(np.abs(TREE["blocks"]["moe"]["up"]["kernel"][1]).max()) < 1.0


def test_init_params_numpy_layout_and_seed():
    cfg = tmoe.BloomMoEConfig(**SIZE)
    a, b = tmoe.init_params_numpy(cfg, 0), tmoe.init_params_numpy(cfg, 1)
    assert "mlp" not in a["blocks"]
    assert a["blocks"]["moe"]["down"]["kernel"].shape == (2, 4, 256, 64)
    assert a["blocks"]["router"]["gate"]["kernel"].shape == (2, 64, 4)
    assert not np.array_equal(a["blocks"]["moe"]["up"]["kernel"],
                              b["blocks"]["moe"]["up"]["kernel"])
    jtree = jax.eval_shape(lambda: jmoe.init_params(jmoe.BloomMoEConfig(**SIZE),
                                                    jax.random.PRNGKey(0)))
    assert (jax.tree_util.tree_structure(jtree)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(jnp.asarray, a)))
    for x, y in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(a)):
        assert x.shape == y.shape


@pytest.mark.parametrize("opt", [dict(fused_ce=True), dict(ce_chunks=4)],
                         ids=["fused_ce", "ce_chunks"])
def test_loss_refuses_fused_and_chunked_ce(opt):
    _, cfg = _cfgs(**opt)
    params = params_from_jax(TREE, cfg, device="cpu")
    ids = torch.from_numpy(IDS).long()
    with pytest.raises(ValueError, match="full logits"):
        tmoe.loss_fn(params, ids, None, ids, cfg, train=False)


def test_train_with_noise_needs_an_rng():
    cfg = tmoe.BloomMoEConfig(**SIZE)   # router_noise_eps 0.1
    params = params_from_jax(TREE, cfg, device="cpu")
    ids = torch.from_numpy(IDS).long()
    with pytest.raises(ValueError, match="explicit rng"):
        tmoe.loss_fn(params, ids, None, ids, cfg, train=True)
    with torch.no_grad():   # no noise, no rng needed
        tmoe.loss_fn(params, ids, None, ids, dataclasses.replace(cfg, router_noise_eps=0.0),
                     train=True)
