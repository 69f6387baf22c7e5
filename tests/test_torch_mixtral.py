"""The port's Mixtral held against the JAX package on the CPU.

- ``mixtral.loss_fn`` (task loss plus the layer means of the routers' aux
  and z losses), ``forward``'s logits and per-layer aux / z, and every
  parameter gradient against JAX's: dense and flash attention (the JAX
  kernels as its tests run them on the CPU, the port's plain versions),
  ``fused_ce`` ("hv" head), remat, no mask, a capacity factor that drops
  tokens, GQA at g = 2 and 4, and a sliding window (4) on the dense route
  and on the flash route;
- greedy ``generate`` token for token, with and without the window;
- ``upcycle_from_llama``: the upcycled forward equals the dense Llama's at
  2e-5, a tied Llama gets its head materialized, and the tree through
  ``params_to_jax`` equals JAX's ``upcycle_from_llama`` at ``jitter=0``
  (every leaf but the fresh router gate, whose draws cannot match JAX's:
  its shape and spread are checked instead);
- ``specs`` and ``pp_specs`` equal to JAX's; router jitter refuses
  ``train=True`` without an rng and follows its seed.

Config as ``tests/models/test_mixtral.py``'s widths (vocab 128, hidden 64,
FFN 112, 2 layers, 4 heads over 2 KV heads, 4 experts, top-2), z weight 0.01
so that z reaches the loss; B = 2 x S = 10 with row 1 right-padded by 3;
weights from ``init_params_numpy`` (numpy seed 0), float32. Tolerances: loss,
logits, aux and z 2e-5 absolute, every gradient 2e-5 of its leaf's largest
value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import llama as jl
from pipegoose_tpu.models import mixtral as jm
from pipegoose_tpu_torch.models import llama as tl
from pipegoose_tpu_torch.models import mixtral as tm
from pipegoose_tpu_torch.models.weights import (
    grads_of,
    param_leaves,
    params_from_jax,
    params_to_jax,
)
from test_torch_llama import LOSS_ATOL, GRAD_REL, IDS, MASK, assert_grads_close

SIZE = dict(vocab_size=128, hidden_size=64, intermediate_size=112, n_layer=2,
            n_head=4, n_kv_head=2, num_experts=4, top_k=2, z_loss_weight=0.01)
G4 = dict(SIZE, n_head=8)


def _cfgs(size=SIZE, **kw):
    return jm.MixtralConfig(**size, **kw), tm.MixtralConfig(**size, **kw)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ids(mask):
    return (torch.from_numpy(IDS).long(),
            None if mask is None else torch.from_numpy(mask))


CASES = {   # name -> (size, config options, mask)
    "dense": (SIZE, {}, MASK),
    "flash": (SIZE, dict(use_flash=True), MASK),
    "fused_ce": (SIZE, dict(fused_ce=True), MASK),
    "flash_fused_ce_remat": (SIZE, dict(use_flash=True, fused_ce=True, remat=True), MASK),
    "nomask": (SIZE, {}, None),
    "capacity_1.0_drops": (SIZE, dict(capacity_factor=1.0), MASK),
    "g4_flash": (G4, dict(use_flash=True), MASK),
    "window_dense": (SIZE, dict(sliding_window=4), MASK),
    "window_flash": (SIZE, dict(sliding_window=4, use_flash=True, fused_ce=True), MASK),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_router_losses_logits_and_every_grad_match_jax(case):
    size, opts, mask = CASES[case]
    jcfg, tcfg = _cfgs(size, **opts)
    tree = tm.init_params_numpy(tcfg, seed=0)
    jmask = None if mask is None else jnp.asarray(mask)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(
        _j(tree), jnp.asarray(IDS), jmask, jnp.asarray(IDS), jcfg, train=False)
    jlogits, jaux, jz = jm.forward(_j(tree), jnp.asarray(IDS), jmask, jcfg)
    params = params_from_jax(tree, tcfg, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_(True)
    ids, m = _ids(mask)
    loss = tm.loss_fn(params, ids, m, ids, tcfg, train=False)
    loss.backward()
    with torch.no_grad():
        logits, aux, z = tm.forward(params, ids, m, tcfg)
    assert abs(loss.item() - float(jloss)) <= LOSS_ATOL, (loss.item(), float(jloss))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=LOSS_ATOL)
    assert_grads_close(params_to_jax(grads_of(params)), jgrads, GRAD_REL, case)
    if "window" in case:   # the window changes the result
        _, nowin = _cfgs(size, **{k: v for k, v in opts.items() if k != "sliding_window"})
        with torch.no_grad():
            other = tm.forward(params, ids, m, nowin)[0]
        assert (other - logits).abs().max() > 1e-4


@pytest.mark.parametrize("window", [None, 3])
def test_greedy_generate_matches_jax_token_for_token(window):
    jcfg, tcfg = _cfgs(sliding_window=window)
    tree = tm.init_params_numpy(tcfg, seed=0)
    prompt = IDS[:, :6]
    want = np.asarray(jm.generate(_j(tree), jnp.asarray(prompt), jcfg, max_new_tokens=6))
    params = params_from_jax(tree, tcfg, device="cpu")
    got = tm.generate(params, prompt, tcfg, max_new_tokens=6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=112, n_layer=2,
             n_head=4, n_kv_head=2)


@pytest.mark.parametrize("tied", [False, True])
def test_upcycle_from_llama(tied):
    lcfg = tl.LlamaConfig(**LLAMA, tie_word_embeddings=tied)
    tree = tl.init_params_numpy(lcfg, seed=0)
    dense = params_from_jax(tree, lcfg, device="cpu")
    cfg, params = tm.upcycle_from_llama(dense, lcfg, num_experts=4, top_k=2, key=7)
    assert "lm_head" in params and len(params["blocks"]) == 2
    ids, m = _ids(MASK)
    with torch.no_grad():
        want = tl.forward(dense, ids, m, lcfg)
        got, _, _ = tm.forward(params, ids, m, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    jlcfg = jl.LlamaConfig(**LLAMA, tie_word_embeddings=tied)
    jcfg, jparams = jm.upcycle_from_llama(_j(tree), jlcfg, num_experts=4, top_k=2,
                                          key=jax.random.PRNGKey(7), jitter=0.0)
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    back = params_to_jax(params)
    gate, jgate = back["blocks"].pop("router"), dict(jparams["blocks"]).pop("router")
    jrest = dict(jparams)
    jrest["blocks"] = {k: v for k, v in jparams["blocks"].items() if k != "router"}
    paths = jax.tree_util.tree_flatten_with_path(jrest)[0]
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(back)[0]}
    assert len(paths) == len(flat)
    for path, w in paths:
        np.testing.assert_array_equal(flat[jax.tree_util.keystr(path)], np.asarray(w))
    g = gate["gate"]["kernel"]
    assert g.shape == np.asarray(jgate["gate"]["kernel"]).shape == (2, 64, 4)
    assert 0.015 < float(g.std()) < 0.025
    # a seeded jitter perturbs every expert and keeps the shapes
    _, jittered = tm.upcycle_from_llama(dense, lcfg, num_experts=4, key=7, jitter=0.1)
    w, w0 = jittered["blocks"][0]["moe"]["w1"]["kernel"], params["blocks"][0]["moe"]["w1"]["kernel"]
    assert w.shape == w0.shape and not torch.equal(w, w0)
    assert not torch.equal(w[0], w[1])


def test_specs_equal_jax():
    jcfg, tcfg = _cfgs()
    tree = tm.init_params_numpy(tcfg, seed=0)
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)   # noqa: E731
    for jfn, tfn in ((jm.specs, tm.specs), (jm.pp_specs, tm.pp_specs)):
        want = jax.tree_util.tree_flatten_with_path(jfn(_j(tree)), is_leaf=is_p)[0]
        got = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(
            tfn(tree), is_leaf=lambda x: isinstance(x, tuple))[0]}
        assert len(want) == len(got)
        for path, spec in want:
            assert tuple(spec) == got[jax.tree_util.keystr(path)], path
    per_layer = tm.specs(params_from_jax(tree, tcfg, device="cpu"))
    blk = per_layer["blocks"][1]
    assert blk["moe"]["w1"]["kernel"] == ("expert", None, "tensor")
    assert blk["moe"]["w2"]["kernel"] == ("expert", "tensor", None)
    assert blk["router"]["gate"]["kernel"] == ()
    assert per_layer["lm_head"]["kernel"] == (None, "tensor")


def test_router_jitter_needs_an_rng_and_follows_its_seed():
    _, cfg = _cfgs(router_jitter=0.5, capacity_factor=1.0)
    params = params_from_jax(tm.init_params_numpy(cfg, 0), cfg, device="cpu")
    ids, m = _ids(MASK)
    with pytest.raises(ValueError, match="rng"):
        tm.loss_fn(params, ids, m, ids, cfg, train=True)
    with torch.no_grad():
        a, b, c = (tm.loss_fn(params, ids, m, ids, cfg, rng=r, train=True).item()
                   for r in (3, 3, 4))
        clean = tm.loss_fn(params, ids, m, ids, cfg, train=False).item()
    assert a == b and a != c and a != clean
