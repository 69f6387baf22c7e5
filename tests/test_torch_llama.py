"""The port's Llama held against the JAX package on the CPU.

- ``llama.loss_fn``, ``forward``'s logits and every parameter gradient
  against ``jax.value_and_grad(llama.loss_fn)`` and JAX's ``forward``: tied
  and untied heads, ``use_flash`` on and off (the JAX kernels as its tests
  run them on the CPU, the port's plain versions), ``fused_ce`` on and off
  (the tied head in the "vh" layout, the untied one in "hv"), remat, no
  mask, and GQA at g = 2 and g = 4;
- ``rope_scaling`` linear, dynamic (past its original context) and llama3,
  logits and loss;
- greedy ``generate`` token for token (tied, untied, llama3 scaling), and
  the dynamic-RoPE decode refusal;
- ``specs`` and ``pp_specs`` equal to JAX's on the stacked tree.

Config as ``tests/models/test_llama.py``'s (vocab 128, hidden 64, FFN 112,
2 layers, 4 heads over 2 KV heads) and one with 8 heads over 2 (g = 4);
B = 2 x S = 10 with row 1 right-padded by 3; weights from
``init_params_numpy`` (numpy seed 0), float32. Tolerances: loss and logits
2e-5 absolute, every gradient 2e-5 of its leaf's largest value.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import llama as jl
from pipegoose_tpu.models.mixtral import RopeScaling as JRopeScaling
from pipegoose_tpu_torch.models import llama as tl
from pipegoose_tpu_torch.models.mixtral import RopeScaling
from pipegoose_tpu_torch.models.weights import (
    grads_of,
    param_leaves,
    params_from_jax,
    params_to_jax,
)

LOSS_ATOL = 2e-5
GRAD_REL = 2e-5
SIZE = dict(vocab_size=128, hidden_size=64, intermediate_size=112, n_layer=2,
            n_head=4, n_kv_head=2)
G4 = dict(SIZE, n_head=8, n_kv_head=2)
B, S, PAD = 2, 10, 3
IDS = np.random.RandomState(13).randint(0, 128, (B, S)).astype(np.int32)
MASK = np.ones((B, S), np.int32)
MASK[1, S - PAD:] = 0


def _cfgs(size=SIZE, scaling=None, **kw):
    j = jl.LlamaConfig(**size, rope_scaling=None if scaling is None
                       else JRopeScaling(**scaling), **kw)
    t = tl.LlamaConfig(**size, rope_scaling=None if scaling is None
                       else RopeScaling(**scaling), **kw)
    return j, t


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def assert_grads_close(got, want, rel, what=""):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= rel * scale, (what, jax.tree_util.keystr(path), err, scale)


def _port_loss(tree, cfg, mask):
    params = params_from_jax(tree, cfg, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_(True)
    ids = torch.from_numpy(IDS).long()
    m = None if mask is None else torch.from_numpy(mask)
    loss = tl.loss_fn(params, ids, m, ids, cfg)
    loss.backward()
    with torch.no_grad():
        logits = tl.forward(params, ids, m, cfg)
    return loss.item(), params_to_jax(grads_of(params)), logits.numpy()


CASES = {   # name -> (size, config options, mask)
    "untied": (SIZE, {}, MASK),
    "tied": (SIZE, dict(tie_word_embeddings=True), MASK),
    "untied_flash": (SIZE, dict(use_flash=True), MASK),
    "tied_flash": (SIZE, dict(tie_word_embeddings=True, use_flash=True), MASK),
    "untied_fused_ce": (SIZE, dict(fused_ce=True), MASK),
    "tied_fused_ce": (SIZE, dict(tie_word_embeddings=True, fused_ce=True), MASK),
    "untied_remat_flash_fused_ce": (SIZE, dict(remat=True, use_flash=True,
                                               fused_ce=True), MASK),
    "tied_nomask": (SIZE, dict(tie_word_embeddings=True), None),
    "g4_flash_fused_ce": (G4, dict(use_flash=True, fused_ce=True), MASK),
    "g4_tied_remat": (G4, dict(tie_word_embeddings=True, remat=True), MASK),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_logits_and_every_grad_match_jax(case):
    size, opts, mask = CASES[case]
    jcfg, tcfg = _cfgs(size, **opts)
    tree = tl.init_params_numpy(tcfg, seed=0)
    assert ("lm_head" in tree) != bool(opts.get("tie_word_embeddings"))
    jmask = None if mask is None else jnp.asarray(mask)
    jloss, jgrads = jax.value_and_grad(jl.loss_fn)(
        _j(tree), jnp.asarray(IDS), jmask, jnp.asarray(IDS), jcfg)
    jlogits = jl.forward(_j(tree), jnp.asarray(IDS), jmask, jcfg)
    loss, grads, logits = _port_loss(tree, tcfg, mask)
    assert abs(loss - float(jloss)) <= LOSS_ATOL, (loss, float(jloss))
    np.testing.assert_allclose(logits, np.asarray(jlogits), rtol=0, atol=LOSS_ATOL)
    assert_grads_close(grads, jgrads, GRAD_REL, case)


SCALINGS = {
    "linear": dict(rope_type="linear", factor=2.0),
    # past its original context of 4 positions: theta is rescaled
    "dynamic": dict(rope_type="dynamic", factor=2.0, original_max_position_embeddings=4),
    # wavelengths on both sides of the band and inside it (head_dim 16)
    "llama3": dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                   high_freq_factor=4.0, original_max_position_embeddings=64),
}


@pytest.mark.parametrize("name", list(SCALINGS))
def test_rope_scaling_matches_jax(name):
    jcfg, tcfg = _cfgs(scaling=SCALINGS[name])
    _, plain = _cfgs()
    tree = tl.init_params_numpy(tcfg, seed=0)
    jloss = jl.loss_fn(_j(tree), jnp.asarray(IDS), jnp.asarray(MASK), jnp.asarray(IDS), jcfg)
    jlogits = jl.forward(_j(tree), jnp.asarray(IDS), jnp.asarray(MASK), jcfg)
    loss, _, logits = _port_loss(tree, tcfg, MASK)
    assert abs(loss - float(jloss)) <= LOSS_ATOL
    np.testing.assert_allclose(logits, np.asarray(jlogits), rtol=0, atol=LOSS_ATOL)
    _, _, unscaled = _port_loss(tree, plain, MASK)
    assert np.abs(logits - unscaled).max() > 1e-4   # the scaling did something


GEN = {"untied": {}, "tied": dict(tie_word_embeddings=True),
       "llama3_g4": dict(scaling=SCALINGS["llama3"], size=G4)}


@pytest.mark.parametrize("name", list(GEN))
def test_greedy_generate_matches_jax_token_for_token(name):
    opts = dict(GEN[name])
    jcfg, tcfg = _cfgs(**opts)
    tree = tl.init_params_numpy(tcfg, seed=0)
    prompt = IDS[:, :6]
    want = np.asarray(jl.generate(_j(tree), jnp.asarray(prompt), jcfg, max_new_tokens=6))
    params = params_from_jax(tree, tcfg, device="cpu")
    got = tl.generate(params, prompt, tcfg, max_new_tokens=6, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_dynamic_rope_decode_is_refused():
    _, tcfg = _cfgs(scaling=SCALINGS["dynamic"])
    params = params_from_jax(tl.init_params_numpy(tcfg, 0), tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="dynamic"):
        tl.generate(params, IDS[:, :4], tcfg, max_new_tokens=2, device="cpu")


@pytest.mark.parametrize("tied", [False, True])
def test_specs_equal_jax(tied):
    jcfg, tcfg = _cfgs(tie_word_embeddings=tied)
    tree = tl.init_params_numpy(tcfg, seed=0)
    for jfn, tfn in ((jl.specs, tl.specs), (jl.pp_specs, tl.pp_specs)):
        want = jfn(_j(tree))
        got = tfn(tree)
        flat_w = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        flat_g = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_flatten_with_path(
                      got, is_leaf=lambda x: isinstance(x, tuple))[0]}
        assert len(flat_w) == len(flat_g)
        for path, spec in flat_w:
            assert tuple(spec) == flat_g[jax.tree_util.keystr(path)], path
    # on the port's per-layer tree each layer's leaves lose the layer dim
    per_layer = tl.specs(params_from_jax(tree, tcfg, device="cpu"))
    assert per_layer["blocks"][1]["attn"]["q"]["kernel"] == (None, "tensor")
    assert per_layer["blocks"][0]["mlp"]["down"]["kernel"] == ("tensor", None)
    assert per_layer["embed"]["weight"] == ("tensor", None)


def test_params_round_trip_and_config_presets():
    _, tcfg = _cfgs()
    tree = tl.init_params_numpy(tcfg, seed=0)
    back = params_to_jax(params_from_jax(tree, tcfg, device="cpu"))
    assert list(back) == ["embed", "blocks", "ln_f", "lm_head"]
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    for name in ("llama2_7b", "llama3_8b"):
        j, t = getattr(jl.LlamaConfig, name)(), getattr(tl.LlamaConfig, name)()
        for f in dataclasses.fields(t):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
