"""The port's ALBERT held against the JAX package on the CPU.

- ``albert.loss_fn``, ``forward``'s logits and every parameter gradient
  against ``jax.value_and_grad(albert.loss_fn)`` and JAX's ``forward``:
  dense and ``use_flash`` (the JAX flash kernels as
  ``tests/models/test_albert_pp_sp.py`` runs them on the CPU, the port's
  plain versions with ``causal=False``), remat, a ``label_mask``, token
  types, no mask;
- ``fill_mask`` tokens equal JAX's;
- ``from_hf`` of a random-init HF ``AlbertForMaskedLM``: logits against
  HF's at 2e-4 on the valid positions and the MLM loss against HF's, the
  converted tree equal to the JAX converter's bit for bit;
- ``tp_specs`` / ``pp_specs`` equal JAX's, ``uniform_stage_counts``, the
  single-rank pipeline and sequence-parallel losses against ``loss_fn``, and
  the refusals (wrong stage counts, an SP window past the position table,
  an unknown SP variant).

Config as ``tests/models/test_albert_pp_sp.py``'s (vocab 128, E 32, H 64,
4 heads, FFN 96, 4 applications of the shared layer, 16 positions); B = 4 x
S = 16 with row 1 right-padded by 3 and ~30% of the valid positions
scored; weights from ``init_params_numpy`` (numpy seed 0), float32.
Tolerances: loss and logits 1e-5 absolute, every gradient 1e-4 of its
leaf's largest value (the key bias, whose gradient is zero in exact
arithmetic, 1e-10 absolute).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import albert as ja
from pipegoose_tpu_torch.models import albert as ta
from pipegoose_tpu_torch.models.weights import (
    grads_of,
    param_leaves,
    params_from_jax,
    params_to_jax,
)

LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
ZERO_GRAD = 1e-6
SIZE = dict(vocab_size=128, embedding_size=32, hidden_size=64, n_layer=4, n_head=4,
            intermediate_size=96, max_position_embeddings=16)
B, S = 4, 16
_RNG = np.random.RandomState(7)
IDS = _RNG.randint(0, SIZE["vocab_size"] - 1, (B, S)).astype(np.int32)
MASK = np.ones((B, S), np.int32)
MASK[1, 13:] = 0
LMASK = ((_RNG.rand(B, S) < 0.3) & MASK.astype(bool)).astype(np.int32)
TYPES = (np.arange(S)[None] >= S // 2).astype(np.int32).repeat(B, 0)


def assert_grads_close(got, want, rel, what=""):
    """Every leaf within ``rel`` of its largest value; a leaf whose largest
    value is under ``ZERO_GRAD`` (the key bias: softmax over keys cancels
    it, so its gradient is zero in exact arithmetic and only rounding
    remains) is held to ``rel x ZERO_GRAD`` absolute."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), ZERO_GRAD)
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= rel * scale, (what, jax.tree_util.keystr(path), err, scale)


def _cfgs(**kw):
    return ja.AlbertConfig(**SIZE, **kw), ta.AlbertConfig(**SIZE, **kw)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _tree():
    return ta.init_params_numpy(ta.AlbertConfig(**SIZE), seed=0)


def _port_grads(tree, cfg, mask, lmask):
    params = params_from_jax(tree, cfg, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_(True)
    ids = torch.from_numpy(IDS).long()
    loss = ta.loss_fn(params, ids, None if mask is None else torch.from_numpy(mask), ids,
                      cfg, label_mask=None if lmask is None else torch.from_numpy(lmask))
    loss.backward()
    return params, float(loss.detach()), params_to_jax(grads_of(params))


@pytest.mark.parametrize("opts,masks", [
    ({}, "label"), ({"use_flash": True}, "label"), ({"remat": True}, "label"),
    ({"use_flash": True, "remat": True}, "attention"), ({}, "none")],
    ids=["dense", "flash", "remat", "flash-remat-attention-mask", "no-mask"])
def test_loss_logits_and_grads_match_jax(opts, masks):
    jcfg, tcfg = _cfgs(**opts)
    tree = _tree()
    mask = None if masks == "none" else MASK
    lmask = LMASK if masks == "label" else None
    ids = jnp.asarray(IDS)
    jmask = None if mask is None else jnp.asarray(mask)
    jl = None if lmask is None else jnp.asarray(lmask)
    loss, grads = jax.value_and_grad(
        lambda p: ja.loss_fn(p, ids, jmask, ids, jcfg, label_mask=jl))(_j(tree))
    params, t_loss, t_grads = _port_grads(tree, tcfg, mask, lmask)
    assert abs(t_loss - float(loss)) <= LOSS_ATOL, (t_loss, float(loss))
    assert_grads_close(t_grads, jax.tree_util.tree_map(np.asarray, grads), GRAD_REL, opts)
    with torch.no_grad():
        logits = ta.forward(params, torch.from_numpy(IDS).long(),
                            None if mask is None else torch.from_numpy(mask), tcfg)
    want = np.asarray(ja.forward(_j(tree), ids, jmask, jcfg))
    np.testing.assert_allclose(logits.numpy(), want, rtol=0, atol=LOSS_ATOL)


def test_token_types_match_jax():
    jcfg, tcfg = _cfgs()
    tree = _tree()
    want = np.asarray(ja.forward_hidden(_j(tree), jnp.asarray(IDS), jnp.asarray(MASK), jcfg,
                                        token_type_ids=jnp.asarray(TYPES)))
    with torch.no_grad():
        got = ta.forward_hidden(params_from_jax(tree, tcfg, device="cpu"),
                                torch.from_numpy(IDS).long(), torch.from_numpy(MASK),
                                tcfg, token_type_ids=torch.from_numpy(TYPES).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOSS_ATOL)


@pytest.mark.parametrize("use_flash", [False, True], ids=["dense", "flash"])
def test_fill_mask_tokens_equal_jax(use_flash):
    jcfg, tcfg = _cfgs(use_flash=use_flash)
    tree = _tree()
    mask_id = SIZE["vocab_size"] - 1
    masked = np.where(LMASK > 0, mask_id, IDS)
    want = np.asarray(ja.fill_mask(_j(tree), jnp.asarray(masked), mask_id, jcfg,
                                   jnp.asarray(MASK)))
    got = ta.fill_mask(params_from_jax(tree, tcfg, device="cpu"),
                       torch.from_numpy(masked).long(), mask_id, tcfg,
                       torch.from_numpy(MASK))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[LMASK == 0] == masked[LMASK == 0]).all()


def test_specs_and_stage_counts_match_jax():
    tree = _tree()
    jtree = _j(tree)
    tspecs = ta.tp_specs(tree)
    jspecs = ja.tp_specs(jtree)
    flat_t = jax.tree_util.tree_flatten(tspecs, is_leaf=lambda x: isinstance(x, tuple))[0]
    flat_j = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert [tuple(s) for s in flat_j] == [tuple(s) for s in flat_t]
    assert ta.pp_specs(tree) == tspecs
    # the port's tree carries the same specs as the numpy tree
    assert ta.tp_specs(params_from_jax(tree, ta.AlbertConfig(**SIZE), device="cpu")) == tspecs
    for n, p in [(4, 4), (12, 4), (3, 2), (13, 4), (1, 2)]:
        assert ta.uniform_stage_counts(n, p) == ja.uniform_stage_counts(n, p)


def _one_rank_world(**sizes):
    import os
    import tempfile

    import torch.distributed as dist

    from pipegoose_tpu_torch.distributed import ParallelContext

    path = os.path.join(tempfile.mkdtemp(), "store")
    return ParallelContext.init_multihost(store=dist.FileStore(path, 1), world_size=1,
                                          rank=0, device="cpu", **sizes)


def test_single_rank_pipeline_and_sp_losses_equal_loss_fn():
    """At pp = 1 and sp = 1 the pipeline (GPipe, 1F1B, M = 2) and the
    sequence-parallel losses (ring, Ulysses, Ulysses with flash) equal
    ``loss_fn``; wrong stage counts, an SP window past the position table
    and an unknown variant raise."""
    torch.set_num_threads(1)
    _, tcfg = _cfgs()
    tree = _tree()
    ids, mask, lmask = (torch.from_numpy(a).long() for a in (IDS, MASK, LMASK))
    ctx = _one_rank_world(pipeline_parallel_size=1, sequence_parallel_size=1)
    try:
        def grads(cfg, fn):
            params = params_from_jax(tree, cfg, device="cpu")
            for t in param_leaves(params):
                t.requires_grad_(True)
            loss = fn(params, cfg)
            loss.backward()
            return float(loss.detach()), params_to_jax(grads_of(params))

        ref_loss, ref = grads(tcfg, lambda p, c: ta.loss_fn(p, ids, mask, ids, c,
                                                             label_mask=lmask))
        runs = {
            "gpipe": (tcfg, lambda p, c: ta.loss_fn_pp(p, ids, mask, ids, c, 2,
                                                       label_mask=lmask)),
            "1f1b": (tcfg, lambda p, c: ta.loss_fn_1f1b(p, ids, mask, ids, c, 2,
                                                        label_mask=lmask)),
            "ring": (tcfg, lambda p, c: ta.loss_fn_sp(p, ids, mask, ids, c,
                                                      label_mask=lmask)),
            "ulysses": (tcfg, lambda p, c: ta.loss_fn_sp(p, ids, mask, ids, c,
                                                         label_mask=lmask,
                                                         variant="ulysses")),
            "ulysses flash": (dataclasses.replace(tcfg, use_flash=True),
                              lambda p, c: ta.loss_fn_sp(p, ids, mask, ids, c,
                                                         label_mask=lmask,
                                                         variant="ulysses")),
            "pp x sp": (tcfg, lambda p, c: ta.loss_fn_pp_sp(p, ids, mask, ids, c, 2,
                                                            label_mask=lmask)),
        }
        for name, (cfg, fn) in runs.items():
            loss, g = grads(cfg, fn)
            assert abs(loss - ref_loss) <= LOSS_ATOL, (name, loss, ref_loss)
            assert_grads_close(g, ref, GRAD_REL, name)
        params = params_from_jax(tree, tcfg, device="cpu")
        with pytest.raises(ValueError, match="stage_layer_counts"):
            ta.loss_fn_pp(params, ids, mask, ids, tcfg, 2, stage_layer_counts=(3,))
        with pytest.raises(ValueError, match="max_position_embeddings"):
            ta.loss_fn_sp(params, ids, mask, ids, dataclasses.replace(
                tcfg, max_position_embeddings=S - 1))
        with pytest.raises(ValueError, match="unknown SP variant"):
            ta.loss_fn_sp(params, ids, mask, ids, tcfg, variant="zigzag")
    finally:
        ctx.destroy()


# -- the HF converter ----------------------------------------------------------------

HF_IDS = np.random.RandomState(42).randint(0, 128, (2, 12))
HF_MASK = np.ones((2, 12), np.int64)
HF_MASK[1, 9:] = 0


def _hf_albert(**kw):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = dict(vocab_size=128, embedding_size=32, hidden_size=64, num_hidden_layers=3,
               num_attention_heads=4, intermediate_size=128, max_position_embeddings=40,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               classifier_dropout_prob=0.0)
    cfg.update(kw)
    return transformers.AlbertForMaskedLM(transformers.AlbertConfig(**cfg)).eval()


def test_from_hf_matches_hf_and_the_jax_converter():
    from pipegoose_tpu.models.hf import albert_params_from_hf as jax_from_hf
    from pipegoose_tpu_torch.models import convert

    model = _hf_albert()
    cfg, params, module = convert.from_hf(model, device="cpu")
    assert module is ta and cfg.n_layer == 3 and cfg.embedding_size == 32
    ids, mask = torch.from_numpy(HF_IDS), torch.from_numpy(HF_MASK)
    with torch.no_grad():
        ref = model(input_ids=ids, attention_mask=mask).logits.numpy()
        got = ta.forward(params, ids, mask, cfg).numpy()
    valid = HF_MASK.astype(bool)
    np.testing.assert_allclose(got[valid], ref[valid], rtol=2e-4, atol=2e-4)
    lmask = (np.random.RandomState(3).rand(2, 12) < 0.3) & valid
    labels = np.where(lmask, HF_IDS, -100)
    with torch.no_grad():
        hf_loss = float(model(input_ids=ids, attention_mask=mask,
                              labels=torch.from_numpy(labels)).loss)
        loss = float(ta.loss_fn(params, ids, mask, ids, cfg,
                                label_mask=torch.from_numpy(lmask.astype(np.int64))))
    assert abs(loss - hf_loss) < 2e-4, (loss, hf_loss)
    _, jtree = jax_from_hf(model)
    mine = params_to_jax(params)
    for (path, want), have in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                                  jax.tree_util.tree_leaves(mine)):
        np.testing.assert_array_equal(have, np.asarray(want), err_msg=str(path))


@pytest.mark.parametrize("kw,match", [
    ({"num_hidden_groups": 2}, "num_hidden_groups"),
    ({"inner_group_num": 2}, "inner_group_num"),
    ({"hidden_act": "gelu"}, "hidden_act")])
def test_from_hf_keeps_the_jax_refusals(kw, match):
    from pipegoose_tpu_torch.models import convert

    with pytest.raises(NotImplementedError, match=match):
        convert.from_hf(_hf_albert(**kw), device="cpu")
