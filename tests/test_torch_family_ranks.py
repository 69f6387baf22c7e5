"""The port's Llama and Mixtral on gloo ranks, held against the JAX package.

- Llama at TP2 x DP2 through ``make_hybrid_train_step`` (ZeRO-1 over
  "data" around SGD at lr 1, so one step moves each parameter by the
  data-mean gradient), untied with flash and fused CE ("hv" head, vocab
  shards) and tied with the dense branch: the step's loss against JAX's
  ``loss_fn`` on the whole batch, the move of every leaf (gathered from the
  shards) against JAX's gradient.
- Mixtral at EP2 x TP2 (each expert coordinate routing its half of the
  batch over ``all_to_all``, the experts' FFN and the heads over "tensor",
  no-drop capacity): each rank's loss and local gradient shard against
  JAX's ``value_and_grad`` of the dense loss on that half (trunk leaves:
  the half's gradient; expert leaves: the sum over both halves, whose
  tokens both reach every expert).
- GPipe and 1F1B at pp 2: Llama untied and tied (M = 2), Llama 3 + 1
  uneven stages (both runtimes), Mixtral GPipe and 1F1B at M = 2 (aux
  weight 0: the aux loss is not linear in the microbatch split; z is) and
  1F1B at M = 1 with the aux weight on (1F1B's ``with_aux``), against
  JAX's dense ``loss_fn``.
- Ring (flash: the chunk kernels' plain versions; dense) and Ulysses at
  sp 2 for both families, Mixtral's dense ring with a sliding window,
  against the dense loss; Mixtral ``loss_fn_pp_sp`` at PP2 x SP2, M = 2,
  against the dense loss.

Tolerances: losses 2e-5 absolute (2e-4 for the SGD-moved TP step), every
gradient 1e-4 of its leaf's largest value. Tiny configs (vocab 128, hidden
64, FFN 112, 4 heads over 2 KV heads, 4 experts, top-2), weights from numpy
seeds, float32; right-padded rows where the path takes a mask. One spawn per
test; the rank bodies live in ``test_torch_family_rank_bodies.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np

from pipegoose_tpu.models import llama as jl
from pipegoose_tpu.models import mixtral as jm
from pipegoose_tpu_torch.models import llama as tl
from pipegoose_tpu_torch.models import mixtral as tm
from pipegoose_tpu_torch.testing.dist import run_ranks
from test_torch_family_rank_bodies import (
    llama_tp_dp_rank,
    mixtral_ep_tp_rank,
    mixtral_pp_sp_rank,
    pipeline_rank,
    sp_rank,
)
from test_torch_llama import assert_grads_close

LOSS_ATOL, GRAD_REL = 2e-5, 1e-4
ROPE = dict(vocab_size=128, hidden_size=64, intermediate_size=112, n_layer=2, n_head=4,
            n_kv_head=2)
MOE = dict(ROPE, num_experts=4, top_k=2, z_loss_weight=0.01)
JAX_CFG = {"llama": jl.LlamaConfig, "mixtral": jm.MixtralConfig}
PORT_CFG = {"llama": tl.LlamaConfig, "mixtral": tm.MixtralConfig}
PORT_MOD = {"llama": tl, "mixtral": tm}
JAX_MOD = {"llama": jl, "mixtral": jm}


def _ids(b, s, seed=5, pad=None):
    ids = np.random.RandomState(seed).randint(0, 128, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    if pad:
        mask[1, s - pad:] = 0
    return ids, mask


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _dense(family, size, opts, ids, mask):
    """JAX's dense loss and gradients of one configuration."""
    cfg = JAX_CFG[family](**size, **opts)
    tree = PORT_MOD[family].init_params_numpy(PORT_CFG[family](**size, **opts), seed=0)
    kw = {} if family == "llama" else {"train": False}
    jmask = None if mask is None else jnp.asarray(mask)
    loss, grads = jax.value_and_grad(JAX_MOD[family].loss_fn)(
        _j(tree), jnp.asarray(ids), jmask, jnp.asarray(ids), cfg, **kw)
    return tree, float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _both(family, size, opts):
    return PORT_CFG[family](**size, **opts)


def test_llama_tp2_dp2_hybrid_step_matches_jax():
    ids, _ = _ids(8, 10)
    runs = [dict(use_flash=True, fused_ce=True), dict(tie_word_embeddings=True)]
    cases, refs = [], []
    for opts in runs:
        tree, loss, grads = _dense("llama", ROPE, opts, ids, None)
        cases.append((tree, _both("llama", ROPE, opts)))
        refs.append((loss, grads))
    ranks = run_ranks(llama_tp_dp_rank, 4, cases, ids, timeout=300)
    for i, (loss, grads) in enumerate(refs):
        for r in ranks:
            assert abs(r[i]["loss"] - loss) <= 2e-4, (i, r[i]["loss"], loss)
        moved = jax.tree_util.tree_map(lambda a, b: a - b, ranks[0][i]["before"],
                                       ranks[0][i]["after"])
        assert_grads_close(moved, grads, GRAD_REL, f"tp2xdp2 case {i}")
        for r in ranks[1:]:   # every rank gathers the same tree
            for a, b in zip(jax.tree_util.tree_leaves(r[i]["after"]),
                            jax.tree_util.tree_leaves(ranks[0][i]["after"])):
                np.testing.assert_array_equal(a, b)


def _shard(arr, spec, coords):
    """numpy leaf cut by a spec tuple at the given axis coordinates."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = arr.shape[dim] // 2
        i = coords[ax]
        arr = np.take(arr, range(i * n, (i + 1) * n), axis=dim)
    return arr


def test_mixtral_ep2_tp2_loss_and_gradients_match_jax():
    ids, _ = _ids(8, 10)
    cfg = tm.MixtralConfig(**MOE)
    tree = tm.init_params_numpy(cfg, seed=0)
    jcfg = jm.MixtralConfig(**MOE)
    halves = []
    for e in range(2):
        part = jnp.asarray(ids[e * 4:(e + 1) * 4])
        loss, grads = jax.value_and_grad(jm.loss_fn)(_j(tree), part, None, part, jcfg,
                                                     train=False)
        halves.append((float(loss), jax.tree_util.tree_map(np.asarray, grads)))
    specs = tm.specs(tree)
    ranks = run_ranks(mixtral_ep_tp_rank, 4, tree, cfg, ids, timeout=300)
    seen = set()
    for e, t, loss, grads in ranks:
        seen.add((e, t))
        assert abs(loss - halves[e][0]) <= LOSS_ATOL, (e, t, loss, halves[e][0])
        coords = {"expert": e, "tensor": t}
        paths = jax.tree_util.tree_flatten_with_path(halves[e][1])[0]
        flat_got = {jax.tree_util.keystr(p): v for p, v in
                    jax.tree_util.tree_flatten_with_path(grads)[0]}
        flat_spec = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, tuple))[0]}
        flat_other = {jax.tree_util.keystr(p): v for p, v in
                      jax.tree_util.tree_flatten_with_path(halves[1 - e][1])[0]}
        assert len(paths) == len(flat_got)
        for path, g in paths:
            key = jax.tree_util.keystr(path)
            whole = g + flat_other[key] if "'moe'" in key else g
            want = _shard(whole, flat_spec[key], coords)
            scale = max(float(np.abs(want).max()), 1e-30)
            err = float(np.abs(flat_got[key] - want).max())
            assert err <= GRAD_REL * scale, (e, t, key, err, scale)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def _check_stage_grads(got_blocks, got_rest, want, what):
    blocks = jax.tree_util.tree_map(lambda *xs: np.concatenate(xs), *got_blocks)
    assert_grads_close({**got_rest, "blocks": blocks}, want, GRAD_REL, what)


def test_pipelines_pp2_match_the_dense_loss():
    ids, mask = _ids(4, 10, pad=3)
    L4 = dict(ROPE, n_layer=4)
    specs = [   # (family, size, options, kind, M, counts)
        ("llama", ROPE, {}, "gpipe", 2, None),
        ("llama", ROPE, {}, "1f1b", 2, None),
        ("llama", ROPE, dict(tie_word_embeddings=True, use_flash=True), "gpipe", 2, None),
        ("llama", ROPE, dict(tie_word_embeddings=True, fused_ce=True), "1f1b", 2, None),
        ("llama", L4, {}, "gpipe", 2, (3, 1)),
        ("llama", L4, dict(tie_word_embeddings=True), "1f1b", 2, (3, 1)),
        ("mixtral", MOE, dict(aux_loss_weight=0.0), "gpipe", 2, None),
        ("mixtral", MOE, dict(aux_loss_weight=0.0, use_flash=True), "1f1b", 2, None),
        ("mixtral", MOE, dict(aux_loss_weight=0.05), "1f1b", 1, None),
        ("mixtral", dict(MOE, n_layer=4), dict(aux_loss_weight=0.0), "1f1b", 2, (3, 1)),
    ]
    cases, refs = [], []
    for family, size, opts, kind, M, counts in specs:
        tree, loss, grads = _dense(family, size, opts, ids, mask)
        cases.append((family, tree, _both(family, size, opts), ids, mask, kind, M, counts))
        refs.append((loss, grads))
    ranks = run_ranks(pipeline_rank, 2, cases, timeout=300)
    for i, (loss, grads) in enumerate(refs):
        what = f"{specs[i][0]} {specs[i][3]} M={specs[i][4]} counts={specs[i][5]} {specs[i][2]}"
        for r in ranks:
            assert abs(r[i]["loss"] - loss) <= LOSS_ATOL, (what, r[i]["loss"], loss)
        _check_stage_grads([r[i]["blocks"] for r in ranks], ranks[-1][i]["rest"], grads, what)
        for a, b in zip(jax.tree_util.tree_leaves(ranks[0][i]["rest"]),
                        jax.tree_util.tree_leaves(ranks[1][i]["rest"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)


def test_ring_and_ulysses_sp2_match_the_dense_loss():
    # 3 pads under a window of 4: every pad query still sees a valid key (a
    # query that sees none gets each route's own finite garbage, which the
    # z loss, a mean over every token, would carry)
    ids, mask = _ids(2, 12, pad=3)
    specs = [   # (family, options, variant)
        ("llama", dict(use_flash=True), "ring"),
        ("llama", dict(tie_word_embeddings=True), "ring"),
        ("llama", dict(use_flash=True, fused_ce=True), "ulysses"),
        ("mixtral", dict(aux_loss_weight=0.0, use_flash=True), "ring"),
        ("mixtral", dict(aux_loss_weight=0.0, sliding_window=4, use_flash=True), "ring"),
        ("mixtral", dict(aux_loss_weight=0.0, sliding_window=4), "ulysses"),
    ]
    cases, refs = [], []
    for family, opts, variant in specs:
        size = ROPE if family == "llama" else MOE
        tree, loss, grads = _dense(family, size, opts, ids, mask)
        cases.append((family, tree, _both(family, size, opts), ids, mask, variant))
        refs.append((loss, grads))
    ranks = run_ranks(sp_rank, 2, cases, timeout=300)
    for i, (loss, grads) in enumerate(refs):
        what = f"{specs[i]}"
        for r in ranks:
            assert abs(r[i]["loss"] - loss) <= LOSS_ATOL, (what, r[i]["loss"], loss)
            assert_grads_close(r[i]["grads"], grads, GRAD_REL, what)


def test_mixtral_pp2_sp2_matches_the_dense_loss():
    ids, mask = _ids(4, 12, pad=4)
    opts = dict(aux_loss_weight=0.0)
    tree, loss, grads = _dense("mixtral", MOE, opts, ids, mask)
    ranks = run_ranks(mixtral_pp_sp_rank, 4, tree, _both("mixtral", MOE, opts), ids, mask, 2,
                      timeout=300)
    for r in ranks:
        assert abs(r["loss"] - loss) <= LOSS_ATOL, (r["loss"], loss)
    by_stage = {r["stage"]: r for r in ranks if r["seq"] == 0}
    _check_stage_grads([by_stage[0]["blocks"], by_stage[1]["blocks"]], by_stage[1]["rest"],
                       grads, "pp2xsp2")
