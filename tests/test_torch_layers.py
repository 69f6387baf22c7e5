"""The port's layer functions and BLOOM pieces held against the JAX package.

Inputs come from a numpy seed and go to both as numpy arrays; everything
runs in float32 on the CPU. Tolerance 1e-6: the two frameworks sum the
same products in another order, which moves float32 results by a few
ulps at these magnitudes (values of order 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.models import generate as jgen
from pipegoose_tpu.nn.tensor_parallel import layers as jlayers
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models import generate as tgen
from pipegoose_tpu_torch.models._decode import greedy_token, vocab_mask_for
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.nn.tensor_parallel import layers as tlayers

ATOL = 1e-6
JCFG = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
TCFG = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)


@pytest.fixture(scope="module")
def trees():
    np_tree = tbloom.init_params_numpy(TCFG, seed=0)
    # nonzero LayerNorm and bias leaves, so those terms are exercised too
    rng = np.random.default_rng(1)
    for ln in (np_tree["embed_ln"], np_tree["ln_f"]):
        ln["scale"] += rng.standard_normal(ln["scale"].shape, dtype=np.float32) * 0.1
        ln["bias"] += rng.standard_normal(ln["bias"].shape, dtype=np.float32) * 0.1
    qkv = np_tree["blocks"]["attn"]["qkv"]
    qkv["bias"] += rng.standard_normal(qkv["bias"].shape, dtype=np.float32) * 0.1
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tparams = params_from_jax(np_tree, TCFG, device="cpu")
    return np_tree, jparams, tparams


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def test_config_matches_jax():
    j, t = jbloom.BloomConfig.bloom_560m(), tbloom.BloomConfig.bloom_560m()
    for name in ("vocab_size", "hidden_size", "n_layer", "n_head",
                 "layer_norm_epsilon", "initializer_range", "head_dim"):
        assert getattr(t, name) == getattr(j, name), name
    assert tbloom.NEG_INF == jbloom.NEG_INF == -1e9


def test_init_params_numpy_has_the_jax_tree_shapes():
    np_tree = tbloom.init_params_numpy(TCFG, seed=3)
    ref = jbloom.init_params(JCFG, jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(np_tree)
            == jax.tree_util.tree_structure(ref))
    for a, b in zip(jax.tree_util.tree_leaves(np_tree),
                    jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == np.float32
    again = tbloom.init_params_numpy(TCFG, seed=3)
    np.testing.assert_array_equal(np_tree["embed"]["weight"],
                                  again["embed"]["weight"])


@pytest.mark.parametrize("n_head", [4, 6, 16])
def test_alibi_slopes(n_head):
    np.testing.assert_array_equal(tbloom.alibi_slopes(n_head),
                                  jbloom.alibi_slopes(n_head))


def test_bloom_gelu():
    x = np.random.default_rng(0).standard_normal((3, 7, 64), dtype=np.float32) * 3
    _close(tbloom.bloom_gelu(torch.from_numpy(x)), jbloom.bloom_gelu(jnp.asarray(x)))


def test_layer_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32) * 2 + 0.5
    p = {"scale": rng.standard_normal(64, dtype=np.float32),
         "bias": rng.standard_normal(64, dtype=np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _close(tlayers.layer_norm(tp, torch.from_numpy(x), 1e-5),
           jlayers.layer_norm(jp, jnp.asarray(x), 1e-5))


def test_embedding_and_embed_ln(trees):
    _, jparams, tparams = trees
    ids = np.random.default_rng(0).integers(0, 64, (2, 9)).astype(np.int32)
    ref = jbloom.embed_tokens(jparams, jnp.asarray(ids), JCFG, None)
    x = tlayers.vocab_parallel_embedding(tparams["embed"], torch.from_numpy(ids))
    out = tlayers.layer_norm(tparams["embed_ln"], x, TCFG.layer_norm_epsilon)
    _close(out, ref)


def test_qkv_proj_interleaves_per_head(trees):
    _, jparams, tparams = trees
    x = np.random.default_rng(0).standard_normal((2, 5, 64), dtype=np.float32)
    jblk = {"qkv": jax.tree_util.tree_map(lambda a: a[1],
                                          jparams["blocks"]["attn"]["qkv"])}
    ref = jgen._qkv_proj(jblk, jnp.asarray(x), JCFG)
    out = tgen._qkv_proj(tparams["blocks"][1]["attn"], torch.from_numpy(x), TCFG)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == (2, 5, 4, 16)
        _close(o, r)


def test_attn_core():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in [(2, 3, 4, 16), (2, 8, 4, 16), (2, 8, 4, 16)])
    bias = rng.standard_normal((2, 4, 3, 8), dtype=np.float32)
    bias[..., 6:] = -1e9
    qmask = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    ref = jgen._attn_core(*map(jnp.asarray, (q, k, v, bias, qmask)), jnp.float32)
    out = tgen._attn_core(*map(torch.from_numpy, (q, k, v, bias, qmask)),
                          torch.float32)
    _close(out, ref)


def test_logits_fn(trees):
    _, jparams, tparams = trees
    h = np.random.default_rng(0).standard_normal((2, 3, 64), dtype=np.float32)
    out = tbloom.logits_fn(tparams, torch.from_numpy(h))
    assert out.dtype == torch.float32
    _close(out, jbloom.logits_fn(jparams, jnp.asarray(h)))


def test_greedy_token_first_max_and_vocab_mask():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 1.0, 1.0, 9.0]])
    assert greedy_token(logits).tolist() == [1, 3]
    mask = vocab_mask_for(tbloom.BloomConfig(vocab_size=4, valid_vocab_size=3))
    assert greedy_token(logits, mask).tolist() == [1, 0]
    assert vocab_mask_for(TCFG) is None


@pytest.mark.parametrize("layer", ["column", "row", "embedding"])
def test_tp_axis_name_raises(trees, layer):
    _, _, tparams = trees
    blk = tparams["blocks"][0]
    x = torch.zeros(1, 2, 64)
    call = {
        "column": lambda: tlayers.column_parallel_linear(blk["mlp"]["up"], x, "tensor"),
        "row": lambda: tlayers.row_parallel_linear(blk["attn"]["out"], x, "tensor"),
        "embedding": lambda: tlayers.vocab_parallel_embedding(
            tparams["embed"], torch.zeros(1, 2, dtype=torch.long), "tensor"),
    }[layer]
    # a tensor axis needs a ParallelContext (the sharded layers are held in
    # test_torch_hybrid.py)
    with pytest.raises(RuntimeError, match="needs a ParallelContext"):
        call()


def test_params_from_jax_splits_layers_as_views(trees):
    np_tree, _, tparams = trees
    assert len(tparams["blocks"]) == TCFG.n_layer
    k1 = tparams["blocks"][1]["mlp"]["down"]["kernel"]
    np.testing.assert_array_equal(k1.numpy(),
                                  np_tree["blocks"]["mlp"]["down"]["kernel"][1])
    assert k1.is_contiguous()
    bf = params_from_jax(np_tree, tbloom.BloomConfig(
        vocab_size=64, hidden_size=64, n_layer=2, n_head=4,
        dtype=torch.bfloat16), device="cpu")
    assert bf["embed"]["weight"].dtype == torch.bfloat16
