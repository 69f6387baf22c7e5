"""The port's paged forward passes and page allocator held against the JAX
package (``serving/kv_pool.py``, attention through ``paged_attention``).

Same weights (numpy, seeded) and tokens on both sides, float32 on the
CPU. Logits agree to 1e-4: two blocks of float32 matmuls, softmaxes and
LayerNorms summed in another order. The pools written by each step must
agree page by page (int8 codes exactly), apart from the NULL page: it
absorbs every pad write at one offset, and which of several writes to
one index lands is left unspecified by both frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.serving import kv_pool as jkv
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.serving import kv_pool as tkv

JCFG = jbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
TCFG = tbloom.BloomConfig(vocab_size=64, hidden_size=64, n_layer=2, n_head=4)
PS, NPAGES, W = 4, 12, 5
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    np_tree = tbloom.init_params_numpy(TCFG, seed=0)
    return (jax.tree_util.tree_map(jnp.asarray, np_tree),
            params_from_jax(np_tree, TCFG, device="cpu"))


def _assert_pools_equal(tpages, jpages):
    """Same pages and offsets written with the same values: fp values to
    1e-6 (they come out of float32 matmuls summed in another order), int8
    codes exactly and their scales to 1e-5 relative."""
    if isinstance(jpages, dict):
        np.testing.assert_array_equal(tpages["q"][:, 1:].numpy(),
                                      np.asarray(jpages["q"])[:, 1:])
        np.testing.assert_allclose(tpages["scale"][:, 1:].numpy(),
                                   np.asarray(jpages["scale"])[:, 1:],
                                   rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(tpages[:, 1:].numpy(),
                                   np.asarray(jpages)[:, 1:], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
def test_prefill_chunks_then_decode_match_jax(params, kv_dtype):
    jparams, tparams = params
    rng = np.random.default_rng(0)
    table = np.array([[3, 7, 1, 0, 0], [2, 5, 9, 11, 0]], np.int32)
    jk, jv = jkv.init_pages(JCFG, NPAGES, PS, kv_dtype=kv_dtype)
    tk, tv = tkv.init_pages(TCFG, NPAGES, PS, kv_dtype=kv_dtype, device="cpu")
    # two chunks of 8 (row 0 stops mid-chunk: a pad tail), then a decode step
    start = np.array([0, 0], np.int32)
    for n_valid in ([8, 8], [3, 8]):
        tokens = rng.integers(0, 64, (2, 8)).astype(np.int32)
        n_valid = np.array(n_valid, np.int32)
        jlog, jk, jv = jkv.paged_prefill_chunk(
            jparams, jnp.asarray(tokens), jk, jv, jnp.asarray(table),
            jnp.asarray(start), jnp.asarray(n_valid), JCFG, attn_impl="paged")
        tlog = tkv.paged_prefill_chunk(
            tparams, torch.from_numpy(tokens), tk, tv, torch.from_numpy(table),
            torch.from_numpy(start), torch.from_numpy(n_valid), TCFG)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=LOGIT_ATOL)
        _assert_pools_equal(tk, jk)
        _assert_pools_equal(tv, jv)
        start = start + n_valid
    tokens = rng.integers(0, 64, (2,)).astype(np.int32)
    jlog, jk, jv = jkv.paged_decode_step(
        jparams, jnp.asarray(tokens), jk, jv, jnp.asarray(table),
        jnp.asarray(start), JCFG, attn_impl="paged")
    tlog = tkv.paged_decode_step(
        tparams, torch.from_numpy(tokens), tk, tv, torch.from_numpy(table),
        torch.from_numpy(start), TCFG)
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == (2, 64)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=LOGIT_ATOL)
    _assert_pools_equal(tk, jk)
    _assert_pools_equal(tv, jv)


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(0)
    bank = rng.standard_normal((NPAGES, PS, 4, 16), dtype=np.float32)
    table = rng.integers(0, NPAGES, (3, W)).astype(np.int32)
    np.testing.assert_array_equal(
        tkv.gather_pages(torch.from_numpy(bank), torch.from_numpy(table)).numpy(),
        np.asarray(jkv.gather_pages(jnp.asarray(bank), jnp.asarray(table))))


def test_page_pool_placement_matches_jax():
    """LIFO placement and history are a pure function of the event order."""
    jpool, tpool = jkv.PagePool(10, PS), tkv.PagePool(10, PS)
    for pool in (jpool, tpool):
        a = pool.alloc(3)
        b = pool.alloc(2)
        pool.release(a)
        pool.alloc(4)
        pool.release(b)
    assert list(tpool.history) == list(jpool.history)
    assert (tpool.free_count, tpool.used_count) == (jpool.free_count, jpool.used_count)
    with pytest.raises(RuntimeError, match="exhausted"):
        tpool.alloc(tpool.free_count + 1)
    with pytest.raises(RuntimeError, match="not allocated"):
        tpool.release([0])


def test_kv_dtype_check():
    assert tkv.check_kv_dtype("fp") is None
    assert tkv.check_kv_dtype("int8") == "int8"
    with pytest.raises(ValueError, match="kv_dtype"):
        tkv.check_kv_dtype("int4")


def test_init_pages_on_the_card_by_default():
    """With no ``device`` the pool goes to the card; without one it raises
    instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkv.init_pages(TCFG, NPAGES, PS)
