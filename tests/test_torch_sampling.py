"""Sampled decoding (``temperature > 0``) of the port, on the CPU.

``jax.random`` draws cannot be matched bit for bit (ROADMAP.md § C), so the
port's pick is held to its distribution: 200 000 draws of one fixed row of
8 logits against ``softmax(logits / T)`` by a chi-square test (p > 1e-3),
and against as many draws of the JAX pick (``jax.random.categorical``) by a
two-sample chi-square test. Then: padded vocabulary slots are never drawn,
finished rows emit eos, the same generator seed gives the same tokens and
None means a generator seeded 0, and ``generate()`` samples on a tiny
BLOOM padded for tp 3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models import generate as tgen
from pipegoose_tpu_torch.models._decode import (
    autoregressive_generate,
    default_generator,
    sample_token,
    vocab_mask_for,
)
from pipegoose_tpu_torch.models.weights import params_from_jax

DRAWS = 200_000
P_MIN = 1e-3
LOGITS = np.array([1.5, -0.3, 0.8, 2.1, -1.7, 0.0, 1.1, -0.6], np.float32)
SIZE = dict(vocab_size=125, hidden_size=64, n_layer=2, n_head=4)


def _counts(tokens, n=len(LOGITS)):
    return np.bincount(np.asarray(tokens).reshape(-1), minlength=n)


@pytest.mark.parametrize("temperature", [0.7, 1.0, 2.5])
def test_pick_follows_softmax_over_temperature(temperature):
    g = torch.Generator().manual_seed(11)
    rows = torch.from_numpy(np.tile(LOGITS, (DRAWS, 1)))
    counts = _counts(sample_token(rows, temperature, g).numpy())
    probs = torch.softmax(torch.from_numpy(LOGITS).double() / temperature, -1).numpy()
    stat, p = stats.chisquare(counts, DRAWS * probs)
    assert p > P_MIN, (counts, DRAWS * probs, stat)


def test_pick_and_the_jax_pick_draw_alike():
    temperature = 0.7
    port = _counts(sample_token(torch.from_numpy(np.tile(LOGITS, (DRAWS, 1))),
                                temperature, torch.Generator().manual_seed(3)).numpy())
    keys = jax.random.PRNGKey(3)
    jax_draws = jax.random.categorical(keys, jnp.asarray(LOGITS) / temperature,
                                       shape=(DRAWS,))
    stat, p, _, _ = stats.chi2_contingency(np.stack([port, _counts(jax_draws)]))
    assert p > P_MIN, (port, _counts(jax_draws), stat)


def test_masked_slots_are_never_drawn():
    cfg = tbloom.BloomConfig(**dict(SIZE, vocab_size=12), valid_vocab_size=8)
    logits = torch.zeros(4096, 12)
    logits[:, 8:] = 30.0          # padded slots would win every draw unmasked
    tok = sample_token(logits, 1.0, torch.Generator().manual_seed(0),
                       vocab_mask_for(cfg))
    assert int(tok.max()) < 8
    assert len(set(tok.tolist())) == 8


def _stub_model(vocab, eos_logit):
    """forward_cached / init_cache of a model whose every row's logits are
    the same vector, eos (token 0) at ``eos_logit``."""
    def forward_cached(params, ids, cache, start, config):
        logits = torch.zeros(ids.shape[0], vocab)
        logits[:, 0] = eos_logit
        return logits, cache

    def init_cache(config, batch, max_len, device=None):
        return {}

    return forward_cached, init_cache


def test_finished_rows_emit_eos():
    fwd, init = _stub_model(16, eos_logit=2.0)
    ids = torch.ones(32, 3, dtype=torch.long)
    out = autoregressive_generate(fwd, init, None, ids, None, 24, temperature=1.0,
                                  eos_token_id=0,
                                  generator=torch.Generator().manual_seed(5))
    new = out[:, 3:].numpy()
    hit = 0
    for row in new:
        zeros = np.flatnonzero(row == 0)
        if len(zeros):
            hit += 1
            assert (row[zeros[0]:] == 0).all(), row
    assert 0 < hit < len(new) + 1 and (new != 0).any()


def test_same_seed_same_tokens_and_none_is_seed_zero():
    fwd, init = _stub_model(16, eos_logit=0.0)
    ids = torch.ones(4, 2, dtype=torch.long)

    def run(g):
        return autoregressive_generate(fwd, init, None, ids, None, 12, temperature=0.9,
                                       generator=g)

    a = run(torch.Generator().manual_seed(21))
    assert torch.equal(a, run(torch.Generator().manual_seed(21)))
    assert not torch.equal(a, run(torch.Generator().manual_seed(22)))
    assert torch.equal(run(None), run(default_generator("cpu")))
    assert torch.equal(run(None), run(torch.Generator().manual_seed(0)))


def test_generate_samples_a_padded_bloom():
    cfg = tbloom.BloomConfig(**SIZE, initializer_range=0.5)
    np_tree, pcfg = tbloom.pad_for_tp(tbloom.init_params_numpy(cfg, seed=0), cfg, 3)
    params = params_from_jax(np_tree, pcfg, device="cpu")
    ids = np.random.default_rng(0).integers(0, 125, (3, 5))
    outs = [tgen.generate(params, ids, pcfg, 8, temperature=0.7, device="cpu",
                          generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert outs[0].shape == (3, 13) and outs[0].dtype == torch.int64
    assert (outs[0][:, :5].numpy() == ids).all()
    assert int(outs[0].max()) < 125 <= pcfg.vocab_size
    greedy = tgen.generate(params, ids, pcfg, 8, device="cpu")
    assert torch.equal(greedy, tgen.generate(params, ids, pcfg, 8, temperature=0.0,
                                             device="cpu",
                                             generator=torch.Generator().manual_seed(9)))
