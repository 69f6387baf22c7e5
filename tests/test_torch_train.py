"""The port's training path held against the JAX package on the CPU:
``bloom.loss_fn`` and every parameter gradient against
``jax.value_and_grad(bloom.loss_fn)`` (plain and flash attention; the
full-logits, fused (``fused_ce``) and chunked (``ce_chunks``) losses),
full and selective remat against none, three ``train_step`` calls against
three steps of ``value_and_grad`` + ``optax.adam`` (full-logits and
fused), the weights' round trip and the probes that must raise.

Tiny BLOOM (vocab 256, hidden 64, 2 layers, 4 heads), B=2 x S=32 with row
1 right-padded, nonzero LayerNorm and bias leaves; inputs and weights
from a numpy seed, float32 throughout.

Tolerances: loss 2e-6 and gradients 2e-6 absolute (values of order 1 and
below; the frameworks sum the same float32 products in another order).
After three Adam steps the params agree to 2e-5 (lr / 50) and the losses
to 1e-5: Adam divides each gradient by its own root-mean-square, so where
a gradient is near zero its rounding is a large share of it and the
update, of order lr = 1e-3, moves by a visible fraction of lr (4.2e-6 at
worst on these inputs, one weight of 24576).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.nn.tensor_parallel import layers as jlayers
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import (
    grads_of,
    param_leaves,
    params_from_jax,
    params_to_jax,
)
from pipegoose_tpu_torch.nn.tensor_parallel import layers as tlayers
from pipegoose_tpu_torch.serving.kv_pool import init_pages, paged_prefill_chunk
from pipegoose_tpu_torch.trainer import make_optimizer, train_step

LOSS_ATOL = 2e-6
GRAD_ATOL = 2e-6
ADAM_PARAM_ATOL = 2e-5
ADAM_LOSS_ATOL = 1e-5
LR = 1e-3
SIZE = dict(vocab_size=256, hidden_size=64, n_layer=2, n_head=4)
B, S = 2, 32


def _cfgs(**kw):
    return jbloom.BloomConfig(**SIZE, **kw), tbloom.BloomConfig(**SIZE, **kw)


@pytest.fixture(scope="module")
def data():
    """Weights with nonzero LayerNorm and bias leaves, ids, labels and a
    mask whose row 1 is right-padded."""
    np_tree = tbloom.init_params_numpy(tbloom.BloomConfig(**SIZE), seed=0)
    rng = np.random.default_rng(1)
    leaves = [np_tree["embed_ln"], np_tree["ln_f"], np_tree["blocks"]["ln_1"],
              np_tree["blocks"]["ln_2"]]
    for ln in leaves:
        for name in ("scale", "bias"):
            ln[name] += rng.standard_normal(ln[name].shape, dtype=np.float32) * 0.1
    for sub in ("qkv", "out"):
        b = np_tree["blocks"]["attn"][sub]["bias"]
        b += rng.standard_normal(b.shape, dtype=np.float32) * 0.1
    for sub in ("up", "down"):
        b = np_tree["blocks"]["mlp"][sub]["bias"]
        b += rng.standard_normal(b.shape, dtype=np.float32) * 0.1
    ids = rng.integers(0, SIZE["vocab_size"], (B, S)).astype(np.int32)
    labels = rng.integers(0, SIZE["vocab_size"], (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, S - 11:] = 0
    return np_tree, ids, labels, mask


def _torch_loss_and_grads(np_tree, tcfg, ids, mask, labels):
    params = params_from_jax(np_tree, tcfg, device="cpu")
    for t in param_leaves(params):
        t.requires_grad_(True)
    loss = tbloom.loss_fn(params, torch.from_numpy(ids).long(),
                          torch.from_numpy(mask), torch.from_numpy(labels).long(),
                          tcfg)
    loss.backward()
    return loss.item(), params_to_jax(grads_of(params))


def _assert_trees_close(got, want, atol):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = jax.tree_util.tree_leaves(got)
    assert len(flat_got) == len(paths)
    for (path, w), g in zip(paths, flat_got):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_loss_and_every_grad_match_jax(data, use_flash):
    np_tree, ids, labels, mask = data
    jcfg, tcfg = _cfgs(use_flash=use_flash)
    jloss, jgrads = jax.value_and_grad(jbloom.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, np_tree), jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(labels), jcfg)
    loss, grads = _torch_loss_and_grads(np_tree, tcfg, ids, mask, labels)
    assert abs(loss - float(jloss)) <= LOSS_ATOL
    _assert_trees_close(grads, jgrads, GRAD_ATOL)


def test_forward_logits_match_jax(data):
    np_tree, ids, _, mask = data
    jcfg, tcfg = _cfgs(use_flash=True)
    want = jbloom.forward(jax.tree_util.tree_map(jnp.asarray, np_tree),
                          jnp.asarray(ids), jnp.asarray(mask), jcfg)
    got = tbloom.forward(params_from_jax(np_tree, tcfg, device="cpu"),
                         torch.from_numpy(ids).long(), torch.from_numpy(mask), tcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=LOSS_ATOL)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_remat_gives_the_same_loss_and_grads(data, use_flash):
    np_tree, ids, labels, mask = data
    _, plain = _cfgs(use_flash=use_flash)
    _, remat = _cfgs(use_flash=use_flash, remat=True)
    loss0, g0 = _torch_loss_and_grads(np_tree, plain, ids, mask, labels)
    loss1, g1 = _torch_loss_and_grads(np_tree, remat, ids, mask, labels)
    assert loss0 == loss1
    _assert_trees_close(g1, g0, 0.0)


def _jax_loss_and_grads(np_tree, jcfg, ids, mask, labels):
    return jax.value_and_grad(jbloom.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, np_tree), jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(labels), jcfg)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_fused_ce_loss_and_every_grad_match_jax(data, use_flash):
    """The fused loss (plain versions of the kernels on the CPU) against
    the JAX fused loss (Pallas in interpret mode): the LM head's gradient
    reaches the tied embedding through the dw kernel."""
    np_tree, ids, labels, mask = data
    jcfg, tcfg = _cfgs(use_flash=use_flash, fused_ce=True)
    jloss, jgrads = _jax_loss_and_grads(np_tree, jcfg, ids, mask, labels)
    loss, grads = _torch_loss_and_grads(np_tree, tcfg, ids, mask, labels)
    assert abs(loss - float(jloss)) <= LOSS_ATOL
    _assert_trees_close(grads, jgrads, GRAD_ATOL)


@pytest.mark.parametrize("n_chunks", [4, 5])
def test_ce_chunks_loss_and_every_grad_match_jax(data, n_chunks):
    """S - 1 = 31 positions: neither 4 nor 5 divides them, so both take
    the weight-0 pad path."""
    np_tree, ids, labels, mask = data
    jcfg, tcfg = _cfgs(use_flash=True, ce_chunks=n_chunks)
    jloss, jgrads = _jax_loss_and_grads(np_tree, jcfg, ids, mask, labels)
    loss, grads = _torch_loss_and_grads(np_tree, tcfg, ids, mask, labels)
    assert abs(loss - float(jloss)) <= LOSS_ATOL
    _assert_trees_close(grads, jgrads, GRAD_ATOL)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("policy", ["dots", "attn", "unknown"])
def test_remat_policies_give_the_same_loss_and_grads(data, policy, use_flash):
    """A selective policy only decides what backward recomputes: loss and
    gradients equal the no-remat run exactly, and JAX's under the same
    policy within GRAD_ATOL. An unknown policy is full remat, as in JAX."""
    np_tree, ids, labels, mask = data
    _, plain = _cfgs(use_flash=use_flash)
    jcfg, tcfg = _cfgs(use_flash=use_flash, remat=True, remat_policy=policy)
    loss0, g0 = _torch_loss_and_grads(np_tree, plain, ids, mask, labels)
    loss1, g1 = _torch_loss_and_grads(np_tree, tcfg, ids, mask, labels)
    assert loss0 == loss1
    _assert_trees_close(g1, g0, 0.0)
    jloss, jgrads = _jax_loss_and_grads(np_tree, jcfg, ids, mask, labels)
    assert abs(loss1 - float(jloss)) <= LOSS_ATOL
    _assert_trees_close(g1, jgrads, GRAD_ATOL)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_recomputes_no_linear_product(data):
    """Under "dots" the backward runs as many ``aten.mm`` as without remat
    (the products' own gradients), while full remat adds the recomputed
    forward products."""
    np_tree, ids, labels, mask = data
    mm = {}
    for name, kw in (("none", {}), ("full", dict(remat=True)),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        _, tcfg = _cfgs(**kw)
        params = params_from_jax(np_tree, tcfg, device="cpu")
        for t in param_leaves(params):
            t.requires_grad_(True)
        loss = tbloom.loss_fn(params, torch.from_numpy(ids).long(),
                              torch.from_numpy(mask),
                              torch.from_numpy(labels).long(), tcfg)
        with _CountOps() as counter:
            loss.backward()
        mm[name] = counter.counts.get(torch.ops.aten.mm.default, 0)
    assert mm["dots"] == mm["none"] < mm["full"]


def test_no_mask_takes_the_plain_mean(data):
    np_tree, ids, labels, _ = data
    jcfg, tcfg = _cfgs(use_flash=True)
    jloss = jbloom.loss_fn(jax.tree_util.tree_map(jnp.asarray, np_tree),
                           jnp.asarray(ids), None, jnp.asarray(labels), jcfg)
    loss = tbloom.loss_fn(params_from_jax(np_tree, tcfg, device="cpu"),
                          torch.from_numpy(ids).long(), None,
                          torch.from_numpy(labels).long(), tcfg)
    assert abs(loss.item() - float(jloss)) <= LOSS_ATOL


def test_three_train_steps_match_optax_adam(data):
    np_tree, ids, labels, mask = data
    jcfg, tcfg = _cfgs(use_flash=True, remat=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    opt = optax.adam(LR)
    opt_state = opt.init(jparams)
    value_and_grad = jax.jit(jax.value_and_grad(jbloom.loss_fn), static_argnums=4)
    jlosses = []
    for _ in range(3):
        loss, grads = value_and_grad(
            jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels), jcfg)
        updates, opt_state = opt.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jlosses.append(float(loss))
    params = params_from_jax(np_tree, tcfg, device="cpu")
    optimizer = make_optimizer(params, LR)
    losses = [train_step(params, optimizer, ids, mask, labels, tcfg,
                         device="cpu").item() for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=ADAM_LOSS_ATOL)
    assert losses[2] < losses[0]
    _assert_trees_close(params_to_jax(params), jparams, ADAM_PARAM_ATOL)


def test_three_fused_ce_train_steps_match_optax_adam(data):
    np_tree, ids, labels, mask = data
    jcfg, tcfg = _cfgs(use_flash=True, remat=True, fused_ce=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    opt = optax.adam(LR)
    opt_state = opt.init(jparams)
    jlosses = []
    for _ in range(3):
        loss, grads = jax.value_and_grad(jbloom.loss_fn)(
            jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(labels), jcfg)
        updates, opt_state = opt.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        jlosses.append(float(loss))
    params = params_from_jax(np_tree, tcfg, device="cpu")
    optimizer = make_optimizer(params, LR)
    losses = [train_step(params, optimizer, ids, mask, labels, tcfg,
                         device="cpu").item() for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=ADAM_LOSS_ATOL)
    assert losses[2] < losses[0]
    _assert_trees_close(params_to_jax(params), jparams, ADAM_PARAM_ATOL)


def test_params_round_trip_and_own_tensors(data):
    np_tree = data[0]
    _, tcfg = _cfgs()
    params = params_from_jax(np_tree, tcfg, device="cpu")
    _assert_trees_close(params_to_jax(params), np_tree, 0.0)
    k0 = params["blocks"][0]["attn"]["qkv"]["kernel"]
    k1 = params["blocks"][1]["attn"]["qkv"]["kernel"]
    assert k0._base is None and k1._base is None   # leaves an optimizer can own
    assert not any(t.requires_grad for t in param_leaves(params))


def test_adam_step_changes_what_serving_reads(data):
    """The optimizer updates the same tensors the serving forward reads,
    in place: prefill logits move with the step and equal those of a
    fresh conversion of the updated weights."""
    np_tree, ids, labels, mask = data
    _, tcfg = _cfgs(use_flash=True)
    params = params_from_jax(np_tree, tcfg, device="cpu")
    ptrs = [t.data_ptr() for t in param_leaves(params)]
    source = params_to_jax(params)

    def prefill(p):
        k, v = init_pages(tcfg, 5, 8, device="cpu")
        i32 = lambda a: torch.tensor(a, dtype=torch.int32)  # noqa: E731
        return paged_prefill_chunk(p, i32(ids[:1]), k, v, i32([[1, 2, 3, 4]]),
                                   i32([0]), i32([S]), tcfg)

    before = prefill(params)
    train_step(params, make_optimizer(params, LR), ids, mask, labels, tcfg,
               device="cpu")
    after = prefill(params)
    assert [t.data_ptr() for t in param_leaves(params)] == ptrs
    assert not after.requires_grad
    assert (after - before).abs().max().item() > 1e-4
    fresh = prefill(params_from_jax(params_to_jax(params), tcfg, device="cpu"))
    torch.testing.assert_close(after, fresh, rtol=0, atol=0)
    _assert_trees_close(np_tree, source, 0.0)   # the source arrays untouched


def test_cross_entropy_and_padded_vocab_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 16), dtype=np.float32) * 3
    targets = rng.integers(0, 12, (2, 5)).astype(np.int32)
    for valid in (None, 12):
        want = jlayers.vocab_parallel_cross_entropy(
            jnp.asarray(logits), jnp.asarray(targets), None, valid_size=valid)
        got = tlayers.vocab_parallel_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(targets), None,
            valid_size=valid)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        tlayers.mask_padded_vocab(torch.from_numpy(logits), None, 12).numpy(),
        np.asarray(jlayers.mask_padded_vocab(jnp.asarray(logits), None, 12)))


def test_build_alibi_matches_jax():
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.int32)
    np.testing.assert_array_equal(
        tbloom.build_alibi(torch.from_numpy(mask), 4).numpy(),
        np.asarray(jbloom.build_alibi(jnp.asarray(mask), 4)))


@pytest.mark.parametrize("probe", ["tp_axis_loss", "tp_axis_ce", "tp_axis_fused_ce"])
def test_unported_options_raise(data, probe):
    np_tree, ids, labels, mask = data
    _, tcfg = _cfgs(fused_ce=probe == "tp_axis_fused_ce")
    params = params_from_jax(np_tree, tcfg, device="cpu")
    args = (torch.from_numpy(ids).long(), torch.from_numpy(mask),
            torch.from_numpy(labels).long())
    # a tensor axis needs a ParallelContext (the sharded loss is held in
    # test_torch_hybrid.py)
    with pytest.raises(RuntimeError, match="needs a ParallelContext"):
        if probe == "tp_axis_ce":
            tlayers.vocab_parallel_cross_entropy(torch.zeros(1, 4), torch.zeros(
                1, dtype=torch.long), "tensor")
        else:
            tbloom.loss_fn(params, *args, tcfg, tp_axis="tensor")


def test_cuda_device_without_a_card_raises(data):
    np_tree, ids, labels, _ = data
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    _, tcfg = _cfgs()
    params = params_from_jax(np_tree, tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        train_step(params, make_optimizer(params, LR), ids, None, labels, tcfg)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        params_from_jax(np_tree, tcfg)
