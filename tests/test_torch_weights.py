"""``models/weights.py`` follows each tree's own top-level keys.

- BLOOM keeps its leaf order: ``param_leaves`` walks ``embed``, ``embed_ln``,
  every block layer by layer, ``ln_f``, as before the other families came,
  whatever order the numpy tree's dict holds its keys in (a JAX-derived
  tree sorts them); the ZeRO-1 state's shards follow that order with the
  same shard shapes, and a train-state checkpoint round trip restores every
  leaf and moment bit for bit.
- A Llama tree (untied and tied) and a Mixtral tree convert both ways, go
  through ``make_optimizer`` (an Adam step moves every leaf), the ZeRO
  optimizer, and ``Trainer.fit`` with ``CheckpointCallback``: a Trainer
  resumed from the checkpoint holds the saved params bit for bit and
  continues with the uninterrupted run's losses.

Tiny configs (vocab 128, hidden 64, 2 layers), CPU, one rank.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pipegoose_tpu_torch.distributed import ParallelContext
from pipegoose_tpu_torch.models import bloom, llama, mixtral
from pipegoose_tpu_torch.models.weights import (
    grads_of,
    param_leaves,
    params_from_jax,
    params_to_jax,
)
from pipegoose_tpu_torch.nn.parallel import tree_leaves
from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
from pipegoose_tpu_torch.optim.zero import shard_shapes
from pipegoose_tpu_torch.trainer import CheckpointCallback, Trainer
from pipegoose_tpu_torch.trainer.step import make_optimizer
from pipegoose_tpu_torch.utils import checkpoint as ckpt

BLOOM = bloom.BloomConfig(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
ROPE = dict(vocab_size=128, hidden_size=64, intermediate_size=112, n_layer=2, n_head=4,
            n_kv_head=2)
FAMILIES = {
    "llama": (llama, llama.LlamaConfig(**ROPE)),
    "llama_tied": (llama, llama.LlamaConfig(**ROPE, tie_word_embeddings=True)),
    "mixtral": (mixtral, mixtral.MixtralConfig(**ROPE, num_experts=4, top_k=2)),
}


def _old_bloom_order(params):
    """The leaf order of BLOOM's tree before the keys were read from the tree."""
    out = []
    for key in ("embed", "embed_ln"):
        out += tree_leaves(params[key])
    for blk in params["blocks"]:
        out += tree_leaves(blk)
    return out + tree_leaves(params["ln_f"])


def test_bloom_leaf_order_zero_layout_and_checkpoint_unchanged(tmp_path):
    np_tree = bloom.init_params_numpy(BLOOM, seed=0)
    sorted_tree = {k: np_tree[k] for k in sorted(np_tree)}   # a JAX tree's key order
    for tree in (np_tree, sorted_tree):
        params = params_from_jax(tree, BLOOM, device="cpu")
        assert list(params) == ["embed", "embed_ln", "blocks", "ln_f"]
        assert [id(t) for t in param_leaves(params)] == [id(t) for t in
                                                        _old_bloom_order(params)]
        assert list(params_to_jax(params)) == ["embed", "embed_ln", "blocks", "ln_f"]
    reordered = {k: params[k] for k in ("ln_f", "blocks", "embed_ln", "embed")}
    assert [id(t) for t in param_leaves(reordered)] == [id(t) for t in
                                                       _old_bloom_order(params)]
    state = DistributedOptimizer(adam(1e-3), axis_name=None).init(params)
    shards = state.inner.param_groups[0]["params"]   # at one rank, the params
    assert [id(s) for s in shards] == [id(t) for t in _old_bloom_order(params)]
    shapes = tree_leaves(shard_shapes(params, 2))
    want = [(-(-t.shape[0] // 2), *t.shape[1:]) for t in _old_bloom_order(params)]
    assert shapes == want
    for p in tree_leaves(params):
        p.grad = torch.randn_like(p)
    state.inner.step()
    ckpt.save_train_state(str(tmp_path / "run"), 1, params, state)
    fresh = params_from_jax(np_tree, BLOOM, device="cpu")
    fstate = DistributedOptimizer(adam(1e-3), axis_name=None).init(fresh)
    ckpt.restore_train_state(str(tmp_path / "run"), 1,
                             {"params": fresh, "opt_state": fstate}, inplace=True)
    for p, q in zip(tree_leaves(params), tree_leaves(fresh)):
        assert torch.equal(p, q)
        a, b = state.inner.state[p], fstate.inner.state[q]
        assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq"))


@pytest.fixture
def ctx1(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cpu",
                                         tensor_parallel_size=1, data_parallel_size=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # runs compared bit for bit
    yield ctx
    torch.set_num_threads(threads)
    ctx.destroy()


def _batches(n):
    rs = np.random.RandomState(3)
    return [rs.randint(1, 128, (4, 10)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_rope_family_trees_train_and_checkpoint(name, ctx1, tmp_path):
    module, cfg = FAMILIES[name]
    np_tree = module.init_params_numpy(cfg, seed=0)
    params = params_from_jax(np_tree, cfg, device="cpu")
    want_keys = ["embed", "blocks", "ln_f"] + ([] if name == "llama_tied" else ["lm_head"])
    assert list(params) == want_keys == list(params_to_jax(params))
    assert [id(t) for t in param_leaves(params)] == [id(t) for t in tree_leaves(params)]
    opt = make_optimizer(params, 1e-2)
    before = [t.detach().clone() for t in param_leaves(params)]
    ids = torch.from_numpy(_batches(1)[0]).long()
    module.loss_fn(params, ids, None, ids, cfg).backward()
    assert all(g.abs().sum() > 0 for g in tree_leaves(grads_of(params)))
    opt.step()
    assert all(not torch.equal(a, b) for a, b in zip(before, param_leaves(params)))

    def lf(p, batch):
        return module.loss_fn(p, batch, None, batch, cfg)

    def trainer(**kw):
        whole = params_from_jax(np_tree, cfg, device="cpu")
        return Trainer(lf, whole, module.specs(whole),
                       DistributedOptimizer(adam(1e-3), axis_name="data"), **kw)

    batches = _batches(4)
    ref = trainer()
    want = [float(x) for x in ref.fit(batches).losses]
    run = str(tmp_path / "run")
    t = trainer(callbacks=[CheckpointCallback(run, every=2)])
    t.fit(batches[:2])
    assert ckpt.available_steps(run) == [2]
    resumed = trainer(resume_dir=run)
    assert resumed.state.step == 2
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(t.params)):
        assert torch.equal(a, b)
    got = [float(x) for x in resumed.fit(batches[2:]).losses]
    assert got == want[2:] and np.all(np.isfinite(want))
