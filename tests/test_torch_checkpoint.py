"""The port's checkpoints (``utils/checkpoint.py``, on
``torch.distributed.checkpoint``): a mirror of ``tests/utils/test_checkpoint.py``
(round trip, the train state, the crash-atomicity contract: ``.tmp`` and
empty directories skipped, the rename as the commit point, transient I/O
errors retried, persistent ones surfaced, no overwrite), and the Trainer's
resume at dp = 1: a resumed run's next losses equal an uninterrupted run's,
and a restore in the middle of ``fit`` keeps the optimizer on the live
parameters (at dp = 1 its ZeRO shards ARE the parameters).

The resharding restores (a TP2 x DP2 save at tp 1 x dp 4 and at one rank)
and the resume at dp = 2 run in ``test_torch_trainer.py``'s 4-rank spawn.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pipegoose_tpu.testing import TransientIOFault
from pipegoose_tpu_torch.distributed import ParallelContext
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.nn.parallel import tree_leaves
from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
from pipegoose_tpu_torch.trainer import CheckpointCallback
from pipegoose_tpu_torch.utils import checkpoint as ckpt
from test_torch_trainer_ranks import make_trainer, whole_params, whole_state

SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
LR = 1e-3


def _tree():
    np_tree = tbloom.init_params_numpy(tbloom.BloomConfig(**SIZE), seed=0)
    return np_tree, params_from_jax(np_tree, tbloom.BloomConfig(**SIZE), device="cpu")


def _batches(n, seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, SIZE["vocab_size"], (8, 12)).astype(np.int32) for _ in range(n)]


def _trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


@pytest.fixture
def ctx1(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cpu",
                                         tensor_parallel_size=1, data_parallel_size=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the CPU's threaded sums may reorder: runs compared bit for bit
    yield ctx
    torch.set_num_threads(threads)
    ctx.destroy()


@pytest.mark.parametrize("group", ["none", "one_rank"])
def test_roundtrip_replicated(tmp_path, group):
    _, params = _tree()
    ctx = None
    if group == "one_rank":
        store = dist.FileStore(str(tmp_path / "store"), 1)
        ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0,
                                             device="cpu")
    try:
        path = ckpt.save_pretrained(params, str(tmp_path / "m"))
        restored = ckpt.from_pretrained(path, params)
        _trees_equal(params, restored)
        assert all(r.data_ptr() != p.data_ptr()
                   for r, p in zip(tree_leaves(restored), tree_leaves(params)))
        bf16 = {"w": torch.randn(5, 3).bfloat16()}   # bits, not values
        path = ckpt.save_pretrained(bf16, str(tmp_path / "b"), step=2)
        assert path.endswith("step_2")
        _trees_equal(bf16, ckpt.from_pretrained(path, {"w": torch.zeros(5, 3).bfloat16()}))
    finally:
        if ctx is not None:
            ctx.destroy()


def test_train_state_resume(tmp_path):
    """Two saves, the newest restored: the params, a ZeRO state's Adam
    moments and step count (restored in place, into a fresh optimizer),
    and ``extra``."""
    _, params = _tree()
    opt = DistributedOptimizer(adam(LR), axis_name=None)
    state = opt.init(params)
    for p in tree_leaves(params):
        p.grad = torch.randn_like(p)
    for _ in range(2):
        state.inner.step()
    run = str(tmp_path / "run")
    ckpt.save_train_state(run, 3, params, state, extra={"note": "three"})
    ckpt.save_train_state(run, 7, params, state, extra={"note": "seven"})
    assert ckpt.latest_step(run) == 7 and ckpt.available_steps(run) == [7, 3]
    _, fresh = _tree()
    for p in tree_leaves(fresh):
        p.sub_(1.0)
    fstate = opt.init(fresh)
    out = ckpt.restore_train_state(run, None, {"params": fresh, "opt_state": fstate,
                                               "extra": None}, inplace=True)
    assert out["opt_state"] is fstate   # loaded into the live tensors
    assert all(a is b for a, b in zip(tree_leaves(out["params"]), tree_leaves(fresh)))
    assert out["extra"] == {"note": "seven"}
    _trees_equal(params, fresh)
    for p, q in zip(tree_leaves(params), tree_leaves(fresh)):
        a, b = state.inner.state[p], fstate.inner.state[q]
        assert set(a) == set(b) == {"step", "exp_avg", "exp_avg_sq"}
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_zero_state_restores_only_in_place(tmp_path):
    _, params = _tree()
    state = DistributedOptimizer(adam(LR), axis_name=None).init(params)
    ckpt.save_train_state(str(tmp_path / "run"), 1, params, state)
    with pytest.raises(ValueError, match="in place"):
        ckpt.restore_train_state(str(tmp_path / "run"), 1,
                                 {"params": params, "opt_state": state})


def test_missing_checkpoint_raises(tmp_path):
    _, params = _tree()
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path / "nope"), None, {"params": params})


def _tiny():
    return {"w": torch.arange(4, dtype=torch.float32)}


def test_latest_step_skips_tmp_and_empty_directories(tmp_path):
    run = tmp_path / "run"
    ckpt.save_train_state(str(run), 2, _tiny())
    os.makedirs(run / "step_9.tmp")
    (run / "step_9.tmp" / "partial").write_text("torn")
    os.makedirs(run / "step_7")  # mkdir happened, content never landed
    (run / "step_junk").mkdir()  # unparseable step number
    assert ckpt.available_steps(str(run)) == [2]
    assert ckpt.latest_step(str(run)) == 2
    restored = ckpt.restore_train_state(str(run), None, {"params": _tiny()})
    np.testing.assert_array_equal(restored["params"]["w"].numpy(), np.arange(4))


def test_save_is_committed_by_rename(tmp_path):
    path = ckpt.save_train_state(str(tmp_path / "run"), 3, _tiny())
    assert os.path.isdir(path) and not os.path.exists(path + ckpt.TMP_SUFFIX)
    # a stale sibling of a failed earlier attempt is cleared on the next save
    os.makedirs(str(tmp_path / "run" / "step_4.tmp"))
    (tmp_path / "run" / "step_4.tmp" / "stale").write_text("x")
    path = ckpt.save_train_state(str(tmp_path / "run"), 4, _tiny())
    assert "stale" not in os.listdir(path)


def test_save_retries_transient_io_errors(tmp_path):
    fault = TransientIOFault(2)
    prev = ckpt.set_io_fault_hook(fault)
    try:
        ckpt.save_train_state(str(tmp_path / "run"), 1, _tiny())
    finally:
        ckpt.set_io_fault_hook(prev)
    assert fault.fired == 2  # two transient failures absorbed
    assert ckpt.latest_step(str(tmp_path / "run")) == 1
    restored = ckpt.restore_train_state(str(tmp_path / "run"), 1, {"params": _tiny()})
    np.testing.assert_array_equal(restored["params"]["w"].numpy(), np.arange(4))


def test_save_surfaces_persistent_io_errors(tmp_path):
    prev = ckpt.set_io_fault_hook(TransientIOFault(99))
    try:
        with pytest.raises(OSError, match="chaos"):
            ckpt.save_pretrained(_tiny(), str(tmp_path / "m"), retries=2, backoff_s=0.0)
    finally:
        ckpt.set_io_fault_hook(prev)
    assert not os.path.exists(str(tmp_path / "m"))


def test_save_refuses_existing_checkpoint(tmp_path):
    ckpt.save_train_state(str(tmp_path / "run"), 1, _tiny())
    with pytest.raises(ValueError, match="already exists"):
        ckpt.save_train_state(str(tmp_path / "run"), 1, _tiny())


# -- the Trainer at dp = 1 -------------------------------------------------------------------


def test_resume_at_dp1_gives_the_uninterrupted_losses(ctx1, tmp_path):
    np_tree, _ = _tree()
    cfg = tbloom.BloomConfig(**SIZE)
    batches = _batches(6)
    ref = make_trainer(np_tree, cfg, LR)
    want = [float(x) for x in ref.fit(batches).losses]
    run = str(tmp_path / "run")
    t = make_trainer(np_tree, cfg, LR, callbacks=[CheckpointCallback(run, every=2)])
    t.fit(batches[:4])
    assert ckpt.available_steps(run) == [4, 2]
    resumed = make_trainer(np_tree, cfg, LR, resume_dir=run)
    assert resumed.state.step == 4
    assert all(s["step"] == 4.0 for s in whole_state(resumed))
    got = [float(x) for x in resumed.fit(batches[4:]).losses]
    assert got == want[4:]
    fresh = make_trainer(np_tree, cfg, LR, resume_dir=str(tmp_path / "empty"))
    assert fresh.state.step == 0


def test_restore_mid_fit_keeps_the_optimizer_on_the_live_params(ctx1, tmp_path):
    """At dp = 1 the inner Adam is keyed by the parameter tensors
    themselves: a restore that bound new tensors would leave it updating
    orphans, and the loss would stop moving. The restore copies into the
    live tensors, so rolling back to step 2 and replaying gives the
    uninterrupted run's losses and params."""
    np_tree, _ = _tree()
    cfg = tbloom.BloomConfig(**SIZE)
    batches = _batches(4)
    ref = make_trainer(np_tree, cfg, LR)
    want = [float(x) for x in ref.fit(batches).losses]
    run = str(tmp_path / "run")
    t = make_trainer(np_tree, cfg, LR, callbacks=[CheckpointCallback(run, every=2)])
    live = [p.data_ptr() for p in tree_leaves(t.params)]
    t.fit(batches)
    assert t.restore_from(run, 2) == 2 and t.state.step == 2
    assert [p.data_ptr() for p in tree_leaves(t.params)] == live
    assert t.opt_state.shards[0] is tree_leaves(t.params)[0]
    del t.state.losses[2:]
    got = [float(x) for x in t.fit(batches[2:]).losses]
    assert got == want
    ref_p, got_p = whole_params(ref), whole_params(t)
    for k in ("embed", "ln_f"):
        for name in ref_p[k]:
            np.testing.assert_array_equal(got_p[k][name], ref_p[k][name])
