"""Failure detection and automatic recovery of the port's Trainer: a mirror
of ``tests/trainer/test_recovery.py`` (but its flight-recorder test: the
recorder is ROADMAP.md queue A, item 13), each test with the same
poisoned-batch schedule and the same expected steps and restore counts, at
tp = dp = 1 on one gloo rank in this process. The restores also give back
an uninterrupted run: its losses and params bit for bit. The same at dp =
2 runs in ``test_torch_trainer.py``'s 4-rank spawn.
"""
import logging
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pipegoose_tpu_torch.distributed import ParallelContext
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.nn.parallel import tree_leaves
from pipegoose_tpu_torch.trainer import (
    AutoRecovery,
    CheckpointCallback,
    FailureDetector,
    TrainerStatus,
    TrainingDiverged,
)
from pipegoose_tpu_torch.utils.checkpoint import available_steps, latest_step
from test_torch_trainer_ranks import POISON, make_trainer, whole_params

SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
LR = 1e-3


@pytest.fixture()
def parts(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cpu",
                                         tensor_parallel_size=1, data_parallel_size=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the CPU's threaded sums may reorder: runs compared bit for bit
    cfg = tbloom.BloomConfig(**SIZE)
    yield cfg, tbloom.init_params_numpy(cfg, seed=0)
    torch.set_num_threads(threads)
    ctx.destroy()


def _batch(seed, poison=False):
    ids = np.random.RandomState(seed).randint(1, SIZE["vocab_size"], (8, 8))
    if poison:
        ids[0, 0] = POISON
    return ids


def _trainer(parts, callbacks):
    cfg, np_tree = parts
    return make_trainer(np_tree, cfg, LR, poison=True, callbacks=callbacks)


def _tear_checkpoint(directory):
    """The newest complete checkpoint's contents replaced by a stub: still
    listed, no longer restorable (as ``pipegoose_tpu.testing.tear_checkpoint``)."""
    steps = available_steps(directory)
    path = os.path.join(os.path.abspath(directory), f"step_{steps[0]}")
    shutil.rmtree(path)
    os.makedirs(path)
    with open(os.path.join(path, "TORN"), "w") as f:
        f.write("simulated torn checkpoint write\n")
    return path


def test_detector_raises_on_nan(parts):
    trainer = _trainer(parts, [FailureDetector()])
    batches = [_batch(1), _batch(2, poison=True), _batch(3)]
    with pytest.raises(TrainingDiverged, match="non-finite"):
        trainer.fit(batches)
    assert trainer.state.step == 2  # failed ON the poisoned step


def test_detector_spike(parts):
    det = FailureDetector(spike_factor=10.0, window=4)
    trainer = _trainer(parts, [det])
    trainer.fit([_batch(s) for s in range(1, 5)])
    assert det._is_divergent(1e6) is not None
    assert det._is_divergent(float(trainer.state.last_loss)) is None


def test_auto_recovery_restores_and_continues(parts, tmp_path):
    run_dir = str(tmp_path / "run")
    rec = AutoRecovery(run_dir, max_restores=2)
    trainer = _trainer(parts, [CheckpointCallback(run_dir, every=2), rec])
    batches = [
        _batch(1), _batch(2),                    # steps 1-2 (ckpt @2)
        _batch(3, poison=True),                  # step 3 diverges -> restore @2
        _batch(4), _batch(5),                    # continue: steps 3-4 (ckpt @4)
    ]
    state = trainer.fit(batches)
    assert rec.restores == 1
    assert state.step == 4
    assert np.isfinite(float(state.last_loss))
    assert all(np.isfinite(float(x)) for x in state.losses)
    for leaf in tree_leaves(trainer.params):
        assert torch.isfinite(leaf).all()
    # ... and equal a run that never saw the poisoned batch
    clean = _trainer(parts, [])
    want = clean.fit([_batch(1), _batch(2), _batch(4), _batch(5)])
    assert [float(x) for x in state.losses] == [float(x) for x in want.losses]
    got_p, want_p = whole_params(trainer), whole_params(clean)
    for k in ("embed", "ln_f"):
        for name in want_p[k]:
            np.testing.assert_array_equal(got_p[k][name], want_p[k][name])


def test_rollback_on_save_boundary_does_not_mislabel(parts, tmp_path):
    run_dir = str(tmp_path / "run")
    rec = AutoRecovery(run_dir, max_restores=1)
    trainer = _trainer(parts, [CheckpointCallback(run_dir, every=1), rec])
    batches = [
        _batch(1),                 # step 1, ckpt@1
        _batch(2, poison=True),    # diverges -> restore @1, NO save
        _batch(3),                 # replayed step 2, ckpt@2
        _batch(4),                 # step 3, ckpt@3
    ]
    state = trainer.fit(batches)
    assert state.step == 3 and rec.restores == 1
    assert latest_step(run_dir) == 3

    def leaf_at(step):
        trainer.restore_from(run_dir, step)
        return trainer.params["blocks"][0]["attn"]["qkv"]["kernel"].detach().clone()

    p1, p2 = leaf_at(1), leaf_at(2)
    assert not torch.equal(p1, p2), "step_2 checkpoint holds step_1's params"


def test_auto_recovery_exhausts(parts, tmp_path):
    run_dir = str(tmp_path / "run")
    rec = AutoRecovery(run_dir, max_restores=1)
    trainer = _trainer(parts, [CheckpointCallback(run_dir, every=1), rec])
    batches = [_batch(1)] + [_batch(s, poison=True) for s in (2, 3)]
    with pytest.raises(TrainingDiverged, match="persistent"):
        trainer.fit(batches)
    assert rec.restores == 1


def test_auto_recovery_without_checkpoint_raises(parts, tmp_path):
    rec = AutoRecovery(str(tmp_path / "never_written"))
    trainer = _trainer(parts, [rec])
    with pytest.raises(TrainingDiverged, match="no checkpoint"):
        trainer.fit([_batch(1, poison=True)])


def test_failed_status_on_divergence(parts):
    trainer = _trainer(parts, [FailureDetector()])
    with pytest.raises(TrainingDiverged):
        trainer.fit([_batch(1, poison=True)])
    assert trainer.state.status is TrainerStatus.FAILED


def test_torn_newest_checkpoint_falls_back_to_older(parts, tmp_path):
    run_dir = str(tmp_path / "run")
    rec = AutoRecovery(run_dir, max_restores=3)
    trainer = _trainer(parts, [CheckpointCallback(run_dir, every=1), rec])
    trainer.fit([_batch(1), _batch(2)])
    torn = _tear_checkpoint(run_dir)
    assert torn.endswith("step_2")
    state = trainer.fit([_batch(3, poison=True), _batch(4)])
    # one budget burned on the torn step_2, one on the good step_1
    assert rec.restores == 2
    assert state.step == 2
    assert np.isfinite(float(state.last_loss))
    # the unrestorable step_2 was quarantined out of the step namespace
    assert (tmp_path / "run" / "step_2.corrupt").is_dir()
    assert not (tmp_path / "run" / "step_2").exists()
    assert 2 not in available_steps(run_dir)


def test_checkpoint_callback_skips_step_already_on_disk(tmp_path):
    trainer = SimpleNamespace(
        state=SimpleNamespace(step=1, last_loss=None),
        params={"w": torch.ones(4)}, opt_state={"m": torch.zeros(4)},
        logger=logging.getLogger("test-torch-ckpt-skip"), callbacks=[],
    )
    cb = CheckpointCallback(str(tmp_path), every=1)
    cb.on_step_end(trainer, 1, 0.0)
    assert available_steps(str(tmp_path)) == [1]
    fresh = CheckpointCallback(str(tmp_path), every=1)  # restart shape
    fresh.on_step_end(trainer, 1, 0.0)   # must skip, not ValueError
    assert fresh._last_saved == 1
    assert available_steps(str(tmp_path)) == [1]


def test_quarantined_step_can_be_resaved_by_fresh_callback(parts, tmp_path):
    cfg, np_tree = parts
    run_dir = str(tmp_path / "run")
    trainer = _trainer(parts, [CheckpointCallback(run_dir, every=1), AutoRecovery(run_dir)])
    trainer.fit([_batch(1), _batch(2)])
    _tear_checkpoint(run_dir)
    # "restarted" process: fresh callbacks, same directory
    rec = AutoRecovery(run_dir, max_restores=3)
    trainer2 = _trainer(parts, [CheckpointCallback(run_dir, every=1), rec])
    state = trainer2.fit([_batch(3, poison=True), _batch(4)])
    assert rec.restores == 2      # torn step_2 skipped, step_1 restored
    assert state.step == 2
    assert available_steps(run_dir) == [2, 1]   # step_2 RE-saved cleanly


def test_torn_newest_with_exhausted_budget_surfaces(parts, tmp_path):
    run_dir = str(tmp_path / "run")
    rec = AutoRecovery(run_dir, max_restores=1)
    trainer = _trainer(parts, [CheckpointCallback(run_dir, every=1), rec])
    trainer.fit([_batch(1), _batch(2)])
    _tear_checkpoint(run_dir)
    with pytest.raises(TrainingDiverged, match="restores"):
        trainer.fit([_batch(3, poison=True)])
    assert rec.restores == 1


def test_checkpoint_refuses_nonfinite_state(parts, tmp_path):
    run_dir = str(tmp_path / "run")
    # check_every=2: the step-1 divergence is never checked; fit ends
    # normally with last_loss = NaN still recorded
    det = FailureDetector(check_every=2)
    trainer = _trainer(parts, [CheckpointCallback(run_dir, every=1), det])
    trainer.fit([_batch(1, poison=True)])
    assert latest_step(run_dir) is None, "non-finite state was checkpointed"


@pytest.mark.parametrize("where", ["param", "moment"])
def test_checkpoint_refuses_nonfinite_params_or_moments(parts, tmp_path, where):
    """The second guard: a finite loss over a non-finite parameter or Adam
    moment (an update that overflowed) is not saved either."""
    run_dir = str(tmp_path / "run")
    cb = CheckpointCallback(run_dir, every=2, save_final=False)
    trainer = _trainer(parts, [cb])
    trainer.fit([_batch(1)])
    leaf = tree_leaves(trainer.params)[3]
    with torch.no_grad():
        if where == "param":
            leaf[0] = float("inf")
        else:
            trainer.opt_state.inner.state[trainer.opt_state.shards[3]]["exp_avg_sq"][0] = \
                float("nan")
    cb._save(trainer, 1)
    assert latest_step(run_dir) is None
    with torch.no_grad():
        if where == "param":
            leaf[0] = 0.0
        else:
            trainer.opt_state.inner.state[trainer.opt_state.shards[3]]["exp_avg_sq"][0] = 0.0
    cb._save(trainer, 1)
    assert latest_step(run_dir) == 1


def test_recorder_is_not_ported():
    """The flight recorder is ported now (A13a): a detector keeps the
    recorder it is given, and consumes its pending trigger
    (``tests/test_torch_flightrec.py`` drives it through ``fit``)."""
    from pipegoose_tpu_torch.telemetry import FlightRecorder

    rec = FlightRecorder("unused")
    det = FailureDetector(recorder=rec)
    assert det.recorder is rec and det.active_trigger is None
