"""The port's Trainer held against the JAX Trainer on the CPU.

- TP2 x DP2 over 4 gloo ranks, 5 steps of ``Trainer.fit``, full logits and
  remat + flash + fused CE: the losses and the final params (gathered
  whole) against the JAX ``Trainer.fit`` on a (data 2, tensor 2) mesh with
  the same batches, to ``tests/test_hybrid.py``'s rtol 2e-3, atol 2e-4. In
  the same spawn: the first run's checkpoint (step 5) restored at tp 1 x
  dp 4 through ``Trainer.rebuild`` + ``restore_from``, and here at one
  rank, params and Adam moments equal to the whole saved bit for bit; a
  resume at dp 2 and ``AutoRecovery`` over a poisoned batch at dp 2 giving
  an uninterrupted run's losses and params.
- The same fit at tp = dp = 1 in this process against the JAX Trainer.
- The callback order and events, ``max_steps``, the FAILED and INTERRUPTED
  status with ``on_fit_abort``, the caller's tree left unchanged,
  ``evaluate`` (plain, ``weight_fn``, ``n_accum = 2``) against JAX
  ``evaluate``, ``LossHistory``, the profiler trace, ``with_rng``, the
  accumulated loss alone against JAX ``make_accumulating_loss``, and the
  options that are not ported (ROADMAP.md queue A, item 13) raising.

Tiny BLOOM (vocab 128, hidden 64, 2 layers, 4 heads), B = 8 x S = 12,
float32; weights and data from numpy seeds. The ranks' bodies live in
``test_torch_trainer_ranks.py``; one 4-rank spawn for the file.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from pipegoose_tpu.core import accumulation as jacc
from pipegoose_tpu.distributed import ParallelContext as JaxContext
from pipegoose_tpu.models import bloom as jbloom
from pipegoose_tpu.optim.zero import DistributedOptimizer as JaxZero
from pipegoose_tpu.trainer import Trainer as JaxTrainer
from pipegoose_tpu.trainer.state import LossHistory as JaxLossHistory
from pipegoose_tpu_torch.core import accumulation as tacc
from pipegoose_tpu_torch.distributed import ParallelContext
from pipegoose_tpu_torch.models import bloom as tbloom
from pipegoose_tpu_torch.models.weights import params_from_jax
from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
from pipegoose_tpu_torch.testing.dist import run_ranks
from pipegoose_tpu_torch.trainer import (
    AutoRecovery,
    Callback,
    Trainer,
    TrainerStatus,
)
from pipegoose_tpu_torch.trainer.state import LossHistory
from pipegoose_tpu_torch.utils.checkpoint import restore_train_state
from test_torch_trainer_ranks import make_trainer, trainer_rank, whole_params, whole_state

SIZE = dict(vocab_size=128, hidden_size=64, n_layer=2, n_head=4)
BATCH, SEQ, LR = 8, 12, 1e-3
RTOL, ATOL = 2e-3, 2e-4           # tests/test_hybrid.py:78
RUNS = {"full_logits": dict(),
        "remat_flash_fused_ce": dict(remat=True, use_flash=True, fused_ce=True)}


@functools.lru_cache(maxsize=None)
def _data():
    """Weights with nonzero LayerNorm and bias leaves, and 6 batches of ids
    >= 1 (id 0 is the recovery runs' poison)."""
    np_tree = tbloom.init_params_numpy(tbloom.BloomConfig(**SIZE), seed=0)
    rng = np.random.default_rng(1)
    for ln in (np_tree["embed_ln"], np_tree["ln_f"], np_tree["blocks"]["ln_1"],
               np_tree["blocks"]["ln_2"]):
        for name in ("scale", "bias"):
            ln[name] += rng.standard_normal(ln[name].shape, dtype=np.float32) * 0.1
    rs = np.random.RandomState(2)
    batches = [rs.randint(1, SIZE["vocab_size"], (BATCH, SEQ)).astype(np.int32)
               for _ in range(6)]
    return np_tree, batches


def _cfg(**opts):
    return tbloom.BloomConfig(**SIZE, **opts)


@pytest.fixture
def ctx1(tmp_path):
    """A world of one gloo rank in this process, "tensor" and "data" named."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cpu",
                                         tensor_parallel_size=1, data_parallel_size=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # the CPU's threaded sums may reorder: runs compared bit for bit
    yield ctx
    torch.set_num_threads(threads)
    ctx.destroy()


def _jax_fit(opts, tp, dp, batches, n_accum=1):
    """The JAX Trainer's losses and final params."""
    np_tree, _ = _data()
    cfg = jbloom.BloomConfig(**SIZE, **opts)
    params = jax.tree_util.tree_map(jnp.asarray, np_tree)
    ctx = JaxContext(tensor_parallel_size=tp, data_parallel_size=dp)
    try:
        def loss_fn(p, ids):
            return jbloom.loss_fn(p, ids, None, ids, cfg, tp_axis="tensor")

        trainer = JaxTrainer(loss_fn, params, jbloom.tp_specs(params),
                             JaxZero(optax.adam(LR), axis_name="data"), ctx,
                             n_accum=n_accum)
        st = trainer.fit([jnp.asarray(b) for b in batches])
        return ([float(x) for x in st.losses],
                jax.tree_util.tree_map(np.asarray, trainer.params))
    finally:
        ctx.destroy()


def _close_trees(got, want, what, rtol=RTOL, atol=ATOL):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    flat = jax.tree_util.tree_leaves(got)
    assert len(flat) == len(paths)
    for (path, w), g in zip(paths, flat):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _equal_states(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["step"] == w["step"], (what, i)
        for name in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(g[name], w[name], err_msg=f"{what} leaf {i} {name}")


# -- TP2 x DP2 over 4 ranks -----------------------------------------------------------


def test_tp2_dp2_trainer_matches_jax_and_its_checkpoint_reshards(devices, tmp_path, ctx1):
    np_tree, batches = _data()
    dirs = [str(tmp_path / d) for d in ("ckpt", "resume", "recovery")]
    runs = [(name, _cfg(**opts)) for name, opts in RUNS.items()]
    ranks = run_ranks(trainer_rank, 4, np_tree, runs, batches, LR, *dirs, timeout=300)
    for r in ranks[1:]:   # the all-gathers leave every rank the same
        for name in RUNS:
            assert r[name]["losses"] == ranks[0][name]["losses"], name
            _close_trees(r[name]["params"], ranks[0][name]["params"], name, 0, 0)
    got = ranks[0]
    for name, opts in RUNS.items():
        want_losses, want_params = _jax_fit(opts, 2, 2, batches[:5])
        np.testing.assert_allclose(got[name]["losses"], want_losses, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        _close_trees(got[name]["params"], want_params, f"{name} vs the JAX Trainer")

    # the TP2 x DP2 checkpoint at tp 1 x dp 4: params and moments bit for bit
    saved = got["saved"]
    assert got["restored_step"] == 5
    for r in ranks:
        _close_trees(r["restored"]["params"], saved["params"], "restored at dp 4", 0, 0)
        _equal_states(r["restored"]["state"], saved["state"], "restored at dp 4")
        assert all(s["step"] == 5.0 for s in r["restored"]["state"])
    # the embedding's ZeRO shard at dp 4: a quarter of its rows
    assert got["restored"]["shard_rows"][0] == (SIZE["vocab_size"] // 4, SIZE["hidden_size"])
    # its next step at tp 1 x dp 4 is the uninterrupted TP2 x DP2 run's
    np.testing.assert_allclose(got["after_restore_loss"], got["uninterrupted_losses"][5],
                               rtol=1e-5)

    # ... and at one rank: through a Trainer, and through the function
    # with no process group role to play
    t = make_trainer(np_tree, _cfg(), LR)
    assert t.restore_from(dirs[0], 5) == 5 and t.state.step == 5
    _close_trees(whole_params(t), saved["params"], "restored at one rank", 0, 0)
    _equal_states(whole_state(t), saved["state"], "restored at one rank")
    like = params_from_jax(np_tree, _cfg(), device="cpu")
    from pipegoose_tpu_torch.models.weights import params_to_jax

    fresh = restore_train_state(dirs[0], 5, {"params": like}, parallel_context=None)
    _close_trees(params_to_jax(fresh["params"]), saved["params"], "restore_train_state", 0, 0)

    # resume and AutoRecovery at dp 2 give the uninterrupted run
    assert got["resumed_step"] == 4
    assert got["resumed_losses"] == got["uninterrupted_losses"][4:]
    rec = got["recovered"]
    assert rec["restores"] == 1 and rec["step"] == 4
    assert rec["losses"] == got["uninterrupted_losses"][:4]
    _close_trees(rec["params"], got["uninterrupted_params4"], "recovered", 0, 0)


# -- one rank, in this process ---------------------------------------------------------


@pytest.mark.parametrize("name", list(RUNS))
def test_fit_at_one_rank_matches_the_jax_trainer(devices, ctx1, name):
    np_tree, batches = _data()
    t = make_trainer(np_tree, _cfg(**RUNS[name]), LR)
    st = t.fit(batches[:5])
    want_losses, want_params = _jax_fit(RUNS[name], 1, 1, batches[:5])
    assert st.status == TrainerStatus.FINISHED and st.step == 5
    np.testing.assert_allclose([float(x) for x in st.losses], want_losses, rtol=RTOL,
                               atol=ATOL)
    _close_trees(whole_params(t), want_params, f"{name} vs the JAX Trainer")


def test_callback_order_and_events(ctx1):
    """tests/trainer/test_trainer.py:35: start, every step, end; callbacks
    run sorted by ``order`` in every round."""
    np_tree, batches = _data()
    events = []

    class Probe(Callback):
        def __init__(self, tag, order):
            self.tag, self.order = tag, order

        def on_fit_start(self, t):
            events.append((self.tag, "start"))

        def on_step_start(self, t, step):
            events.append((self.tag, "pre", step))

        def on_step_end(self, t, step, loss):
            assert isinstance(loss, torch.Tensor) and t.state.step == step
            events.append((self.tag, step))

        def on_fit_end(self, t):
            events.append((self.tag, "end"))

    t = make_trainer(np_tree, _cfg(), LR, callbacks=[Probe("b", 5), Probe("a", -5)])
    assert [c.tag for c in t.callbacks] == ["a", "b"]
    state = t.fit([batches[0]] * 5)   # one batch: the loss must fall
    assert state.status == TrainerStatus.FINISHED and state.step == 5
    a = [e[1:] for e in events if e[0] == "a"]
    assert a[0] == ("start",) and a[-1] == ("end",)
    assert [e[0] for e in a[1:-1] if len(e) == 1] == [1, 2, 3, 4, 5]
    assert [e[1] for e in a if len(e) == 2 and e[0] == "pre"] == [0, 1, 2, 3, 4]
    # "a" (order -5) before "b" in every round
    assert [e[0] for e in events[:2]] == ["a", "b"]
    assert all(events[i][0] == "a" and events[i + 1][0] == "b"
               for i in range(0, len(events), 2))
    assert float(state.losses[-1]) < float(state.losses[0])


def test_max_steps_pulls_no_extra_batch(ctx1):
    np_tree, batches = _data()
    pulled = []

    def gen():
        for i, b in enumerate(batches):
            pulled.append(i)
            yield b

    t = make_trainer(np_tree, _cfg(), LR)
    assert t.fit(gen(), max_steps=3).step == 3
    assert pulled == [0, 1, 2]
    it = gen()
    pulled.clear()
    assert t.fit(it, max_steps=3).step == 3 and pulled == []   # already there


@pytest.mark.parametrize("exc", [RuntimeError, KeyboardInterrupt])
def test_failed_status_and_fit_abort(ctx1, exc):
    np_tree, batches = _data()
    seen = []

    class Boom(Callback):
        def on_step_end(self, t, step, loss):
            if step == 2:
                raise exc("boom")

        def on_fit_abort(self, t, e):
            seen.append(e)

    class BadTeardown(Callback):
        def on_fit_abort(self, t, e):
            raise ValueError("teardown fails; the original still propagates")

    t = make_trainer(np_tree, _cfg(), LR, callbacks=[Boom(), BadTeardown()])
    with pytest.raises(exc, match="boom"):
        t.fit(batches)
    want = TrainerStatus.INTERRUPTED if exc is KeyboardInterrupt else TrainerStatus.FAILED
    assert t.state.status is want and t.state.step == 2
    assert len(seen) == 1 and isinstance(seen[0], exc)


def test_callers_params_are_left_unchanged(ctx1):
    """The step trains its parameters in place; the Trainer's are fresh
    tensors, so the caller's tree keeps its values."""
    from pipegoose_tpu_torch.models.bloom import tp_specs
    from pipegoose_tpu_torch.nn.parallel import tree_leaves
    from test_torch_trainer_ranks import make_loss

    np_tree, batches = _data()
    whole = params_from_jax(np_tree, _cfg(), device="cpu")
    before = [p.clone() for p in tree_leaves(whole)]
    t = Trainer(make_loss(_cfg()), whole, tp_specs(whole), DistributedOptimizer(adam(LR)))
    t.fit(batches[:3])
    for p, b, q in zip(tree_leaves(whole), before, tree_leaves(t.params)):
        assert torch.equal(p, b) and not p.requires_grad
        assert p.data_ptr() != q.data_ptr()
    assert any(not torch.equal(b, q) for b, q in zip(before, tree_leaves(t.params)))


def _jax_evaluate(batches, n_accum=1, weight_fn=None, masked=False):
    np_tree, _ = _data()
    cfg = jbloom.BloomConfig(**SIZE)
    params = jax.tree_util.tree_map(jnp.asarray, np_tree)
    ctx = JaxContext(tensor_parallel_size=1, data_parallel_size=1)
    try:
        def loss_fn(p, b):
            if masked:
                return jbloom.loss_fn(p, b["ids"], b["mask"], b["ids"], cfg, tp_axis="tensor")
            return jbloom.loss_fn(p, b, None, b, cfg, tp_axis="tensor")

        from jax.sharding import PartitionSpec as P

        spec = {"ids": P("data"), "mask": P("data")} if masked else P("data")
        trainer = JaxTrainer(loss_fn, params, jbloom.tp_specs(params),
                             JaxZero(optax.adam(LR), axis_name="data"), ctx,
                             n_accum=n_accum, batch_spec=spec)
        jb = [jax.tree_util.tree_map(jnp.asarray, b) for b in batches]
        return trainer.evaluate(jb, weight_fn=weight_fn)
    finally:
        ctx.destroy()


@pytest.mark.parametrize("mode", ["plain", "weight_fn", "n_accum_2"])
def test_evaluate_matches_jax(devices, ctx1, mode):
    """``evaluate`` equals JAX ``evaluate``: plain, token-weighted over ragged
    masks, and with ``n_accum = 2`` the equal-weight microbatch mean with no
    backward; it leaves the params and their gradients alone, and training
    lowers it."""
    from pipegoose_tpu_torch.models.bloom import loss_fn, tp_specs
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    np_tree, batches = _data()
    cfg = _cfg()
    n_accum = 2 if mode == "n_accum_2" else 1
    if mode == "weight_fn":
        rng = np.random.RandomState(4)
        evals = []
        for n_valid in (12, 3):   # ragged: the second batch mostly padding
            mask = np.ones((BATCH, SEQ), np.int32)
            mask[:, n_valid:] = 0
            evals.append({"ids": rng.randint(1, SIZE["vocab_size"], (BATCH, SEQ)
                                             ).astype(np.int32), "mask": mask})

        def wf(b):
            return float(np.asarray(b["mask"])[:, 1:].sum())

        def lf(p, b):
            return loss_fn(p, b["ids"], b["mask"], b["ids"], cfg, tp_axis="tensor")
        spec = {"ids": ("data",), "mask": ("data",)}   # a tree of specs, as JAX's
    else:
        evals, wf, spec = batches[:3], None, ("data",)

        def lf(p, b):
            return loss_fn(p, b, None, b, cfg, tp_axis="tensor")
    whole = params_from_jax(np_tree, cfg, device="cpu")
    t = Trainer(lf, whole, tp_specs(whole), DistributedOptimizer(adam(1e-2)),
                batch_spec=spec, n_accum=n_accum)
    got = t.evaluate(evals, weight_fn=wf)
    want = _jax_evaluate(evals, n_accum, wf, masked=mode == "weight_fn")
    assert abs(got - want) < 2e-5 * abs(want), (got, want)
    before = [p.clone() for p in tree_leaves(t.params)]
    assert t.evaluate(evals, weight_fn=wf) == got   # pure
    assert all(torch.equal(a, b) and b.grad is None
               for a, b in zip(before, tree_leaves(t.params)))
    if mode == "weight_fn":
        assert abs(t.evaluate(evals) - got) > 1e-6   # the two means differ here
    else:
        t.fit(batches[:5])
        assert t.evaluate(evals) < got
    with pytest.raises(ValueError, match="no batches"):
        t.evaluate([])


def test_loss_history_ring_bounds_and_converts():
    """tests/trainer/test_trainer.py:172, with tensors: the ring stays
    bounded, entries older than sync_lag become Python floats, the list
    surgery of AutoRecovery's rollback works; as JAX's LossHistory."""
    for cls, make in ((LossHistory, lambda i: torch.tensor(float(i))),
                      (JaxLossHistory, lambda i: jnp.float32(i))):
        h = cls(maxlen=8, sync_lag=2)
        for i in range(20):
            h.append(make(i))
        assert len(h) == 8
        assert [float(x) for x in h] == [12.0, 13.0, 14.0, 15.0, 16.0, 17.0, 18.0, 19.0]
        assert all(isinstance(x, float) for x in h[:-2])
        assert not isinstance(h[-1], float)
        del h[6:]
        assert len(h) == 6 and float(h[-1]) == 17.0
        with pytest.raises(ValueError, match="maxlen"):
            cls(maxlen=0)


def test_profiler_trace_dir_writes_a_chrome_trace(ctx1, tmp_path):
    np_tree, batches = _data()
    t = make_trainer(np_tree, _cfg(), LR)
    trace_dir = str(tmp_path / "trace")
    assert t.fit(batches[:2], profiler_trace_dir=trace_dir).step == 2
    with open(os.path.join(trace_dir, "trace_rank0.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_with_rng_folds_the_step_into_the_seed(ctx1):
    np_tree, batches = _data()
    cfg = _cfg()
    seen = []

    def lf(p, ids, rng):
        seen.append(rng)
        return tbloom.loss_fn(p, ids, None, ids, cfg, tp_axis="tensor")

    whole = params_from_jax(np_tree, cfg, device="cpu")
    t = Trainer(lf, whole, tbloom.tp_specs(whole), DistributedOptimizer(adam(LR)),
                with_rng=True)
    t.fit(batches[:3], rng=7)
    assert seen == [tacc.fold_in(7, i) for i in range(3)]
    seen.clear()
    t.evaluate(batches[:2], rng=5)
    assert seen == [tacc.fold_in(5, i) for i in range(2)]


@pytest.mark.parametrize("k", [2, 4])
def test_make_accumulated_loss_matches_jax(k):
    np_tree, batches = _data()
    cfg = _cfg(remat=True, use_flash=True)
    jcfg = jbloom.BloomConfig(**SIZE, remat=True, use_flash=True)
    ids = batches[1]
    jfn = jacc.make_accumulating_loss(lambda p, b: jbloom.loss_fn(p, b, None, b, jcfg), k)
    want = float(jfn(jax.tree_util.tree_map(jnp.asarray, np_tree), jnp.asarray(ids)))
    params = params_from_jax(np_tree, cfg, device="cpu")
    fn = tacc.make_accumulated_loss(
        lambda p, b: tbloom.loss_fn(p, b.long(), None, b.long(), cfg), k)
    with torch.no_grad():
        got = fn(params, torch.from_numpy(ids))
    assert abs(got.item() - want) <= 2e-6
    # the same mean as the accumulating loss, which also runs the backward
    from pipegoose_tpu_torch.trainer import make_optimizer

    make_optimizer(params, LR)
    acc = tacc.make_accumulating_loss(
        lambda p, b: tbloom.loss_fn(p, b.long(), None, b.long(), cfg), k)
    assert acc(params, torch.from_numpy(ids)).item() == got.item()


@pytest.mark.parametrize("probe", ["doctor", "profile", "with_health", "recorder"])
def test_unported_options_raise_naming_item_13(ctx1, probe):
    np_tree, _ = _data()
    if probe == "recorder":
        # the flight recorder is ported (A13a): recovery now takes one
        from pipegoose_tpu_torch.telemetry import FlightRecorder

        rec = FlightRecorder("unused")
        assert AutoRecovery("unused", recorder=rec).recorder is rec
        return
    with pytest.raises(NotImplementedError, match="item 13"):
        if probe == "with_health":
            make_trainer(np_tree, _cfg(), LR, with_health=True)
        else:
            getattr(make_trainer(np_tree, _cfg(), LR), probe)(None)


def test_trainer_package_exports():
    import pipegoose_tpu_torch.trainer as tt

    for name in ("Trainer", "Callback", "LossLoggerCallback", "CheckpointCallback",
                 "DistributedLogger", "TrainerState", "TrainerStatus", "FailureDetector",
                 "AutoRecovery", "TrainingDiverged"):
        assert name in tt.__all__ and hasattr(tt, name), name


def test_no_context_raises():
    with pytest.raises(ValueError, match="no ParallelContext"):
        Trainer(len, {}, {}, DistributedOptimizer(adam(LR)))
