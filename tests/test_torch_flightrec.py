"""The port's flight recorder: the counterparts of
``tests/telemetry/test_flightrec.py`` (ring bounds, structured triggers,
atomic black boxes, span summaries, the serving stall trigger) run on
``pipegoose_tpu_torch.telemetry``; a ``FailureDetector`` driven by the
recorder firing on the step, with the trigger, that the JAX detector fires
on (a loss stream by hand, and a poisoned batch through ``Trainer.fit``);
and a ``fit`` with ``TelemetryCallback`` and the recorder giving the JAX
loop's metric names and counts, and its records.

The port's black box records torch, CUDA and the device where the JAX one
records jax and its backend (ROADMAP.md § C)."""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from pipegoose_tpu_torch.telemetry import MetricsRegistry
from pipegoose_tpu_torch.telemetry.flightrec import FlightRecorder, TriggerEvent


def _trainer_stub(health=None, tokens=128):
    """Minimal duck-typed trainer for the callback interface."""
    state = types.SimpleNamespace(last_health=health, step=0)
    return types.SimpleNamespace(
        state=state, tokens_per_step=tokens, parallel_context=None,
        logger=None,
    )


def _healthy(gn=1.0):
    return {
        "grad_norm": gn,
        "grad_norm_per_module": {"embed": gn * 0.9, "blocks": gn * 0.1},
        "nonfinite_grad_leaves": 0.0,
        "nonfinite_update_leaves": 0.0,
        "update_max_abs": 1e-3,
        "update_norm": 0.1,
        "param_norm": 10.0,
        "update_ratio": 0.01,
    }


def _run_steps(rec, trainer, losses, healths=None):
    for i, loss in enumerate(losses, start=1):
        trainer.state.last_health = (
            healths[i - 1] if healths is not None else _healthy()
        )
        rec.on_step_start(trainer, i)
        rec.on_step_end(trainer, i, loss)


def test_ring_is_bounded(tmp_path):
    rec = FlightRecorder(str(tmp_path), capacity=4)
    for i in range(10):
        rec.record("x", step=i)
    assert len(rec.records) == 4
    assert [r["step"] for r in rec.records] == [6, 7, 8, 9]


def test_nonfinite_trigger_names_module_and_dumps(tmp_path):
    rec = FlightRecorder(str(tmp_path), capacity=8)
    trainer = _trainer_stub()
    bad = _healthy()
    bad["nonfinite_grad_leaves"] = 2.0
    bad["grad_norm"] = float("inf")
    bad["grad_norm_per_module"] = {"embed": float("inf"), "blocks": 0.1}
    _run_steps(rec, trainer, [4.0, 4.0, float("inf")],
               [_healthy(), _healthy(), bad])
    trig = rec.take_trigger()
    assert trig is not None and trig.name == "nonfinite"
    assert "'embed'" in trig.reason          # names the module group
    assert "non-finite loss" in trig.reason
    assert trig.dump_path and os.path.exists(trig.dump_path)
    # consuming clears it
    assert rec.take_trigger() is None

    # STRICT JSON: the nonfinite dump is exactly where inf/nan live;
    # bare Infinity/NaN tokens would make the black box unreadable by
    # jq/JS/log pipelines right when it matters (RFC 8259 has no such
    # literals — python's json.load merely tolerates them)
    text = open(trig.dump_path).read()
    assert "Infinity" not in text and "NaN" not in text
    data = json.loads(
        text, parse_constant=lambda c: pytest.fail(f"non-JSON token {c}")
    )
    assert data["records"][-1]["health"]["grad_norm"] == "inf"
    assert data["trigger"]["name"] == "nonfinite"
    assert data["trigger"]["step"] == 3
    assert data["trigger"]["details"]["bad_modules"] == ["embed"]
    kinds = [r["kind"] for r in data["records"]]
    assert kinds.count("train.step") == 3
    assert data["records"][-1]["health"]["nonfinite_grad_leaves"] == 2.0
    assert data["records"][-1]["step_time_s"] is not None
    assert "torch" in data["environment"] and "device_count" in data["environment"]
    # atomic write: no temp litter
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_update_overflow_triggers_without_bad_loss(tmp_path):
    """Overflowed optimizer updates under a still-finite loss (the
    CheckpointCallback blind spot) must fire on their own."""
    rec = FlightRecorder(str(tmp_path))
    bad = _healthy()
    bad["nonfinite_update_leaves"] = 1.0
    _run_steps(rec, _trainer_stub(), [4.0], [bad])
    trig = rec.take_trigger()
    assert trig is not None and trig.name == "nonfinite"
    assert "optimizer updates" in trig.reason


def test_loss_spike_zscore_arms_after_warmup(tmp_path):
    # below the arming threshold a spike-looking value must not fire
    # (startup loss cliffs would trip a day-one z-score)
    rec0 = FlightRecorder(str(tmp_path / "a"), loss_spike_z=4.0, window=8,
                          grad_explosion_factor=None)
    _run_steps(rec0, _trainer_stub(), [4.0, 50.0])
    assert rec0.take_trigger() is None

    rec = FlightRecorder(str(tmp_path / "b"), loss_spike_z=4.0, window=8,
                         grad_explosion_factor=None)
    trainer = _trainer_stub()
    _run_steps(rec, trainer, [4.0, 4.1, 3.9, 4.0])   # >= window//2: armed
    assert rec.take_trigger() is None
    _run_steps(rec, trainer, [50.0])
    trig = rec.take_trigger()
    assert trig is not None and trig.name == "loss_spike"
    assert "sigma" in trig.reason
    assert trig.details["z"] > 4.0


def test_grad_explosion_trigger_names_largest_module(tmp_path):
    rec = FlightRecorder(str(tmp_path), grad_explosion_factor=10.0,
                         window=4, loss_spike_z=None)
    trainer = _trainer_stub()
    _run_steps(rec, trainer, [4.0, 4.0], [_healthy(1.0), _healthy(1.1)])
    assert rec.take_trigger() is None
    _run_steps(rec, trainer, [4.0], [_healthy(100.0)])
    trig = rec.take_trigger()
    assert trig is not None and trig.name == "grad_explosion"
    assert "'embed'" in trig.reason          # largest per-module norm
    assert trig.details["grad_norm"] == pytest.approx(100.0)


def test_spike_does_not_poison_its_own_baseline(tmp_path):
    """A triggering step's loss must NOT enter the trailing window —
    otherwise one spike shifts the mean and masks the next one."""
    rec = FlightRecorder(str(tmp_path), loss_spike_z=4.0, window=6,
                         grad_explosion_factor=None)
    trainer = _trainer_stub()
    _run_steps(rec, trainer, [4.0, 4.1, 3.9, 4.0])
    _run_steps(rec, trainer, [60.0])
    assert rec.take_trigger().name == "loss_spike"
    assert 60.0 not in rec._loss_hist
    _run_steps(rec, trainer, [55.0])         # second spike still fires
    assert rec.take_trigger().name == "loss_spike"


def test_check_every_skips_off_steps(tmp_path):
    rec = FlightRecorder(str(tmp_path), check_every=2)
    trainer = _trainer_stub()
    bad = _healthy()
    bad["nonfinite_grad_leaves"] = 1.0
    # step 1 is an off step (1 % 2 != 0): not recorded, no trigger
    trainer.state.last_health = bad
    rec.on_step_start(trainer, 1)
    rec.on_step_end(trainer, 1, float("nan"))
    assert len(rec.records) == 0 and rec.take_trigger() is None
    rec.on_step_start(trainer, 2)
    rec.on_step_end(trainer, 2, float("nan"))
    assert len(rec.records) == 1 and rec.take_trigger() is not None


def test_reset_after_restore_clears_baselines_and_marks_ring(tmp_path):
    rec = FlightRecorder(str(tmp_path))
    _run_steps(rec, _trainer_stub(), [4.0, 4.0, 4.0])
    assert len(rec._loss_hist) == 3
    rec.last_trigger = TriggerEvent("nonfinite", "x", 3)
    rec.reset_after_restore(2)
    assert not rec._loss_hist and not rec._grad_hist
    assert rec.take_trigger() is None
    assert rec.records[-1]["kind"] == "restore"
    assert rec.records[-1]["step"] == 2


def test_max_dumps_bounds_disk(tmp_path):
    rec = FlightRecorder(str(tmp_path), max_dumps=2)
    for i in range(4):
        path = rec.dump(TriggerEvent("nonfinite", "r", i))
        assert (path is not None) == (i < 2)
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".json")]) == 2


def test_span_summaries_drain_from_enabled_registry(tmp_path):
    from pipegoose_tpu_torch.telemetry.spans import span

    reg = MetricsRegistry(enabled=True)
    rec = FlightRecorder(str(tmp_path), registry=reg)
    trainer = _trainer_stub()
    rec.on_fit_start(trainer)
    with span("train.step", registry=reg):
        pass
    with span("train.step", registry=reg):
        pass
    rec.on_step_start(trainer, 1)
    rec.on_step_end(trainer, 1, 4.0)
    spans = rec.records[-1]["spans"]
    assert spans["train.step"]["n"] == 2
    assert spans["train.step"]["total_s"] >= 0
    rec.on_fit_end(trainer)
    assert rec._sink not in reg._sinks


def test_disabled_registry_is_never_implicitly_enabled(tmp_path):
    reg = MetricsRegistry(enabled=False)
    rec = FlightRecorder(str(tmp_path), registry=reg)
    rec.on_fit_start(_trainer_stub())
    assert not reg.enabled and not rec._attached


def test_serving_stall_trigger_dumps(tmp_path):
    rec = FlightRecorder(str(tmp_path))
    rec.observe_serving_step(1, active=2, queue_depth=3, dur_s=0.01, tokens=2)
    trig = rec.trigger_decode_stall(
        5, "no decode progress", context={"queued": 3}
    )
    assert trig.name == "decode_stall"
    data = json.load(open(trig.dump_path))
    assert data["context"]["queued"] == 3
    assert data["records"][0]["kind"] == "serving.step"


def test_validation():
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder("/tmp/x", capacity=0)
    with pytest.raises(ValueError, match="check_every"):
        FlightRecorder("/tmp/x", check_every=0)
    with pytest.raises(ValueError, match="window"):
        FlightRecorder("/tmp/x", window=1)


def test_black_box_names_the_layout_and_environment(tmp_path):
    """A trainer's context gives the black box its axis sizes; the
    environment names torch, CUDA, the device count (and on a card its
    name) and, under a process group, the rank."""
    rec = FlightRecorder(str(tmp_path))
    ctx = types.SimpleNamespace(sizes={"data": 2, "tensor": 4, "pipe": 1}, device="cpu")
    trainer = types.SimpleNamespace(
        state=types.SimpleNamespace(last_health=None), tokens_per_step=64,
        parallel_context=ctx)
    rec.on_step_start(trainer, 1)
    rec.on_step_end(trainer, 1, float("nan"))
    data = json.load(open(rec.last_trigger.dump_path))
    assert data["context"] == {"tokens_per_step": 64, "device_kind": "cpu",
                               "mesh_axes": {"data": 2, "tensor": 4, "pipe": 1},
                               "n_devices": 8}
    env = data["environment"]
    assert env["torch"] == torch.__version__ and env["cuda"] == torch.version.cuda
    assert env["device_count"] == torch.cuda.device_count()
    assert "jax" not in env


# -- the recorder and the detector against the JAX pair ---------------------

def _detector_run(recorder_cls, detector_cls, diverged, tmp_path, losses):
    """A recorder (order -20) and a detector taking its triggers (-10) fed
    one loss stream by hand; returns (step, reason without the dump's
    path, trigger name) of the failure, or None."""
    rec = recorder_cls(str(tmp_path), window=8, loss_spike_z=4.0)
    det = detector_cls(recorder=rec)
    trainer = types.SimpleNamespace(
        state=types.SimpleNamespace(last_health=None), tokens_per_step=16,
        parallel_context=None, logger=None)
    for i, loss in enumerate(losses, start=1):
        for cb in (rec, det):
            cb.on_step_start(trainer, i)
        try:
            for cb in (rec, det):
                cb.on_step_end(trainer, i, loss)
        except diverged as e:
            msg = str(e).split(" (black box: ")[0]
            return i, msg, os.path.basename(rec.dumps[-1]) if rec.dumps else None
    return None


@pytest.mark.parametrize("kind", ["spike", "nan", "none"])
def test_failure_detector_fires_on_jax_step(tmp_path, kind):
    """The same losses through the port's and JAX's recorder + detector:
    the failure is raised on the same step with the same reason (a loss
    spike's z-score, a non-finite loss), or by neither."""
    from pipegoose_tpu.telemetry.flightrec import FlightRecorder as JaxRecorder
    from pipegoose_tpu.trainer.recovery import FailureDetector as JaxDetector
    from pipegoose_tpu.trainer.recovery import TrainingDiverged as JaxDiverged
    from pipegoose_tpu_torch.trainer.recovery import FailureDetector, TrainingDiverged

    rng = np.random.RandomState(3)
    losses = list(4.0 - 0.01 * np.arange(12) + 0.02 * rng.randn(12))
    if kind == "spike":
        losses[9] = 9.0
    elif kind == "nan":
        losses[6] = float("nan")
    got = _detector_run(FlightRecorder, FailureDetector, TrainingDiverged,
                        tmp_path / "port", losses)
    want = _detector_run(JaxRecorder, JaxDetector, JaxDiverged, tmp_path / "jax", losses)
    assert got == want
    if kind == "none":
        assert got is None
    else:
        assert got[0] == (10 if kind == "spike" else 7)
        assert ("loss_spike" if kind == "spike" else "nonfinite") in got[1]


# -- Trainer.fit with the callback and the recorder --------------------------

SIZE = dict(vocab_size=64, hidden_size=32, n_layer=2, n_head=2)
BATCH, SEQ, LR = 4, 8, 1e-3
POISON = 0


def _batches(n, poison_at=None):
    rs = np.random.RandomState(5)
    out = [rs.randint(1, SIZE["vocab_size"], (BATCH, SEQ)).astype(np.int32)
           for _ in range(n)]
    if poison_at is not None:
        out[poison_at][0, 0] = POISON
    return out


@pytest.fixture
def ctx1(tmp_path):
    from pipegoose_tpu_torch.distributed import ParallelContext

    store = dist.FileStore(str(tmp_path / "store"), 1)
    ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cpu",
                                         tensor_parallel_size=1, data_parallel_size=1)
    yield ctx
    ctx.destroy()


@pytest.fixture
def fresh_global_registries():
    """Both packages' global registries cleared and disabled, and put back
    after: the fit loops' spans record there."""
    import pipegoose_tpu.telemetry.registry as jreg
    import pipegoose_tpu_torch.telemetry.registry as treg

    saved = [(r, r._enabled, dict(r._metrics), list(r._sinks))
             for r in (jreg.get_registry(), treg.get_registry())]
    for r, *_ in saved:
        r.clear()
        r.disable()
    yield jreg.get_registry(), treg.get_registry()
    for r, enabled, metrics, sinks in saved:
        r._enabled, r._metrics, r._sinks = enabled, metrics, sinks


def _np_tree():
    from pipegoose_tpu_torch.models import bloom as tbloom

    return tbloom.init_params_numpy(tbloom.BloomConfig(**SIZE), seed=0)


def _jax_trainer(callbacks, poison):
    from pipegoose_tpu.distributed import ParallelContext as JaxContext
    from pipegoose_tpu.models import bloom as jbloom
    from pipegoose_tpu.optim.zero import DistributedOptimizer as JaxZero
    from pipegoose_tpu.trainer import Trainer as JaxTrainer

    cfg = jbloom.BloomConfig(**SIZE)
    params = jax.tree_util.tree_map(jnp.asarray, _np_tree())
    ctx = JaxContext(tensor_parallel_size=1, data_parallel_size=1)

    def loss_fn(p, ids):
        base = jbloom.loss_fn(p, ids, None, ids, cfg, tp_axis="tensor")
        return jnp.where(ids[0, 0] == POISON, jnp.float32(jnp.nan), base) if poison else base

    return ctx, JaxTrainer(loss_fn, params, jbloom.tp_specs(params),
                           JaxZero(optax.adam(LR), axis_name="data"), ctx,
                           callbacks=callbacks)


def _port_trainer(callbacks, poison):
    from pipegoose_tpu_torch.models import bloom as tbloom
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.trainer import Trainer

    cfg = tbloom.BloomConfig(**SIZE)

    def loss_fn(p, ids):
        base = tbloom.loss_fn(p, ids, None, ids, cfg, tp_axis="tensor")
        if not poison:
            return base
        return torch.where(ids[0, 0] == POISON, torch.full_like(base, float("nan")), base)

    whole = params_from_jax(_np_tree(), cfg, device="cpu")
    return Trainer(loss_fn, whole, tbloom.tp_specs(whole),
                   DistributedOptimizer(adam(LR), axis_name="data"), callbacks=callbacks)


def _names_and_counts(reg):
    snap = reg.snapshot()
    return ({k: v for k, v in snap["counters"].items()},
            sorted(snap["gauges"]),
            {k: v["count"] for k, v in snap["histograms"].items()})


def _records(rec):
    return [(r["kind"], r.get("step"), {k: v["n"] for k, v in (r.get("spans") or {}).items()})
            for r in rec.records]


def test_fit_with_callback_and_recorder_matches_jax(ctx1, fresh_global_registries, tmp_path):
    """A 4-step fit with TelemetryCallback (on the global registry, so the
    loop's spans land beside the callback's metrics), a FlightRecorder and
    a FailureDetector taking its triggers: the port gives the JAX loop's
    counter values, gauge names, histogram counts (the train.data and
    train.step spans one sample a step) and recorder records."""
    from pipegoose_tpu.telemetry import FlightRecorder as JaxRecorder
    from pipegoose_tpu.telemetry import TelemetryCallback as JaxCallback
    from pipegoose_tpu.trainer.recovery import FailureDetector as JaxDetector
    from pipegoose_tpu_torch.telemetry import TelemetryCallback
    from pipegoose_tpu_torch.trainer.recovery import FailureDetector

    jreg, treg = fresh_global_registries
    batches = _batches(4)
    jrec = JaxRecorder(str(tmp_path / "jax"))
    ctx, jt = _jax_trainer([JaxCallback(flops_per_step=1e9, device_kind="cpu", fence=True,
                                        hbm_every=1), jrec, JaxDetector(recorder=jrec)],
                           poison=False)
    try:
        jt.fit([jnp.asarray(b) for b in batches])
    finally:
        ctx.destroy()
    trec = FlightRecorder(str(tmp_path / "port"))
    tt = _port_trainer([TelemetryCallback(flops_per_step=1e9, fence=True, hbm_every=1),
                        trec, FailureDetector(recorder=trec)], poison=False)
    tt.fit(batches)
    got, want = _names_and_counts(treg), _names_and_counts(jreg)
    assert got == want
    assert got[2]["span.train.step.seconds"] == 4 and got[2]["span.train.data.seconds"] == 4
    assert "train.mfu" in got[1] and "train.hbm_bytes_in_use" not in got[1]
    assert _records(trec) == _records(jrec)
    assert tt.last_batch is batches[-1]
    # the callback's MFU is the phase formula's: flops / step time / peak
    snap = treg.snapshot()
    assert snap["gauges"]["train.mfu"] > 0


def test_poisoned_fit_fails_on_jax_step_with_a_black_box(ctx1, fresh_global_registries,
                                                         tmp_path):
    """A NaN loss on the third batch: the port's FailureDetector(recorder=)
    raises on the step the JAX one does, with the recorder's nonfinite
    trigger and a black box on disk, and the rings agree."""
    from pipegoose_tpu.telemetry import FlightRecorder as JaxRecorder
    from pipegoose_tpu.trainer.recovery import FailureDetector as JaxDetector
    from pipegoose_tpu.trainer.recovery import TrainingDiverged as JaxDiverged
    from pipegoose_tpu_torch.trainer.recovery import FailureDetector, TrainingDiverged

    batches = _batches(4, poison_at=2)
    jrec = JaxRecorder(str(tmp_path / "jax"))
    ctx, jt = _jax_trainer([jrec, JaxDetector(recorder=jrec)], poison=True)
    try:
        with pytest.raises(JaxDiverged) as jerr:
            jt.fit([jnp.asarray(b) for b in batches])
    finally:
        ctx.destroy()
    trec = FlightRecorder(str(tmp_path / "port"))
    tt = _port_trainer([trec, FailureDetector(recorder=trec)], poison=True)
    with pytest.raises(TrainingDiverged) as terr:
        tt.fit(batches)
    strip = lambda e: str(e.value).split(" (black box: ")[0]  # noqa: E731
    assert strip(terr) == strip(jerr) and "nonfinite" in strip(terr)
    assert os.path.basename(trec.dumps[0]) == os.path.basename(jrec.dumps[0])
    assert json.load(open(trec.dumps[0]))["trigger"]["step"] == 3
    assert [(k, s) for k, s, _ in _records(trec)] == [(k, s) for k, s, _ in _records(jrec)]
