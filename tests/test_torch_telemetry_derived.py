"""The port's derived gauges, TelemetryCallback, the decode loops' spans and
the hybrid step's comm gauges, on the CPU.

- ``derived``: the host half of ``tests/telemetry/test_derived.py`` (the
  HLO half waits for ROADMAP.md queue A, item A13b). The port's tables
  hold the H100 (PCIe matched before SXM) and "cpu", and no TPU row;
  ``mfu`` and ``tokens_per_second`` agree with JAX's given ``peak=`` or
  ``device_kind="cpu"``; without CUDA ``peak_flops_for(None)`` and
  ``hbm_utilization(None)`` raise, and a CPU device reports no memory.
- ``TelemetryCallback``: the counterparts of
  ``tests/telemetry/test_callback.py`` on a one-rank gloo Trainer; its
  ``auto_cost=True`` raises (the HLO probe is A13b).
- ``generate()``: the ``generate.prefill`` / ``generate.decode`` spans one
  sample a call each, as JAX's ``generate()`` records them.
- ``make_hybrid_train_step``: the ``comm.*`` gauges when telemetry is on."""
import json
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from pipegoose_tpu.telemetry import derived as jderived
from pipegoose_tpu_torch.telemetry import MetricsRegistry, TelemetryCallback, derived
from pipegoose_tpu_torch.utils.profiler import device_memory_stats

NO_CUDA = not torch.cuda.is_available()


def test_peak_flops_table_substring_match():
    assert derived.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert derived.peak_flops_for("NVIDIA H100 PCIe") == 756e12
    assert derived.peak_flops_for("cpu") == 1e12
    with pytest.warns(UserWarning, match="unknown device kind"):
        assert derived.peak_flops_for("martian accelerator") == derived.DEFAULT_PEAK_FLOPS


def test_tables_hold_the_h100_and_no_tpu_row():
    """Every table has the same keys, the PCIe row first (its name also
    contains the SXM key), and no TPU name."""
    tables = (derived.PEAK_FLOPS, derived.PEAK_ICI_BYTES, derived.PEAK_DCI_BYTES,
              derived.HBM_BYTES, derived.HBM_BW_BYTES)
    for table in tables:
        assert list(table) == ["h100 pcie", "h100", "cpu"]
    for fn, sxm, cpu in ((derived.ici_bytes_per_s_for, 900e9, 10e9),
                         (derived.dci_bytes_per_s_for, 50e9, 1e9),
                         (derived.hbm_bytes_for, 80 * 2**30, 16 * 2**30),
                         (derived.hbm_bw_bytes_per_s_for, 3.35e12, 50e9)):
        assert fn("NVIDIA H100 80GB HBM3") == sxm
        assert fn("cpu") == cpu
    for table in tables:
        for key in table:
            assert not any(t in key for t in ("v4", "v5", "v6", "tpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        derived.hbm_bw_bytes_per_s_for("NVIDIA H100 PCIe")


@pytest.mark.skipif(not NO_CUDA, reason="the no-card path: a card names its device")
def test_no_card_lookups_raise_rather_than_pick_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        derived.peak_flops_for(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        derived.hbm_utilization(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_memory_stats(None)


def test_hbm_utilization_empty_on_cpu():
    assert device_memory_stats("cpu") == {"unavailable": "cpu"}
    assert derived.hbm_utilization("cpu") == {}
    assert derived.hbm_utilization(torch.device("cpu")) == {}


@pytest.mark.parametrize("flops,secs,peak,n", [(1e12, 0.01, 197e12, 1), (1e12, 0.01, 197e12, 4),
                                               (1e12, 0.0, 1e12, 1), (3.3e15, 0.29, 989e12, 1)])
def test_mfu_equal_jax(flops, secs, peak, n):
    assert derived.mfu(flops, secs, peak=peak, n_devices=n) == jderived.mfu(
        flops, secs, peak=peak, n_devices=n)
    assert derived.mfu(flops, secs, device_kind="cpu") == jderived.mfu(
        flops, secs, device_kind="cpu")
    assert derived.mfu(1e12, 0.01, peak=197e12) == pytest.approx(1e14 / 197e12)


def test_tokens_per_second_equal_jax():
    for toks, secs in ((100, 2.0), (100, 0.0), (8192, 0.3251)):
        assert derived.tokens_per_second(toks, secs) == jderived.tokens_per_second(toks, secs)
    assert derived.tokens_per_second(100, 2.0) == 50.0


# -- TelemetryCallback (tests/telemetry/test_callback.py) ----------------------

SIZE = dict(vocab_size=64, hidden_size=32, n_layer=2, n_head=2)


@pytest.fixture
def ctx1(tmp_path):
    from pipegoose_tpu_torch.distributed import ParallelContext

    store = dist.FileStore(str(tmp_path / "store"), 1)
    ctx = ParallelContext.init_multihost(store=store, world_size=1, rank=0, device="cpu",
                                         tensor_parallel_size=1, data_parallel_size=1)
    yield ctx
    ctx.destroy()


def _fit(cb, steps=3, batch=8, seq=8):
    from pipegoose_tpu_torch.models import bloom
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.optim import DistributedOptimizer, adam
    from pipegoose_tpu_torch.trainer import Trainer

    cfg = bloom.BloomConfig(**SIZE)
    whole = params_from_jax(bloom.init_params_numpy(cfg, seed=0), cfg, device="cpu")

    def loss_fn(p, ids):
        return bloom.loss_fn(p, ids, None, ids, cfg, tp_axis="tensor")

    trainer = Trainer(loss_fn, whole, bloom.tp_specs(whole),
                      DistributedOptimizer(adam(1e-3), axis_name="data"), callbacks=[cb])
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq))
    trainer.fit([ids] * steps)
    return trainer


def test_callback_records_step_metrics_and_jsonl(ctx1, tmp_path):
    reg = MetricsRegistry(enabled=False)  # the callback enables it
    jl = str(tmp_path / "t.jsonl")
    _fit(TelemetryCallback(registry=reg, jsonl=jl, fence=True), steps=3)
    assert reg.enabled
    snap = reg.snapshot()
    assert snap["counters"]["train.steps_total"] == 3
    assert snap["counters"]["train.tokens_total"] == 3 * 8 * 8
    assert snap["histograms"]["train.step_seconds"]["count"] == 3
    assert snap["gauges"]["train.tokens_per_s"] > 0
    lines = [json.loads(line) for line in open(jl)]
    kinds = [line["kind"] for line in lines]
    assert kinds[0] == "train.fit_start"
    assert kinds.count("train.step") == 3
    assert kinds[-2] == "train.fit_end"
    assert kinds[-1] == "snapshot"
    step_ev = next(line for line in lines if line["kind"] == "train.step")
    assert step_ev["tokens_per_s"] > 0 and step_ev["dur_s"] > 0


def test_auto_cost_raises_naming_a13b():
    """The JAX callback downgrades quietly when its HLO probe fails; the
    port has no probe yet and says so at construction."""
    with pytest.raises(NotImplementedError, match="A13b"):
        TelemetryCallback(auto_cost=True)


def test_explicit_flops_sets_mfu_from_the_step_time(ctx1, tmp_path):
    """``train.mfu`` is flops_per_step / the step's wall time / the peak of
    the parameters' device (the CPU's placeholder here)."""
    reg = MetricsRegistry(enabled=True)
    events = []
    reg.attach(events.append)
    _fit(TelemetryCallback(registry=reg, flops_per_step=1e9), steps=2)
    snap = reg.snapshot()
    last = [e for e in events if e["kind"] == "train.step"][-1]
    assert snap["gauges"]["train.mfu"] == last["mfu"] == pytest.approx(
        1e9 / last["dur_s"] / derived.peak_flops_for("cpu"))
    assert "train.flops_per_step" not in snap["gauges"]
    assert "train.hbm_utilization" not in snap["gauges"]


def test_hbm_every_on_cpu_leaves_the_gauges_unset(ctx1):
    reg = MetricsRegistry(enabled=True)
    _fit(TelemetryCallback(registry=reg, hbm_every=1), steps=2)
    gauges = reg.snapshot()["gauges"]
    assert "train.hbm_bytes_in_use" not in gauges and "train.hbm_utilization" not in gauges


def test_prom_written_on_fit_end(ctx1, tmp_path):
    prom = str(tmp_path / "m.prom")
    reg = MetricsRegistry(enabled=True)
    _fit(TelemetryCallback(registry=reg, prom=prom), steps=2)
    text = open(prom).read()
    assert "train_steps_total 2.0" in text
    assert "# TYPE train_step_seconds histogram" in text


# -- the decode loops' spans ----------------------------------------------------

@pytest.fixture
def fresh_global_registries():
    import pipegoose_tpu.telemetry.registry as jreg
    import pipegoose_tpu_torch.telemetry.registry as treg

    saved = [(r, r._enabled, dict(r._metrics), list(r._sinks))
             for r in (jreg.get_registry(), treg.get_registry())]
    for r, *_ in saved:
        r.clear()
        r.enable()
    yield jreg.get_registry(), treg.get_registry()
    for r, enabled, metrics, sinks in saved:
        r._enabled, r._metrics, r._sinks = enabled, metrics, sinks


@pytest.mark.parametrize("new", [1, 5])
def test_generate_spans_equal_jax(fresh_global_registries, new):
    from pipegoose_tpu.models import bloom as jbloom
    from pipegoose_tpu.models import generate as jgen
    from pipegoose_tpu_torch.models import bloom as tbloom
    from pipegoose_tpu_torch.models import generate as tgen
    from pipegoose_tpu_torch.models.weights import params_from_jax

    jreg, treg = fresh_global_registries
    cfg = tbloom.BloomConfig(**SIZE)
    np_tree = tbloom.init_params_numpy(cfg, seed=0)
    ids = np.random.RandomState(1).randint(1, 64, (2, 6))
    events = []
    treg.attach(events.append)
    for _ in range(2):
        got = tgen.generate(params_from_jax(np_tree, cfg, device="cpu"), torch.from_numpy(ids),
                            cfg, new, device="cpu")
        want = jgen.generate(jax.tree_util.tree_map(jnp.asarray, np_tree), jnp.asarray(ids),
                             jbloom.BloomConfig(**SIZE), new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = [{k: v["count"] for k, v in r.snapshot()["histograms"].items()}
              for r in (treg, jreg)]
    assert counts[0] == counts[1]
    assert counts[0]["span.generate.prefill.seconds"] == 2
    assert counts[0].get("span.generate.decode.seconds", 0) == (2 if new > 1 else 0)
    prefill = [e for e in events if e.get("span") == "generate.prefill"]
    assert prefill[0]["prompt_len"] == 6 and prefill[0]["batch"] == 2


# -- the hybrid step's comm gauges -------------------------------------------------

def test_comm_gauges_when_telemetry_is_on(fresh_global_registries):
    """The gauges JAX's step exports at build: the overlap flag, the wire
    bits, and the int8 reduction's analytic bytes saved over the whole
    (unsharded) tree, here a dp-4 x tp-2 layout's shards."""
    from pipegoose_tpu_torch.distributed.compressed import grad_comm_bytes_saved
    from pipegoose_tpu_torch.parallel.hybrid import _set_comm_gauges

    _, reg = fresh_global_registries
    ctx = types.SimpleNamespace(sizes={"data": 4, "tensor": 2},
                                axis_size=lambda ax: {"data": 4, "tensor": 2}[ax])
    whole = {"w": torch.zeros(6, 8), "b": [torch.zeros(5), torch.zeros(3, 4)]}
    specs = {"w": (None, "tensor"), "b": [(None,), (None, None)]}
    shards = {"w": torch.zeros(6, 4), "b": [torch.zeros(5), torch.zeros(3, 4)]}
    opt = types.SimpleNamespace(axis_name="data")
    _set_comm_gauges(shards, specs, ctx, opt, "int8", True, "data")
    assert reg.gauge("comm.overlap_enabled").value == 1.0
    assert reg.gauge("comm.grad_wire_bits").value == 8.0
    assert reg.gauge("comm.bytes_saved").value == float(grad_comm_bytes_saved(whole, 4, "int8"))
    _set_comm_gauges(shards, specs, ctx, opt, "fp32", False, "data")
    assert reg.gauge("comm.bytes_saved").value == 0.0
    assert reg.gauge("comm.grad_wire_bits").value == 32.0
    reg.disable()
    _set_comm_gauges(shards, specs, ctx, opt, "bf16", True, "data")
    assert reg.gauge("comm.grad_wire_bits").value == 32.0     # disabled: nothing set
