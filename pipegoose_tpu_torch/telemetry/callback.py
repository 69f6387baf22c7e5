"""TelemetryCallback: per-step trainer metrics into the registry.

The counterpart of ``pipegoose_tpu/telemetry/callback.py``. The trainer's
instrumentation lives in a callback, not the fit loop, so its cost is
opt-in: the loop itself only carries disabled-registry spans. Adding this
callback turns on:

- ``train.step_seconds`` histogram and ``train.tokens_per_s`` gauge per
  step (tokens from ``trainer.tokens_per_step``);
- ``train.tokens_total`` / ``train.steps_total`` counters;
- ``train.mfu`` gauge, from an explicit ``flops_per_step`` (the whole
  step's model FLOPs) over the peak of the card the parameters live on
  (``derived.PEAK_FLOPS``). The JAX callback can also probe the compiled
  step for its FLOPs (``auto_cost=True``); that probe reads XLA's HLO and
  waits for ROADMAP.md queue A, item A13b, so ``auto_cost=True`` raises;
- ``train.hbm_utilization`` and ``train.hbm_bytes_in_use`` gauges every
  ``hbm_every`` steps (0 = off), read from the caching allocator of the
  card the parameters live on (a CPU run reports none and leaves them
  unset);
- a ``"train.step"`` JSONL event every ``every`` steps.

**Timing.** The Trainer never waits for the loss (launches queue ahead);
with ``fence=False`` (the default) a step's wall time is launch to
launch, which in steady state equals the card's step time but
mis-attributes the first steps. ``fence=True`` waits every step for the
work queued on the loss's stream: exact per-step times, at the cost of
draining the queue each step.
"""
from __future__ import annotations

import time
from typing import Any, Optional, Union

import torch

from pipegoose_tpu_torch.telemetry import derived
from pipegoose_tpu_torch.telemetry.exporters import (
    JSONLExporter,
    PrometheusTextfileExporter,
)
from pipegoose_tpu_torch.telemetry.registry import MetricsRegistry, get_registry
from pipegoose_tpu_torch.telemetry.spans import fence_wait
from pipegoose_tpu_torch.trainer.callback import Callback


def _params_device(trainer: Any) -> Optional[torch.device]:
    from pipegoose_tpu_torch.nn.parallel import tree_leaves

    leaves = tree_leaves(getattr(trainer, "params", None))
    return leaves[0].device if leaves and isinstance(leaves[0], torch.Tensor) else None


def _device_kind(device: Optional[torch.device]) -> Optional[str]:
    """The spec tables' key for ``device``: the card's name, or "cpu"."""
    if device is None:
        return None
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class TelemetryCallback(Callback):
    order = 5  # after recovery (-10) / default (0) callbacks

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        jsonl: Union[str, JSONLExporter, None] = None,
        prom: Union[str, PrometheusTextfileExporter, None] = None,
        every: int = 1,
        flops_per_step: Optional[float] = None,
        auto_cost: bool = False,
        hbm_every: int = 0,
        fence: bool = False,
        device_kind: Optional[str] = None,
    ):
        """``device_kind`` names the card for the peak table; by default
        the device the trainer's parameters live on names it."""
        if auto_cost:
            raise NotImplementedError(
                "auto_cost=True probes the compiled step's HLO for its FLOPs and "
                "collective bytes, which is not ported yet (ROADMAP.md queue A, "
                "item 13, its half A13b); pass flops_per_step instead")
        self.registry = registry
        self.every = max(int(every), 1)
        self.flops_per_step = flops_per_step
        self.hbm_every = int(hbm_every)
        self.fence = fence
        self.device_kind = device_kind
        self._jsonl = jsonl
        self._prom = prom
        self._t0: Optional[float] = None
        self._peak: Optional[float] = None
        self._device: Optional[torch.device] = None

    # -- lifecycle ---------------------------------------------------------

    def on_fit_start(self, trainer: Any) -> None:
        reg = self.registry or get_registry()
        self.registry = reg
        reg.enable()  # adding the callback IS the opt-in
        if isinstance(self._jsonl, str):
            self._jsonl = JSONLExporter(self._jsonl, registry=reg)
        elif self._jsonl is not None:
            reg.attach(self._jsonl)
        if isinstance(self._prom, str):
            self._prom = PrometheusTextfileExporter(self._prom)
        self._device = _params_device(trainer)
        if self._peak is None:
            self._peak = derived.peak_flops_for(
                self.device_kind or _device_kind(self._device))
        reg.event("train.fit_start")

    def on_step_start(self, trainer: Any, step: int) -> None:
        self._t0 = time.perf_counter()

    def on_step_end(self, trainer: Any, step: int, loss: Any) -> None:
        if self._t0 is None:
            return
        if self.fence:
            fence_wait(loss)
        dt = time.perf_counter() - self._t0
        reg = self.registry
        reg.histogram("train.step_seconds").observe(dt)
        reg.counter("train.steps_total").inc()
        tokens = getattr(trainer, "tokens_per_step", 0)
        tps = derived.tokens_per_second(tokens, dt)
        if tokens:
            reg.counter("train.tokens_total").inc(tokens)
            reg.gauge("train.tokens_per_s").set(tps)
        step_mfu = None
        if self.flops_per_step:
            step_mfu = derived.mfu(self.flops_per_step, dt, peak=self._peak)
            reg.gauge("train.mfu").set(step_mfu)
        if self.hbm_every and step % self.hbm_every == 0 and self._device is not None:
            hbm = derived.hbm_utilization(self._device)
            if "utilization" in hbm:
                reg.gauge("train.hbm_utilization").set(hbm["utilization"])
            if "bytes_in_use" in hbm:
                reg.gauge("train.hbm_bytes_in_use").set(hbm["bytes_in_use"])
        if step % self.every == 0:
            ev = {"step": step, "dur_s": dt, "tokens_per_s": tps}
            if step_mfu is not None:
                ev["mfu"] = step_mfu
            reg.event("train.step", **ev)

    def on_fit_end(self, trainer: Any) -> None:
        reg = self.registry
        if reg is None:
            return
        reg.event("train.fit_end")
        if isinstance(self._jsonl, JSONLExporter):
            self._jsonl.export_snapshot(reg)
        if isinstance(self._prom, PrometheusTextfileExporter):
            self._prom.write(reg)
