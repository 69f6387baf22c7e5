"""Anomaly flight recorder: a black box for diverging runs.

The counterpart of ``pipegoose_tpu/telemetry/flightrec.py``:

- a HOST-SIDE ring buffer of the last ``capacity`` step records: loss,
  fenced step time, the health tree (host-converted; the port's in-graph
  health statistics wait for ROADMAP.md queue A, item A13b, so a trainer's
  ``state.last_health`` stays None), and per-step span summaries drained
  from the registry's event stream;
- STRUCTURED triggers evaluated on every checked step: non-finite
  anywhere (loss, gradients, optimizer updates; the reason names the
  offending module group), loss-spike z-score, grad-norm explosion against
  the running median, and the serving no-decode-progress watchdog (driven
  by ``ServingEngine``);
- on a trigger, an ATOMIC JSON black box: the ring, the trigger (name,
  reason, details), the parallel layout, and the environment (Python,
  torch, CUDA, the device's name and count, the ``torch.distributed``
  rank).

``FailureDetector`` / ``AutoRecovery`` (``trainer/recovery.py``) accept
``recorder=``: a fired trigger is consumed by the detector in the SAME
callback round (the recorder runs at order -20, before the detector's
-10), so recovery reacts to which signal fired, and the black box is on
disk before any restore rewinds the evidence.

The recorder is opt-in and host-synced by design: reading the loss each
checked step waits for the card, as ``TelemetryCallback(fence=True)``
does, which is also what makes the recorded step time a fenced device
time. ``check_every > 1`` amortizes it.
"""
from __future__ import annotations

import dataclasses
import math
import os
import statistics
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from pipegoose_tpu_torch.trainer.callback import Callback, _host_scalar


@dataclasses.dataclass
class TriggerEvent:
    """One fired anomaly trigger (and its black-box dump, if written)."""

    name: str          # "nonfinite" | "loss_spike" | "grad_explosion" |
    #                    "decode_stall" | "slo_burn" | custom (fire_trigger)
    reason: str        # human-readable; names the offending module group
    step: int
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)
    dump_path: Optional[str] = None


def _finite(x: Optional[float]) -> bool:
    return x is not None and isinstance(x, (int, float)) and math.isfinite(x)


class FlightRecorder(Callback):
    """Ring-buffer step recorder with structured anomaly triggers.

    As a trainer callback it records every ``check_every``-th step and
    evaluates the training triggers; ``ServingEngine`` drives the same
    object through :meth:`observe_serving_step` /
    :meth:`trigger_decode_stall`. A fired trigger is held in
    ``last_trigger`` until a consumer (``FailureDetector`` with
    ``recorder=``) calls :meth:`take_trigger`.

    ``loss_spike_z``: z-score of the step loss against the trailing
    ``window`` finite losses (arms at ``window // 2`` history).
    ``grad_explosion_factor``: global grad norm vs. the trailing
    median (reads the trainer's health tree, which the port's Trainer
    does not produce until A13b; ignored without it). ``max_dumps`` bounds disk usage under a persistent
    failure loop.
    """

    order = -20  # record + trigger BEFORE FailureDetector (-10) consumes

    def __init__(
        self,
        directory: str,
        capacity: int = 128,
        check_every: int = 1,
        loss_spike_z: Optional[float] = 6.0,
        grad_explosion_factor: Optional[float] = 25.0,
        window: int = 50,
        max_dumps: int = 8,
        registry=None,
        context: Optional[Dict[str, Any]] = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.directory = directory
        self.check_every = check_every
        self.loss_spike_z = loss_spike_z
        self.grad_explosion_factor = grad_explosion_factor
        self.window = window
        self.max_dumps = max_dumps
        self.context = dict(context or {})
        self.records: deque = deque(maxlen=capacity)
        self.dumps: List[str] = []
        self.last_trigger: Optional[TriggerEvent] = None
        self._loss_hist: deque = deque(maxlen=window)
        self._grad_hist: deque = deque(maxlen=window)
        self._registry = registry
        self._span_acc: Dict[str, List[float]] = {}
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        self._attached = False

    # -- ring --------------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> dict:
        """Append one timestamped record to the ring and return it."""
        rec = {"ts": time.time(), "kind": kind, **fields}
        with self._lock:
            self.records.append(rec)
        return rec

    # -- span summaries (registry event sink) ------------------------------

    def _sink(self, event: dict) -> None:
        if event.get("kind") != "span":
            return
        with self._lock:
            acc = self._span_acc.setdefault(event.get("span", "?"), [0, 0.0])
            acc[0] += 1
            acc[1] += float(event.get("dur_s", 0.0))

    def _drain_spans(self) -> Dict[str, dict]:
        with self._lock:
            out = {
                k: {"n": int(n), "total_s": t}
                for k, (n, t) in self._span_acc.items()
            }
            self._span_acc.clear()
        return out

    # -- trainer callback interface ----------------------------------------

    def _maybe_attach(self) -> None:
        from pipegoose_tpu_torch.telemetry.registry import get_registry

        if self._attached:
            return
        reg = self._registry if self._registry is not None else get_registry()
        # span summaries ride the event stream; a disabled registry
        # emits none, and attaching would change nothing — skip so the
        # recorder never implicitly turns telemetry on. Re-checked every
        # step (one branch when attached): a TelemetryCallback in the
        # same callback list enables the registry AFTER this recorder's
        # on_fit_start (it runs at order 5, the recorder at -20), so a
        # fit-start-only check would silently drop all span summaries
        # in exactly the documented wiring.
        if reg.enabled:
            reg.attach(self._sink)
            self._registry = reg
            self._attached = True

    def on_fit_start(self, trainer: Any) -> None:
        self._maybe_attach()

    def on_fit_end(self, trainer: Any) -> None:
        if self._attached and self._registry is not None:
            self._registry.detach(self._sink)
            self._attached = False

    def on_step_start(self, trainer: Any, step: int) -> None:
        self._maybe_attach()
        self._t0 = time.perf_counter()

    def on_step_end(self, trainer: Any, step: int, loss: Any) -> None:
        if step % self.check_every:
            return
        from pipegoose_tpu_torch.telemetry.health import host_health

        loss_f = _host_scalar(loss)  # syncs the step: the time below is fenced
        dt = (
            time.perf_counter() - self._t0 if self._t0 is not None else None
        )
        health = host_health(getattr(trainer.state, "last_health", None))
        self.record(
            "train.step", step=step, loss=loss_f, step_time_s=dt,
            health=health, spans=self._drain_spans(),
        )
        trig = self._train_trigger(step, loss_f, health)
        if trig is not None:
            trig.dump_path = self.dump(trig, context=self._train_context(trainer))
            self.last_trigger = trig
            return
        # only healthy steps feed the baselines (a spike must not
        # poison the median it is judged against)
        if _finite(loss_f):
            self._loss_hist.append(loss_f)
        if health is not None and _finite(health.get("grad_norm")):
            self._grad_hist.append(health["grad_norm"])

    # -- triggers ----------------------------------------------------------

    def _train_trigger(
        self, step: int, loss: Optional[float], health: Optional[dict]
    ) -> Optional[TriggerEvent]:
        # 1) non-finite anywhere — name the module group, not just "NaN"
        bad_bits = []
        details: Dict[str, Any] = {}
        if health is not None:
            per_mod = health.get("grad_norm_per_module", {}) or {}
            bad_mods = sorted(
                m for m, v in per_mod.items() if not _finite(v)
            )
            if health.get("nonfinite_grad_leaves", 0) or bad_mods:
                mods = (
                    f" in module group(s) {', '.join(repr(m) for m in bad_mods)}"
                    if bad_mods else ""
                )
                bad_bits.append(
                    f"non-finite gradients{mods} "
                    f"({health.get('nonfinite_grad_leaves', 0):.0f} leaves)"
                )
                details["bad_modules"] = bad_mods
            if health.get("nonfinite_update_leaves", 0):
                bad_bits.append(
                    "non-finite optimizer updates "
                    f"({health['nonfinite_update_leaves']:.0f} leaves)"
                )
            details["health"] = health
        if loss is not None and not _finite(loss):
            bad_bits.append(f"non-finite loss {loss}")
        if bad_bits:
            return TriggerEvent(
                "nonfinite", "; ".join(bad_bits), step, details
            )

        # 2) grad-norm explosion vs. the trailing median
        if (
            self.grad_explosion_factor is not None
            and health is not None
            and _finite(health.get("grad_norm"))
            and len(self._grad_hist) >= max(2, self.window // 2)
        ):
            gn = health["grad_norm"]
            med = statistics.median(self._grad_hist)
            if med > 0 and gn > self.grad_explosion_factor * med:
                per_mod = {
                    m: v
                    for m, v in (health.get("grad_norm_per_module") or {}).items()
                    if _finite(v)
                }
                worst = max(per_mod, key=per_mod.get) if per_mod else None
                at = (
                    f" (largest module group {worst!r} = {per_mod[worst]:.3g})"
                    if worst else ""
                )
                return TriggerEvent(
                    "grad_explosion",
                    f"grad norm {gn:.3g} > {self.grad_explosion_factor} x "
                    f"median {med:.3g}{at}",
                    step,
                    {"grad_norm": gn, "median": med, "health": health},
                )

        # 3) loss-spike z-score
        if (
            self.loss_spike_z is not None
            and _finite(loss)
            and len(self._loss_hist) >= max(2, self.window // 2)
        ):
            mean = statistics.fmean(self._loss_hist)
            std = statistics.pstdev(self._loss_hist)
            if std > 0:
                z = (loss - mean) / std
                if z > self.loss_spike_z:
                    return TriggerEvent(
                        "loss_spike",
                        f"loss {loss:.4g} is {z:.1f} sigma above the "
                        f"trailing mean {mean:.4g} (window {len(self._loss_hist)})",
                        step,
                        {"z": z, "mean": mean, "std": std},
                    )
        return None

    def fire_trigger(
        self, name: str, reason: str, step: int,
        context: Optional[dict] = None,
        details: Optional[Dict[str, Any]] = None,
    ) -> TriggerEvent:
        """Fire a structured trigger by name (black-box dump + pending
        ``last_trigger``) — the generic path custom monitors (e.g. the
        SLO burn-rate monitor, ``telemetry.slo``) raise through; the
        built-in training/serving triggers are thin wrappers over it."""
        trig = TriggerEvent(name, reason, step, dict(details or {}))
        trig.dump_path = self.dump(trig, context=context)
        self.last_trigger = trig
        return trig

    def take_trigger(self) -> Optional[TriggerEvent]:
        """Consume the pending trigger (recovery's entry point)."""
        trig, self.last_trigger = self.last_trigger, None
        return trig

    def reset_after_restore(self, restored_step: int) -> None:
        """Called by ``AutoRecovery`` after a checkpoint rollback: the
        spike/explosion baselines span the rolled-back timeline and a
        marker record keeps the ring's history interpretable."""
        self._loss_hist.clear()
        self._grad_hist.clear()
        self.last_trigger = None
        self.record("restore", step=restored_step)

    # -- serving -----------------------------------------------------------

    def observe_serving_step(self, step: int, **fields: Any) -> None:
        self.record("serving.step", step=step, **fields)

    def trigger_decode_stall(
        self, step: int, reason: str, context: Optional[dict] = None,
        **details: Any,
    ) -> TriggerEvent:
        """Fire the serving watchdog trigger and dump the black box."""
        return self.fire_trigger(
            "decode_stall", reason, step, context=context, details=details
        )

    # -- dump --------------------------------------------------------------

    def _train_context(self, trainer: Any) -> Dict[str, Any]:
        """The parallel layout of the run: the ``ParallelContext``'s axis
        sizes (the port has no mesh object), the world size and the
        parameters' device."""
        out: Dict[str, Any] = {"tokens_per_step": getattr(trainer, "tokens_per_step", None)}
        ctx = getattr(trainer, "parallel_context", None)
        sizes = getattr(ctx, "sizes", None)
        if sizes is not None:
            out["mesh_axes"] = {k: int(v) for k, v in dict(sizes).items()}
            out["n_devices"] = int(math.prod(out["mesh_axes"].values()))
        device = getattr(ctx, "device", None)
        if device is not None:
            out["device_kind"] = _device_name(device)
        return out

    @staticmethod
    def _environment() -> Dict[str, Any]:
        env: Dict[str, Any] = {"python": sys.version.split()[0]}
        try:
            import torch

            env["torch"] = torch.__version__
            env["cuda"] = torch.version.cuda
            env["device_count"] = torch.cuda.device_count()
            if torch.cuda.is_available():
                env["device_name"] = torch.cuda.get_device_name(
                    torch.cuda.current_device())
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                env["rank"] = dist.get_rank()
                env["world_size"] = dist.get_world_size()
        except Exception:  # noqa: BLE001 - never let forensics crash the run
            pass
        try:
            import numpy

            env["numpy"] = numpy.__version__
        except Exception:  # noqa: BLE001
            pass
        return env

    def dump(
        self, trigger: TriggerEvent, context: Optional[dict] = None
    ) -> Optional[str]:
        """Atomically write the black-box JSON; returns its path (None
        once ``max_dumps`` is exhausted — the ring keeps recording)."""
        if len(self.dumps) >= self.max_dumps:
            return None
        from pipegoose_tpu_torch.telemetry.exporters import (
            atomic_write_text,
            safe_json_dumps,
        )

        path = os.path.join(
            self.directory,
            f"blackbox_step{trigger.step:08d}_{trigger.name}.json",
        )
        with self._lock:
            records = list(self.records)
        payload = {
            "trigger": {
                "name": trigger.name,
                "reason": trigger.reason,
                "step": trigger.step,
                "details": trigger.details,
            },
            "records": records,
            "context": {**self.context, **(context or {})},
            "environment": self._environment(),
            "created_ts": time.time(),
        }
        atomic_write_text(
            path, safe_json_dumps(payload, indent=1), suffix=".blackbox.tmp"
        )
        self.dumps.append(path)
        return path


def _device_name(device: Any) -> str:
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
