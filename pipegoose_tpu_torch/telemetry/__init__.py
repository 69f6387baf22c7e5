"""Telemetry: the metrics registry, span tracing, JSONL and Prometheus
exporters, SLO burn-rate monitoring, fleet merges, the anomaly flight
recorder, the serving memory ledger, the Trainer's TelemetryCallback and
the derived gauges (MFU, tokens/s, device memory).

The counterpart of ``pipegoose_tpu/telemetry/``'s host-side core. Library
hot paths (the Trainer's fit loop, the serving engine, the decode loops)
are instrumented against the GLOBAL registry, which starts disabled, so an
unobserved run pays one branch per site. Turn it on with
``telemetry.enable()`` (or by adding a ``TelemetryCallback``, or building
an engine with an enabled registry) and attach exporters:

    from pipegoose_tpu_torch import telemetry

    telemetry.enable()
    jsonl = telemetry.JSONLExporter("run.jsonl",
                                    registry=telemetry.get_registry())
    ...train / serve...
    jsonl.export_snapshot()
    telemetry.PrometheusTextfileExporter("run.prom").write(
        telemetry.get_registry())

Not ported yet (ROADMAP.md queue A): the request, Chrome and fleet traces,
the ops server, goodput and the perf sentinel (A13a split (2)); the mesh
doctor, the profiler attribution, the in-graph health statistics and the
HLO half of ``derived`` (A13b).
"""
from pipegoose_tpu_torch.telemetry.callback import TelemetryCallback
from pipegoose_tpu_torch.telemetry.derived import (
    HBM_BW_BYTES,
    HBM_BYTES,
    PEAK_DCI_BYTES,
    PEAK_FLOPS,
    PEAK_ICI_BYTES,
    dci_bytes_per_s_for,
    hbm_bw_bytes_per_s_for,
    hbm_bytes_for,
    hbm_utilization,
    ici_bytes_per_s_for,
    mfu,
    peak_flops_for,
    tokens_per_second,
)
from pipegoose_tpu_torch.telemetry.exporters import (
    JSONLExporter,
    PrometheusTextfileExporter,
)
from pipegoose_tpu_torch.telemetry.fleet import (
    FleetRegistry,
    merge_histograms,
    merge_metrics,
)
from pipegoose_tpu_torch.telemetry.flightrec import FlightRecorder, TriggerEvent
from pipegoose_tpu_torch.telemetry.health import host_health
from pipegoose_tpu_torch.telemetry.memledger import MemoryLedger
from pipegoose_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    disable,
    enable,
    get_registry,
)
from pipegoose_tpu_torch.telemetry.slo import (
    SLOMonitor,
    SLOTarget,
    default_serving_slos,
)
from pipegoose_tpu_torch.telemetry.spans import current_span_path, span

__all__ = [
    "Counter",
    "FleetRegistry",
    "FlightRecorder",
    "Gauge",
    "HBM_BW_BYTES",
    "HBM_BYTES",
    "Histogram",
    "JSONLExporter",
    "MemoryLedger",
    "MetricsRegistry",
    "PEAK_DCI_BYTES",
    "PEAK_FLOPS",
    "PEAK_ICI_BYTES",
    "PrometheusTextfileExporter",
    "SLOMonitor",
    "SLOTarget",
    "TelemetryCallback",
    "TriggerEvent",
    "current_span_path",
    "dci_bytes_per_s_for",
    "default_serving_slos",
    "disable",
    "enable",
    "get_registry",
    "hbm_bw_bytes_per_s_for",
    "hbm_bytes_for",
    "hbm_utilization",
    "host_health",
    "ici_bytes_per_s_for",
    "merge_histograms",
    "merge_metrics",
    "mfu",
    "peak_flops_for",
    "span",
    "tokens_per_second",
]
