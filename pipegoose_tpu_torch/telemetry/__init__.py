"""Telemetry: the metrics registry, span tracing, JSONL and Prometheus
exporters, SLO burn-rate monitoring, fleet merges, the anomaly flight
recorder, the serving memory ledger, the Trainer's TelemetryCallback, the
derived gauges (MFU, tokens/s, device memory), the request and fleet
tracers, the Chrome / Perfetto trace export, the live ops server, the
goodput ledgers and the perf-regression sentinel.

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

A serving run traced and served live:

    tracer = telemetry.RequestTracer(registry=reg)
    engine = ServingEngine(params, cfg, registry=reg, tracer=tracer,
                           sentinel=telemetry.PerfSentinel())
    with telemetry.OpsServer(reg, tracer=tracer) as ops:
        ...engine.run(requests); scrape ops.url + "/metrics"...

Not ported yet (ROADMAP.md queue A): the control plane that drives the
fleet tracer's hops and the fleet goodput ledger's ticks, and the
tracer's disaggregation and KV-tier transfer hooks (A12); the mesh doctor,
the profiler attribution (the ops server's doctor, profile and plan
providers, the sentinel's ``StepProfile`` input), the in-graph health
statistics and the HLO half of ``derived`` (A13b).
"""
from pipegoose_tpu_torch.telemetry.callback import TelemetryCallback
from pipegoose_tpu_torch.telemetry.chrometrace import (
    ChromeTraceExporter,
    goodput_trace_events,
    memory_trace_events,
    pipeline_trace_events,
    register_pipeline_gauges,
    router_trace_events,
    span_events_to_trace,
    trace_from_jsonl,
)
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
from pipegoose_tpu_torch.telemetry.fleettrace import (
    FleetTracer,
    TailSampler,
    fleet_trace_events,
)
from pipegoose_tpu_torch.telemetry.flightrec import FlightRecorder, TriggerEvent
from pipegoose_tpu_torch.telemetry.goodput import (
    GoodputLedger,
    Incident,
    TrainerGoodput,
    availability_slo_target,
)
from pipegoose_tpu_torch.telemetry.health import host_health
from pipegoose_tpu_torch.telemetry.memledger import MemoryLedger
from pipegoose_tpu_torch.telemetry.opsserver import OpsServer, parse_prometheus_text
from pipegoose_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    disable,
    enable,
    get_registry,
)
from pipegoose_tpu_torch.telemetry.reqtrace import (
    NULL_TRACER,
    NullRequestTracer,
    RequestTracer,
    request_trace_events,
)
from pipegoose_tpu_torch.telemetry.sentinel import PerfSentinel, read_bench_history
from pipegoose_tpu_torch.telemetry.slo import (
    SLOMonitor,
    SLOTarget,
    default_serving_slos,
)
from pipegoose_tpu_torch.telemetry.spans import current_span_path, span

__all__ = [
    "ChromeTraceExporter",
    "Counter",
    "FleetRegistry",
    "FleetTracer",
    "FlightRecorder",
    "Gauge",
    "GoodputLedger",
    "HBM_BW_BYTES",
    "HBM_BYTES",
    "Histogram",
    "Incident",
    "JSONLExporter",
    "MemoryLedger",
    "MetricsRegistry",
    "NULL_TRACER",
    "NullRequestTracer",
    "OpsServer",
    "PEAK_DCI_BYTES",
    "PEAK_FLOPS",
    "PEAK_ICI_BYTES",
    "PerfSentinel",
    "PrometheusTextfileExporter",
    "RequestTracer",
    "SLOMonitor",
    "SLOTarget",
    "TailSampler",
    "TelemetryCallback",
    "TrainerGoodput",
    "TriggerEvent",
    "availability_slo_target",
    "current_span_path",
    "dci_bytes_per_s_for",
    "default_serving_slos",
    "disable",
    "enable",
    "fleet_trace_events",
    "get_registry",
    "goodput_trace_events",
    "hbm_bw_bytes_per_s_for",
    "hbm_bytes_for",
    "hbm_utilization",
    "host_health",
    "ici_bytes_per_s_for",
    "memory_trace_events",
    "merge_histograms",
    "merge_metrics",
    "mfu",
    "parse_prometheus_text",
    "peak_flops_for",
    "pipeline_trace_events",
    "read_bench_history",
    "register_pipeline_gauges",
    "request_trace_events",
    "router_trace_events",
    "span",
    "span_events_to_trace",
    "tokens_per_second",
    "trace_from_jsonl",
]
