"""Live ops endpoint: /metrics, /healthz and the /debug views.

The counterpart of ``pipegoose_tpu/telemetry/opsserver.py``.
:class:`OpsServer` is a standard-library (``http.server``) background HTTP
endpoint over the telemetry objects:

- ``GET /metrics``        Prometheus text rendered live from the registry,
                          the same text ``PrometheusTextfileExporter``
                          writes for the same snapshot.
- ``GET /healthz``        200 when healthy, 503 when degraded, with a JSON
                          body naming why: an unconsumed flight-recorder
                          trigger (decode stall, nonfinite, slo_burn, ...)
                          and/or a breaching SLO target (the monitor is
                          evaluated on every probe).
- ``GET /debug/requests`` in-flight and recent request timelines from the
                          ``RequestTracer``.
- ``GET /debug/fleet``    a fleet status provider (a dict or a callable).
- ``GET /debug/memory``   the live memory ledger (e.g.
                          ``engine.memledger.report``).
- ``GET /debug/goodput``  a goodput ledger report.
- ``GET /debug/trace``    one stitched fleet trace from the ``FleetTracer``
                          by ``?trace_id=`` or ``?uid=``.
- ``GET /debug/tail``     the fleet tail sampler's slowest traces.

The JAX server's doctor, profile and plan providers (``/debug/doctor``,
``/debug/profile``, ``/debug/plan``) wait for the port's mesh doctor,
profiler attribution and planner (ROADMAP.md queue A, A13b): the server
takes no such argument, and those paths answer 404 as an unset provider
does.

Operational posture: rank-0-filtered (other ranks never bind a socket),
``port=0`` binds an ephemeral port, handlers snapshot shared state under
the server lock and serialize with ``safe_json_dumps``. The handlers read
host state only and launch no device work. The SLO monitor is evaluated
under a lock of its own, so a breach's black-box write never stalls a
concurrent scrape. The server runs on daemon threads and is ``stop()``-able;
nothing starts unless the caller constructs one.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qs

from pipegoose_tpu_torch.telemetry.registry import MetricsRegistry, get_registry
from pipegoose_tpu_torch.utils.procindex import RankFilter as _RankFilter

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# /debug endpoints that serve an attached report/provider verbatim:
# path -> (OpsServer attribute, 404-message label). One branch serves
# all of them; adding the next debug surface is one row here plus a
# constructor knob.
_PROVIDER_ENDPOINTS = {
    "/debug/fleet": ("_fleet", "fleet status provider"),
    "/debug/memory": ("_memory", "memory ledger"),
    "/debug/goodput": ("_goodput", "goodput ledger"),
}
# the JAX server's providers that wait for the port's A13b: these paths
# answer as an unset provider does
_UNSET_ENDPOINTS = {
    "/debug/doctor": "doctor report",
    "/debug/profile": "step profile",
    "/debug/plan": "plan report",
}


class OpsServer:
    """Background ops HTTP endpoint (see module docstring).

    ``slo``: optional ``telemetry.slo.SLOMonitor`` (evaluated per
    ``/healthz`` probe). ``recorder``: optional ``FlightRecorder`` —
    a pending (un-consumed) trigger marks the process degraded.
    ``tracer``: optional ``RequestTracer`` behind ``/debug/requests``.
    ``fleet``: a JSON-able dict or a zero-arg callable returning one
    behind ``/debug/fleet`` (the JAX control plane's ``fleet_status``
    is the natural provider; the port's waits for A12).
    ``memory``: a JSON-able dict or a zero-arg callable returning one
    (e.g. ``engine.memledger.report``) behind ``/debug/memory`` — the
    live memory ledger's per-owner-class byte account, conservation
    verdict, leak-audit findings, and steps-to-exhaustion forecast.
    ``goodput``: a JSON-able dict or a zero-arg callable returning one
    (e.g. ``ledger.report``) behind ``/debug/goodput`` — the
    fleet goodput ledger's wall-clock attribution, conservation
    verdict, and incident log (MTTR, capacity-gap, SLO burn).
    ``fleettrace``: optional ``telemetry.fleettrace.FleetTracer``
    behind ``/debug/trace`` (one stitched trace by ``?trace_id=`` /
    ``?uid=``) and ``/debug/tail`` (slowest-trace exemplars).
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        rank: Optional[int] = 0,
        slo: Optional[Any] = None,
        recorder: Optional[Any] = None,
        tracer: Optional[Any] = None,
        fleet: Optional[Any] = None,
        fleettrace: Optional[Any] = None,
        memory: Optional[Any] = None,
        goodput: Optional[Any] = None,
    ):
        self.registry = registry if registry is not None else get_registry()
        self.host = host
        self._requested_port = int(port)
        self._rank_ok = _RankFilter(rank)
        self.slo = slo
        self.recorder = recorder
        self.tracer = tracer
        self._fleet = fleet
        self._memory = memory
        self._goodput = goodput
        self.fleettrace = fleettrace
        self._lock = threading.Lock()
        # SLOMonitor mutates per-target state on evaluate(), so
        # concurrent /healthz probes must serialize — but on its OWN
        # lock: a breach transition fires a flight-recorder black-box
        # dump (disk write) mid-evaluation, and holding the server lock
        # through that would stall a concurrent /metrics scrape exactly
        # when the system is degraded.
        self._slo_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- wiring ------------------------------------------------------------

    def _resolve_provider(self, attr: str) -> Optional[Any]:
        """ONE provider-or-value resolution for every /debug endpoint:
        a zero-arg callable (that isn't itself a report object) is
        invoked per request, anything else is served as-is; a raising
        provider resolves to None (404, never a 500 storm)."""
        with self._lock:
            p = getattr(self, attr)
        if callable(p) and not hasattr(p, "to_json"):
            try:
                return p()
            except Exception:  # noqa: BLE001 - provider failure != 500 storm
                return None
        return p

    def set_fleet(self, fleet: Any) -> None:
        """Attach (or replace) the provider behind ``/debug/fleet``."""
        with self._lock:
            self._fleet = fleet

    def set_memory(self, memory: Any) -> None:
        """Attach (or replace) the provider behind ``/debug/memory``."""
        with self._lock:
            self._memory = memory

    def set_goodput(self, goodput: Any) -> None:
        """Attach (or replace) the provider behind ``/debug/goodput``
        — a ``GoodputLedger.report``-shaped dict or a callable
        returning one (``lambda: ledger.report()`` stays live)."""
        with self._lock:
            self._goodput = goodput

    def set_fleettrace(self, fleettrace: Any) -> None:
        """Attach (or replace) the ``FleetTracer`` behind
        ``/debug/trace`` and ``/debug/tail``."""
        with self._lock:
            self.fleettrace = fleettrace

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> Optional[str]:
        """Bind + serve on a daemon thread; returns the base URL, or
        None when rank-filtered out (non-zero ranks are no-ops so the
        same construction code runs on every process)."""
        if not self._rank_ok():
            return None
        if self._httpd is not None:
            return self.url
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer(
            (self.host, self._requested_port), handler
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="pipegoose-ops-server",
            daemon=True,
        )
        self._thread.start()
        return self.url

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None

    @property
    def port(self) -> Optional[int]:
        return None if self._httpd is None else self._httpd.server_address[1]

    @property
    def url(self) -> Optional[str]:
        p = self.port
        return None if p is None else f"http://{self.host}:{p}"

    def __enter__(self) -> "OpsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- endpoint payloads (snapshot-under-lock) ---------------------------

    def render_metrics(self) -> str:
        with self._lock:
            return self.registry.to_prometheus()

    def health(self) -> Tuple[int, Dict[str, Any]]:
        """(status_code, body) for ``/healthz``: 200 iff no pending
        flight-recorder trigger and no breaching SLO target."""
        problems = []
        trig = getattr(self.recorder, "last_trigger", None)
        if trig is not None:
            problems.append({
                "kind": "flight_recorder_trigger",
                "name": trig.name,
                "reason": trig.reason,
                "step": trig.step,
                "dump_path": trig.dump_path,
            })
        slo_status = None
        if self.slo is not None:
            with self._slo_lock:
                slo_status = self.slo.status()
            if not slo_status.get("ok", True):
                for name, t in slo_status.get("targets", {}).items():
                    if t.get("breaching"):
                        problems.append({
                            "kind": "slo_burn",
                            "name": name,
                            "burn_fast": t.get("burn_fast"),
                            "burn_slow": t.get("burn_slow"),
                        })
        body: Dict[str, Any] = {
            "ok": not problems,
            "problems": problems,
        }
        if slo_status is not None:
            body["slo"] = slo_status
        if self.tracer is not None:
            # the tracer guards its own state; len() needs no ops lock
            body["requests_in_flight"] = len(self.tracer.in_flight)
        return (200 if not problems else 503), body

    def debug_requests(self) -> Optional[Dict[str, Any]]:
        if self.tracer is None:
            return None
        with self._lock:
            return self.tracer.snapshot()

    def debug_trace(self, query: Dict[str, str]) -> Tuple[int, Any]:
        """(status_code, body) for ``/debug/trace?trace_id=``/``?uid=``:
        one stitched cross-replica trace. trace_id is the fleet-stable
        key; uid resolves through the tracer's dispatch index (uids are
        replica-local, so the MOST RECENT dispatch wins a reused uid)."""
        ft = self.fleettrace
        if ft is None:
            return 404, {"error": "no fleet tracer attached"}
        try:
            uid = int(query["uid"]) if "uid" in query else None
            trace_id = (int(query["trace_id"])
                        if "trace_id" in query else None)
        except ValueError:
            return 400, {"error": "uid/trace_id must be integers"}
        if uid is None and trace_id is None:
            return 400, {"error": "pass ?trace_id=N or ?uid=N"}
        payload = ft.trace_json(uid=uid, trace_id=trace_id)
        if payload is None:
            return 404, {"error": "no trace for "
                         f"trace_id={trace_id} uid={uid}"}
        return 200, payload

    def debug_tail(self) -> Tuple[int, Any]:
        """(status_code, body) for ``/debug/tail``: the slowest
        completed fleet traces per objective with dominant hops."""
        ft = self.fleettrace
        if ft is None:
            return 404, {"error": "no fleet tracer attached"}
        return 200, ft.tail_payload()


def _make_handler(ops: OpsServer):
    """Handler class closed over the server object (BaseHTTPRequestHandler
    is instantiated per connection by ThreadingHTTPServer)."""
    from pipegoose_tpu_torch.telemetry.exporters import safe_json_dumps

    class _OpsHandler(BaseHTTPRequestHandler):
        server_version = "pipegoose-ops/1"

        def log_message(self, fmt: str, *args: Any) -> None:
            pass  # probes must not spam the serving process's stderr

        def _send(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, payload: Any) -> None:
            self._send(code, (safe_json_dumps(payload, indent=1) + "\n")
                       .encode(), "application/json")

        def do_GET(self) -> None:  # noqa: N802 - http.server API
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            try:
                if path == "/metrics":
                    self._send(200, ops.render_metrics().encode(),
                               PROM_CONTENT_TYPE)
                elif path == "/healthz":
                    code, body = ops.health()
                    self._send_json(code, body)
                elif path == "/debug/requests":
                    payload = ops.debug_requests()
                    if payload is None:
                        self._send_json(404, {"error": "no request tracer "
                                              "attached"})
                    else:
                        self._send_json(200, payload)
                elif path == "/debug/trace":
                    parts = self.path.split("?", 1)
                    query = {
                        k: v[-1]
                        for k, v in parse_qs(parts[1]).items()
                    } if len(parts) == 2 else {}
                    code, payload = ops.debug_trace(query)
                    self._send_json(code, payload)
                elif path == "/debug/tail":
                    code, payload = ops.debug_tail()
                    self._send_json(code, payload)
                elif path in _UNSET_ENDPOINTS:
                    self._send_json(404, {"error": f"no {_UNSET_ENDPOINTS[path]} "
                                          "attached"})
                elif path in _PROVIDER_ENDPOINTS:
                    attr, label = _PROVIDER_ENDPOINTS[path]
                    report = ops._resolve_provider(attr)
                    if report is None:
                        self._send_json(404, {"error": f"no {label} "
                                              "attached"})
                    else:
                        payload = (report.to_json()
                                   if hasattr(report, "to_json") else report)
                        self._send_json(200, payload)
                elif path == "/":
                    self._send_json(200, {
                        "endpoints": ["/metrics", "/healthz",
                                      "/debug/requests", "/debug/fleet", "/debug/memory",
                                      "/debug/goodput",
                                      "/debug/trace", "/debug/tail"],
                    })
                else:
                    self._send_json(404, {"error": f"unknown path {path!r}"})
            except (BrokenPipeError, ConnectionResetError):
                pass  # probe hung up mid-response: not our problem
            except Exception as e:  # noqa: BLE001 - a handler bug must
                # surface as a 500 on THIS probe, not kill the thread pool
                try:
                    self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                except Exception:  # noqa: BLE001
                    pass

    return _OpsHandler


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Minimal parser for the text exposition format: sample lines ->
    {name_with_labels: value}. Raises ValueError on a malformed line —
    what the CI smoke and tests use to assert ``/metrics`` parses."""
    out: Dict[str, float] = {}
    for i, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.rsplit(" ", 1)
        if len(parts) != 2:
            raise ValueError(f"line {i + 1}: not '<name> <value>': {line!r}")
        name, value = parts
        key = name.split("{", 1)[0]
        if not key or not (key[0].isalpha() or key[0] == "_"):
            raise ValueError(f"line {i + 1}: bad metric name {name!r}")
        out[name] = float(value)  # ValueError on a non-numeric sample
    return out
