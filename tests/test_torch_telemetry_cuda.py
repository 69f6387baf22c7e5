"""The telemetry core on the card: what has no meaning without one. Skips
without a card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_telemetry_cuda.py

- Inside a ``torch.cuda.graph`` capture a counter's ``inc``, a gauge's
  ``set``, a histogram's ``observe``, an ``event`` and a ``span`` record
  nothing, and replays add nothing: host code runs once, at capture.
- A span's fence waits for the work queued on the fenced tensor's stream:
  a span around a long matmul chain measures at least the card's time of
  it (CUDA events), and a span without the fence measures the launches.
- A fence on a side stream waits for that stream's work.
- ``peak_flops_for(None)`` reads the card's name; ``hbm_utilization`` and
  ``device_memory_stats`` read the caching allocator (bytes in use equal
  ``torch.cuda.memory_allocated``) and the card's total memory.
"""
import time

import pytest
import torch

pytestmark = pytest.mark.cuda


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_capture_records_nothing_and_replays_add_nothing():
    dev = _needs_card()
    from pipegoose_tpu_torch.telemetry import MetricsRegistry, span

    reg = MetricsRegistry(enabled=True)
    events = []
    reg.attach(events.append)
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")
    x = torch.ones(256, device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):       # warm-up off the capture stream
        y = x * 2
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c.inc()
        g.set(3.0)
        h.observe(0.5)
        reg.event("captured")
        with span("captured", registry=reg) as sp:
            y = x * 2
            sp.fence(y)
    for _ in range(10):
        graph.replay()
    torch.cuda.synchronize()
    assert y.sum().item() == 512.0        # the captured work ran on replay
    assert c.value == 0.0 and g.value != g.value and h.count == 0
    assert events == []
    assert "span.captured.seconds" not in reg.snapshot()["histograms"]
    c.inc()                               # outside a capture it records
    assert c.value == 1.0


def _chain(a, n=40):
    for _ in range(n):
        a = torch.tanh(a @ a)
    return a


def test_fence_waits_for_the_card():
    dev = _needs_card()
    from pipegoose_tpu_torch.telemetry import MetricsRegistry, span

    reg = MetricsRegistry(enabled=True)
    a = torch.randn(2048, 2048, device=dev) * 0.01
    _chain(a, 2)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    with span("fenced", registry=reg) as sp:
        out = _chain(a)
        sp.fence(out)
    t1.record()
    torch.cuda.synchronize()
    card_s = t0.elapsed_time(t1) / 1e3
    fenced = reg.histogram("span.fenced.seconds").sum
    assert fenced >= 0.9 * card_s
    with span("unfenced", registry=reg):
        out = _chain(a)
    t_host = time.perf_counter()
    torch.cuda.synchronize()
    waited = time.perf_counter() - t_host
    assert reg.histogram("span.unfenced.seconds").count == 1
    assert waited > 0          # the unfenced span left work in the queue


def test_fence_waits_on_the_tensors_stream():
    dev = _needs_card()
    from pipegoose_tpu_torch.telemetry.spans import fence_wait

    side = torch.cuda.Stream()
    a = torch.randn(2048, 2048, device=dev) * 0.01
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        out = _chain(a)
        fence_wait(out)            # inside the block: the side stream is current
        done = torch.cuda.Event()
        done.record(side)
    assert done.query()


def test_memory_stats_and_peak_read_the_card():
    dev = _needs_card()
    from pipegoose_tpu_torch.telemetry import derived, hbm_utilization, peak_flops_for
    from pipegoose_tpu_torch.utils.profiler import device_memory_stats

    name = torch.cuda.get_device_name(dev)
    assert peak_flops_for(None) == peak_flops_for(name)
    keep = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    stats = device_memory_stats(dev)
    assert stats["bytes_in_use"] == torch.cuda.memory_allocated(dev)
    assert stats["bytes_limit"] == torch.cuda.mem_get_info(dev)[1]
    hbm = hbm_utilization(dev)
    assert hbm["bytes_in_use"] == torch.cuda.memory_allocated(dev)
    assert hbm["utilization"] == hbm["bytes_in_use"] / hbm["bytes_limit"]
    assert hbm_utilization(None)["bytes_limit"] == stats["bytes_limit"]
    if "h100" in name.lower():
        assert derived.hbm_bw_bytes_per_s_for(None) in (2.0e12, 3.35e12)
    del keep
