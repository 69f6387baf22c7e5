#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py          # from the repository root, one card

The main path is BLOOM-560m (full width: vocab 250880, hidden 1024, 24
layers, 16 heads) served by ``pipegoose_tpu_torch.serving.ServingEngine``
with chunked prefill over a paged KV pool, every attention read going
through the hand-written CUDA paged-attention kernel. Weights are random,
made from seed 0. Phases, each fatal on failure:

  0  the card: name and power limit (nvidia-smi), torch and CUDA versions;
  1  build every kernel from the sources in this checkout (nvcc, in
     parallel) and print ptxas's registers / shared memory / spills;
  2  each kernel against its plain PyTorch version on the card at
     bloom-560m's shapes (decode B=8 C=1, chunked prefill B=1 C=128;
     float32, bf16 and int8 pages);
  3  the float32 engine on the card against the same engine on the CPU:
     identical greedy tokens, and agreeing finite logits;
  4  timed bf16 serving runs (fp KV, then int8 KV): tokens/s, mean TTFT,
     mean decode-step ms, and the kernel's launch count, which must be
     n_layer x (decode steps + prefill chunks);
  5  the kernel's time at phase 4's decode shape beside its bound, its
     plain version's time and one PyTorch library call's.

The line before the last is a JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. Without a card, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
ATOL = {"f32": 1e-4, "int8": 1e-4, "bf16": 2e-3}   # online-softmax reassociation
LOGIT_ATOL = 1e-3              # float32 card vs CPU logits after 24 layers
NEAR_TIE = 1e-4                # top-2 margin below which a flip is a genuine tie
KERNEL = {
    "source": "pipegoose_tpu_torch/ops/csrc/paged_attention.cu",
    "replaces": "pipegoose_tpu/ops/paged_attention.py:217",
    "route": "cuda",
}


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 0 -------------------------------------------------------------------

def phase0_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card visible to torch; nothing ran")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.device_count()} card(s), "
        f"using {torch.cuda.get_device_name(0)}")
    return card


# -- phase 1 -------------------------------------------------------------------

def phase1_build() -> None:
    from pipegoose_tpu_torch.ops import _build

    names = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(names)
    log(f"phase 1: built {names} in {time.perf_counter() - t0:.1f} s")
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:   # ptxas -v, per kernel
                log(f"  {name}: {line.strip()}")


# -- phase 2 -------------------------------------------------------------------

def make_case(rng, dev, *, rows, c, starts, width, ps=16, nh=16, hd=64,
              layers=1):
    """Garbage-filled banks (NULL page included) for ``layers`` layers, a
    table of distinct random pages over each row's live prefix and NULL
    beyond it, f32 queries, ALiBi slopes of 16 heads."""
    from pipegoose_tpu_torch.models.bloom import alibi_slopes

    live = [(s + c - 1) // ps + 1 for s in starts]
    n_pages = 1 + sum(live)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((rows, width), np.int32)
    at = 0
    for b, n in enumerate(live):
        table[b, :n] = perm[at:at + n]
        at += n
    k = torch.randn(layers, n_pages, ps, nh, hd, device=dev)
    v = torch.randn(layers, n_pages, ps, nh, hd, device=dev)
    q = torch.randn(rows, c, nh, hd, device=dev)
    return {
        "q": q, "k": k, "v": v,
        "table": torch.from_numpy(table).to(dev),
        "start": torch.tensor(starts, dtype=torch.int32, device=dev),
        "slopes": torch.from_numpy(alibi_slopes(nh)).to(dev),
    }


def pages_as(case, fmt):
    """The case's float32 banks in page format ``fmt`` (f32, bf16, int8)."""
    from pipegoose_tpu_torch.serving.kv_pool import quantize_kv

    if fmt == "f32":
        return case["k"], case["v"]
    if fmt == "bf16":
        return case["k"].to(torch.bfloat16), case["v"].to(torch.bfloat16)
    out = []
    for x in (case["k"], case["v"]):
        q, s = quantize_kv(x)
        out.append({"q": q, "scale": s})
    return tuple(out)


def layer_of(pages, i):
    from pipegoose_tpu_torch.serving.kv_pool import layer_bank

    return layer_bank(pages, i)


def phase2_kernel_vs_plain(dev) -> dict:
    from pipegoose_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(SEED)
    torch.manual_seed(SEED)
    cases = {
        # starts: row at 0, a partial last page, one near max_context (1024)
        "decode B=8 C=1": make_case(rng, dev, rows=8, c=1, width=64,
                                    starts=[0, 17, 1023, 100, 300, 511, 700, 15]),
        "chunk B=1 C=128": make_case(rng, dev, rows=1, c=128, width=64,
                                     starts=[200]),
    }
    errs = {}
    for label, case in cases.items():
        for fmt in ("f32", "bf16", "int8"):
            k, v = (layer_of(p, 0) for p in pages_as(case, fmt))
            args = (case["q"], k, v, case["table"], case["start"])
            before = pa.paged_attention.launches
            out = pa.paged_attention(*args, slopes=case["slopes"])
            torch.cuda.synchronize()
            if pa.paged_attention.launches != before + 1:
                raise AssertionError(f"{label} {fmt}: launch counter did not move")
            ref = pa.paged_attention_reference(*args, slopes=case["slopes"])
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"{label} {fmt}: bad output {tuple(out.shape)}")
            err = (out - ref).abs().max().item()
            ok = err <= ATOL[fmt]
            log(f"phase 2: {label} {fmt} pages: max_abs_err={err} "
                f"(atol {ATOL[fmt]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{label} {fmt}: kernel disagrees with plain")
            errs[fmt] = max(errs.get(fmt, 0.0), err)
    return errs


# -- phase 3 -------------------------------------------------------------------

def prefill_logits(params, config, prompt, dev):
    """Float32 logits after ``prompt`` from ONE paged chunk over a fresh
    pool (pages 1..W in order): an engine-free reference forward."""
    from pipegoose_tpu_torch.serving.kv_pool import init_pages, paged_prefill_chunk

    ps, n = 16, len(prompt)
    width = -(-n // ps)
    k, v = init_pages(config, width + 1, ps, device=dev)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa: E731
    return paged_prefill_chunk(
        params, i32([list(prompt)]), k, v, i32([list(range(1, width + 1))]),
        i32([0]), i32([n]), config)


def make_engine(params, config, dev, *, num_slots, kv_dtype=None):
    """The main path's engine: page size 16, 1024-token context, 128-token
    prefill chunks, enough pages for every slot's worst case."""
    from pipegoose_tpu_torch.serving import ServingEngine

    return ServingEngine(params, config, num_slots=num_slots,
                         num_pages=num_slots * (1024 // 16) + 1, page_size=16,
                         max_context=1024, prefill_chunk=128,
                         kv_dtype=kv_dtype, device=dev)


def as_requests(requests):
    from pipegoose_tpu_torch.serving import Request

    return [Request(prompt=p, max_new_tokens=n) for p, n in requests]


def serve(params, config, requests, dev, *, num_slots, kv_dtype=None):
    eng = make_engine(params, config, dev, num_slots=num_slots, kv_dtype=kv_dtype)
    return eng, *eng.run(as_requests(requests))


def check_launches(label, launches, metrics, n_layer):
    want = n_layer * (metrics["decode_steps"] + metrics["prefill_chunks"])
    log(f"  {label}: kernel launches {launches}, n_layer x (decode steps "
        f"{metrics['decode_steps']} + prefill chunks {metrics['prefill_chunks']}) "
        f"= {want}")
    if launches != want or launches == 0:
        raise AssertionError(f"{label}: the main path bypassed the kernel")


def phase3_engine_vs_cpu(np_tree, dev):
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.ops import paged_attention as pa

    cfg = BloomConfig.bloom_560m()
    rng = np.random.default_rng(SEED + 3)
    requests = [(rng.integers(0, cfg.vocab_size, int(n)), 16)
                for n in rng.integers(40, 301, 3)]
    log(f"phase 3: bloom-560m float32, prompts {[len(p) for p, _ in requests]}, "
        f"16 new tokens each, 4 slots, chunk 128")
    cpu_params = params_from_jax(np_tree, cfg, device="cpu")
    gpu_params = params_from_jax(np_tree, cfg, device=dev)
    t0 = time.perf_counter()
    _, cpu_outs, _ = serve(cpu_params, cfg, requests, "cpu", num_slots=4)
    log(f"  cpu engine: {time.perf_counter() - t0:.1f} s")
    pa.paged_attention.launches = 0
    _, gpu_outs, gpu_metrics = serve(gpu_params, cfg, requests, dev, num_slots=4)
    check_launches("card engine", pa.paged_attention.launches, gpu_metrics,
                   cfg.n_layer)
    for (prompt, _), c, g in zip(requests, cpu_outs, gpu_outs):
        diff = np.nonzero(c.generated != g.generated)[0]
        if diff.size == 0:
            log(f"  request {c.uid}: {len(g.generated)} tokens identical")
            continue
        step = int(diff[0])
        prefix = np.concatenate([prompt, c.generated[:step]])
        top2 = torch.topk(prefill_logits(cpu_params, cfg, prefix, "cpu")[0], 2).values
        margin = (top2[0] - top2[1]).item()
        log(f"  request {c.uid}: diverges at step {step}, cpu top-2 margin {margin}")
        if margin >= NEAR_TIE:
            raise AssertionError(f"request {c.uid} diverged at step {step}, "
                                 f"margin {margin} is not a near-tie")
    prompt = requests[0][0]
    lg = prefill_logits(gpu_params, cfg, prompt, dev)
    lc = prefill_logits(cpu_params, cfg, prompt, "cpu")
    if lg.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError(f"card logits bad: shape {tuple(lg.shape)}")
    err = (lg.cpu() - lc).abs().max().item()
    log(f"  logits after a {len(prompt)}-token prompt: finite, card vs cpu "
        f"max_abs_err={err} (atol {LOGIT_ATOL})")
    if err > LOGIT_ATOL:
        raise AssertionError("card and cpu logits disagree")


# -- phase 4 -------------------------------------------------------------------

def phase4_timed_serving(np_tree, dev) -> dict:
    from pipegoose_tpu_torch.models.bloom import BloomConfig
    from pipegoose_tpu_torch.models.weights import params_from_jax
    from pipegoose_tpu_torch.ops import paged_attention as pa

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16)
    params = params_from_jax(np_tree, cfg, device=dev)
    rng = np.random.default_rng(SEED + 4)
    requests = [(rng.integers(0, cfg.vocab_size, int(n)), 64)
                for n in rng.integers(128, 513, 12)]
    log(f"phase 4: bloom-560m bf16, 12 requests, prompts 128-512 "
        f"(sum {sum(len(p) for p, _ in requests)}), 64 new tokens, 8 slots")
    launches = {}
    for kv in (None, "int8"):
        label = f"{kv or 'fp'} KV"
        serve(params, cfg, requests, dev, num_slots=8, kv_dtype=kv)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pa.paged_attention.launches = 0
        _, outs, m = serve(params, cfg, requests, dev, num_slots=8, kv_dtype=kv)
        launches[kv or "fp"] = pa.paged_attention.launches
        log(f"  {label}: {m['decode_tokens_per_s']} tokens/s, "
            f"mean TTFT {m['mean_ttft_s'] * 1e3} ms, mean decode step "
            f"{m['decode_step_time_s'] / m['decode_steps'] * 1e3} ms, "
            f"{m['generated_tokens']} tokens in {m['wall_time_s']} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if m["generated_tokens"] != 12 * 64 or any(
                len(o.generated) != 64 for o in outs):
            raise AssertionError(f"{label}: not every request got 64 tokens")
        check_launches(label, launches[kv or "fp"], m, cfg.n_layer)
        decode_profile(params, cfg, requests[:8], dev, kv, label)
    return launches


def decode_profile(params, cfg, requests, dev, kv_dtype, label, ticks=16):
    """Where a decode step's time goes: fill the 8 slots, let every prefill
    finish, then run ``ticks`` decode-only ticks under torch.profiler and
    report wall time, device busy time and the top kernels per tick."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pipegoose_tpu_torch.serving import Status

    eng = make_engine(params, cfg, dev, num_slots=8, kv_dtype=kv_dtype)
    eng.start_run(as_requests(requests))
    while eng.sched.queue or any(r.status is Status.PREFILL
                                 for r in eng.sched.active()):
        eng.tick_once()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    eng.finish_run()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / ticks
    if busy_ms == 0:
        log(f"  {label} decode tick: {wall_ms} ms wall under the profiler; "
            f"device time not measured (the profiler saw no device activity)")
        return
    log(f"  {label} decode tick (8 slots, profiled): {wall_ms} ms wall, device "
        f"busy {busy_ms} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in kernels) / ticks:.0f} kernels per tick")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3 / ticks:.4f} ms/tick "
            f"{e.count / ticks:.0f} launches/tick  {e.key[:90]}")


# -- phase 5 -------------------------------------------------------------------

def time_ms(fn, calls, replays=20):
    """Per-call ms of ``fn(i)`` for i in range(calls), timed with CUDA events
    two ways: (device ms, call ms). Device ms replays a CUDA graph of the
    ``calls`` calls, so no host work sits between the launches; call ms
    calls ``fn`` eagerly, the host's Python and launch overhead included."""
    stream = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    with torch.cuda.stream(side):          # warm-up off the capture stream
        for i in range(3):
            fn(i)
    stream.wait_stream(side)
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for i in range(calls):
        fn(i)
    t1.record()
    torch.cuda.synchronize()
    call_ms = t0.elapsed_time(t1) / calls
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (replays * calls), call_ms


def decode_bound_ms(case, fmt):
    """Least time for the decode call: each visible K/V value (plus its
    scale for int8), the f32 queries, the output, the visited table
    entries, starts and slopes moved once at 3.35 TB/s, against 4 flops
    per visible key element (q.k and p.v FMAs) at 67 TFLOP/s."""
    b, c, nh, hd = case["q"].shape
    keys = int((case["start"].long() + c).sum())        # visible keys, all rows
    per = {"f32": 4, "bf16": 2, "int8": 1}[fmt]
    kv = 2 * keys * nh * (hd * per + (4 if fmt == "int8" else 0))
    pages = int(((case["start"].long() + c - 1) // 16 + 1).sum())
    nbytes = kv + 2 * b * c * nh * hd * 4 + pages * 4 + b * 4 + nh * 4
    flops = 4 * keys * nh * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase5_kernel_time(dev, card, errs, launches) -> list:
    from pipegoose_tpu_torch.models.bloom import NEG_INF
    from pipegoose_tpu_torch.ops import paged_attention as pa
    from pipegoose_tpu_torch.serving.kv_pool import gather_pages

    n_layer = 24
    rng = np.random.default_rng(SEED + 5)
    starts = [int(s) for s in rng.integers(128, 576, 8)]
    case = make_case(rng, dev, rows=8, c=1, width=64, starts=starts,
                     layers=n_layer)
    log(f"phase 5: decode B=8 C=1 nh=16 hd=64 ps=16 W=64, starts {starts}; "
        f"each call reads the next of {n_layer} layer banks (L2-cold), on {card}")
    rows = []
    for fmt, kv in (("bf16", "fp"), ("int8", "int8")):
        k, v = pages_as(case, fmt)
        banks = [(layer_of(k, i), layer_of(v, i)) for i in range(n_layer)]
        q, table, start, slopes = case["q"], case["table"], case["start"], case["slopes"]
        if fmt == "bf16":
            q = q.to(torch.bfloat16)       # the bf16 engine's queries

        def kernel(i):
            kb, vb = banks[i % n_layer]
            pa.paged_attention(q, kb, vb, table, start, slopes=slopes)

        def plain(i):
            kb, vb = banks[i % n_layer]
            pa.paged_attention_reference(q, kb, vb, table, start, slopes=slopes)

        # the library yardstick: SDPA over each layer's pre-gathered view
        # with the same additive bias (the gather itself is not timed)
        sdpa_dtype = torch.bfloat16 if fmt == "bf16" else torch.float32
        views = [(gather_pages(kb, table).to(sdpa_dtype).transpose(1, 2).contiguous(),
                  gather_pages(vb, table).to(sdpa_dtype).transpose(1, 2).contiguous())
                 for kb, vb in banks]
        key_pos = torch.arange(views[0][0].shape[2], device=dev)
        keep = key_pos[None, :] <= start.long()[:, None]
        bias = (slopes[None, :, None, None] * key_pos.float()[None, None, None, :]
                + torch.where(keep, 0.0, NEG_INF)[:, None, None, :]).to(sdpa_dtype)
        qs = q.to(sdpa_dtype).transpose(1, 2).contiguous()

        def library(i):
            kt, vt = views[i % n_layer]
            torch.nn.functional.scaled_dot_product_attention(qs, kt, vt, attn_mask=bias)

        ms, call_ms = time_ms(kernel, n_layer)
        plain_ms, plain_call_ms = time_ms(plain, n_layer)
        library_ms, library_call_ms = time_ms(library, n_layer)
        bound_ms, bound_by = decode_bound_ms(case, fmt)
        log(f"  {fmt} pages, device ms per call: kernel {ms}, bound {bound_ms} "
            f"({bound_by}), plain {plain_ms}, SDPA {library_ms} [{card}]")
        log(f"  {fmt} pages, eager ms per call (host included): kernel "
            f"{call_ms}, plain {plain_call_ms}, SDPA {library_call_ms}")
        rows.append({
            "name": f"paged_attention ({fmt} pages, decode)", **KERNEL,
            "launches": launches[kv], "max_abs_err": errs[fmt], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "call_ms": call_ms,
        })
        del banks, views
    return rows


def main() -> int:
    card = phase0_card()
    dev = torch.device("cuda")
    from pipegoose_tpu_torch import resolve_device
    from pipegoose_tpu_torch.models.bloom import BloomConfig, init_params_numpy

    resolve_device(dev)   # float32 products without TF32
    phase1_build()
    errs = phase2_kernel_vs_plain(dev)
    t0 = time.perf_counter()
    np_tree = init_params_numpy(BloomConfig.bloom_560m(), seed=SEED)
    log(f"weights: bloom-560m from seed {SEED} in {time.perf_counter() - t0:.1f} s")
    phase3_engine_vs_cpu(np_tree, dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches = phase4_timed_serving(np_tree, dev)
    del np_tree
    gc.collect()
    torch.cuda.empty_cache()
    rows = phase5_kernel_time(dev, card, errs, launches)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
