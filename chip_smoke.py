#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py          # from the repository root, one card

Two main paths, both BLOOM-560m at full width (vocab 250880, hidden 1024,
24 layers, 16 heads) with random weights made from seed 0:

- serving: ``pipegoose_tpu_torch.serving.ServingEngine`` with chunked
  prefill over a paged KV pool, every attention read going through the
  hand-written CUDA paged-attention kernel;
- training: ``pipegoose_tpu_torch.trainer.train_step`` (loss, backward,
  Adam), its attention going through the hand-written CUDA flash-attention
  forward, dQ and dK/dV kernels, and with ``fused_ce`` its loss through the
  hand-written CUDA fused cross-entropy forward, d-hidden and d-weight
  kernels.

Phases, each fatal on failure:

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
     plain version's time and one PyTorch library call's;
  6  the three flash-attention kernels against their plain versions at
     bloom-560m's attention shape (B=8, S=1024, nh=16, hd=64) in bf16 and
     float32, and on a right-padded mask, S=100, GQA g=2, window=64 and
     causal=False;
  7  the float32 train step on the card against the same step on the CPU
     (full width, depth cut to 2 layers): loss, every gradient, and the
     losses over 3 Adam steps;
  8  timed bf16 training steps exactly as ``bench.py``'s "flash" variant
     (24 layers, remat, flash, batch 8 x 1024, Adam 1e-4): step ms,
     tokens/s, MFU, peak memory, falling losses, the kernels' launch
     counts, and where one profiled step's device time goes;
  9  each flash kernel's time at phase 8's shape beside its bound, its
     plain version's time and PyTorch's SDPA forward or backward;
 10  the three fused cross-entropy kernels (forward, d-hidden, d-weight)
     against their plain versions on the card: float32 and bf16, ragged T
     and V with a nonzero offset and valid_size < V, both weight layouts,
     and bench.py's shape in bf16 (T = 8 x 1023, H = 1024, V = 250880);
 11  phase 7's float32 train step, card vs CPU, with fused_ce=True,
     ce_chunks=8, remat_policy="dots" and remat_policy="attn"; on the card
     the fused loss also equals the full-logits loss of the same weights;
 12  timed bf16 training as phase 8 in bench.py's "flash+fusedce",
     "noremat+flash+fusedce" and "flash+ce8" variants: step ms, tokens/s,
     MFU, peak memory (below phase 8's for the fused variants), falling
     losses, every kernel's launches per step, and one profiled step's
     device time with the fused kernels' share;
 13  each fused kernel's time at phase 12's shape beside its bound, its
     plain version's time and a composite of PyTorch calls that computes
     the same function through the full logits.

The line before the last is a JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. Without a card, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import dataclasses
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
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 dense tensor cores
ATOL = {"f32": 1e-4, "int8": 1e-4, "bf16": 2e-3}   # online-softmax reassociation
LOGIT_ATOL = 1e-3              # float32 card vs CPU logits after 24 layers
NEAR_TIE = 1e-4                # top-2 margin below which a flip is a genuine tie
KERNEL = {
    "source": "pipegoose_tpu_torch/ops/csrc/paged_attention.cu",
    "replaces": "pipegoose_tpu/ops/paged_attention.py:217",
    "route": "cuda",
}
FLASH_SOURCE = "pipegoose_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "fwd": "pipegoose_tpu/ops/flash_attention.py:88",
    "dq": "pipegoose_tpu/ops/flash_attention.py:187",
    "dkv": "pipegoose_tpu/ops/flash_attention.py:270",
}
# flash kernel vs plain, on max |diff| against the largest |plain| value M:
# float32 outputs 1e-5 + 2e-4 M (the sums run in another order; ALiBi
# scores reach ~512 at S=1024, where a float32 ulp is 6.1e-5, and the
# backward multiplies P's relative error by dO.V); bf16 outputs
# 1e-5 + 2^-7 M (both sides round float32 values that differ in their last
# bits, so they may land one bf16 ulp, at most 2^-7 of the value, apart);
# lse, float32 in both dtypes, 1e-5 + 2^-21 M (four float32 ulps).
FLASH_RTOL = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -7}
FLASH_ATOL = 1e-5
LSE_RTOL = 2.0 ** -21
# float32 train step, card vs CPU, full width at 2 layers: the loss to
# 1e-4 absolute and every gradient to 1e-3 of its leaf's largest value
# (float32 sums over 1024-wide products, 512 tokens and 250880 vocab
# entries, taken in another order by cuBLAS and the CPU's BLAS); after
# Adam steps the losses to 1e-3, since Adam moves a weight whose gradient
# is near zero by up to lr whatever the gradient's rounding
FUSED_SOURCE = "pipegoose_tpu_torch/ops/csrc/fused_ce.cu"
FUSED_REPLACES = {
    "fwd": "pipegoose_tpu/ops/fused_ce.py:63",
    "dh": "pipegoose_tpu/ops/fused_ce.py:163",
    "dw": "pipegoose_tpu/ops/fused_ce.py:221",
}
# fused CE kernel vs plain, on max |diff| against the largest finite |plain|
# value M (a masked target's logit, exactly -1e9, is left out of M), with no
# absolute floor, since dh and dw scale with g = 1/T: lse and target logit
# 2^-18 M (bf16 products are exact in float32 and only the order of the sums
# differs; float32 inputs run in split TF32, which drops 2^-22 of each
# product); float32 dh, dw 1e-4 M (split-TF32 products summed over the
# vocabulary or the tokens in another order); bf16 dh, dw 2^-6 M, two bf16
# ulps: the final rounding, and the dlogits tile that the kernels round to
# bf16 before the second product
FUSED_STAT_RTOL = 2.0 ** -18
FUSED_GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
TRAIN_LOSS_ATOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_ADAM_LOSS_ATOL = 1e-3


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
    from pipegoose_tpu_torch.serving import Status

    eng = make_engine(params, cfg, dev, num_slots=8, kv_dtype=kv_dtype)
    eng.start_run(as_requests(requests))
    while eng.sched.queue or any(r.status is Status.PREFILL
                                 for r in eng.sched.active()):
        eng.tick_once()
    profile_device(eng.tick_once, ticks, f"{label} decode tick (8 slots, profiled)",
                   "tick", top=6)
    eng.finish_run()


def profile_device(fn, n, label, unit, top):
    """Run ``fn()`` ``n`` times under torch.profiler after a sync; log the
    wall time, the device busy time (summed kernel time) and its share,
    and the ``top`` kernels by device time, each per ``unit``. Returns
    (wall ms, busy ms, the profiler's device-kernel averages)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy_ms == 0:
        log(f"  {label}: {wall_ms} ms wall under the profiler; device time "
            f"not measured (the profiler saw no device activity)")
        return wall_ms, busy_ms, kernels
    log(f"  {label}: {wall_ms} ms wall, device busy {busy_ms} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(e.count for e in kernels) / n:.0f} kernels per {unit}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3 / n:.4f} ms/{unit} "
            f"{e.count / n:.0f} launches/{unit}  {e.key[:90]}")
    return wall_ms, busy_ms, kernels


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


# -- phase 6 -------------------------------------------------------------------

def flash_case(dev, dtype, *, b, s=1024, nh=16, nkv=16, hd=64, pad=0, seed=0):
    """Flattened flash-kernel operands: q, dO (B*nh, S, hd) and k, v
    (B*nkv, S, hd) in ``dtype`` from a seeded normal, BLOOM's ALiBi slopes,
    and kv_pos / kv_neg from a mask whose last row ends in ``pad`` padded
    keys (all ones when pad is 0)."""
    from pipegoose_tpu_torch.models.bloom import alibi_slopes
    from pipegoose_tpu_torch.ops.flash_attention import mask_to_kv_bias

    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda rows: torch.randn(rows, s, hd, device=dev, generator=gen).to(dtype)  # noqa: E731
    mask = torch.ones(b, s, device=dev)
    if pad:
        mask[-1, s - pad:] = 0
    kpos, kneg = (x[:, None].expand(b, nkv, s).reshape(b * nkv, s).contiguous()
                  for x in mask_to_kv_bias(mask))
    slopes = torch.from_numpy(alibi_slopes(nh)).to(dev).repeat(b)
    return {"q": rand(b * nh), "k": rand(b * nkv), "v": rand(b * nkv),
            "do": rand(b * nh), "slopes": slopes, "kpos": kpos, "kneg": kneg,
            "g": nh // nkv, "scale": hd ** -0.5}


def flash_args(case, causal=True, window=None):
    """(forward args, backward args without lse/delta, mode) of a case."""
    fwd = tuple(case[n] for n in ("q", "k", "v", "slopes", "kpos", "kneg"))
    return fwd, (case["scale"], causal, case["g"], window)


def flash_bwd_args(case, lse, delta):
    return (case["q"], case["k"], case["v"], case["do"], lse, delta,
            case["slopes"], case["kpos"], case["kneg"])


def flash_err(got, want, rtol):
    """(max abs error, tolerance) of a kernel output against its plain
    version; fails on a bad shape or a non-finite value."""
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"bad kernel output {tuple(got.shape)}")
    err = (got.float() - want.float()).abs().max().item()
    return err, FLASH_ATOL + rtol * want.float().abs().max().item()


def check_flash(label, case, causal=True, window=None) -> dict:
    """Each flash kernel once against its plain version on one case;
    every launch counter must move by exactly one. Returns each kernel's
    max abs error."""
    from pipegoose_tpu_torch.ops import flash_attention as fa

    fwd, mode = flash_args(case, causal, window)
    dtype = case["q"].dtype
    counts = (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches)
    out, lse = fa.flash_fwd(*fwd, *mode)
    ref_out, ref_lse = fa.flash_fwd_reference(*fwd, *mode)
    delta = (case["do"].float() * ref_out.float()).sum(-1)
    bwd = flash_bwd_args(case, ref_lse, delta)
    dq = fa.flash_dq(*bwd, *mode)
    dk, dv = fa.flash_dkv(*bwd, *mode)
    torch.cuda.synchronize()
    moved = tuple(n - c for n, c in zip(
        (fa.flash_fwd.launches, fa.flash_dq.launches, fa.flash_dkv.launches), counts))
    if moved != (1, 1, 1):
        raise AssertionError(f"{label}: launch counters moved by {moved}")
    ref_dk, ref_dv = fa.flash_dkv_reference(*bwd, *mode)
    checks = {
        "out": flash_err(out, ref_out, FLASH_RTOL[dtype]),
        "lse": flash_err(lse, ref_lse, LSE_RTOL),
        "dq": flash_err(dq, fa.flash_dq_reference(*bwd, *mode), FLASH_RTOL[dtype]),
        "dk": flash_err(dk, ref_dk, FLASH_RTOL[dtype]),
        "dv": flash_err(dv, ref_dv, FLASH_RTOL[dtype]),
    }
    bad = [n for n, (err, tol) in checks.items() if err > tol]
    log(f"phase 6: {label}: " + ", ".join(
        f"{n} {err:.3g} (tol {tol:.3g})" for n, (err, tol) in checks.items())
        + (f" FAIL {bad}" if bad else " ok"))
    if bad:
        raise AssertionError(f"{label}: flash kernels disagree with plain on {bad}")
    return {"fwd": max(checks["out"][0], checks["lse"][0]), "dq": checks["dq"][0],
            "dkv": max(checks["dk"][0], checks["dv"][0])}


def phase6_flash_vs_plain(dev) -> dict:
    """Returns the max abs errors of the bloom-560m bf16 case, the shape
    and dtype of phase 8's calls."""
    errs = {}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        main = check_flash(f"{name} B=8 S=1024 nh=16 hd=64 causal",
                           flash_case(dev, dtype, b=8, seed=SEED))
        if dtype is torch.bfloat16:
            errs = main
        check_flash(f"{name} B=2 right-padded (300 keys)",
                    flash_case(dev, dtype, b=2, pad=300, seed=SEED + 1))
        check_flash(f"{name} B=2 S=100 (ragged tile)",
                    flash_case(dev, dtype, b=2, s=100, seed=SEED + 2))
        check_flash(f"{name} B=2 GQA nh=16 nkv=8",
                    flash_case(dev, dtype, b=2, nkv=8, seed=SEED + 3))
        check_flash(f"{name} B=2 window=64",
                    flash_case(dev, dtype, b=2, seed=SEED + 4), window=64)
        check_flash(f"{name} B=2 causal=False",
                    flash_case(dev, dtype, b=2, seed=SEED + 5), causal=False)
    return errs


# -- phase 7 -------------------------------------------------------------------

def phase7_train_vs_cpu(np_tree, dev) -> None:
    train_vs_cpu(np_tree, dev, "phase 7")


def train_vs_cpu(np_tree, dev, label, **opts):
    """The float32 train step on the card against the same step on the
    CPU: full widths, depth cut to 2 layers, batch 2 x 256 with a
    right-padded row, remat and flash, plus the config options ``opts``.
    Returns the card's params after the steps and the config."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig, loss_fn
    from pipegoose_tpu_torch.models.weights import grads_of, params_from_jax, params_to_jax
    from pipegoose_tpu_torch.trainer import make_optimizer, train_step

    n_layer, b, s, pad, lr = 2, 2, 256, 57, 1e-4
    vocab, hidden = np_tree["embed"]["weight"].shape
    cfg = BloomConfig(vocab_size=vocab, hidden_size=hidden, n_layer=n_layer,
                      n_head=16, **{"remat": True, "use_flash": True, **opts})
    tree = {**np_tree, "blocks": cut_layers(np_tree["blocks"], n_layer)}
    rng = np.random.default_rng(SEED + 7)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    mask = np.ones((b, s), np.int64)
    mask[1, s - pad:] = 0
    extra = "".join(f", {k}={v!r}" for k, v in opts.items())
    log(f"{label}: float32 train step, card vs CPU: vocab {vocab}, hidden "
        f"{hidden}, 16 heads, depth cut 24 -> {n_layer} layers, batch {b} x {s} (row 1 right-padded by {pad}), "
        f"remat={cfg.remat}, flash, Adam lr {lr}{extra}")
    runs = {}
    for where in ("cpu", dev):
        t0 = time.perf_counter()
        params = params_from_jax(tree, cfg, device=where)
        opt = make_optimizer(params, lr)
        losses = [train_step(params, opt, ids, mask, ids, cfg, device=where).item()]
        grads = params_to_jax(grads_of(params))
        for _ in range(2):
            losses.append(train_step(params, opt, ids, mask, ids, cfg,
                                     device=where).item())
        with torch.no_grad():
            as_t = lambda a: torch.from_numpy(a).to(where)  # noqa: E731
            losses.append(loss_fn(params, as_t(ids), as_t(mask), as_t(ids), cfg).item())
        runs[str(where)] = (losses, grads, params)
        log(f"  {where}: losses {losses} in {time.perf_counter() - t0:.1f} s")
        del opt
    (cpu_losses, cpu_grads, _), (gpu_losses, gpu_grads, gpu_params) = (
        runs["cpu"], runs["cuda"])
    if not all(np.isfinite(gpu_losses)):
        raise AssertionError(f"non-finite card losses {gpu_losses}")
    loss_err = abs(gpu_losses[0] - cpu_losses[0])
    adam_err = max(abs(a - c) for a, c in zip(gpu_losses[1:], cpu_losses[1:]))
    worst = max(((path, leaf_rel_err(g, c)) for path, g, c in
                 zip_leaves(gpu_grads, cpu_grads)), key=lambda x: x[1])
    log(f"  loss err {loss_err} (atol {TRAIN_LOSS_ATOL}); worst gradient "
        f"{worst[0]} rel err {worst[1]} (rtol {TRAIN_GRAD_RTOL}); losses after "
        f"1-3 Adam steps err {adam_err} (atol {TRAIN_ADAM_LOSS_ATOL})")
    if (loss_err > TRAIN_LOSS_ATOL or worst[1] > TRAIN_GRAD_RTOL
            or adam_err > TRAIN_ADAM_LOSS_ATOL):
        raise AssertionError("card and CPU train steps disagree")
    return gpu_params, cfg, (ids, mask)


def cut_layers(blocks, n):
    """The first ``n`` layers of a stacked per-layer numpy subtree."""
    if isinstance(blocks, dict):
        return {k: cut_layers(v, n) for k, v in blocks.items()}
    return blocks[:n]


def zip_leaves(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from zip_leaves(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def leaf_rel_err(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- phase 8 -------------------------------------------------------------------

def phase8_timed_training(np_tree, dev, card) -> dict:
    """bench.py's "flash" variant on the card; returns its run (the flash
    launch counts of its 7 steps under "launches", its peak memory)."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig

    cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16, remat=True, use_flash=True)
    return timed_training(np_tree, dev, card, cfg, "phase 8",
                          "'flash': remat, flash, fused_ce off")


def kernel_counters():
    """Every ported training kernel's launch counter, by name."""
    from pipegoose_tpu_torch.ops import flash_attention as fa
    from pipegoose_tpu_torch.ops import fused_ce as fce

    return {"fwd": fa.flash_fwd, "dq": fa.flash_dq, "dkv": fa.flash_dkv,
            "fused_ce_fwd": fce.fused_ce_fwd, "fused_ce_dh": fce.fused_ce_dh,
            "fused_ce_dw": fce.fused_ce_dw}


def timed_training(np_tree, dev, card, cfg, label, variant) -> dict:
    """Timed bf16 train steps at bench.py's shape (batch 8 x 1024 of
    RandomState(0) ids, labels = ids, no mask, Adam 1e-4, 2 warm-up and 5
    timed steps between CUDA events), every launch counter set to 0 just
    before the steps and read just after; then one profiled step. Fails
    unless the kernels launch as ``cfg`` asks and the losses fall."""
    from pipegoose_tpu_torch.models.weights import param_leaves, params_from_jax
    from pipegoose_tpu_torch.trainer import make_optimizer, train_step

    batch, seq, warm, timed = 8, 1024, 2, 5
    params = params_from_jax(np_tree, cfg, device=dev)
    opt = make_optimizer(params, 1e-4)
    ids = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (batch, seq))).to(dev)
    n_params = sum(t.numel() for t in param_leaves(params))
    log(f"{label}: bloom-560m bf16 train step (bench.py {variant}), batch {batch} "
        f"x {seq}, Adam 1e-4, {n_params} params, {warm} warm-up + {timed} timed "
        f"steps, on {card}")

    def step():
        return train_step(params, opt, ids, None, ids, cfg, device=dev)

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    losses += [step() for _ in range(timed)]
    t1.record()
    torch.cuda.synchronize()
    counts = {name: c.launches for name, c in counters.items()}
    steps = warm + timed
    step_ms = t0.elapsed_time(t1) / timed
    tokens_per_s = batch * seq / (step_ms / 1e3)
    flops_per_token = 6 * n_params + 12 * cfg.n_layer * cfg.hidden_size * seq
    mfu = tokens_per_s * flops_per_token / BF16_FLOPS_PER_S
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [x.item() for x in losses]
    log(f"  step {step_ms} ms, {tokens_per_s} tokens/s, MFU {mfu} (bench.py's "
        f"{flops_per_token} flops/token over 989 TFLOP/s bf16), peak "
        f"{peak_gib:.2f} GiB")
    log(f"  losses over {steps} steps on one batch: {losses}")
    fwd_per_layer = 2 if cfg.remat else 1
    per_step = {"fwd": fwd_per_layer * cfg.n_layer, "dq": cfg.n_layer,
                "dkv": cfg.n_layer}
    per_step.update({k: int(cfg.fused_ce) for k in
                     ("fused_ce_fwd", "fused_ce_dh", "fused_ce_dw")})
    want = {k: steps * n for k, n in per_step.items()}
    log(f"  launches over {steps} steps {counts}; want per step {per_step} "
        f"(flash fwd {fwd_per_layer} x {cfg.n_layer} layers"
        f"{': remat recomputes the forward' if cfg.remat else ''})")
    if counts != want:
        raise AssertionError(f"{label}: the training step bypassed a kernel")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    _, busy_ms, kernels = profile_device(step, 1, "one profiled train step",
                                         "step", top=10)
    fused_ms = sum(e.self_device_time_total for e in kernels
                   if "fused_ce" in e.key) / 1e3
    if cfg.fused_ce:
        log(f"  fused cross-entropy kernels: {fused_ms} ms of the profiled step's "
            f"{busy_ms} ms device time "
            f"({100 * fused_ms / busy_ms if busy_ms else float('nan'):.1f}%)")
    run = {"launches": {k: v for k, v in counts.items() if want[k]},
           "step_ms": step_ms, "peak_gib": peak_gib, "losses": losses}
    del params, opt
    return run


# -- phase 9 -------------------------------------------------------------------

def time_eager_ms(fn, calls):
    """Per-call ms of ``fn()`` called ``calls`` times eagerly between CUDA
    events, after a warm-up call."""
    fn()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def flash_bound_ms(kind, case, tensors, causal=True):
    """Least time for one call: the flops of the visible (q, k) pairs (fwd
    4 hd, dq 6 hd, dkv 8 hd per pair) at 989 TFLOP/s bf16, against every
    input read once and every output written once at 3.35 TB/s."""
    bh, s, hd = case["q"].shape
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[kind] * hd * pairs
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase9_flash_time(dev, card, errs, launches) -> list:
    from pipegoose_tpu_torch.models.bloom import NEG_INF
    from pipegoose_tpu_torch.ops import flash_attention as fa

    b, nh, s, hd = 8, 16, 1024, 64
    case = flash_case(dev, torch.bfloat16, b=b, seed=SEED + 9)
    fwd, mode = flash_args(case)
    out, lse = fa.flash_fwd(*fwd, *mode)
    delta = (case["do"].float() * out.float()).sum(-1)
    bwd = flash_bwd_args(case, lse, delta)
    dq = fa.flash_dq(*bwd, *mode)
    dk, dv = fa.flash_dkv(*bwd, *mode)
    io = {"fwd": fwd + (out, lse), "dq": bwd + (dq,), "dkv": bwd + (dk, dv)}
    calls = {
        "fwd": (lambda i: fa.flash_fwd(*fwd, *mode),
                lambda i: fa.flash_fwd_reference(*fwd, *mode)),
        "dq": (lambda i: fa.flash_dq(*bwd, *mode),
               lambda i: fa.flash_dq_reference(*bwd, *mode)),
        "dkv": (lambda i: fa.flash_dkv(*bwd, *mode),
                lambda i: fa.flash_dkv_reference(*bwd, *mode)),
    }
    # the library yardstick: SDPA on (B, nh, S, hd) bf16 with the ALiBi and
    # causal terms as one additive bias; its backward gives dq, dk and dv
    # in one autograd call, timed eagerly (autograd runs it on a worker
    # thread, outside a CUDA graph capture)
    heads = lambda t: t.reshape(b, nh, s, hd).detach().clone().requires_grad_()  # noqa: E731
    qs, ks, vs = heads(case["q"]), heads(case["k"]), heads(case["v"])
    kpos = torch.arange(s, device=dev, dtype=torch.float32)
    keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    bias = torch.where(keep, case["slopes"][:nh, None, None] * kpos, NEG_INF)
    bias = bias[None].to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    so = sdpa(qs, ks, vs, attn_mask=bias)
    go = case["do"].reshape(b, nh, s, hd)
    with torch.no_grad():
        lib_fwd_ms, _ = time_ms(lambda i: sdpa(qs, ks, vs, attn_mask=bias), 8)
    lib_bwd_ms = time_eager_ms(
        lambda: torch.autograd.grad(so, (qs, ks, vs), go, retain_graph=True), 8)
    log(f"phase 9: flash kernels at phase 8's shape (B*nh={b * nh}, S={s}, "
        f"hd={hd}, bf16, causal, no padding), device ms per call, on {card}")
    rows = []
    for kind in ("fwd", "dq", "dkv"):
        kernel, plain = calls[kind]
        ms, call_ms = time_ms(kernel, 8)
        plain_ms, _ = time_ms(plain, 4)
        bound_ms, bound_by = flash_bound_ms(kind, case, io[kind])
        library_ms = lib_fwd_ms if kind == "fwd" else lib_bwd_ms
        log(f"  flash_{kind}: kernel {ms} (eager {call_ms}), bound {bound_ms} "
            f"({bound_by}), plain {plain_ms}, SDPA {'forward' if kind == 'fwd' else 'backward (dq, dk, dv in one call, eager)'} "
            f"{library_ms}")
        rows.append({
            "name": f"flash_{kind} (bf16, B*nh=128, S=1024, hd=64, causal)",
            "source": FLASH_SOURCE, "replaces": FLASH_REPLACES[kind],
            "route": "cuda", "launches": launches[kind],
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "call_ms": call_ms,
        })
    return rows


# -- phase 10 ------------------------------------------------------------------

def fused_case(dev, dtype, *, t, hd, v, offset=0, valid=None, vh=True, seed=0):
    """Fused CE operands: h (T, H) unit normal (a final LayerNorm's scale),
    w like BLOOM's embedding (normal, std 0.02) in the "vh" (V, H) or "hv"
    (H, V) layout, seeded targets over [0, offset + V), and g = 1/T per
    token (the mean loss's cotangent)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(t, hd, device=dev, generator=gen).to(dtype)
    w = (torch.randn(v, hd, device=dev, generator=gen) * 0.02).to(dtype)
    if not vh:
        w = w.t().contiguous()
    targets = torch.randint(0, offset + v, (t,), device=dev, generator=gen,
                            dtype=torch.int32)
    g = torch.full((t,), 1.0 / t, device=dev)
    return {"h": h, "w": w, "targets": targets, "g": g, "offset": offset,
            "valid": valid, "vh": vh}


def fused_err(got, want, rtol):
    """(max abs error, tolerance) against the largest finite |plain| value
    (entries of -1e9, masked target logits, are left out of the scale)."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"bad kernel output {tuple(got.shape)}")
    finite = want.abs() < 1e8
    scale = want[finite].abs().max().item() if finite.any() else 0.0
    return (got - want).abs().max().item(), rtol * scale


def check_fused(label, case) -> dict:
    """Each fused kernel once against its plain version on one case; every
    launch counter must move by exactly one. Returns each kernel's max abs
    error."""
    from pipegoose_tpu_torch.ops import fused_ce as fce

    dtype = case["h"].dtype
    fwd = (case["h"], case["w"], case["targets"], case["offset"], case["valid"],
           case["vh"])
    counters = (fce.fused_ce_fwd, fce.fused_ce_dh, fce.fused_ce_dw)
    before = tuple(c.launches for c in counters)
    lse, tl = fce.fused_ce_fwd(*fwd)
    ref_lse, ref_tl = fce.fused_ce_fwd_reference(*fwd)
    bwd = (case["h"], case["w"], case["targets"], ref_lse, case["g"],
           case["offset"], case["valid"], case["vh"])
    dh = fce.fused_ce_dh(*bwd)
    dw = fce.fused_ce_dw(*bwd)
    torch.cuda.synchronize()
    moved = tuple(c.launches - b for c, b in zip(counters, before))
    if moved != (1, 1, 1):
        raise AssertionError(f"{label}: launch counters moved by {moved}")
    checks = {"lse": fused_err(lse, ref_lse, FUSED_STAT_RTOL),
              "target logit": fused_err(tl, ref_tl, FUSED_STAT_RTOL)}
    del ref_lse, ref_tl
    checks["dh"] = fused_err(dh, fce.fused_ce_dh_reference(*bwd), FUSED_GRAD_RTOL[dtype])
    checks["dw"] = fused_err(dw, fce.fused_ce_dw_reference(*bwd), FUSED_GRAD_RTOL[dtype])
    bad = [n for n, (err, tol) in checks.items() if err > tol]
    log(f"phase 10: {label}: " + ", ".join(
        f"{n} {err:.3g} (tol {tol:.3g})" for n, (err, tol) in checks.items())
        + (f" FAIL {bad}" if bad else " ok"))
    if bad:
        raise AssertionError(f"{label}: fused kernels disagree with plain on {bad}")
    return {"fwd": max(checks["lse"][0], checks["target logit"][0]),
            "dh": checks["dh"][0], "dw": checks["dw"][0]}


def phase10_fused_vs_plain(dev) -> dict:
    """Returns the max abs errors at bench.py's shape in bf16, the shape
    and dtype of phase 12's calls."""
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for vh in (True, False):
            check_fused(f"{name} T=100 H=1024 V=1000 offset=300 valid=1283 "
                        f"{'vh' if vh else 'hv'}",
                        fused_case(dev, dtype, t=100, hd=1024, v=1000, offset=300,
                                   valid=1283, vh=vh, seed=SEED + 10))
    errs = check_fused("bf16 T=8184 H=1024 V=250880 vh (bench.py's shape)",
                       fused_case(dev, torch.bfloat16, t=8 * 1023, hd=1024,
                                  v=250880, seed=SEED + 11))
    gc.collect()
    torch.cuda.empty_cache()
    return errs


# -- phase 11 ------------------------------------------------------------------

def phase11_train_options_vs_cpu(np_tree, dev) -> None:
    """Phase 7's check with each option of this slice; the fused run's
    kernels must launch, and its loss must equal the full-logits loss of
    the same weights on the card."""
    from pipegoose_tpu_torch.models.bloom import loss_fn

    counters = kernel_counters()
    for opts in (dict(fused_ce=True), dict(ce_chunks=8),
                 dict(remat_policy="dots"), dict(remat_policy="attn")):
        for c in counters.values():
            c.launches = 0
        params, cfg, (ids, mask) = train_vs_cpu(np_tree, dev, "phase 11", **opts)
        counts = {n: c.launches for n, c in counters.items() if "fused" in n}
        if cfg.fused_ce:
            # 3 steps and the last loss: 4 forwards, 3 backwards
            log(f"  fused launches {counts}; want fwd 4, dh 3, dw 3")
            if counts != {"fused_ce_fwd": 4, "fused_ce_dh": 3, "fused_ce_dw": 3}:
                raise AssertionError("the fused train step bypassed its kernels")
            with torch.no_grad():
                as_t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
                fused = loss_fn(params, as_t(ids), as_t(mask), as_t(ids), cfg).item()
                full = loss_fn(params, as_t(ids), as_t(mask), as_t(ids),
                               dataclasses.replace(cfg, fused_ce=False)).item()
            log(f"  card: fused loss {fused}, full-logits loss {full}, err "
                f"{abs(fused - full)} (atol {TRAIN_LOSS_ATOL})")
            if abs(fused - full) > TRAIN_LOSS_ATOL:
                raise AssertionError("fused and full-logits losses disagree")
        elif any(counts.values()):
            raise AssertionError(f"fused kernels launched without fused_ce: {counts}")
        del params
        gc.collect()
        torch.cuda.empty_cache()


# -- phase 12 ------------------------------------------------------------------

def phase12_timed_variants(np_tree, dev, card, flash_peak_gib) -> dict:
    """bench.py's fused and chunked variants, timed as phase 8. Returns the
    runs by variant name."""
    from pipegoose_tpu_torch.models.bloom import BloomConfig

    variants = {
        "flash+fusedce": dict(remat=True, use_flash=True, fused_ce=True),
        "noremat+flash+fusedce": dict(remat=False, use_flash=True, fused_ce=True),
        "flash+ce8": dict(remat=True, use_flash=True, ce_chunks=8),
    }
    runs = {}
    for name, kw in variants.items():
        cfg = BloomConfig.bloom_560m(dtype=torch.bfloat16, **kw)
        runs[name] = timed_training(np_tree, dev, card, cfg, "phase 12",
                                    f"'{name}'")
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.fused_ce and not runs[name]["peak_gib"] < flash_peak_gib:
            raise AssertionError(
                f"{name}: peak {runs[name]['peak_gib']:.2f} GiB is not below the "
                f"full-logits step's {flash_peak_gib:.2f} GiB")
    log("phase 12: " + ", ".join(
        f"{n} {r['step_ms']:.1f} ms / {r['peak_gib']:.2f} GiB" for n, r in runs.items())
        + f" (phase 8 'flash' peak {flash_peak_gib:.2f} GiB)")
    return runs


# -- phase 13 ------------------------------------------------------------------

def fused_bound_ms(kind, case, tensors):
    """Least time for one call: 2 T V H flops for the forward's logits, 4 T
    V H for dh and dw (the logits and the second product) at 989 TFLOP/s
    bf16, against every input read once and every output written once at
    3.35 TB/s."""
    t, hd = case["h"].shape
    v = case["w"].shape[0] if case["vh"] else case["w"].shape[1]
    flops = (2 if kind == "fwd" else 4) * t * v * hd
    nbytes = sum(x.numel() * x.element_size() for x in tensors)
    t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase13_fused_time(dev, card, errs, launches) -> list:
    from pipegoose_tpu_torch.ops import fused_ce as fce

    t, hd, v = 8 * 1023, 1024, 250880
    case = fused_case(dev, torch.bfloat16, t=t, hd=hd, v=v, seed=SEED + 13)
    h, w, targets, g = case["h"], case["w"], case["targets"], case["g"]
    lse, tl = fce.fused_ce_fwd(h, w, targets)
    bwd = (h, w, targets, lse, g)
    dh = fce.fused_ce_dh(*bwd)
    dw = fce.fused_ce_dw(*bwd)
    io = {"fwd": (h, w, targets, lse, tl), "dh": bwd + (dh,), "dw": bwd + (dw,)}
    calls = {
        "fwd": (lambda i: fce.fused_ce_fwd(h, w, targets),
                lambda: fce.fused_ce_fwd_reference(h, w, targets)),
        "dh": (lambda i: fce.fused_ce_dh(*bwd), lambda: fce.fused_ce_dh_reference(*bwd)),
        "dw": (lambda i: fce.fused_ce_dw(*bwd), lambda: fce.fused_ce_dw_reference(*bwd)),
    }
    # the library yardstick, a composite: the full-logits path's PyTorch
    # calls for the same function. fwd: the bf16 cuBLAS logits, logsumexp
    # and a gather; dh and dw: softmax minus one-hot from the saved float32
    # logits, times g, in bf16, then one cuBLAS product each
    rows_t = torch.arange(t, device=dev)
    tg = targets.long()

    def lib_fwd():
        lg = torch.matmul(h, w.t()).float()
        return torch.logsumexp(lg, dim=-1), lg.gather(1, tg[:, None])

    saved = torch.matmul(h, w.t()).float()

    def lib_dl():
        p = torch.softmax(saved, dim=-1)
        p[rows_t, tg] -= 1.0
        return (p * g[:, None]).to(torch.bfloat16)

    library = {"fwd": lib_fwd, "dh": lambda: torch.matmul(lib_dl(), w),
               "dw": lambda: torch.matmul(lib_dl().t(), h)}
    log(f"phase 13: fused CE kernels at phase 12's shape (T={t}, H={hd}, V={v}, "
        f"bf16, vh), device ms per call, on {card}")
    rows = []
    for kind in ("fwd", "dh", "dw"):
        kernel, plain = calls[kind]
        ms, call_ms = time_ms(kernel, 2, replays=5)
        plain_ms = time_eager_ms(plain, 2)
        library_ms = time_eager_ms(library[kind], 2)
        bound_ms, bound_by = fused_bound_ms(kind, case, io[kind])
        log(f"  fused_ce_{kind}: kernel {ms} (eager {call_ms}), bound {bound_ms} "
            f"({bound_by}), plain {plain_ms}, full-logits composite {library_ms}")
        rows.append({
            "name": f"fused_ce_{kind} (bf16, T={t}, H={hd}, V={v}, vh)",
            "source": FUSED_SOURCE, "replaces": FUSED_REPLACES[kind], "route": "cuda",
            "launches": launches[f"fused_ce_{kind}"], "max_abs_err": errs[kind],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "call_ms": call_ms,
        })
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    t_start = time.perf_counter()
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
    gc.collect()
    torch.cuda.empty_cache()
    rows = phase5_kernel_time(dev, card, errs, launches)
    gc.collect()
    torch.cuda.empty_cache()   # the serving state is gone before training
    flash_errs = phase6_flash_vs_plain(dev)
    phase7_train_vs_cpu(np_tree, dev)
    gc.collect()
    torch.cuda.empty_cache()
    flash_run = phase8_timed_training(np_tree, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    rows += phase9_flash_time(dev, card, flash_errs, flash_run["launches"])
    gc.collect()
    torch.cuda.empty_cache()
    fused_errs = phase10_fused_vs_plain(dev)
    phase11_train_options_vs_cpu(np_tree, dev)
    gc.collect()
    torch.cuda.empty_cache()
    fused_runs = phase12_timed_variants(np_tree, dev, card, flash_run["peak_gib"])
    del np_tree
    gc.collect()
    torch.cuda.empty_cache()
    rows += phase13_fused_time(dev, card, fused_errs,
                               fused_runs["flash+fusedce"]["launches"])
    log(f"wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
