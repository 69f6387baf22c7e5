#!/usr/bin/env python3
"""Variant sweep of the port's bf16 fused cross-entropy forward kernel (B4)
on one H100.

    python3 scripts/sweep_fused_ce_fwd.py [--parent DIR]     # from the repository root

Builds copies of ``pipegoose_tpu_torch/ops/csrc`` with one design choice of
the TMA-fed warpgroup-MMA kernel (``fused_ce_fwd_wgmma.cu``) undone each,
one nvcc per copy, all at once, into
``build/fused_ce_fwd_variants/<variant>/``:

- ``this``: the sources as they are, launched as ``fwd_plan`` says (BN =
  256 at H = 1024, a 4-deep ring of 48 KB stages, 33 splits at T = 8184);
- ``no_pingpong``: the two consumers' epilogues without the named barriers
  that make them take turns;
- ``stages3``: a 3-deep ring (a 5-deep one does not fit: 5 x 48 KB is more
  than the 227 KB a block may use);
- ``bn128``: the same build launched with 128-column vocab tiles (64
  accumulator registers a consumer, 32 KB stages);
- ``bn128_stages6``: 128-column tiles and a 6-deep ring of 32 KB stages;
- ``regs_24_240``: the producer at 24 registers, the consumers at 240, in
  place of 40 and 232;
- ``ffma_exp``: the softmax's exponent as one FFMA, ``x log2(e) - m
  log2(e)``, in place of a subtraction and a multiplication (one
  instruction fewer a value; not exact where a whole row is masked, so
  not the kernel's);
- ``no_softmax``, ``no_products``, ``no_exp``: timing only, their outputs
  wrong by construction: the epilogue's softmax left out, every wgmma left
  out (the loads, barriers and epilogue kept), or the softmax's ex2.approx
  replaced by its argument (its other instructions kept), to bound what
  each costs;
- ``parent`` (with ``--parent DIR``, a checkout of the parent revision):
  its ``fused_ce.cu``, the WMMA kernel, for bf16.

Prints ptxas's registers and spills of each variant's forward kernels, then
times B4 at bench.py's shape (T = 8 x 1023, H = 1024, V = 250880, bf16),
with the (V, H) and the (H, V) weight, every variant on the same inputs, in
turns (the variants in order, then in reverse), device ms per call from
CUDA-graph replays; each variant's lse and target logit are held against
the plain version (error as a fraction of 1e-5 + 2^-18 of the largest plain
value, the bound chip_smoke.py holds them to) and against ``this`` bit for
bit. With ``--parent`` it also checks that the float32 forward (the
split-TF32 WMMA kernel of fused_ce.cu, which this revision leaves as it
was) equals the parent's bit for bit, at T = 2048, H = 1024, V = 32768 in
both layouts. Needs a card and nvcc; exits non-zero without them.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pipegoose_tpu_torch.ops import _build  # noqa: E402
from pipegoose_tpu_torch.ops import fused_ce as fce  # noqa: E402

SOURCE = "fused_ce_fwd_wgmma"
# variant -> [(text, replacement)] in fused_ce_fwd_wgmma.cu, each text found once
PATCHES = {
    "this": [],
    "no_pingpong": [
        ("      if (c == 1 || tile > tile0) bar_sync(kTurn + c, 256);\n", ""),
        ("      if (c == 0 || tile + 1 < tile_end) bar_arrive(kTurn + 1 - c, 256);\n", "")],
    "stages3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "bn128_stages6": [("constexpr int kStages = 4;", "constexpr int kStages = 6;")],
    "regs_24_240": [("constexpr int kProducerRegs = 40;", "constexpr int kProducerRegs = 24;"),
                    ("constexpr int kConsumerRegs = 232;", "constexpr int kConsumerRegs = 240;")],
    "ffma_exp": [
        ("      if ((i / 2) % 2 == j) s += exp2_approx((acc[i] - mn) * kLog2e);",
         "      if ((i / 2) % 2 == j) s += exp2_approx(fmaf(acc[i], kLog2e, -mn * kLog2e));")],
    "no_softmax": [
        ("      tile_softmax(acc, q2, v - v0, valid - offset - v0, tc, m, l, ts);\n", "")],
    "no_exp": [
        ("      if ((i / 2) % 2 == j) s += exp2_approx((acc[i] - mn) * kLog2e);",
         "      if ((i / 2) % 2 == j) s += (acc[i] - mn) * kLog2e;")],
    "no_products": [
        ("        wgmma_m64n256k16<kHV>(acc, a, b, scale_d);",
         "        acc[ks] += (float)((a ^ b) & 1) + scale_d;"),
        ("        wgmma_m64n128k16<kHV>(acc, a, b, scale_d);",
         "        acc[ks] += (float)((a ^ b) & 1) + scale_d;")],
}
TIMING_ONLY = ("no_softmax", "no_products", "no_exp")
# variant -> (build, bn); None: as the plan says
CALLS = {"bn128": ("this", 128), "bn128_stages6": ("bn128_stages6", 128)}
SHAPE = (8 * 1023, 1024, 250880)  # T, H, V
F32_SHAPE = (2048, 1024, 32768)
RTOL = 2.0 ** -18


def nvcc(src: Path, out: Path):
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build(parent, out: Path) -> dict:
    """Copy, patch and compile every variant (and the parent's fused_ce.cu
    and this tree's, for the float32 check); returns {variant: CDLL}."""
    procs = {}
    for name, patches in PATCHES.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.SRC_DIR, d)
        text = (d / f"{SOURCE}.cu").read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: patch text not found once: {old!r}")
            text = text.replace(old, new)
        (d / f"{SOURCE}.cu").write_text(text)
        procs[name] = (nvcc(d / f"{SOURCE}.cu", d / f"{SOURCE}.so"), d / f"{SOURCE}.so")
    if parent:
        d = out / "parent"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(Path(parent) / _build.SRC_DIR.relative_to(ROOT), d)
        procs["parent"] = (nvcc(d / "fused_ce.cu", d / "fused_ce.so"), d / "fused_ce.so")
        procs["this_wmma"] = (nvcc(out / "this" / "fused_ce.cu", out / "this" / "fused_ce.so"),
                              out / "this" / "fused_ce.so")
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "fused_ce_fwd_wgmma_kernel" in fn and (
                    "registers" in line or "spill stores" in line):
                args = fn.split("fused_ce_fwd_wgmma_kernel")[-1][:16]
                print(f"  {name} fused_ce_fwd_wgmma_kernel{args}: {line.split(':')[-1].strip()}",
                      flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib, name, n_int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def graph_ms(fn, calls, replays):
    """Device ms per call of ``calls`` calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (calls * replays)


def inputs(dev, dtype, t, hd, v, vh, seed):
    """chip_smoke.py's fused-CE operands: h unit normal, w normal with std
    0.02, seeded targets."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(t, hd, device=dev, generator=gen).to(dtype)
    w = (torch.randn(v, hd, device=dev, generator=gen) * 0.02).to(dtype)
    if not vh:
        w = w.t().contiguous()
    targets = torch.randint(0, v, (t,), device=dev, generator=gen, dtype=torch.int32)
    return h, w, targets


def frac(got, want):
    scale = want.abs().max().item()
    return ((got - want).abs().max() / (1e-5 + RTOL * scale)).item()


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="a checkout of the parent revision")
    ap.add_argument("--out", default=str(ROOT / "build" / "fused_ce_fwd_variants"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_fused_ce_fwd: no CUDA card visible to torch")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build(args.parent, Path(args.out))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    t, hd, v = SHAPE
    for vh in (True, False):
        layout = "vh" if vh else "hv"
        h, w, targets = inputs(dev, torch.bfloat16, t, hd, v, vh, seed=13)
        calls, outs = {}, {}
        variants = [(n, n, None) for n in PATCHES if n not in CALLS] + [
            (n, *c) for n, c in CALLS.items()]
        for name, lib_name, bn in variants:
            plan = fce.fwd_plan(torch.bfloat16, t, hd, v, vh, sms=sms)
            bn = bn or plan["bn"]
            splits = max(1, min(-(-v // bn), -(-fce.FWD_WAVES * sms // -(-t // fce.FWD_BM))))
            part = torch.empty((3, splits, t), device=dev)
            out = outs[name] = torch.empty((2, t), device=dev)
            fn = entry(libs[lib_name], "fused_ce_fwd_wgmma", 8)
            ptrs = (h.data_ptr(), w.data_ptr(), targets.data_ptr(), part.data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr())
            calls[name] = (lambda fn=fn, ptrs=ptrs, bn=bn, sp=splits, part=part: fn(
                *ptrs, t, hd, v, 0, fce.NO_VALID, int(vh), sp, bn, stream()))
            print(f"  {name} ({layout}): BN {bn}, {splits} splits", flush=True)
        if "parent" in libs:
            splits = fce.fwd_plan(torch.float32, t, hd, v, vh)["splits"]
            part = torch.empty((3, splits, t), device=dev)
            out = outs["parent"] = torch.empty((2, t), device=dev)
            fn = entry(libs["parent"], "fused_ce_fwd_bf16", 7)
            ptrs = (h.data_ptr(), w.data_ptr(), targets.data_ptr(), part.data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr())
            calls["parent"] = (lambda fn=fn, ptrs=ptrs, sp=splits, part=part: fn(
                *ptrs, t, hd, v, 0, fce.NO_VALID, int(vh), sp, stream()))
        for name, call in calls.items():
            err = call()
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
        torch.cuda.synchronize()
        want = fce.fused_ce_fwd_reference(h, w, targets, 0, None, vh)
        print(f"B4 ({layout}) error vs plain, fraction of the bound (lse, target logit): "
              + ", ".join(f"{n} {frac(outs[n][0], want[0]):.3f} / {frac(outs[n][1], want[1]):.3f}"
                          for n in calls if n not in TIMING_ONLY), flush=True)
        same = [n for n in calls if n != "this" and n not in TIMING_ONLY and n != "parent"
                and torch.equal(outs[n], outs["this"])]
        print(f"  equal to 'this' bit for bit: {same}", flush=True)
        del want
        torch.cuda.empty_cache()
        order = list(calls)
        ms = {n: [] for n in order}
        for n in order + order[::-1]:
            ms[n].append(graph_ms(calls[n], 2, 3))
        for n in order:
            print(f"B4 (T={t}, H={hd}, V={v}, bf16, {layout}) {n}: device ms per call {ms[n]}, "
                  f"{2 * t * v * hd / (min(ms[n]) * 1e9):.1f} TFLOP/s [{card}]", flush=True)
        del h, w, targets, calls, outs
        torch.cuda.empty_cache()

    if "parent" not in libs:
        return 0
    t, hd, v = F32_SHAPE
    for vh in (True, False):
        h, w, targets = inputs(dev, torch.float32, t, hd, v, vh, seed=14)
        splits = fce.fwd_plan(torch.float32, t, hd, v, vh)["splits"]
        got = []
        for name in ("this_wmma", "parent"):
            part = torch.empty((3, splits, t), device=dev)
            out = torch.empty((2, t), device=dev)
            err = entry(libs[name], "fused_ce_fwd_f32", 7)(
                h.data_ptr(), w.data_ptr(), targets.data_ptr(), part.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), t, hd, v, 0, fce.NO_VALID, int(vh),
                splits, stream())
            if err:
                raise RuntimeError(f"{name} float32 forward: cudaError {err}")
            got.append(out)
        torch.cuda.synchronize()
        same = torch.equal(*got)
        print(f"float32 forward (T={t}, H={hd}, V={v}, {'vh' if vh else 'hv'}) equal to the "
              f"parent's bit for bit: {same}", flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
