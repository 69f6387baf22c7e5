#!/usr/bin/env python3
"""Variant sweep of the port's bf16 fused cross-entropy backward kernels
(B5 d-hidden, B6 d-weight) on one H100.

    python3 scripts/sweep_fused_ce_bwd.py [--parent DIR]     # from the repository root

Builds copies of ``pipegoose_tpu_torch/ops/csrc`` with one design choice of
the tensor-core kernel (``fused_ce_mma.cu``) undone each, one nvcc per
copy, all at once, into ``build/fused_ce_bwd_variants/<variant>/``:

- ``this``: the sources as they are, launched as ``bwd_plan`` says for the
  clusters the card reports it holds at once (a cluster of C = 4 blocks at
  H = 1024, 128 resident rows, 64-row streamed tiles; B5's vocabulary walk
  in 5 splits, so that its 64 row clusters fill the waves of the 30
  resident clusters of an H100 SXM);
- ``one_split``: the same build, B5 in one split (3 waves, the last of 4
  clusters);
- ``c2``: the same build, launched with C = 2 and 64 resident rows (512-wide
  H slices, 32-row tiles; 128 row clusters, one split), the other
  configuration of the plan;
- ``one_m16``: product 2's warps hold one m16 tile (16 rows x 256 columns)
  in place of two (32 x 128);
- ``full_reduce``: every block reads all the cluster's partial logits
  through distributed shared memory (remote loads) and forms dl for every
  row itself, in place of owning a share of the rows, into which the other
  blocks write their partials (remote stores), and sending its dl to every
  block;
- ``expf``: the accurate ``expf`` in place of one ``ex2.approx``;
- ``four_ranks``: the reduction's remote loads four ranks at a time (32
  registers) in place of two (16);
- ``stage_unrolled``: the staging of a whole streamed tile as an unrolled
  loop, in place of rolled;
- ``warps16``: 16 warps a block (64 accumulator registers a thread) in
  place of 8 (128);
- ``no_reduce``, ``no_product1``, ``no_product2``, ``no_staging``,
  ``loads_local``, ``stores_local``: timing only, their outputs wrong by
  construction: the cluster's reduction to dl, the partial logits'
  product, the second product or the staging of the streamed tiles left
  out, or the reduction's remote loads (of the other blocks' partials) or
  remote stores (of dl into the other blocks) sent to this block's own
  shared memory, each barrier kept, to bound what each phase costs;
- ``parent`` (with ``--parent DIR``, a checkout of the parent revision):
  its ``fused_ce.cu``, the WMMA kernel, for bf16.

Prints ptxas's registers and spills of each tensor-core instantiation and
how many clusters of each configuration the card holds at once, then times
B5 and B6 at bench.py's shape (T = 8 x 1023, H = 1024, V = 250880, bf16),
with the (V, H) and the (H, V) weight, every variant on the
same inputs, in turns (the variants in order, then in reverse), device ms
per call from CUDA-graph replays; each variant's outputs are held against
the plain versions (error as a fraction of 1e-5 + 2^-6 of the largest
plain value, the bound chip_smoke.py holds them to). With ``--parent`` it
also checks that the float32 dh and dw (the split-TF32 WMMA kernel,
which this revision leaves as it was) equal the parent's bit for bit, at T
= 2048, H = 1024, V = 32768 in both layouts. Needs a card and nvcc; exits
non-zero without them.
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

SOURCE = "fused_ce_mma"
# variant -> [(text, replacement)] in fused_ce_mma.cu, each text found once
PATCHES = {
    "this": [],
    "one_m16": [("constexpr int kCeWarpRows = 32;", "constexpr int kCeWarpRows = 16;")],
    "full_reduce": [
        ("  const int share = BM / cluster;   // rows whose dl each block forms",
         "  const int share = BM;"),
        ("  const int row0 = rank * share;", "  const int row0 = 0;"),
        ("      for (int q = 0; q < cluster; ++q) st_cluster_u4(cluster_addr(dst, q), pk);",
         "      *reinterpret_cast<uint4*>(dst) = pk;")],
    "expf": [("  return g * (exp_approx(z) - (col == tgt ? 1.f : 0.f));",
              "  return g * (expf(z) - (col == tgt ? 1.f : 0.f));")],
    "four_ranks": [("constexpr int kRanksInFlight = 2;", "constexpr int kRanksInFlight = 4;")],
    "stage_unrolled": [("#pragma unroll 1\n  for (int k = 0; k < kN / kThreads; ++k) {",
                        "#pragma unroll\n  for (int k = 0; k < kN / kThreads; ++k) {")],
    "warps16": [("constexpr int kCeWarps128 = 8;", "constexpr int kCeWarps128 = 16;")],
    "no_reduce": [("    reduce(i, j, dlb + (j & 1) * S::kDlBytes);\n", "")],
    "no_product1": [("    for (int kk = 0; kk < W / 16; ++kk) k_step(kk);",
                     "    for (int kk = 0; kk < 0; ++kk) k_step(kk);")],
    "no_product2": [("    for (int kk = 0; kk < BN / 16; ++kk) {",
                     "    for (int kk = 0; kk < 0; ++kk) {")],
    "no_staging": [("    if (j + 1 < nloc) stage_s(i + 1, j + 1);\n", "")],
    "loads_local": [("        const uint32_t a = cluster_addr(src, q0 + q);",
                     "        const uint32_t a = cluster_addr(src, rank);")],
    "stores_local": [
        ("      for (int q = 0; q < cluster; ++q) st_cluster_u4(cluster_addr(dst, q), pk);",
         "      st_cluster_u4(cluster_addr(dst, rank), pk);")],
}
TIMING_ONLY = ("no_reduce", "no_product1", "no_product2", "no_staging", "loads_local",
               "stores_local")
# variant -> (build, bm, cluster, dh splits); None: as the plan says
CALLS = {"one_split": ("this", None, None, 1), "c2": ("this", 64, 2, 1)}
SHAPE = (8 * 1023, 1024, 250880)  # T, H, V
F32_SHAPE = (2048, 1024, 32768)
BF16_RTOL = 2.0 ** -6


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
            elif "fused_ce_bwd_mma_kernel" in fn and (
                    "registers" in line or "spill stores" in line):
                args = fn.split("fused_ce_bwd_mma_kernel")[-1]
                print(f"  {name} fused_ce_bwd_mma_kernel{args}: {line.split(':')[-1].strip()}",
                      flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib, name, n_int, n_ptr=6):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
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
    0.02, seeded targets, g = 1/T; lse from the plain forward."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(t, hd, device=dev, generator=gen).to(dtype)
    w = (torch.randn(v, hd, device=dev, generator=gen) * 0.02).to(dtype)
    if not vh:
        w = w.t().contiguous()
    targets = torch.randint(0, v, (t,), device=dev, generator=gen, dtype=torch.int32)
    g = torch.full((t,), 1.0 / t, device=dev)
    lse, _ = fce.fused_ce_fwd_reference(h, w, targets, 0, None, vh)
    return h, w, targets, lse, g


def frac(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / (1e-5 + BF16_RTOL * want.abs().max())).item()


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="a checkout of the parent revision")
    ap.add_argument("--out", default=str(ROOT / "build" / "fused_ce_bwd_variants"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_fused_ce_bwd: no CUDA card visible to torch")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build(args.parent, Path(args.out))
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    t, hd, v = SHAPE
    resident = libs["this"].fused_ce_mma_resident_clusters
    resident.argtypes, resident.restype = [ctypes.c_int] * 4, ctypes.c_int
    print("clusters of the dh kernel the card holds at once, (BM, C): " + ", ".join(
        f"({bm}, {c}) {resident(0, 1, bm, c)}" for bm, c in
        ((128, 1), (128, 2), (128, 4), (128, 8), (64, 2), (64, 4), (64, 8))), flush=True)

    for vh in (True, False):
        layout = "vh" if vh else "hv"
        ops = inputs(dev, torch.bfloat16, t, hd, v, vh, seed=13)
        ptrs = [x.data_ptr() for x in ops]
        ints = (t, hd, v, 0, fce.NO_VALID, int(vh))
        calls = {"dh": {}, "dw": {}}
        outs = {}
        variants = [(n, n, None, None, None) for n in PATCHES] + [
            (n, *c) for n, c in CALLS.items()]
        for name, lib_name, bm, cluster, splits in variants:
            for kind, like in (("dh", ops[0]), ("dw", ops[1])):
                plan = fce.bwd_plan(torch.bfloat16, t, hd, v, kind,
                                    lambda bm, c: resident(0, int(vh), bm, c))
                b = bm or plan["bm"]
                c = cluster or plan["cluster"]
                sp = (splits or plan["splits"]) if kind == "dh" else 1
                ws = torch.empty((sp, t, hd), dtype=torch.float32, device=dev) if sp > 1 else None
                fn = entry(libs[lib_name], f"fused_ce_{kind}_mma", 9, n_ptr=7)
                out = outs[name, kind] = torch.empty_like(like)
                calls[kind][name] = (lambda fn=fn, out=out, ws=ws, b=b, c=c, sp=sp: fn(
                    *ptrs, out.data_ptr(), 0 if ws is None else ws.data_ptr(), *ints, b, c, sp,
                    stream()))
        if "parent" in libs:
            for kind, like in (("dh", ops[0]), ("dw", ops[1])):
                fn = entry(libs["parent"], f"fused_ce_{kind}_bf16", 6)
                out = outs["parent", kind] = torch.empty_like(like)
                calls[kind]["parent"] = (lambda fn=fn, out=out: fn(
                    *ptrs, out.data_ptr(), *ints, stream()))
        for kind, ref in (("dh", fce.fused_ce_dh_reference), ("dw", fce.fused_ce_dw_reference)):
            for name, call in calls[kind].items():
                err = call()
                if err:
                    raise RuntimeError(f"{name} {kind}: cudaError {err}")
            torch.cuda.synchronize()
            want = ref(*ops, 0, None, vh)
            print(f"B{5 if kind == 'dh' else 6} ({layout}) error vs plain, fraction of the bound: "
                  + ", ".join(f"{n} {frac(outs[n, kind], want):.3f}" for n in calls[kind]
                              if n not in TIMING_ONLY), flush=True)
            same = [n for n in calls[kind] if n != "this" and n in PATCHES
                    and n not in TIMING_ONLY and torch.equal(outs[n, kind], outs["this", kind])]
            print(f"  equal to 'this' bit for bit: {same}", flush=True)
            del want
            torch.cuda.empty_cache()
        for kind in ("dh", "dw"):
            order = list(calls[kind])
            ms = {n: [] for n in order}
            for n in order + order[::-1]:
                ms[n].append(graph_ms(calls[kind][n], 2, 3))
            for n in order:
                print(f"B{5 if kind == 'dh' else 6} (T={t}, H={hd}, V={v}, bf16, {layout}) {n}: "
                      f"device ms per call {ms[n]} [{card}]", flush=True)
        del ops, calls, outs
        torch.cuda.empty_cache()

    if "parent" not in libs:
        return 0
    t, hd, v = F32_SHAPE
    for vh in (True, False):
        ops = inputs(dev, torch.float32, t, hd, v, vh, seed=14)
        ptrs = [x.data_ptr() for x in ops]
        same = []
        for kind, like in (("dh", ops[0]), ("dw", ops[1])):
            got = []
            for name in ("this_wmma", "parent"):
                out = torch.empty_like(like)
                err = entry(libs[name], f"fused_ce_{kind}_f32", 6)(
                    *ptrs, out.data_ptr(), t, hd, v, 0, fce.NO_VALID, int(vh), stream())
                if err:
                    raise RuntimeError(f"{name} float32 {kind}: cudaError {err}")
                got.append(out)
            torch.cuda.synchronize()
            same.append(torch.equal(*got))
        print(f"float32 dh, dw (T={t}, H={hd}, V={v}, {'vh' if vh else 'hv'}) equal to the "
              f"parent's bit for bit: {same}", flush=True)
        if not all(same):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
