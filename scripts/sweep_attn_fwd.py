#!/usr/bin/env python3
"""Variant sweep of the port's bf16 attention forwards on one H100.

    python3 scripts/sweep_attn_fwd.py [--parent DIR]     # from the repository root

Builds copies of ``pipegoose_tpu_torch/ops/csrc`` with one design choice of
the tensor-core forward main loop (``attn_mma.cuh`` ``fwd_mma_walk``)
undone each, one nvcc per source, all at once, into
``build/attn_fwd_variants/<variant>/``:

- ``this``: the sources as they are;
- ``expf``: exp as the accurate ``expf`` in place of one ``ex2.approx``;
- ``resident_q``: the warp's Q fragments loaded once into registers in
  place of an ldmatrix from the staged Q tile at each k step;
- ``no_tile_test``: B7 tests every element's position, also on tiles that
  lie wholly before every query of the block;
- ``3_blocks``: ``__launch_bounds__`` for 3 blocks an SM in place of 4 at
  hd <= 64 (more registers a thread);
- ``parent`` (with ``--parent DIR``, a checkout of the parent revision):
  its sources unchanged.

Prints ptxas's registers and spills of each forward kernel, then times the
flash forward B1 at the training shape (B*nh = 128, S = 1024, hd = 64,
causal, BLOOM's ALiBi) and the ring-chunk forward B7 at the SP shape (B*nh
= 16, S = 8192, the diagonal chunk, zero state), every variant on the same
inputs, in turns (the variants in order, then in reverse), device ms per
call from CUDA-graph replays; each variant's outputs are checked against
the plain versions (error as a fraction of the bound chip_smoke.py holds
them to). Needs a card and nvcc; exits non-zero without them.
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
from pipegoose_tpu_torch.ops import flash_attention as fa  # noqa: E402

SOURCES = ("flash_attention", "flash_chunk")
# variant -> [(file, text, replacement)], each text found exactly once
PATCHES = {
    "this": [],
    "expf": [("attn_mma.cuh",
              '  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));',
              "  y = expf(x);")],
    "resident_q": [
        ("attn_mma.cuh", "  for (int slot = 0; cur < n_kt; slot ^= 1) {",
         "  uint32_t aq[KS][4];\n  for (int slot = 0, it = 0; cur < n_kt; slot ^= 1, ++it) {"),
        ("attn_mma.cuh", "    const float* KN = KP + kMmaTile;\n    float s[8][4];",
         "    const float* KN = KP + kMmaTile;\n    if (it == 0)\n"
         "      for (int kk = 0; kk < KS; ++kk) load_a<HD>(aq[kk], Qs, warp, kk, lane);\n"
         "    float s[8][4];"),
        ("attn_mma.cuh", "      uint32_t a[4];\n      load_a<HD>(a, Qs, warp, kk, lane);",
         "      const uint32_t (&a)[4] = aq[kk];"),
    ],
    "no_tile_test": [("flash_chunk.cu", "    return x > q_min;", "    return true;")],
    "3_blocks": [("attn_mma.cuh", "  static constexpr int kMinBlocks = HD <= 64 ? 4 : 2;\n};",
                  "  static constexpr int kMinBlocks = HD <= 64 ? 3 : 2;\n};")],
}
B1_SHAPE = (128, 1024, 64)   # B*nh, S, hd
B7_SHAPE = (16, 8192, 64)


def build(variants: dict, out: Path) -> dict:
    """Copy, patch and compile every variant; returns {variant: {source: CDLL}}."""
    procs = {}
    for name, src in variants.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        for file, old, new in PATCHES.get(name, []):
            text = (d / file).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: patch text not found once in {file}: {old!r}")
            (d / file).write_text(text.replace(old, new))
        for n in SOURCES:
            procs[name, n] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{n}.so"), str(d / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {name: {} for name in variants}
    for (name, n), proc in procs.items():
        log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{n}.cu:\n{log}")
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1]
            elif "fwd" in fn and "ILi64E" in fn and ("registers" in line or "spill stores" in line):
                kernel = fn[fn.index("fwd") - 6:].split("ILi64E")[0].split("_cu_")[-1]
                print(f"  {name} {n} {kernel}<64>: {line.split(':')[-1].strip()}", flush=True)
        libs[name][n] = ctypes.CDLL(str(out / name / f"{n}.so"))
    return libs


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


def entry(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float,
                                                                         ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def frac(got, want, rtol):
    """max |got - want| as a fraction of 1e-5 + rtol * max |want|."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / (1e-5 + rtol * want.abs().max())).item()


def turns(calls: dict, n_calls: int, replays: int) -> dict:
    order = list(calls)
    ms = {n: [] for n in order}
    for n in order + order[::-1]:
        ms[n].append(graph_ms(calls[n], n_calls, replays))
    return ms


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="a checkout of the parent revision")
    ap.add_argument("--out", default=str(ROOT / "build" / "attn_fwd_variants"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_attn_fwd: no CUDA card visible to torch")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    variants = {name: _build.SRC_DIR for name in PATCHES}
    if args.parent:
        variants["parent"] = Path(args.parent) / _build.SRC_DIR.relative_to(ROOT)
    libs = build(variants, Path(args.out))
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(0)

    bh, s, hd = B1_SHAPE
    q, k, v = (torch.randn(bh, s, hd, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    slopes = torch.tensor([2.0 ** -(8 * (h % 16 + 1) / 16) for h in range(bh)], device=dev)
    kpos, kneg = (t.to(dev).contiguous() for t in fa.mask_to_kv_bias(torch.ones(bh, s)))
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, slopes, kpos, kneg, hd ** -0.5, True)
    calls = {}
    for name, lib in libs.items():
        fn = entry(lib["flash_attention"], "flash_fwd_bf16", 8, 6)
        out, lse = torch.empty_like(q), torch.empty(bh, s, device=dev)
        calls[name] = (lambda fn=fn, out=out, lse=lse: fn(
            *(t.data_ptr() for t in (q, k, v, slopes, kpos, kneg, out, lse)), bh, s, hd, 1, 1, 0,
            hd ** -0.5, stream()))
        calls[name]()
        torch.cuda.synchronize()
        print(f"B1 {name}: out {frac(out, ref_out, 2 ** -7):.3f}, lse "
              f"{frac(lse, ref_lse, 2 ** -21):.3f} of their bounds", flush=True)
    del ref_out, ref_lse
    for name, ms in turns(calls, 20, 10).items():
        print(f"B1 (B*nh={bh}, S={s}, hd={hd}) {name}: device ms per call {ms} [{card}]",
              flush=True)

    bh, s, hd = B7_SHAPE
    q, k, v = (torch.randn(bh, s, hd, device=dev, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    slopes = torch.tensor([2.0 ** -(8 * (h + 1) / 16) for h in range(bh)], device=dev)
    pos = torch.arange(s, device=dev).float()[None].expand(bh, s).contiguous()
    kneg = torch.zeros(bh, s, device=dev)
    state = (torch.full((bh, s), -1e9, device=dev), torch.zeros(bh, s, device=dev),
             torch.zeros(bh, s, hd, device=dev))
    want = fa.flash_ring_chunk_reference(q, k, v, slopes, pos, pos, kneg, *state, hd ** -0.5)
    calls = {}
    for name, lib in libs.items():
        fn = entry(lib["flash_chunk"], "flash_chunk_fwd_bf16", 13, 5)
        got = tuple(torch.empty_like(t) for t in state)
        calls[name] = (lambda fn=fn, got=got: fn(
            *(t.data_ptr() for t in (q, k, v, slopes, pos, pos, kneg, *state, *got)), bh, s, s,
            hd, 1, hd ** -0.5, stream()))
        calls[name]()
        torch.cuda.synchronize()
        print(f"B7 {name}: m {frac(got[0], want[0], 2 ** -21):.3f}, l "
              f"{frac(got[1], want[1], 2e-4):.3f}, acc {frac(got[2], want[2], 2 ** -7):.3f} "
              f"of their bounds", flush=True)
    del want
    for name, ms in turns(calls, 4, 5).items():
        print(f"B7 (B*nh={bh}, S={s}, hd={hd}, diagonal chunk) {name}: device ms per call "
              f"{ms} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
