#!/usr/bin/env python3
"""Variant sweep of the port's bf16 attention backward kernels on one H100.

    python3 scripts/sweep_attn_bwd.py [--parent DIR]     # from the repository root

Builds copies of ``pipegoose_tpu_torch/ops/csrc`` with one design choice of
the tensor-core backward main loops (``attn_mma.cuh`` ``dq_mma_walk``,
``dkv_mma_walk``) or of the flash backward's policy undone each, one nvcc
per source, all at once, into ``build/attn_bwd_variants/<variant>/``:

- ``this``: the sources as they are;
- ``expf``: the flash backward's P as the accurate ``expf`` in place of one
  ``ex2.approx``;
- ``every_element_tested``: B2/B3 test the causal and window masks on every
  element, also on tiles that no mask cuts;
- ``dq_two_copies``: dQ's per-element loop copied for a tested and an
  untested tile, in place of one loop that reads the tile's flag;
- ``dkv_branch_in_pass``: dK/dV's choice between a tested and an untested
  tile made inside the rolled pass loop, in place of one copy of the pass
  loop for each;
- ``parent`` (with ``--parent DIR``, a checkout of the parent revision):
  its sources unchanged.

Prints ptxas's registers and spills of each backward kernel at hd = 64,
then times the flash dQ (B2) and dK/dV (B3) at the training shape (B*nh =
128, S = 1024, hd = 64, causal, BLOOM's ALiBi) and at one 8192-token
sequence (B*nh = 16), every variant on the same inputs, in turns (the
variants in order, then in reverse), device ms per call from CUDA-graph
replays; each variant's outputs at the training shape are checked against
the plain versions (error as a fraction of the bound chip_smoke.py holds
them to). Then the ring-chunk dQ (B8) and dK/dV (B9) at the SP shape (B*nh
= 16, S = 8192, the diagonal chunk), this revision's against the parent's
in turns, with whether their outputs are equal bit for bit. Needs a card
and nvcc; exits non-zero without them.
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
    "expf": [("flash_attention.cu",
              "  __device__ static float prob(float x) { return exp_approx(x); }",
              "  __device__ static float prob(float x) { return expf(x); }")],
    "every_element_tested": [
        ("flash_attention.cu",
         "  __device__ bool tested(int q0, int k0) const { return straddles(q0, k0, causal, window); }",
         "  __device__ bool tested(int q0, int k0) const { return true; }")],
    "dq_two_copies": [
        ("attn_mma.cuh", "    const bool test = pol.tested(q0, k0);\n",
         "    auto to_ds = [&](bool test) {\n"),
        ("attn_mma.cuh", "        s[n][e] = p * (dp[n][e] - dl_r[h]);\n      }\n",
         "        s[n][e] = p * (dp[n][e] - dl_r[h]);\n      }\n    };\n"
         "    if (pol.tested(q0, k0))\n      to_ds(true);\n    else\n"
         "      to_ds(false);\n")],
    "dkv_branch_in_pass": [
        ("attn_mma.cuh", "    auto passes = [&](bool test) {\n",
         "    const bool tested = pol.tested(q0, k0);\n    auto passes = [&](bool) {\n"),
        ("attn_mma.cuh",
         "#pragma unroll\n        for (int n = 0; n < 2; ++n)\n#pragma unroll\n"
         "          for (int e = 0; e < 4; ++e) {   // st <- P^T",
         "        auto to_p_ds = [&](bool test) {\n#pragma unroll\n        for (int n = 0; n < 2; ++n)"
         "\n#pragma unroll\n          for (int e = 0; e < 4; ++e) {   // st <- P^T"),
        ("attn_mma.cuh", "            dpt[n][e] = p * (dpt[n][e] - DL[i]);\n          }\n",
         "            dpt[n][e] = p * (dpt[n][e] - DL[i]);\n          }\n        };\n"
         "        if (tested)\n          to_p_ds(true);\n        else\n          to_p_ds(false);\n"),
        ("attn_mma.cuh", "    if (pol.tested(q0, k0))\n      passes(true);\n"
         "    else\n      passes(false);\n", "    passes(true);\n")],
}
FLASH_SHAPES = ((128, 1024, 64), (16, 8192, 64))   # B*nh, S, hd
CHUNK_SHAPE = (16, 8192, 64)


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
            elif ("dq_" in fn or "dkv_" in fn) and "ILi64E" in fn and (
                    "registers" in line or "spill stores" in line):
                kernel = fn.split("ILi64E")[0].split("_cu_")[-1].lstrip("0123456789abcdef")
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


def flash_inputs(dev, gen, bh, s, hd):
    """bf16 q, k, v, dO with BLOOM's ALiBi, the plain forward's lse and
    delta = rowsum(dO * out): the backward's operands, causal."""
    q, k, v, do = (torch.randn(bh, s, hd, device=dev, generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    slopes = torch.tensor([2.0 ** -(8 * (h % 16 + 1) / 16) for h in range(bh)], device=dev)
    kpos, kneg = (t.to(dev).contiguous() for t in fa.mask_to_kv_bias(torch.ones(bh, s)))
    out, lse = fa.flash_fwd(q, k, v, slopes, kpos, kneg, hd ** -0.5, True)
    delta = (do.float() * out.float()).sum(-1)
    return (q, k, v, do, lse, delta, slopes, kpos, kneg)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="a checkout of the parent revision")
    ap.add_argument("--out", default=str(ROOT / "build" / "attn_bwd_variants"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_attn_bwd: no CUDA card visible to torch")
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

    for bh, s, hd in FLASH_SHAPES:
        ops = flash_inputs(dev, gen, bh, s, hd)
        ptrs = [t.data_ptr() for t in ops]
        check = s <= 1024
        if check:
            ref_dq = fa.flash_dq_reference(*ops, hd ** -0.5, True)
            ref_dk, ref_dv = fa.flash_dkv_reference(*ops, hd ** -0.5, True)
        calls = {"dq": {}, "dkv": {}}
        for name, lib in libs.items():
            dq_fn = entry(lib["flash_attention"], "flash_dq_bf16", 10, 6)
            dkv_fn = entry(lib["flash_attention"], "flash_dkv_bf16", 11, 6)
            dq, dk, dv = (torch.empty_like(ops[0]) for _ in range(3))
            calls["dq"][name] = (lambda fn=dq_fn, dq=dq: fn(
                *ptrs, dq.data_ptr(), bh, s, hd, 1, 1, 0, hd ** -0.5, stream()))
            calls["dkv"][name] = (lambda fn=dkv_fn, dk=dk, dv=dv: fn(
                *ptrs, dk.data_ptr(), dv.data_ptr(), bh, s, hd, 1, 1, 0, hd ** -0.5, stream()))
            calls["dq"][name]()
            calls["dkv"][name]()
            torch.cuda.synchronize()
            if check:
                print(f"B2/B3 {name}: dq {frac(dq, ref_dq, 2 ** -7):.3f}, dk "
                      f"{frac(dk, ref_dk, 2 ** -7):.3f}, dv {frac(dv, ref_dv, 2 ** -7):.3f} of "
                      f"their bounds", flush=True)
        if check:
            del ref_dq, ref_dk, ref_dv
        n_calls, replays = (20, 10) if s <= 1024 else (4, 5)
        for kind, label in (("dq", "B2"), ("dkv", "B3")):
            for name, ms in turns(calls[kind], n_calls, replays).items():
                print(f"{label} (B*nh={bh}, S={s}, hd={hd}) {name}: device ms per call {ms} "
                      f"[{card}]", flush=True)
        del ops, calls
        torch.cuda.empty_cache()

    if "parent" not in libs:
        return 0
    bh, s, hd = CHUNK_SHAPE
    q, k, v, do, lse, delta, slopes, kpos, kneg = flash_inputs(dev, gen, bh, s, hd)
    ops = (q, k, v, do, lse, delta, slopes, kpos, kpos, kneg)   # qpos = kpos: the diagonal
    ptrs = [t.data_ptr() for t in ops]
    calls, outs = {"dq": {}, "dkv": {}}, {}
    for name in ("this", "parent"):
        lib = libs[name]["flash_chunk"]
        dq_fn = entry(lib, "flash_chunk_dq_bf16", 11, 5)
        dkv_fn = entry(lib, "flash_chunk_dkv_bf16", 12, 5)
        dq, dk, dv = (torch.empty(bh, s, hd, device=dev) for _ in range(3))
        outs[name] = (dq, dk, dv)
        calls["dq"][name] = (lambda fn=dq_fn, dq=dq: fn(
            *ptrs, dq.data_ptr(), bh, s, s, hd, 1, hd ** -0.5, stream()))
        calls["dkv"][name] = (lambda fn=dkv_fn, dk=dk, dv=dv: fn(
            *ptrs, dk.data_ptr(), dv.data_ptr(), bh, s, s, hd, 1, hd ** -0.5, stream()))
        calls["dq"][name]()
        calls["dkv"][name]()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(outs["this"], outs["parent"])]
    print(f"B8/B9 this vs parent, bit for bit: dq {same[0]}, dk {same[1]}, dv {same[2]}",
          flush=True)
    for kind, label in (("dq", "B8"), ("dkv", "B9")):
        for name, ms in turns(calls[kind], 4, 5).items():
            print(f"{label} (B*nh={bh}, S={s}, hd={hd}, diagonal chunk) {name}: device ms per "
                  f"call {ms} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
