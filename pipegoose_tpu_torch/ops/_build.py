"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
its own by ``nvcc`` for Hopper (``sm_90a``) into
``build/kernels/<name>-<hash>.so`` at the repository root, then loaded
with ``ctypes``. The hash covers the source and the flags, so an edited
source builds anew at first use and an unchanged one is loaded as it
is. Only the sources in this checkout are compiled. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(exe, os.X_OK):
        raise RuntimeError(
            "nvcc not found (looked on PATH and /usr/local/cuda/bin): the "
            "CUDA kernels are built on the machine with the card")
    return exe


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content and flags."""
    digest = hashlib.sha256()
    digest.update((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> List[Path]:
    """Build every named source that is not built yet, one ``nvcc`` per
    source, all started together. Raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    names = list(names)
    paths = [library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name, path in todo:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in running:
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            ok = proc.returncode == 0
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {BUILD_TIMEOUT_S} s"
            ok = False
        path.with_suffix(".log").write_text(log)
        if ok:
            os.replace(tmp, path)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's report for the current build of ``name``."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        (path,) = build([name])
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
