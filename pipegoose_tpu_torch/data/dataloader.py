"""Sharded token data loading.

The counterpart of ``pipegoose_tpu/data/dataloader.py``, with its own copy
of the module's numpy parts:

- ``TokenDataset``: a flat binary uint32 token file (the standard
  pre-tokenized corpus format), mmap'd;
- per-data-rank disjoint strided sharding with deterministic per-epoch
  shuffling (DistributedSampler semantics): the same windows as the JAX
  loader's, bit for bit, for the same file, seed, epoch and shard;
- the repository's native host loader (``native/dataloader.cpp``: a
  background prefetch thread and a batch ring), compiled on demand with
  g++ into ``build/native/`` and bound with ctypes; a pure-numpy path keeps
  everything working where no toolchain exists. ``TokenDataset.route``
  says which one runs ("native" or "numpy"); both are host code.

``__iter__`` yields numpy arrays; the train step moves each rank's part to
its device (``parallel.hybrid._local_batch``).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_SRC = os.path.join(_ROOT, "native", "dataloader.cpp")
_NATIVE_SO = os.path.join(_ROOT, "build", "native", "libpgt_dataloader.so")
_lib = None
_lib_tried = False


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native loader; None on any failure."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not os.path.exists(_NATIVE_SO) or os.path.getmtime(
            _NATIVE_SO
        ) < os.path.getmtime(_NATIVE_SRC):
            os.makedirs(os.path.dirname(_NATIVE_SO), exist_ok=True)
            # a private tmp path and an atomic rename: data-parallel rank
            # processes racing g++ on the shared path would otherwise
            # dlopen a half-written file
            tmp = f"{_NATIVE_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                 _NATIVE_SRC, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _NATIVE_SO)
        lib = ctypes.CDLL(_NATIVE_SO)
        lib.pgt_loader_open.restype = ctypes.c_void_p
        lib.pgt_loader_open.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ]
        lib.pgt_loader_windows.restype = ctypes.c_uint64
        lib.pgt_loader_windows.argtypes = [ctypes.c_void_p]
        lib.pgt_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)
        ]
        lib.pgt_loader_set_epoch.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.pgt_loader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def _splitmix64(x: int) -> int:
    M = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & M
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M
    return x ^ (x >> 31)


def _permute(idx: int, n: int, key: int) -> int:
    """Bijection on [0, n): an affine map mod 2^k cycle-walked into range,
    bit-identical to native/dataloader.cpp:permute, so the native and the
    numpy loaders yield the SAME batches."""
    mask = 1
    while mask < n:
        mask <<= 1
    mask -= 1
    a = _splitmix64(key) | 1
    b = _splitmix64(key ^ 0xDA3E39CB94B95BDB)
    x = idx
    while True:
        x = (a * x + b) & mask
        if x < n:
            return x


def write_token_file(tokens: np.ndarray, path: str) -> None:
    """Write a flat uint32 token corpus file."""
    np.asarray(tokens, dtype=np.uint32).tofile(path)


class TokenDataset:
    """Deterministic, sharded (batch, seq) windows over a token file.

    ``rank``/``world`` shard windows disjointly across data(-parallel)
    ranks, strided like torch's DistributedSampler; ``set_epoch``
    reshuffles. ``native``: None takes the native loader where it builds,
    True requires it, False takes the numpy path; ``route`` records which.
    """

    def __init__(
        self,
        path: str,
        batch: int,
        seq: int,
        rank: int = 0,
        world: int = 1,
        seed: int = 0,
        native: Optional[bool] = None,
    ):
        self.path, self.batch, self.seq = path, batch, seq
        self.rank, self.world, self.seed = rank, world, seed
        self.epoch = 0
        self._iter_token = 0  # newest live iterator wins (see __iter__)
        self._epoch_gen = 0  # bumped on EVERY set_epoch (even same epoch)
        self._closed = False
        self._handle = None
        self._lib = _load_native() if native in (None, True) else None
        if native is True and self._lib is None:
            raise RuntimeError("native loader requested but unavailable")
        if self._lib is not None:
            self._handle = self._lib.pgt_loader_open(
                path.encode(), batch, seq, rank, world, seed
            )
            if not self._handle:
                self._lib = None  # a file too small for one batch, etc.
        if self._lib is None:
            self._tokens = np.fromfile(path, dtype=np.uint32)
        self.route = "native" if self._handle else "numpy"

    # -- geometry -----------------------------------------------------------

    @property
    def windows_per_epoch(self) -> int:
        if self._closed:
            raise RuntimeError("TokenDataset is closed")
        if self._handle:
            return int(self._lib.pgt_loader_windows(self._handle))
        w = self._tokens.size // self.seq
        return (w // self.world) // self.batch * self.batch

    def steps_per_epoch(self) -> int:
        return self.windows_per_epoch // self.batch

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for a new epoch; the native loader discards any
        prefetched old-epoch batches and restarts at step 0 (the numpy
        iterator observes the epoch change and resets its own counter)."""
        self.epoch = epoch
        self._epoch_gen += 1  # every call restarts at step 0, like native
        if self._handle:
            self._lib.pgt_loader_set_epoch(self._handle, epoch)

    # -- iteration ----------------------------------------------------------

    def _fill_numpy(self, step: int) -> np.ndarray:
        """Bit-identical mirror of the native fill() (same permutation)."""
        per_rank = self.windows_per_epoch
        key = _splitmix64(self.seed) ^ _splitmix64(self.epoch + 1)
        out = np.empty((self.batch, self.seq), np.uint32)
        for b in range(self.batch):
            linear = (step * self.batch + b) % per_rank
            widx = _permute(linear, per_rank, key)
            gw = widx * self.world + self.rank
            out[b] = self._tokens[gw * self.seq : (gw + 1) * self.seq]
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        """Single live iterator: the native prefetch ring is one shared
        stream, and two interleaving iterators would silently steal each
        other's batches. Creating a new iterator invalidates the old one
        (it raises on its next pull). The numpy path's step counter is
        per-iterator and resets on EVERY ``set_epoch`` call, as the native
        loader's does."""
        self._iter_token += 1
        token = self._iter_token
        step = 0
        gen_seen = self._epoch_gen
        buf = np.empty(self.batch * self.seq, np.uint32)
        while True:
            if self._closed:
                raise RuntimeError("TokenDataset is closed")
            if token != self._iter_token:
                raise RuntimeError(
                    "a newer iterator was created for this TokenDataset; only "
                    "one live iterator is supported (shared prefetch stream)"
                )
            if self._handle:
                self._lib.pgt_loader_next(
                    self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
                )
                yield buf.reshape(self.batch, self.seq).copy()
            else:
                if gen_seen != self._epoch_gen:
                    gen_seen = self._epoch_gen
                    step = 0
                yield self._fill_numpy(step)
                step += 1

    def take(self, n: int):
        it = iter(self)
        return [next(it) for _ in range(n)]

    def close(self) -> None:
        if self._handle:
            self._lib.pgt_loader_close(self._handle)
            self._handle = None
        self._closed = True

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
