"""Several ranks on one machine's CPU: the gloo multi-process harness.

The counterpart, in role, of ``pipegoose_tpu/testing/fake_cluster.py``:
the JAX tests fake 8 devices in one process, while a ``torch.distributed``
program needs one process per rank. ``run_ranks`` spawns them, joins them
through a ``FileStore`` in a fresh temporary directory (no TCP port, so
concurrent test workers cannot collide), runs ``fn(rank, world_size,
*args)`` in each with the gloo default group up, and returns what each
returned, tensors turned into numpy arrays.

``fn`` and its arguments are pickled into the children, which start from a
fresh interpreter (the ``spawn`` method): define ``fn`` at the top level of
a module that the children can import, and keep that module's imports to
what a child needs.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 120.0


def to_numpy(tree: Any) -> Any:
    """Tensors (in dicts, lists and tuples) as numpy arrays; a bf16 tensor
    as float32."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def _child(fn, rank, world_size, store_path, results, args):
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world_size)
        # no rank may run fn and exit while a peer is still connecting:
        # its closed socket would fail the peer's init instead of fn
        dist.barrier()
        results.put((rank, True, to_numpy(fn(rank, world_size, *args))))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args,
              timeout: float = JOIN_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` gloo ranks,
    one spawned process each with one CPU thread, and return the results
    in rank order. Raises ``RuntimeError`` with the child's traceback if a
    rank raised, and ``TimeoutError`` if the ranks did not all finish
    within ``timeout`` seconds (a hung collective): every rank still
    running is then killed."""
    mp = multiprocessing.get_context("spawn")
    results = mp.Queue()
    got, failures = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [mp.Process(target=_child, daemon=True,
                            args=(fn, r, world_size, store_path, results, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) + len(failures) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:   # killed by a signal before it could report
                        failures.append((dead[0], f"died with exit code "
                                         f"{procs[dead[0]].exitcode}"))
                        break
                    continue
                if ok:
                    got[rank] = payload
                else:
                    failures.append((rank, payload))
                    break   # the others may wait on the failed rank forever
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(5.0, deadline - time.monotonic())))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if failures:
        rank, text = failures[0]
        raise RuntimeError(f"rank {rank} of {world_size} failed:\n{text}")
    if len(got) < world_size:
        missing = sorted(set(range(world_size)) - set(got))
        raise TimeoutError(f"ranks {missing} of {world_size} did not finish "
                           f"within {timeout} s; killed")
    return [got[r] for r in range(world_size)]
