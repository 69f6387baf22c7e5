"""Synchronous continuous-batching serving engine over the paged pool.

The counterpart of ``pipegoose_tpu/serving/engine.py`` with
``attn_kernel="paged"`` and ``prefill_chunk`` set, the configuration in
which every attention read goes through the paged-attention kernel.
``ServingEngine.run(requests)`` drives the host-side loop:

    while work remains:
        admit queued requests into free slots        (scheduler.admit)
        advance prefills, one CHUNK per prefilling   (paged_prefill_chunk)
          request per tick
        one decode step over ALL decoding slots      (paged_decode_step)
        record tokens; evict finished, reclaim pages (scheduler)

Greedy decoding only: the contract is token identity with the JAX
engine and with per-request ``generate()``. The KV pool lives in place
on the device. The monolithic prefill, prefix cache, speculative
decoding, weight quantisation, tensor parallelism, disaggregation, KV
tiers and the telemetry hooks wait for later slices of the port
(ROADMAP.md queue A).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from pipegoose_tpu_torch._device import resolve_device
from pipegoose_tpu_torch.models._decode import greedy_token, vocab_mask_for
from pipegoose_tpu_torch.serving.kv_pool import (
    PagePool,
    check_kv_dtype,
    init_pages,
    paged_decode_step,
    paged_prefill_chunk,
)
from pipegoose_tpu_torch.serving.scheduler import Request, Scheduler, Status


@dataclass
class RequestOutput:
    uid: int
    prompt: np.ndarray
    generated: np.ndarray
    finish_reason: str
    queue_latency_s: float
    ttft_s: float


class _RunState:
    """Accumulators of one serving run (``start_run`` .. ``finish_run``)."""

    def __init__(self, now):
        self.now = now
        self.t0 = 0.0
        self.done: List[Request] = []
        self.steps = 0
        self.chunks = 0
        self.step_time = 0.0            # summed decode-step wall time


class ServingEngine:
    """Greedy continuous-batching inference over a paged KV pool.

    ``num_slots`` bounds the decode batch, ``num_pages * page_size`` the
    pooled KV capacity, ``max_context`` the per-request prompt+new budget
    (it fixes the page-table width). ``prefill_chunk`` (required, a page
    multiple) is how many prompt tokens each prefilling request forwards
    per tick. ``kv_dtype="int8"`` stores int8 pages with a per-(position,
    head) scale. ``params`` come from ``models.weights.params_from_jax``
    on ``device``."""

    def __init__(self, params, config, *, num_slots: int = 4,
                 num_pages: int = 64, page_size: int = 16,
                 max_context: int = 256, prefill_chunk: Optional[int] = None,
                 kv_dtype: Optional[str] = None, device="cuda"):
        if prefill_chunk is None:
            raise ValueError(
                "prefill_chunk is required: the monolithic prefill is not "
                "ported yet (ROADMAP.md queue A), chunked prefill is the "
                "only prefill path")
        if max_context % page_size:
            raise ValueError("max_context must be a multiple of page_size")
        self.device = resolve_device(device)
        if params["embed"]["weight"].device.type != self.device.type:
            raise ValueError(
                f"params are on {params['embed']['weight'].device}, the "
                f"engine on {self.device}: build them with "
                f"params_from_jax(..., device={str(self.device)!r})")
        self.params = params
        self.config = config
        self.num_slots = num_slots
        self.table_width = max_context // page_size
        self.prefill_chunk = prefill_chunk
        self.kv_dtype = check_kv_dtype(kv_dtype)
        self.pool = PagePool(num_pages, page_size)
        self.sched = Scheduler(num_slots, self.pool, max_context,
                               chunk_tokens=prefill_chunk)
        self.k_pages, self.v_pages = init_pages(
            config, num_pages, page_size, kv_dtype=self.kv_dtype,
            device=self.device)
        self._mask_fn = vocab_mask_for(config)
        self._run: Optional[_RunState] = None

    def _tensor(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(self.device)

    def _prefill_chunk_tick(self, req: Request, now) -> None:
        """Advance one prefill chunk through the page tables; on reaching
        the target, record the first token."""
        target = req.target_len
        begin = req.prefilled_len
        end = min(begin + self.prefill_chunk, target)
        n = end - begin
        self.sched.ensure_pages(req, end)
        ids = np.zeros((1, self.prefill_chunk), np.int32)
        ids[0, :n] = req.tokens[begin:end]
        table = np.zeros((1, self.table_width), np.int32)
        table[0, :len(req.pages)] = req.pages
        logits = paged_prefill_chunk(
            self.params, self._tensor(ids), self.k_pages, self.v_pages,
            self._tensor(table), self._tensor([begin]), self._tensor([n]),
            self.config)
        tok = int(greedy_token(logits, self._mask_fn)[0])  # syncs the device
        req.prefilled_len = end
        if end == target:
            self.sched.record_token(req, tok, now())

    def _decode_step(self, active: List[Request]) -> np.ndarray:
        """One decode step over the decoding slots; returns each slot's
        next token (padded slots included, ignored by the caller)."""
        table = np.zeros((self.num_slots, self.table_width), np.int32)
        seq_lens = np.zeros((self.num_slots,), np.int32)
        tokens = np.zeros((self.num_slots,), np.int32)
        for req in active:
            table[req.slot, :len(req.pages)] = req.pages
            seq_lens[req.slot] = req.cached_len
            tokens[req.slot] = req.generated[-1]
        logits = paged_decode_step(
            self.params, self._tensor(tokens), self.k_pages, self.v_pages,
            self._tensor(table), self._tensor(seq_lens), self.config)
        return greedy_token(logits, self._mask_fn).cpu().numpy()  # syncs

    # -- API ---------------------------------------------------------------

    def run(self, requests: Sequence[Request], now=time.perf_counter):
        """Serve ``requests`` to completion; returns (list[RequestOutput] in
        submit order, metrics dict)."""
        if self._run is not None:
            raise RuntimeError("a serving run is already in progress")
        try:
            self.start_run(requests, now=now)
            while not self.sched.all_done():
                self.tick_once()
            return self.finish_run()
        finally:
            self._run = None

    def start_run(self, requests: Sequence[Request] = (),
                  now=time.perf_counter) -> None:
        """Begin a steppable run: submit ``requests``. Drive with
        :meth:`tick_once` until ``sched.all_done()``, close with
        :meth:`finish_run`."""
        if self._run is not None:
            raise RuntimeError("a serving run is already in progress")
        rs = _RunState(now)
        self._run = rs
        for r in requests:
            self.sched.submit(r, now())
        rs.t0 = now()

    def tick_once(self) -> bool:
        """One scheduler iteration: admit, one chunk per prefilling
        request, one decode step over the decoding slots, record tokens
        and evict. Returns True when the tick made progress."""
        rs = self._run
        if rs is None:
            raise RuntimeError("tick_once needs start_run first")
        now = rs.now
        admitted = self.sched.admit(now())
        prefilling = [r for r in self.sched.active() if r.status is Status.PREFILL]
        for req in prefilling:
            self._prefill_chunk_tick(req, now)
            rs.chunks += 1
            if req.status is Status.DONE:
                rs.done.append(req)
        active = [r for r in self.sched.active() if r.status is Status.DECODE]
        if not active:
            return bool(admitted or prefilling)
        for req in active:
            self.sched.ensure_page(req)
        t_step = now()
        nxt = self._decode_step(active)
        t = now()
        rs.steps += 1
        rs.step_time += t - t_step
        for req in active:
            self.sched.record_token(req, int(nxt[req.slot]), t)
            if req.status is Status.DONE:
                rs.done.append(req)
        return True

    def finish_run(self):
        """Close the run: (outputs in uid order, metrics dict)."""
        rs = self._run
        if rs is None:
            raise RuntimeError("finish_run needs start_run first")
        wall = max(rs.now() - rs.t0, 1e-9)
        outputs = [
            RequestOutput(
                uid=r.uid, prompt=np.asarray(r.prompt),
                generated=np.asarray(r.generated, np.int64),
                finish_reason=r.finish_reason,
                queue_latency_s=r.t_admit - r.t_submit,
                ttft_s=r.t_first_token - r.t_submit,
            )
            for r in sorted(rs.done, key=lambda r: r.uid)
        ]
        generated = sum(len(o.generated) for o in outputs)
        metrics = {
            "wall_time_s": wall,
            "generated_tokens": generated,
            "decode_tokens_per_s": generated / wall,
            "decode_steps": rs.steps,
            "decode_step_time_s": rs.step_time,
            "prefill_chunks": rs.chunks,
            "mean_ttft_s": (sum(o.ttft_s for o in outputs) / len(outputs)
                            if outputs else 0.0),
        }
        self._run = None
        return outputs, metrics
