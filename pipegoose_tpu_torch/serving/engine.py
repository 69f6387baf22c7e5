"""Synchronous continuous-batching serving engine over the paged pool.

The counterpart of ``pipegoose_tpu/serving/engine.py`` with
``attn_kernel="paged"``, the configuration in which every decode step
and prefill chunk reads attention through the paged-attention kernel.
``ServingEngine.run(requests)`` drives the host-side loop:

    while work remains:
        admit queued requests into free slots        (scheduler.admit)
        prefill: one CHUNK per prefilling request    (paged_prefill_chunk)
          per tick, or with prefill_chunk=None the
          whole prompt at admission                  (forward_cached +
                                                      write_prompt_pages)
        one decode step over ALL decoding slots      (paged_decode_step)
        record tokens; evict finished, reclaim pages (scheduler)

``weight_dtype="int8"|"int4"`` quantizes the block kernels at
construction (``quant.quantize_params``); every dense product of a block
then runs the dequant-fused matmul kernels. Greedy decoding only: the
contract is token identity with the JAX engine and with per-request
``generate()``. The KV pool lives in place on the device. The prefix
cache, speculative decoding, tensor parallelism, disaggregation, KV
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
from pipegoose_tpu_torch.models.generate import forward_cached, init_cache
from pipegoose_tpu_torch.quant.weights import (
    QuantSpec,
    bytes_by_dtype,
    quantize_params,
    quantized_weight_bytes,
)
from pipegoose_tpu_torch.serving.kv_pool import (
    PagePool,
    check_kv_dtype,
    init_pages,
    paged_decode_step,
    paged_prefill_chunk,
    write_prompt_pages,
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
        self.chunks = 0                 # prefill forwards; chunks when chunked
        self.prefills = 0               # prefills completed
        self.step_time = 0.0            # summed decode-step wall time


class ServingEngine:
    """Greedy continuous-batching inference over a paged KV pool.

    ``num_slots`` bounds the decode batch, ``num_pages * page_size`` the
    pooled KV capacity, ``max_context`` the per-request prompt+new budget
    (it fixes the page-table width). ``prefill_chunk`` (a page multiple)
    is how many prompt tokens each prefilling request forwards per tick;
    None prefills each prompt whole at admission through the contiguous
    cache, in a bucket of ``pages_for(len) * page_size`` left-padded
    positions. ``kv_dtype="int8"`` stores int8 pages with a per-(position,
    head) scale. ``weight_dtype`` ("int8" | "int4"; "fp" is an alias for
    None) quantizes the block kernels at construction, on ``device``;
    ``weight_group_size`` is the int4 contraction-group width. With
    neither knob set the engine serves ``params`` as given (the same
    object). ``params`` come from ``models.weights.params_from_jax`` on
    ``device``."""

    def __init__(self, params, config, *, num_slots: int = 4,
                 num_pages: int = 64, page_size: int = 16,
                 max_context: int = 256, prefill_chunk: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 weight_group_size: int = 32, device="cuda"):
        if max_context % page_size:
            raise ValueError("max_context must be a multiple of page_size")
        self.device = resolve_device(device)
        if params["embed"]["weight"].device.type != self.device.type:
            raise ValueError(
                f"params are on {params['embed']['weight'].device}, the "
                f"engine on {self.device}: build them with "
                f"params_from_jax(..., device={str(self.device)!r})")
        if weight_dtype == "fp":
            weight_dtype = None
        self.weight_dtype = weight_dtype
        if weight_dtype is not None:
            with torch.no_grad():
                params = quantize_params(params, QuantSpec(weight_dtype,
                                                           weight_group_size))
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

    def _prefill_request(self, req: Request, now) -> None:
        """Monolithic prefill: forward the whole prompt through a
        contiguous cache in a page-multiple bucket, left-padded, scatter
        its k/v into the request's pages and record the first token."""
        s = req.prompt_len
        ps = self.pool.page_size
        bucket = self.pool.pages_for(s) * ps
        pad = bucket - s
        ids = np.zeros((1, bucket), np.int32)
        ids[0, pad:] = np.asarray(req.prompt, np.int32)
        mask = np.zeros((1, bucket), np.int32)
        mask[0, pad:] = 1
        cache = init_cache(self.config, 1, bucket, device=self.device)
        logits, cache = forward_cached(self.params, self._tensor(ids), cache, 0,
                                       self.config,
                                       extras={"mask": self._tensor(mask)})
        tok = greedy_token(logits, self._mask_fn)
        phys = np.zeros((self.table_width,), np.int32)
        phys[:len(req.pages)] = req.pages
        write_prompt_pages(self.k_pages, self.v_pages, cache,
                           self._tensor(phys), pad, ps)
        tok = int(tok[0])                                  # syncs the device
        req.prefilled_len = s
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

    def memory_report(self) -> dict:
        """Byte census of the engine's resident state, by dtype: weights
        from the live params (quantized leaves count their int8 + scale
        bytes), KV from the live pool (values + scale planes).
        ``page_capacity_ratio`` is how many times more pages the same KV
        bytes hold than an fp pool of this geometry. The JAX report's
        registry gauges and host tier wait for the port's telemetry and KV
        tiers."""
        weights = quantized_weight_bytes(self.params)
        kv_by = bytes_by_dtype((self.k_pages, self.v_pages))
        kv_total = int(sum(kv_by.values()))
        cfg = self.config
        num_pages = self.pool.num_pages
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        fp_total = (2 * cfg.n_layer * num_pages * self.pool.page_size
                    * cfg.n_head * cfg.head_dim * itemsize)
        return {
            "weight_dtype": self.weight_dtype or "fp",
            "kv_dtype": self.kv_dtype or "fp",
            "weights": weights,
            "kv": {
                "bytes_by_dtype": kv_by,
                "total_bytes": kv_total,
                "num_pages": num_pages,
                "bytes_per_page": kv_total // num_pages,
                "fp_bytes_per_page": fp_total // num_pages,
                "page_capacity_ratio": round(fp_total / max(kv_total, 1), 4),
            },
        }

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
        if self.prefill_chunk is None:
            prefilling, prefill = admitted, self._prefill_request
        else:
            prefilling = [r for r in self.sched.active()
                          if r.status is Status.PREFILL]
            prefill = self._prefill_chunk_tick
        for req in prefilling:
            prefill(req, now)
            rs.chunks += 1
            if req.status is not Status.PREFILL:
                rs.prefills += 1
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
            "prefills": rs.prefills,
            "mean_ttft_s": (sum(o.ttft_s for o in outputs) / len(outputs)
                            if outputs else 0.0),
        }
        if self.prefill_chunk is not None:
            # as the JAX engine: a monolithic prefill is one forward per
            # request, counted in ``prefills``, and reports no chunks
            metrics["prefill_chunks"] = rs.chunks
        self._run = None
        return outputs, metrics
