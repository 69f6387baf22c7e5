"""Synchronous continuous-batching serving engine over the paged pool.

The counterpart of ``pipegoose_tpu/serving/engine.py`` with
``attn_kernel="paged"``, the configuration in which every decode step,
prefill chunk, speculative draft and verification reads attention
through the paged-attention kernel. ``ServingEngine.run(requests)``
drives the host-side loop:

    while work remains:
        shed queued requests past their deadline,
        admit queued requests into free slots        (scheduler.admit;
                                                      prefix-cache hits
                                                      share KV pages)
        prefill: one CHUNK per prefilling request    (paged_prefill_chunk,
          per tick, after a copy-on-write of a        copy_page)
          partly shared page; or with neither the
          cache nor prefill_chunk, the whole prompt
          at admission                               (forward_cached +
                                                      write_prompt_pages)
        one decode step over ALL decoding slots      (paged_decode_step),
          or a draft + verify speculative cycle
        record tokens; evict finished, reclaim pages (scheduler)

Opt-in modes, all off by default:

- ``prefix_cache=True``: content-addressed page sharing
  (``serving/prefix_cache.py``); a request whose prompt prefix is cached
  skips prefill for the shared pages and forwards only its tail, after a
  copy-on-write when the tail starts inside a shared page. Without
  ``prefill_chunk`` the tail is forwarded as one page-multiple bucket.
- ``prefill_chunk=N``: prompts advance N tokens a tick through the page
  tables, between decode steps.
- ``speculative=(k, n)``: self-speculative decoding. The first ``k``
  blocks plus the final LN and tied head (the same weights) draft up to
  ``n`` tokens a slot; one full-model pass over the bundle
  (``paged_prefill_chunk(all_logits=True)``) verifies them. Accepted
  tokens are the full model's greedy tokens.
- ``continuous=False``: padded batching (a batch drains before the next
  is admitted), the baseline of an A/B.
- ``stall_patience``: ticks without admission, prefill, shedding or
  decode before the watchdog raises.

``weight_dtype="int8"|"int4"`` quantizes the block kernels at
construction (``quant.quantize_params``); every dense product of a block
then runs the dequant-fused matmul kernels. Greedy decoding only: the
contract is token identity with the JAX engine and with per-request
``generate()``. The KV pool lives in place on the device.

Tensor parallelism: ``param_specs`` (``models.bloom.tp_specs``) serves the
whole tree sharded over the ``tp_axis`` of a ``ParallelContext``, one
engine per rank, as the JAX engine does under a mesh: each rank keeps its
shard of the weights (quantized whole first, then sharded by
``quant.quantize_param_specs``), a pool of its ``n_head / tp`` heads, and
its vocab shard of the logits, and every token is the global argmax
(``models._decode.global_greedy_pick``). Every rank runs the same host
scheduler; the clock is the one input that could differ, so every
``now()`` reading is rank 0's, broadcast over the axis, and shedding, TTFT
and the run's metrics agree on every rank.

Telemetry (``telemetry/``): every run updates the engine's registry
(``registry=``, the global one by default, disabled until enabled):
request, token, prefill, chunk, step, shed, prefix-cache and speculative
counters, TTFT, per-token, end-to-end and decode-gap histograms, occupancy
gauges, and the ``serving.prefill`` / ``serving.decode_step`` spans, whose
wall time covers the card's work (each ends with the token read). A
``recorder=`` (``telemetry.FlightRecorder``) records every decode step and
dumps a black box when the watchdog trips; ``memledger=True`` (or a
``telemetry.MemoryLedger``) keeps a byte-exact account of the pool's pages,
checked every tick. The request tracer waits for ROADMAP.md queue A, A13a
split (2); sampling, the fleet API (``submit_request``, ``take_finished``,
faults), disaggregation and KV tiers for A12.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pipegoose_tpu_torch._device import resolve_device
from pipegoose_tpu_torch.distributed.functional import broadcast
from pipegoose_tpu_torch.distributed.parallel_context import ParallelContext
from pipegoose_tpu_torch.models._decode import (
    global_greedy_pick,
    greedy_token,
    vocab_mask_for,
)
from pipegoose_tpu_torch.models.generate import forward_cached, init_cache
from pipegoose_tpu_torch.nn.parallel import shard_tree
from pipegoose_tpu_torch.quant.weights import (
    QuantSpec,
    bytes_by_dtype,
    quantize_param_specs,
    quantize_params,
    quantized_weight_bytes,
    validate_tp_compat,
)
from pipegoose_tpu_torch.serving.kv_pool import (
    PagePool,
    check_kv_dtype,
    copy_page,
    init_pages,
    paged_decode_step,
    paged_prefill_chunk,
    write_prompt_pages,
)
from pipegoose_tpu_torch.serving.prefix_cache import PrefixCache
from pipegoose_tpu_torch.serving.scheduler import Request, Scheduler, Status
from pipegoose_tpu_torch.telemetry.registry import get_registry
from pipegoose_tpu_torch.telemetry.spans import span


@dataclass
class RequestOutput:
    uid: int
    prompt: np.ndarray
    generated: np.ndarray
    finish_reason: str
    queue_latency_s: float
    # None for a shed request: it never got a first token
    ttft_s: Optional[float]
    decode_tokens_per_s: Optional[float]
    e2e_latency_s: float = 0.0          # submit -> done
    tenant: Optional[str] = None


class _RunState:
    """Accumulators of one serving run (``start_run`` .. ``finish_run``)."""

    def __init__(self, now, tick_hook, tok0=0.0):
        self.now = now
        self.tick_hook = tick_hook
        self.t0 = 0.0
        self.tok0 = tok0                # serving.tokens_total at the start
        self.done: List[Request] = []
        self.tick = 0
        self.steps = 0                  # decode steps and speculative cycles
        self.chunks = 0                 # paged prefill forwards
        self.prefills = 0               # prefills completed
        self.step_time = 0.0            # summed decode-step wall time
        self.stalled = 0
        self.t_last_decode: Optional[float] = None
        self.max_gap = 0.0
        self.prefill_tokens = 0         # prompt tokens forwarded
        self.hit_tokens = 0             # prompt tokens served by the cache
        self.cow_copies = 0
        self.spec_cycles = self.spec_drafted = self.spec_accepted = 0
        self.spec_tokens = 0            # tokens the cycles emitted


def _quantile(values, q: float) -> float:
    """The JAX registry histogram's rule: the sorted sample at
    ``min(int(q * n), n - 1)``."""
    sample = sorted(values)
    if not sample:
        return float("nan")
    return sample[min(int(q * len(sample)), len(sample) - 1)]


class ServingEngine:
    """Greedy continuous-batching inference over a paged KV pool.

    ``num_slots`` bounds the decode batch, ``num_pages * page_size`` the
    pooled KV capacity, ``max_context`` the per-request prompt+new budget
    (it fixes the page-table width). ``prefill_chunk`` (a page multiple)
    is how many prompt tokens each prefilling request forwards per tick;
    with neither it nor ``prefix_cache`` each prompt is prefilled whole
    at admission through the contiguous cache, in a bucket of
    ``pages_for(len) * page_size`` left-padded positions.
    ``prefix_cache``, ``speculative=(k, n)``, ``continuous`` and
    ``stall_patience`` are the modes of the module docstring.
    ``kv_dtype="int8"`` stores int8 pages with a per-(position, head)
    scale. ``weight_dtype`` ("int8" | "int4"; "fp" is an alias for None)
    quantizes the block kernels at construction, on ``device``;
    ``weight_group_size`` is the int4 contraction-group width. With
    neither knob set the engine serves ``params`` as given (the same
    object). ``params`` come from ``models.weights.params_from_jax`` on
    ``device``.

    ``param_specs`` (the spec tree of the fp ``params``, e.g.
    ``models.bloom.tp_specs(params)``) serves them tensor-parallel over
    ``tp_axis`` of ``parallel_context`` (the current ``ParallelContext``
    when None): ``params`` is then the WHOLE tree, the same on every rank,
    and each rank builds its own engine with the same arguments and runs
    the same requests. With ``param_specs=None`` the engine is the
    single-device one, whatever ``tp_axis`` says.

    ``registry``, ``recorder`` and ``memledger`` are the telemetry hooks of
    the module docstring."""

    def __init__(self, params, config, *, num_slots: int = 4,
                 num_pages: int = 64, page_size: int = 16,
                 max_context: int = 256, continuous: bool = True,
                 stall_patience: int = 100, prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 speculative: Optional[Tuple[int, int]] = None,
                 kv_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 weight_group_size: int = 32, param_specs=None,
                 tp_axis: str = "tensor", parallel_context=None, device="cuda",
                 registry=None, recorder=None, memledger=None):
        if max_context % page_size:
            raise ValueError("max_context must be a multiple of page_size")
        if stall_patience < 1:
            raise ValueError(f"stall_patience must be >= 1, got {stall_patience}")
        if speculative is not None:
            k, n = speculative
            if not 1 <= k < config.n_layer:
                raise ValueError(
                    f"speculative draft depth {k} must be in "
                    f"[1, n_layer={config.n_layer})")
            if n < 1:
                raise ValueError(f"speculative draft length {n} must be >= 1")
        self.device = resolve_device(device)
        if params["embed"]["weight"].device.type != self.device.type:
            raise ValueError(
                f"params are on {params['embed']['weight'].device}, the "
                f"engine on {self.device}: build them with "
                f"params_from_jax(..., device={str(self.device)!r})")
        if weight_dtype == "fp":
            weight_dtype = None
        self.weight_dtype = weight_dtype
        self.tp_axis = None
        tp = 1
        if param_specs is not None:
            ctx = parallel_context or ParallelContext.get_context()
            if ctx is None:
                raise ValueError("param_specs needs a ParallelContext; construct one first")
            tp = ctx.axis_size(tp_axis)
            if config.n_head % tp:
                raise ValueError(f"n_head={config.n_head} not divisible by tp={tp}")
            self.tp_axis = tp_axis
        if weight_dtype is not None:
            quant = QuantSpec(weight_dtype, weight_group_size)
            validate_tp_compat(config, tp, quant)
            if param_specs is not None:
                # mapped from the fp tree, before its kernels change shape
                param_specs = quantize_param_specs(param_specs, params, quant)
            with torch.no_grad():
                # the WHOLE tree, before any shard: an int8 scale is the
                # maximum over the whole contraction dim, which a
                # row-parallel shard holds only part of
                params = quantize_params(params, quant)
        self._weights = None
        if param_specs is not None:
            # the JAX engine reports the global arrays' bytes
            self._weights = quantized_weight_bytes(params)
            params = shard_tree(params, param_specs, ctx)
        self.tp = tp
        self.params = params
        self.config = config
        self.num_slots = num_slots
        self.page_size = page_size
        self.table_width = max_context // page_size
        self.prefill_chunk = prefill_chunk
        self.speculative = speculative
        self.stall_patience = stall_patience
        self.kv_dtype = check_kv_dtype(kv_dtype)
        self.pool = PagePool(num_pages, page_size)
        self.prefix_cache = PrefixCache(self.pool) if prefix_cache else None
        self.sched = Scheduler(num_slots, self.pool, max_context,
                               continuous=continuous,
                               prefix_cache=self.prefix_cache,
                               chunk_tokens=prefill_chunk)
        # the cache's tails attend to shared pages, so they take the paged
        # prefill too; the monolithic path stays the default otherwise
        self._paged_prefill = prefix_cache or prefill_chunk is not None
        self.k_pages, self.v_pages = init_pages(
            config, num_pages, page_size, tp=tp, kv_dtype=self.kv_dtype,
            device=self.device)
        self._mask_fn = vocab_mask_for(config)
        self._run: Optional[_RunState] = None
        self.recorder = recorder
        self.registry = registry if registry is not None else get_registry()
        self._resolve_metrics()
        # the memory ledger comes last: its bytes per page are measured
        # from the live pool above
        self.memledger = None
        if memledger:
            from pipegoose_tpu_torch.telemetry.memledger import MemoryLedger

            self.attach_memledger(memledger if isinstance(memledger, MemoryLedger)
                                  else MemoryLedger())

    def _resolve_metrics(self) -> None:
        """Resolve the metric handles once: inc / set / observe check the
        enabled flag themselves, so a disabled registry costs one branch
        per site in the hot loop (no lock, no name lookup)."""
        reg = self.registry
        self._m_tokens = reg.counter("serving.tokens_total")
        self._m_requests = reg.counter("serving.requests_total")
        self._m_shed = reg.counter("serving.shed_total")
        self._m_prefills = reg.counter("serving.prefills_total")
        self._m_steps = reg.counter("serving.decode_steps_total")
        self._m_ttft = reg.histogram("serving.ttft_seconds")
        self._m_tok_lat = reg.histogram("serving.decode_token_seconds")
        self._m_e2e = reg.histogram("serving.e2e_latency_seconds")
        self._m_queue = reg.gauge("serving.queue_depth")
        self._m_active = reg.gauge("serving.slots_active")
        self._m_slot_occ = reg.gauge("serving.slot_occupancy")
        self._m_page_occ = reg.gauge("serving.page_occupancy")
        self._m_tps = reg.gauge("serving.tokens_per_s")
        self._m_hit_tok = reg.counter("serving.prefix_cache.hit_tokens")
        self._m_miss_tok = reg.counter("serving.prefix_cache.miss_tokens")
        self._m_shared = reg.counter("serving.prefix_cache.shared_pages")
        self._m_cow = reg.counter("serving.prefix_cache.cow_copies")
        self._m_cached = reg.gauge("serving.prefix_cache.cached_pages")
        # pages leaf-first eviction could recover right now
        self._m_evictable = reg.gauge("serving.prefix_cache.evictable_pages")
        self._m_frag = reg.gauge("serving.pool.fragmentation")
        self._m_prefill_tok = reg.counter("serving.prefill_tokens_total")
        self._m_chunks = reg.counter("serving.prefill_chunks_total")
        self._m_gap = reg.histogram("serving.decode_gap_seconds")
        self._m_spec_cycles = reg.counter("serving.spec.cycles")
        self._m_spec_draft = reg.counter("serving.spec.draft_tokens")
        self._m_spec_acc = reg.counter("serving.spec.accepted_tokens")

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy pick of every forward: over the whole vocabulary, or
        under a tensor axis the global argmax over the vocab shards."""
        if self.tp_axis is None:
            return greedy_token(logits, self._mask_fn)
        return global_greedy_pick(logits, self.tp_axis,
                                  getattr(self.config, "valid_vocab_size", None))

    def _lockstep_clock(self, now):
        """``now`` under a tensor axis larger than 1: every reading is rank
        0's, broadcast over the axis as one float64, so every rank's
        scheduler sheds, admits and times alike (every rank reads the clock
        at the same points of the same host logic)."""
        if self.tp <= 1:
            return now

        def clock() -> float:
            t = torch.tensor([now()], dtype=torch.float64, device=self.device)
            return float(broadcast(t, self.tp_axis, 0)[0])

        return clock

    def _tensor(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(self.device)

    def _start_prefill(self, req: Request, rs: _RunState) -> None:
        """Paged-path admission follow-up: account the cache hit, then run
        the pending copy-on-write (the shared page whose tail this request
        will write gets a private copy) and drop the admission's pin on
        the source right after it."""
        if self.prefix_cache is not None:
            rs.hit_tokens += req.hit_tokens
            # chunk-only engines have no cache: all-miss counters would
            # read as a misconfigured cache
            self._m_hit_tok.inc(req.hit_tokens)
            self._m_miss_tok.inc(req.target_len - req.hit_tokens)
            self._m_shared.inc(req.prefilled_len // self.page_size)
        if req.cow is not None:
            src, m = req.cow
            dst = req.pages[req.prefilled_len // self.page_size]
            copy_page(self.k_pages, self.v_pages, src, dst)
            self.pool.release([src], owner=("cow", req.uid))   # the acquire pin
            req.cow = None
            req.prefilled_len += m
            rs.cow_copies += 1
            self._m_cow.inc()

    def _observe_ttft(self, req: Request) -> None:
        """TTFT into its histogram once per request: a preempted request
        re-enters prefill with its first ``t_first_token`` kept."""
        if (req.ttft_observed or req.t_first_token is None
                or req.t_submit is None):
            return
        req.ttft_observed = True
        self._m_ttft.observe(req.t_first_token - req.t_submit)

    def _prefill_chunk_tick(self, req: Request, rs: _RunState) -> None:
        """Advance one prefill chunk through the page tables. On reaching
        the target: publish the full prompt pages to the cache, then
        record the first token, or for a preempted request resume
        decoding (its pending token is already in ``generated``)."""
        target = req.target_len
        begin = req.prefilled_len
        end = min(begin + (self.prefill_chunk or target - begin), target)
        n = end - begin
        # one width when chunking (the last chunk pads), else a
        # page-multiple bucket
        prog = (self.prefill_chunk if self.prefill_chunk is not None
                else self.pool.pages_for(n) * self.page_size)
        self.sched.ensure_pages(req, end)
        ids = np.zeros((1, prog), np.int32)
        ids[0, :n] = req.tokens[begin:end]
        table = np.zeros((1, self.table_width), np.int32)
        table[0, :len(req.pages)] = req.pages
        with span("serving.prefill", registry=self.registry):
            logits = paged_prefill_chunk(
                self.params, self._tensor(ids), self.k_pages, self.v_pages,
                self._tensor(table), self._tensor([begin]), self._tensor([n]),
                self.config, self.tp_axis)
            tok = int(self._pick(logits)[0])        # syncs: span = card work
        req.prefilled_len = end
        rs.prefill_tokens += n
        self._m_chunks.inc()
        self._m_prefill_tok.inc(n)
        if end < target:
            return
        if self.prefix_cache is not None:
            n_full = req.prompt_len // self.page_size
            self.prefix_cache.insert(
                np.asarray(req.prompt)[:n_full * self.page_size],
                req.pages[:n_full])
            self._m_cached.set(self.prefix_cache.cached_pages)
        self._m_prefills.inc()
        if req.generated:
            # resumed after preemption: the last logits re-derive the
            # pending token (greedy); decode picks up where it left off
            req.status = Status.DECODE
            return
        self.sched.record_token(req, tok, rs.now())
        self._m_tokens.inc()
        self._observe_ttft(req)

    def _prefill_request(self, req: Request, rs: _RunState) -> None:
        """Monolithic prefill: forward the whole prompt through a
        contiguous cache in a page-multiple bucket, left-padded, scatter
        its k/v into the request's pages and record the first token."""
        if req.generated:
            raise RuntimeError(
                "re-admitting a preempted request requires the paged "
                "prefill path — construct the engine with prefix_cache "
                "and/or prefill_chunk")
        s = req.prompt_len
        ps = self.pool.page_size
        with span("serving.prefill", registry=self.registry):
            bucket = self.pool.pages_for(s) * ps
            pad = bucket - s
            ids = np.zeros((1, bucket), np.int32)
            ids[0, pad:] = np.asarray(req.prompt, np.int32)
            mask = np.zeros((1, bucket), np.int32)
            mask[0, pad:] = 1
            cache = init_cache(self.config, 1, bucket, self.tp, device=self.device)
            logits, cache = forward_cached(self.params, self._tensor(ids), cache, 0,
                                           self.config, self.tp_axis,
                                           extras={"mask": self._tensor(mask)})
            tok = self._pick(logits)
            phys = np.zeros((self.table_width,), np.int32)
            phys[:len(req.pages)] = req.pages
            write_prompt_pages(self.k_pages, self.v_pages, cache,
                               self._tensor(phys), pad, ps)
            tok = int(tok[0])                        # syncs: span = card work
            req.prefilled_len = s
            rs.prefill_tokens += s
            self.sched.record_token(req, tok, rs.now())
        self._m_prefill_tok.inc(s)
        self._m_prefills.inc()
        self._m_tokens.inc()  # the prefill's token
        self._observe_ttft(req)

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
        with span("serving.decode_step", registry=self.registry):
            logits = paged_decode_step(
                self.params, self._tensor(tokens), self.k_pages, self.v_pages,
                self._tensor(table), self._tensor(seq_lens), self.config, self.tp_axis)
            return self._pick(logits).cpu().numpy()          # syncs: span = card work

    def _spec_cycle(self, rows: List[Request], rs: _RunState):
        """One speculative cycle over the decoding slots: draft up to n
        tokens a slot with the k-block shallow exit, verify the bundle in
        one full-model pass, emit the longest verified prefix plus the
        correction token. Drafts and verified ids stay on the device until
        one fetch each after the verification. A row's draft writes past
        its bound go to the NULL page; the verification rewrites every
        layer at positions ``seq .. seq + g``, so no draft KV of a
        rejected token survives. Returns (emitted, drafted, accepted,
        surviving rows: lazy growth may retract a neighbour)."""
        spec_k, n_spec = self.speculative
        table = np.zeros((self.num_slots, self.table_width), np.int32)
        seq = np.zeros((self.num_slots,), np.int32)
        tok0 = np.zeros((self.num_slots,), np.int32)
        g = np.zeros((self.num_slots,), np.int32)
        for r in rows:
            if r.status is not Status.DECODE:
                continue  # retracted by an earlier row's lazy growth
            # bound the draft depth so verified writes stay inside the
            # admission's worst case: positions <= cached + remaining - 1
            g_i = min(n_spec, r.max_new_tokens - len(r.generated) - 1)
            self.sched.ensure_pages(r, r.cached_len + g_i + 1)
        rows = [r for r in rows if r.status is Status.DECODE]
        for r in rows:
            table[r.slot, :len(r.pages)] = r.pages
            seq[r.slot] = r.cached_len
            tok0[r.slot] = r.generated[-1]
            g[r.slot] = min(n_spec, r.max_new_tokens - len(r.generated) - 1)
        # the plain path's span: speculation must not make the decode-step
        # stream vanish
        with span("serving.decode_step", registry=self.registry):
            d_table, d_seq, d_tok0, d_g = (self._tensor(a) for a in (table, seq, tok0, g))
            cur = d_tok0
            drafts = []
            for j in range(n_spec):
                logits = paged_decode_step(
                    self.params, cur, self.k_pages, self.v_pages, d_table, d_seq + j,
                    self.config, self.tp_axis, write_ok=d_g > j, draft_layers=spec_k)
                cur = self._pick(logits).to(torch.int32)
                drafts.append(cur)
            ids = torch.stack([d_tok0, *drafts], dim=1)
            logits = paged_prefill_chunk(
                self.params, ids, self.k_pages, self.v_pages, d_table, d_seq,
                d_g + 1, self.config, self.tp_axis, all_logits=True)
            b, c, _ = logits.shape
            verified = self._pick(logits.reshape(b * c, -1)).reshape(b, c)
            drafts = ids[:, 1:].cpu().numpy()
            toks = verified.cpu().numpy()        # syncs: span = card work
        t = rs.now()
        emitted = accepted = 0
        for r in rows:
            i = r.slot
            m = 0
            while m < g[i] and int(drafts[i, m]) == int(toks[i, m]):
                m += 1
            accepted += m
            # m matched drafts + the correction (or bonus) token
            for j in range(m + 1):
                self.sched.record_token(r, int(toks[i, j]), t)
                emitted += 1
                if r.status is Status.DONE:
                    rs.done.append(r)
                    break
        drafted = int(g.sum())
        self._m_spec_cycles.inc()
        self._m_spec_draft.inc(drafted)
        self._m_spec_acc.inc(accepted)
        return emitted, drafted, accepted, rows

    def _stall(self, rs: _RunState) -> None:
        """The no-progress watchdog tripped: dump a black box (when a
        recorder is attached), end the run and raise rather than loop
        forever."""
        queued = len(self.sched.queue)
        head = self.sched.queue[0] if queued else None
        reason = (
            f"no decode progress for {self.stall_patience} scheduler "
            f"iterations: {queued} queued, 0 active, "
            f"{self.pool.free_count}/{self.pool.capacity} pages free")
        if head is not None:
            worst = self.pool.pages_for(self.sched._worst_tokens(head))
            reason += f"; queue head uid={head.uid} needs {worst} pages worst-case"
        where = ""
        if self.recorder is not None:
            trig = self.recorder.trigger_decode_stall(
                rs.steps, reason,
                context={
                    "num_slots": self.num_slots,
                    "page_size": self.page_size,
                    "pages_free": self.pool.free_count,
                    "pages_total": self.pool.capacity,
                    "queued": queued,
                    "decode_steps": rs.steps,
                    "wall_s": rs.now() - rs.t0,
                })
            if trig.dump_path:
                where = f" (black box: {trig.dump_path})"
        self._run = None   # the stall is terminal for this run
        raise RuntimeError(f"serving decode stall: {reason}{where}")

    # -- API ---------------------------------------------------------------

    def _kv_bytes_by_dtype(self) -> dict:
        """The live pool's bytes by dtype (values + scale planes), over
        every rank under a tensor axis (this rank's heads times tp), as
        the JAX engine counts its global arrays."""
        return {k: v * self.tp for k, v in
                bytes_by_dtype((self.k_pages, self.v_pages)).items()}

    def memory_report(self, registry=None) -> dict:
        """Byte census of the engine's resident state, by dtype: weights
        from the live params (quantized leaves count their int8 + scale
        bytes), KV from the live pool (values + scale planes).
        ``page_capacity_ratio`` is how many times more pages the same KV
        bytes hold than an fp pool of this geometry. Under a tensor axis the
        bytes are the whole engine's over every rank, as the JAX engine
        counts its global arrays: the whole quantized tree, and this rank's
        head-sharded pool times tp. Sets the ``serving.hbm.weights_bytes``,
        ``serving.hbm.kv_bytes`` and ``serving.hbm.kv_page_capacity_ratio``
        gauges of ``registry`` (the engine's by default). The JAX report's
        host tier waits for the port's KV tiers."""
        weights = self._weights or quantized_weight_bytes(self.params)
        kv_by = self._kv_bytes_by_dtype()
        kv_total = int(sum(kv_by.values()))
        cfg = self.config
        num_pages = self.pool.num_pages
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        fp_total = (2 * cfg.n_layer * num_pages * self.pool.page_size
                    * cfg.n_head * cfg.head_dim * itemsize)
        report = {
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
        reg = registry if registry is not None else self.registry
        reg.gauge(
            "serving.hbm.weights_bytes",
            help="resident model weight bytes (quantized leaves counted "
                 "at their wire size)",
        ).set(float(weights["total_bytes"]))
        reg.gauge(
            "serving.hbm.kv_bytes",
            help="resident KV page-pool bytes (values + scale planes)",
        ).set(float(kv_total))
        reg.gauge(
            "serving.hbm.kv_page_capacity_ratio",
            help="pages the same device memory holds vs an fp pool (1.0 = fp)",
        ).set(float(report["kv"]["page_capacity_ratio"]))
        return report

    def attach_memledger(self, ledger) -> None:
        """Attach (or detach, with None) a ``telemetry.MemoryLedger``: bind
        it to the pool (as its synchronous event observer), the scheduler,
        the prefix cache, the flight recorder and the registry, with the
        bytes per page measured from the live pool (q + scale planes for
        int8 pages, the census ``memory_report`` takes). Attaching to a
        warm engine adopts its pool through the ledger's ``resync``."""
        if ledger is None:
            if self.memledger is not None:
                self.memledger.unbind()
            self.memledger = None
            return
        total = int(sum(self._kv_bytes_by_dtype().values()))
        ledger.bind(
            self.pool, sched=self.sched, cache=self.prefix_cache,
            host_tier=None, recorder=self.recorder, registry=self.registry,
            bytes_per_page=total // self.pool.num_pages)
        self.memledger = ledger

    def _ledger_tick(self, rs: _RunState) -> None:
        """Per-tick ledger hook (conservation check, forecast, occupancy
        sample). Without a ledger (the default) the cost is this one
        attribute read and branch."""
        ml = self.memledger
        if ml is None:
            return
        ml.on_tick(rs.tick, t=rs.now())

    def run(self, requests: Sequence[Request], now=time.perf_counter,
            tick_hook=None):
        """Serve ``requests`` to completion; returns (list[RequestOutput] in
        submit order, metrics dict). ``tick_hook(engine, tick)`` runs at
        the start of every tick: the seam for mid-run interventions such
        as ``engine.sched.preempt``."""
        if self._run is not None:
            raise RuntimeError("a serving run is already in progress")
        try:
            self.start_run(requests, now=now, tick_hook=tick_hook)
            while not self.sched.all_done():
                self.tick_once()
            return self.finish_run()
        finally:
            self._run = None

    def start_run(self, requests: Sequence[Request] = (),
                  now=time.perf_counter, tick_hook=None) -> None:
        """Begin a steppable run: submit ``requests``. Drive with
        :meth:`tick_once` until ``sched.all_done()``, close with
        :meth:`finish_run`."""
        if self._run is not None:
            raise RuntimeError("a serving run is already in progress")
        now = self._lockstep_clock(now)
        rs = _RunState(now, tick_hook, self._m_tokens.value)
        self._run = rs
        for r in requests:
            self.sched.submit(r, now())
            self._m_requests.inc()
        self._m_queue.set(len(self.sched.queue))
        rs.t0 = now()

    def tick_once(self) -> bool:
        """One scheduler iteration: shed and admit, one chunk per
        prefilling request, then one decode step (or speculative cycle)
        over the decoding slots, record tokens and evict. Returns True
        when the tick made progress (admitted, prefilled, shed or
        decoded)."""
        rs = self._run
        if rs is None:
            raise RuntimeError("tick_once needs start_run first")
        now = rs.now
        rs.tick += 1
        if rs.tick_hook is not None:
            rs.tick_hook(self, rs.tick)
        admitted = self.sched.admit(now())
        shed_now = self.sched.drain_shed()
        if shed_now:
            # shedding is the degraded-but-healthy mode: a counter and
            # terminal outputs, never a watchdog trigger
            self._m_shed.inc(len(shed_now))
            rs.done.extend(shed_now)
        chunked = 0
        if self._paged_prefill:
            for req in admitted:
                self._start_prefill(req, rs)
            for req in [r for r in self.sched.active()
                        if r.status is Status.PREFILL]:
                if req.status is not Status.PREFILL:
                    continue  # retracted by a neighbour's growth this loop
                self._prefill_chunk_tick(req, rs)
                rs.chunks += 1
                chunked += 1
                if req.status is Status.DONE:
                    rs.done.append(req)
                if req.status is not Status.PREFILL:
                    rs.prefills += 1
        else:
            for req in admitted:
                self._prefill_request(req, rs)
                rs.prefills += 1
                if req.status is Status.DONE:
                    rs.done.append(req)
        active = [r for r in self.sched.active() if r.status is Status.DECODE]
        self._m_queue.set(len(self.sched.queue))
        if not active:
            if admitted or chunked or shed_now:
                rs.stalled = 0
            else:
                rs.stalled += 1
                if rs.stalled >= self.stall_patience:
                    self._stall(rs)
            rs.t_last_decode = None
            self._ledger_tick(rs)
            return bool(admitted or chunked or shed_now)
        rs.stalled = 0
        use_spec = self.speculative is not None and any(
            r.max_new_tokens - len(r.generated) > 1 for r in active)
        if use_spec:
            t_step = now()
            emitted, drafted, accepted, active = self._spec_cycle(active, rs)
            rs.spec_cycles += 1
            rs.spec_tokens += emitted
            rs.spec_drafted += drafted
            rs.spec_accepted += accepted
            t = now()
        else:
            for req in active:
                if req.status is Status.DECODE:
                    self.sched.ensure_page(req)
            # lazy growth may have retracted a neighbour
            active = [r for r in active if r.status is Status.DECODE]
            t_step = now()
            nxt = self._decode_step(active)
            t = now()
            emitted = len(active)
        if rs.t_last_decode is not None:
            gap = t_step - rs.t_last_decode
            self._m_gap.observe(gap)
            rs.max_gap = max(rs.max_gap, gap)
        rs.t_last_decode = t
        rs.steps += 1
        rs.step_time += t - t_step
        self._observe_step(rs, active, emitted, t - t_step)
        if not use_spec:
            for req in active:
                self.sched.record_token(req, int(nxt[req.slot]), t)
                if req.status is Status.DONE:
                    rs.done.append(req)
        self._ledger_tick(rs)
        return True

    def _observe_step(self, rs: _RunState, active: List[Request], emitted: int,
                      dur: float) -> None:
        """A decode step's (or speculative cycle's) metrics, JSONL event and
        flight-recorder record."""
        reg = self.registry
        slot_occ = len(active) / self.num_slots
        page_occ = self.pool.used_count / self.pool.capacity
        # seconds per token per slot: a plain step emits one token per
        # active slot, a speculative cycle may emit several
        self._m_tok_lat.observe(dur * len(active) / max(emitted, 1))
        self._m_steps.inc()
        self._m_tokens.inc(emitted)
        self._m_active.set(len(active))
        self._m_slot_occ.set(slot_occ)
        self._m_page_occ.set(page_occ)
        if reg.enabled:
            # fragmentation() sorts the free list: too heavy for the
            # disabled path's one-branch cost
            self._m_frag.set(self.pool.fragmentation())
            if self.prefix_cache is not None:
                # per step, not only on insert: pressure eviction happens
                # exactly when dashboards look
                self._m_cached.set(self.prefix_cache.cached_pages)
                self._m_evictable.set(self.prefix_cache.evictable_count())
        reg.event("serving.step", step=rs.steps, active=len(active),
                  queue_depth=len(self.sched.queue), dur_s=dur,
                  slot_occupancy=slot_occ, page_occupancy=page_occ,
                  tokens=emitted)
        if self.recorder is not None:
            self.recorder.observe_serving_step(
                rs.steps, active=len(active), queue_depth=len(self.sched.queue),
                dur_s=dur, tokens=emitted)

    def _output(self, r: Request) -> RequestOutput:
        e2e = r.t_done - r.t_submit
        if r.finish_reason == "shed":
            # never served: the whole life was queue wait, no TTFT
            return RequestOutput(
                uid=r.uid, prompt=np.asarray(r.prompt),
                generated=np.asarray(r.generated, np.int64),
                finish_reason="shed", queue_latency_s=e2e, ttft_s=None,
                decode_tokens_per_s=None, e2e_latency_s=e2e, tenant=r.tenant)
        self._m_e2e.observe(e2e)
        return RequestOutput(
            uid=r.uid, prompt=np.asarray(r.prompt),
            generated=np.asarray(r.generated, np.int64),
            finish_reason=r.finish_reason,
            queue_latency_s=r.t_admit - r.t_submit,
            ttft_s=r.t_first_token - r.t_submit,
            decode_tokens_per_s=len(r.generated) / max(r.t_done - r.t_admit, 1e-9),
            e2e_latency_s=e2e, tenant=r.tenant)

    def finish_run(self):
        """Close the run: (outputs in uid order, metrics dict)."""
        rs = self._run
        if rs is None:
            raise RuntimeError("finish_run needs start_run first")
        wall = max(rs.now() - rs.t0, 1e-9)
        # tokens/s from the counter's delta: the per-step instrumentation
        # checked against the run's own count
        self._m_tps.set((self._m_tokens.value - rs.tok0) / wall)
        outputs = [self._output(r) for r in sorted(rs.done, key=lambda r: r.uid)]
        served = [o.ttft_s for o in outputs if o.ttft_s is not None]
        generated = sum(len(o.generated) for o in outputs)
        metrics = {
            "wall_time_s": wall,
            "generated_tokens": generated,
            "decode_tokens_per_s": generated / wall,
            "decode_steps": rs.steps,
            "decode_step_time_s": rs.step_time,
            "prefills": rs.prefills,
            "mean_ttft_s": sum(served) / len(served) if served else 0.0,
            # prompt tokens forwarded through prefill (cache hits subtract)
            "prefill_tokens": rs.prefill_tokens,
            "shed_requests": sum(o.finish_reason == "shed" for o in outputs),
        }
        if self._paged_prefill:
            # as the JAX engine: a monolithic prefill is one forward per
            # request, counted in ``prefills``, and reports no chunks
            metrics["prefill_chunks"] = rs.chunks
            metrics["max_decode_gap_s"] = rs.max_gap
        if self.prefix_cache is not None:
            hit, fwd = rs.hit_tokens, rs.prefill_tokens
            metrics["prefix_cache"] = {
                "hit_tokens": hit,
                "prefill_tokens": fwd,
                "hit_rate": round(hit / (hit + fwd), 4) if hit + fwd else 0.0,
                "cached_pages": self.prefix_cache.cached_pages,
                "shared_pages_now": self.pool.shared_count,
                "cow_copies": rs.cow_copies,
            }
        if self.speculative is not None:
            metrics["speculative"] = {
                "draft_tokens": rs.spec_drafted,
                "accepted_tokens": rs.spec_accepted,
                "acceptance_rate": round(rs.spec_accepted / rs.spec_drafted, 4)
                if rs.spec_drafted else 0.0,
                "cycles": rs.spec_cycles,
                "tokens": rs.spec_tokens,
            }
        if self.memledger is not None:
            # peak per-class occupancy, fragmentation, leak and audit
            # verdicts: the run's memory trajectory in one block
            metrics["memory"] = self.memledger.run_summary()
        self._run = None
        return outputs, metrics


def make_skewed_replay(*, n_requests: int, n_prefixes: int, prefix_len: int,
                       suffix_lens: Sequence[int], max_new: int,
                       vocab: int, seed: int = 0, zipf_a: float = 1.2):
    """Synthetic heavy-traffic replay with SKEWED prompt reuse: each
    request's prompt is one of ``n_prefixes`` shared prefixes (drawn
    Zipf-style, rank r with weight 1/r^a) followed by a private random
    suffix. Returns a list of (prompt ndarray, max_new) pairs; every call
    with the same seed replays the identical trace (the JAX function's,
    draw for draw). The JAX function's tenant draws and working-set
    sizing wait for the fleet API."""
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(1, vocab, (prefix_len,)) for _ in range(n_prefixes)]
    weights = np.array([1.0 / (r + 1) ** zipf_a for r in range(n_prefixes)])
    weights /= weights.sum()
    specs = []
    for _ in range(n_requests):
        pfx = prefixes[rng.choice(n_prefixes, p=weights)]
        sfx = rng.randint(1, vocab, (int(rng.choice(suffix_lens)),))
        specs.append((np.concatenate([pfx, sfx]), max_new))
    return specs


def prefix_replay_benchmark(params, config, *, n_requests=12, n_prefixes=3,
                            prefix_len=16, suffix_lens=(2, 4, 6), max_new=6,
                            seed=0, zipf_a=1.2, num_slots=4, num_pages=64,
                            page_size=8, max_context=64, prefill_chunk=None,
                            include_speculative=False, speculative=(1, 3),
                            arms=None, measure=None, param_specs=None,
                            tp_axis="tensor", device="cuda"):
    """One skewed-prompt-reuse replay through (a) the baseline engine
    (monolithic prefill, no sharing), (b) chunked prefill, (c) the prefix
    cache, (d) both, and optionally (e) both + self-speculative decoding.
    Each arm runs twice to warm up (a cold run that seeds the cache, a
    warm one) and is measured on the third. Per arm: tokens/s, TTFT p50
    and p99 (the JAX histogram's quantile rule), prefill tokens forwarded,
    the largest decode-step gap, the hit rate and the acceptance rate;
    ``summary`` sets the cache arm against the baseline. JSON-able.

    ``arms`` ({label: engine keywords}) replaces (a)-(e), and then the
    summary is left out unless both "baseline" and "cached" are among
    them. ``measure(label, engine, run)``, if given, takes each measured
    run: it calls ``run()`` once and returns its (outputs, metrics), so a
    caller can read device counters around exactly that run.
    ``param_specs`` and ``tp_axis`` pass through to every arm's engine
    (tensor-parallel serving over the current context, every rank running
    the same replay). The JAX version's ``trace`` waits for the port's
    request tracer (ROADMAP.md queue A, A13a split (2)), ``include_quant``
    and ``include_tiered`` for its KV tiers (A12)."""
    vocab = getattr(config, "valid_vocab_size", None) or config.vocab_size
    replay = make_skewed_replay(
        n_requests=n_requests, n_prefixes=n_prefixes, prefix_len=prefix_len,
        suffix_lens=suffix_lens, max_new=max_new, vocab=vocab, seed=seed,
        zipf_a=zipf_a)

    def requests():
        return [Request(prompt=p, max_new_tokens=n) for p, n in replay]

    if arms is None:
        chunk = prefill_chunk or page_size
        arms = {
            "baseline": {},
            "chunked": {"prefill_chunk": chunk},
            "cached": {"prefix_cache": True},
            "cached+chunked": {"prefill_chunk": chunk, "prefix_cache": True},
        }
        if include_speculative:
            arms["cached+spec"] = {"prefill_chunk": chunk, "prefix_cache": True,
                                   "speculative": tuple(speculative)}
    results = {}
    for label, kw in arms.items():
        engine = ServingEngine(
            params, config, num_slots=num_slots, num_pages=num_pages,
            page_size=page_size, max_context=max_context, param_specs=param_specs,
            tp_axis=tp_axis, device=device, **kw)
        engine.run(requests())
        engine.run(requests())
        run = lambda: engine.run(requests())  # noqa: E731
        outs, metrics = measure(label, engine, run) if measure else run()
        ttft = [o.ttft_s for o in outs if o.ttft_s is not None]
        row = {
            "decode_tokens_per_s": metrics["decode_tokens_per_s"],
            "ttft_p50_s": _quantile(ttft, 0.5),
            "ttft_p99_s": _quantile(ttft, 0.99),
            "decode_steps": metrics["decode_steps"],
            "wall_time_s": metrics["wall_time_s"],
            "prefill_tokens": metrics["prefill_tokens"],
        }
        if "max_decode_gap_s" in metrics:
            row["max_decode_gap_s"] = metrics["max_decode_gap_s"]
        if "prefix_cache" in metrics:
            row["hit_rate"] = metrics["prefix_cache"]["hit_rate"]
        if "speculative" in metrics:
            row["spec_acceptance_rate"] = metrics["speculative"]["acceptance_rate"]
        results[label] = row
    if "baseline" not in results or "cached" not in results:
        return results
    base, cached = results["baseline"], results["cached"]
    results["summary"] = {
        "requests": n_requests,
        "shared_prefix_len": prefix_len,
        "hit_rate": cached.get("hit_rate", 0.0),
        "prefill_token_reduction": round(
            1.0 - cached["prefill_tokens"] / max(base["prefill_tokens"], 1), 4),
        "ttft_p99_speedup": round(
            base["ttft_p99_s"] / max(cached["ttft_p99_s"], 1e-9), 3),
        "tokens_per_s_speedup": round(
            cached["decode_tokens_per_s"]
            / max(base["decode_tokens_per_s"], 1e-9), 3),
    }
    return results
