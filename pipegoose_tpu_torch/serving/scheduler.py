"""Continuous-batching scheduler: request lifecycle + slot/page admission.

The counterpart of ``pipegoose_tpu/serving/scheduler.py``. The request
lifecycle is QUEUED -> PREFILL -> DECODE -> DONE, over a fixed number of
decode SLOTS:

- **admission** pops the FIFO queue into free slots whenever the page
  pool can cover the candidate's WORST-CASE footprint
  (``ceil((prompt + max_new) / page_size)``) on top of every active
  request's outstanding reservation. Pages are then allocated LAZILY:
  the first prefill chunk's pages at admission, later chunks' and decode
  pages as the write position crosses a page boundary, so short-finishing
  requests never hold their worst case, while the reservation arithmetic
  guarantees a lazy ``alloc`` never fails mid-flight. FIFO head-of-line
  blocking keeps the schedule deterministic. Queued requests past their
  ``deadline_s`` are SHED at admission.
- **prefix caching** (``prefix_cache=PrefixCache(pool)``): the longest
  cached prefix of the prompt is SHARED (a refcount, no alloc, no
  prefill) and only the unique tail is prefilled, after a copy-on-write
  of a partly matched page. The ledger then counts ``free + evictable``
  as capacity and debits the pages a hit pins, and ``_alloc`` evicts
  least-recently-used cache pages on demand; where that cannot cover a
  reservation, it retracts the newest other request.
- **eviction** frees a finished request's pages and reservation the step
  its last token is emitted (shared pages drop a reference). ``preempt``
  is the mid-flight variant: every page goes back and the request
  re-queues ahead of fresh arrivals, to re-prefill ``prompt +
  generated[:-1]`` and resume decoding token for token.

``continuous=False`` admits a batch only into an empty slot set and
drains it fully before the next: the naive padded baseline of an A/B.

With a memory ledger on the pool (``telemetry.memledger``), every alloc
and release names its owner (``PagePool``'s ``owner=``) and admission reports the
queue head's worst-case need (``note_admission``). With a request tracer
(``telemetry.RequestTracer``, ``tracer=``) the scheduler drives its
lifecycle hooks: submit, shed, admit, preempt, first token and done. Every
admission the ledger defers counts in ``admission_deferrals``, the goodput
ledger's admission-blocked signal. The disaggregated transfers with their
ledger tags and tracer hooks, ``withdraw`` and ``capacity_snapshot`` wait
for the port's fleet layer (ROADMAP.md queue A, item A12).
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from pipegoose_tpu_torch.serving.kv_pool import PagePool


class Status(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclass
class Request:
    """One generation request. Engine/scheduler fill the lifecycle
    fields; callers provide the first three, and optionally a deadline
    (seconds from submit after which a still-queued request is shed) and
    a tenant name."""

    prompt: np.ndarray                 # (S,) token ids
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    deadline_s: Optional[float] = None
    tenant: Optional[str] = None

    uid: Optional[int] = None
    # the fleet tracer's join key (telemetry.FleetTracer.on_ingress): uids
    # are scheduler-local, the trace id follows the request across replicas
    trace_id: Optional[int] = None
    status: Status = Status.QUEUED
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    pages: List[int] = field(default_factory=list)
    outstanding: int = 0               # worst-case pages not yet allocated
    prefilled_len: int = 0             # tokens whose KV is in pages + forwarded
    hit_tokens: int = 0                # of those, tokens served by the cache
    cow: Optional[Tuple[int, int]] = None  # (src page, valid tokens) pending copy
    finish_reason: Optional[str] = None
    # t_submit, t_admit and t_first_token mark the FIRST submission,
    # admission and token and survive preempt -> re-admit, so queue
    # latency and TTFT measure what the user waited
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    ttft_observed: bool = False

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[0])

    @property
    def cached_len(self) -> int:
        """Tokens currently in the KV pages: the whole prompt plus every
        generated token except the pending one (the decode step writes
        the pending token before attending)."""
        return self.prompt_len + max(len(self.generated) - 1, 0)

    @property
    def target_len(self) -> int:
        """Tokens a (re-)prefill must put in the pages before decoding can
        resume: the prompt, and after a preemption every generated token
        but the pending last one."""
        return self.cached_len

    @property
    def tokens(self) -> np.ndarray:
        return np.concatenate(
            [np.asarray(self.prompt, np.int64),
             np.asarray(self.generated, np.int64)])


class Scheduler:
    """``retractions`` counts the requests that ``_alloc`` preempted to
    keep a reservation, ``admission_deferrals`` the admissions the ledger
    deferred (the head did not fit). ``tracer`` (None by default: one
    attribute read and branch per lifecycle event) takes the request
    tracer's lifecycle hooks."""

    def __init__(self, num_slots: int, pool: PagePool, max_context: int,
                 continuous: bool = True, prefix_cache=None,
                 chunk_tokens: Optional[int] = None, tracer=None):
        if num_slots < 1:
            raise ValueError("need at least one decode slot")
        if chunk_tokens is not None and (
                chunk_tokens < pool.page_size or chunk_tokens % pool.page_size):
            raise ValueError(
                f"chunk_tokens={chunk_tokens} must be a positive multiple "
                f"of page_size={pool.page_size} (a chunk that starts on a "
                f"page boundary ends on one)")
        self.num_slots = num_slots
        self.pool = pool
        self.max_context = max_context
        self.continuous = continuous
        self.cache = prefix_cache
        self.chunk_tokens = chunk_tokens
        self.tracer = tracer
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.queue: deque = deque()
        self.shed: List[Request] = []   # shed since the last drain_shed()
        self._outstanding_total = 0
        self._next_uid = 0
        self.retractions = 0
        self.admission_deferrals = 0

    def _worst_tokens(self, req: Request) -> int:
        return req.prompt_len + req.max_new_tokens

    # -- lifecycle ---------------------------------------------------------

    def submit(self, req: Request, now: float) -> None:
        worst = self.pool.pages_for(self._worst_tokens(req))
        if req.prompt_len < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.deadline_s is not None and req.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {req.deadline_s}")
        if self._worst_tokens(req) > self.max_context:
            raise ValueError(
                f"request needs {self._worst_tokens(req)} "
                f"context but the engine was sized for {self.max_context}")
        if worst > self.pool.capacity:
            raise ValueError(
                f"request worst case is {worst} pages but the pool only "
                f"has {self.pool.capacity}")
        req.uid = self._next_uid
        self._next_uid += 1
        if req.t_submit is None:
            req.t_submit = now
        req.status = Status.QUEUED
        self.queue.append(req)
        if self.tracer is not None:
            self.tracer.on_submit(req, now)

    def _shed_expired(self, now: float) -> None:
        """Drop QUEUED requests already past their deadline into
        ``self.shed`` (terminal, finish_reason="shed"). Only requests never
        admitted shed: an admitted one, preempted back into the queue
        included (``t_admit`` set), has paid its prefill and runs on."""
        if not any(r.deadline_s is not None for r in self.queue):
            return
        kept: deque = deque()
        for req in self.queue:
            if (req.deadline_s is not None and req.t_admit is None
                    and req.t_submit is not None
                    and now - req.t_submit > req.deadline_s):
                req.status = Status.DONE
                req.finish_reason = "shed"
                req.t_done = now
                self.shed.append(req)
                if self.tracer is not None:
                    self.tracer.on_shed(req, now)
            else:
                kept.append(req)
        self.queue = kept

    def drain_shed(self) -> List[Request]:
        """Requests shed since the last drain."""
        out, self.shed = self.shed, []
        return out

    def _admission_check(self, req: Request):
        """The admission ledger, changing nothing: can free pages, plus
        evictable cache pages, minus the pages a hit would pin, cover
        ``req``'s worst case beyond every outstanding reservation?
        Returns ``(fits, hit)``; :meth:`admit` and :meth:`can_admit` both
        read it."""
        target = req.target_len
        worst = self.pool.pages_for(self._worst_tokens(req))
        hit = None
        shared: List[int] = []
        evictable = pinned = 0
        if self.cache is not None and (
                self.pool.free_count + self.cache.cached_pages
                - self._outstanding_total
                < worst - (target - 1) // self.pool.page_size):
            # cannot fit even if every cached page were evictable and the
            # hit the longest possible: skip the trie walk and scan
            return False, None
        if self.cache is not None:
            # >= 1 token must be forwarded: its logits give the next token
            hit = self.cache.lookup(req.tokens[:target], max_tokens=target - 1)
            shared = hit.pages
            pins = shared + ([hit.cow_page] if hit.cow_page is not None else [])
            pinned = sum(1 for p in pins if self.pool.refcount(p) == 1)
            evictable = self.cache.evictable_count()
        need_new = worst - len(shared)
        if (self.pool.free_count + evictable - pinned
                - self._outstanding_total < need_new):
            return False, hit
        return True, hit

    def can_admit(self, req: Request) -> bool:
        """Would :meth:`admit` admit ``req`` now from the queue's head?
        Reserves, pins and touches nothing."""
        if not any(s is None for s in self.slots):
            return False
        if not self.continuous and any(s is not None for s in self.slots):
            return False
        return self._admission_check(req)[0]

    def admit(self, now: float) -> List[Request]:
        """Shed expired queued requests, then move queued requests into
        free slots while the ledger covers their worst case. A cache hit
        shares its pages and shortens the prefill. Returns the newly
        admitted requests (they still need a prefill of their tail)."""
        self._shed_expired(now)
        admitted: List[Request] = []
        if not self.continuous and any(s is not None for s in self.slots):
            return admitted  # padded batching: drain before refill
        while self.queue:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            req = self.queue[0]
            target = req.target_len
            worst = self.pool.pages_for(self._worst_tokens(req))
            fits, hit = self._admission_check(req)
            led = self.pool.ledger
            if led is not None:
                # the exhaustion forecaster's feed: the head's worst-case
                # need, and whether memory let it in
                led.note_admission(worst, fits)
            if not fits:
                self.admission_deferrals += 1
                break  # FIFO head-of-line: deterministic admission order
            shared: List[int] = hit.pages if hit is not None else []
            need_new = worst - len(shared)
            self.queue.popleft()
            req.slot = free_slots[0]
            self.slots[req.slot] = req
            req.status = Status.PREFILL
            if req.t_admit is None:
                req.t_admit = now
            req.cow = None
            req.pages = []
            req.prefilled_len = req.hit_tokens = 0
            if hit is not None:
                self.cache.acquire(hit, owner=req.uid)   # pins shared + COW source
                req.pages = list(shared)
                req.prefilled_len = hit.tokens
                req.hit_tokens = hit.total_tokens
                if hit.cow_page is not None:
                    req.cow = (hit.cow_page, hit.cow_tokens)
            cow_tokens = req.cow[1] if req.cow else 0
            # after a COW the first chunk ends cow_tokens past a boundary
            chunk_end = target if self.chunk_tokens is None else min(
                req.prefilled_len + cow_tokens + self.chunk_tokens, target)
            n_now = self.pool.pages_for(chunk_end) - len(req.pages)
            req.pages += self._alloc(n_now, req)
            req.outstanding = need_new - n_now
            self._outstanding_total += req.outstanding
            admitted.append(req)
            if self.tracer is not None:
                self.tracer.on_admit(req, now)
        return admitted

    def preempt(self, req: Request) -> None:
        """Give back every page of a live request (cache-shared ones stay
        in the cache for the re-admission to hit) and re-queue it ahead of
        never-admitted arrivals, in original submit order among preempted
        peers. Generated tokens are kept; re-admission re-prefills
        ``prompt + generated[:-1]`` and decode resumes."""
        if req.status not in (Status.PREFILL, Status.DECODE):
            raise ValueError(f"cannot preempt a {req.status.value} request")
        self._release_all(req)
        self._outstanding_total -= req.outstanding
        req.outstanding = 0
        self.slots[req.slot] = None
        req.slot = None
        req.prefilled_len = req.hit_tokens = 0
        req.status = Status.QUEUED
        pos = 0
        while (pos < len(self.queue)
               and self.queue[pos].t_admit is not None
               and self.queue[pos].uid < req.uid):
            pos += 1
        self.queue.insert(pos, req)
        if self.tracer is not None:
            self.tracer.on_preempt(req)

    def ensure_pages(self, req: Request, n_tokens: int) -> None:
        """Lazy growth to cover ``n_tokens`` cached positions (decode: one
        past the pending write; chunked prefill: the chunk's end;
        speculation: the bundle's end). Cannot fail: admission reserved
        the worst case against free + evictable pages, and the one hole
        in that ledger (a later ``insert`` hanging a live request's child
        under a node an earlier admission counted as evictable) is closed
        by retraction: ``_alloc(owner=req)`` preempts the newest other
        active request. Callers iterating a batch must re-check each
        request's status after a neighbour's growth."""
        if req.status not in (Status.PREFILL, Status.DECODE):
            raise RuntimeError(
                f"ensure_pages on a {req.status.value} request "
                f"(retracted mid-batch by a neighbour's lazy growth?)")
        while len(req.pages) * self.pool.page_size < n_tokens:
            req.pages += self._alloc(1, req, retract=True)
            req.outstanding -= 1
            self._outstanding_total -= 1

    def ensure_page(self, req: Request) -> None:
        """Decode-step growth: cover the pending token's write position."""
        self.ensure_pages(req, req.cached_len + 1)

    def record_token(self, req: Request, token: int, now: float) -> None:
        if req.t_first_token is None:
            req.t_first_token = now
            if self.tracer is not None:
                self.tracer.on_first_token(req, now)
        req.status = Status.DECODE
        req.generated.append(int(token))
        if req.eos_token_id is not None and int(token) == req.eos_token_id:
            self._finish(req, "eos", now)
        elif len(req.generated) >= req.max_new_tokens:
            self._finish(req, "length", now)

    def _alloc(self, n: int, req: Request, retract: bool = False) -> List[int]:
        """Pool alloc of ``n`` pages for ``req`` that treats LRU-evictable
        cache pages as free. With ``retract`` (the must-not-fail growth
        path) a shortfall eviction cannot cover retracts the newest other
        active requests until it can. Admission does not retract: its
        check and alloc are atomic."""
        if n <= 0:
            return []
        if self.cache is not None and self.pool.free_count < n:
            self.cache.evict(n - self.pool.free_count)
            if self.pool.free_count < n and retract:
                for victim in sorted(
                        (r for r in self.slots
                         if r is not None and r is not req),
                        key=lambda r: r.uid, reverse=True):
                    self.preempt(victim)
                    self.retractions += 1
                    self.cache.evict(n - self.pool.free_count)
                    if self.pool.free_count >= n:
                        break
        return self.pool.alloc(n, owner=("req", req.uid))

    def _release_all(self, req: Request) -> None:
        if req.cow is not None:          # COW never ran: drop its pin
            self.pool.release([req.cow[0]], owner=("cow", req.uid))
            req.cow = None
        if req.pages:
            self.pool.release(req.pages, owner=("req", req.uid))
            req.pages = []

    def _finish(self, req: Request, reason: str, now: float) -> None:
        req.status = Status.DONE
        req.finish_reason = reason
        req.t_done = now
        self._release_all(req)
        self._outstanding_total -= req.outstanding
        req.outstanding = 0
        self.slots[req.slot] = None
        if self.tracer is not None:
            self.tracer.on_done(req, now)

    # -- queries -----------------------------------------------------------

    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def all_done(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)
