"""Continuous-batching scheduler: request lifecycle + slot/page admission.

The counterpart of ``pipegoose_tpu/serving/scheduler.py``, for chunked
prefill without a prefix cache. The request lifecycle is QUEUED ->
PREFILL -> DECODE -> DONE, over a fixed number of decode SLOTS:

- **admission** pops the FIFO queue into free slots whenever the page
  pool can cover the candidate's WORST-CASE footprint
  (``ceil((prompt + max_new) / page_size)``) on top of every active
  request's outstanding reservation. Pages are then allocated LAZILY:
  the first prefill chunk's pages at admission, later chunks' and decode
  pages as the write position crosses a page boundary, so short-finishing
  requests never hold their worst case, while the reservation arithmetic
  guarantees a lazy ``alloc`` can never fail mid-flight. FIFO
  head-of-line blocking keeps the schedule deterministic.
- **eviction** frees a finished request's pages and reservation the step
  its last token is emitted, so the next ``admit`` can reuse both.

Prefix caching, deadline shedding, preemption and disaggregated
transfers wait for later slices of the port (ROADMAP.md queue A).
"""
from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

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
    fields; callers provide the first three."""

    prompt: np.ndarray                 # (S,) token ids
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    # deadline shedding is not ported yet: a deadline is refused at submit
    deadline_s: Optional[float] = None

    uid: Optional[int] = None
    status: Status = Status.QUEUED
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    pages: List[int] = field(default_factory=list)
    outstanding: int = 0               # worst-case pages not yet allocated
    prefilled_len: int = 0             # tokens whose KV is in pages + forwarded
    finish_reason: Optional[str] = None
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

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
        """Tokens prefill must put in the pages before decoding starts."""
        return self.cached_len

    @property
    def tokens(self) -> np.ndarray:
        return np.concatenate(
            [np.asarray(self.prompt, np.int64),
             np.asarray(self.generated, np.int64)])


class Scheduler:
    def __init__(self, num_slots: int, pool: PagePool, max_context: int,
                 chunk_tokens: Optional[int] = None, prefix_cache=None):
        if prefix_cache is not None:
            raise NotImplementedError(
                "prefix caching is not ported yet (ROADMAP.md queue A, "
                "prefix cache and COW)")
        if num_slots < 1:
            raise ValueError("need at least one decode slot")
        if chunk_tokens is not None and (
                chunk_tokens < pool.page_size or chunk_tokens % pool.page_size):
            raise ValueError(
                f"chunk_tokens={chunk_tokens} must be a positive multiple "
                f"of page_size={pool.page_size} (chunks end on page "
                f"boundaries so every chunk's pages exist before it runs)")
        self.num_slots = num_slots
        self.pool = pool
        self.max_context = max_context
        self.chunk_tokens = chunk_tokens
        self.slots: List[Optional[Request]] = [None] * num_slots
        self.queue: deque = deque()
        self._outstanding_total = 0
        self._next_uid = 0

    def _worst_tokens(self, req: Request) -> int:
        return req.prompt_len + req.max_new_tokens

    # -- lifecycle ---------------------------------------------------------

    def submit(self, req: Request, now: float) -> None:
        worst = self.pool.pages_for(self._worst_tokens(req))
        if req.prompt_len < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.deadline_s is not None:
            raise NotImplementedError(
                "deadline shedding is not ported yet (ROADMAP.md queue A)")
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

    def admit(self, now: float) -> List[Request]:
        """Move queued requests into free slots while the pool can cover
        their worst case beyond all outstanding reservations. Returns the
        newly admitted requests (they still need their prefill)."""
        admitted: List[Request] = []
        while self.queue:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            req = self.queue[0]
            worst = self.pool.pages_for(self._worst_tokens(req))
            if self.pool.free_count - self._outstanding_total < worst:
                break  # FIFO head-of-line: deterministic admission order
            self.queue.popleft()
            req.slot = free_slots[0]
            self.slots[req.slot] = req
            req.status = Status.PREFILL
            if req.t_admit is None:
                req.t_admit = now
            req.prefilled_len = 0
            target = req.target_len
            chunk_end = target if self.chunk_tokens is None else min(
                self.chunk_tokens, target)
            n_now = self.pool.pages_for(chunk_end)
            req.pages = self.pool.alloc(n_now)
            req.outstanding = worst - n_now
            self._outstanding_total += req.outstanding
            admitted.append(req)
        return admitted

    def ensure_pages(self, req: Request, n_tokens: int) -> None:
        """Lazy growth to cover ``n_tokens`` cached positions (decode: one
        past the pending write; chunked prefill: the chunk's end). Cannot
        fail: admission reserved the worst case."""
        if req.status not in (Status.PREFILL, Status.DECODE):
            raise RuntimeError(f"ensure_pages on a {req.status.value} request")
        while len(req.pages) * self.pool.page_size < n_tokens:
            req.pages += self.pool.alloc(1)
            req.outstanding -= 1
            self._outstanding_total -= 1

    def ensure_page(self, req: Request) -> None:
        """Decode-step growth: cover the pending token's write position."""
        self.ensure_pages(req, req.cached_len + 1)

    def record_token(self, req: Request, token: int, now: float) -> None:
        if req.t_first_token is None:
            req.t_first_token = now
        req.status = Status.DECODE
        req.generated.append(int(token))
        if req.eos_token_id is not None and int(token) == req.eos_token_id:
            self._finish(req, "eos", now)
        elif len(req.generated) >= req.max_new_tokens:
            self._finish(req, "length", now)

    def _finish(self, req: Request, reason: str, now: float) -> None:
        req.status = Status.DONE
        req.finish_reason = reason
        req.t_done = now
        if req.pages:
            self.pool.release(req.pages)
            req.pages = []
        self._outstanding_total -= req.outstanding
        req.outstanding = 0
        self.slots[req.slot] = None

    # -- queries -----------------------------------------------------------

    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def all_done(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)
