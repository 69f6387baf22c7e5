"""Pipeline schedules as timetables: host code, no tensor.

The counterpart of ``pipegoose_tpu/nn/pipeline_parallel/scheduler.py``,
with the same names and results. A task is (microbatch_idx,
partition_idx); GPipe's clock c runs every task with ``microbatch_idx +
partition_idx == c`` (torchgpipe § 3.2.1). ``one_f_one_b_tables`` compiles
the 1F1B per-stage instruction streams into the global clock timetable
that ``pipeline.one_f_one_b`` walks eagerly on every rank, so that every
rank enters every clock's transfers in the same order.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List

import numpy as np


class JobType(str, enum.Enum):
    FORWARD = "forward"
    BACKWARD = "backward"


@dataclasses.dataclass(frozen=True)
class Task:
    job_type: JobType
    microbatch_idx: int
    partition_idx: int


class GPipeScheduler:
    """The GPipe clock-cycle timeline. The backward timeline describes what
    autograd does through ``pipeline.gpipe``: the clocks replayed in
    reverse with the job types flipped."""

    def __init__(self, n_microbatches: int, n_partitions: int):
        assert n_microbatches >= 1 and n_partitions >= 1
        self.n_microbatches = n_microbatches
        self.n_partitions = n_partitions

    @property
    def total_forward_clocks(self) -> int:
        return self.n_microbatches + self.n_partitions - 1

    @property
    def total_backward_clocks(self) -> int:
        return self.total_forward_clocks

    @property
    def bubble_fraction(self) -> float:
        """Idle share of the stage-clock grid: P stages over M + P - 1
        clocks hold M tasks each, so (P-1)/(M+P-1) of every stage's
        timeline is bubble (torchgpipe §3.3; identical for the forward
        and backward halves, and for the 1F1B reordering: it moves the
        idle clocks, it does not remove them)."""
        return (self.n_partitions - 1) / self.total_forward_clocks

    def get_forward_schedules(self) -> List[List[Task]]:
        """clock -> tasks, forward: task (m, p) runs at clock m + p."""
        out: List[List[Task]] = []
        for c in range(self.total_forward_clocks):
            tasks = [
                Task(JobType.FORWARD, m, c - m)
                for m in range(self.n_microbatches)
                if 0 <= c - m < self.n_partitions
            ]
            out.append(tasks)
        return out

    def get_backward_schedules(self) -> List[List[Task]]:
        """Reverse of forward with flipped job type: the order in which
        autograd visits the forward clocks."""
        fwd = self.get_forward_schedules()
        return [
            [Task(JobType.BACKWARD, t.microbatch_idx, t.partition_idx) for t in tasks]
            for tasks in reversed(fwd)
        ]


def one_f_one_b_tables(n_microbatches: int, n_partitions: int):
    """Compile the 1F1B per-stage instruction streams into a global
    clock timetable for the runtime (``pipeline.one_f_one_b``).

    Greedy list-scheduling of each stage's ``timeline`` under the data
    dependencies of a pipeline with one-clock transfers:
    F(m, p) needs F(m, p-1) at an earlier clock (activation arrives the
    clock after it was produced); B(m, p) needs B(m, p+1) earlier (for
    the cotangent) — B(m, P-1) only needs its own F, which stream order
    guarantees. Each stage executes at most ONE instruction per clock.

    Returns ``(fwd, bwd, n_slots, n_clock)`` where ``fwd``/``bwd`` are
    (n_clock, P) int arrays holding the microbatch index executed by
    stage p at clock c (or -1), and ``n_slots`` is the verified ring
    size bounding simultaneously-live saved activations / in-transit
    values per stage (<= P + 1, the 1F1B memory guarantee).
    """
    M, P = n_microbatches, n_partitions
    streams = [OneFOneBScheduler(M, P).timeline(p) for p in range(P)]
    ptrs = [0] * P
    f_done: dict = {}
    b_done: dict = {}
    fwd_rows, bwd_rows = [], []
    c = 0
    while any(ptrs[p] < len(streams[p]) for p in range(P)):
        fwd_row = [-1] * P
        bwd_row = [-1] * P
        progressed = False
        for p in range(P):
            if ptrs[p] >= len(streams[p]):
                continue
            t = streams[p][ptrs[p]]
            m = t.microbatch_idx
            if t.job_type == JobType.FORWARD:
                ready = p == 0 or f_done.get((m, p - 1), c) < c
                if ready:
                    fwd_row[p] = m
                    f_done[(m, p)] = c
                    ptrs[p] += 1
                    progressed = True
            else:
                ready = (p == P - 1) or b_done.get((m, p + 1), c) < c
                if ready:
                    bwd_row[p] = m
                    b_done[(m, p)] = c
                    ptrs[p] += 1
                    progressed = True
        assert progressed, f"1F1B schedule deadlocked at clock {c} (M={M}, P={P})"
        fwd_rows.append(fwd_row)
        bwd_rows.append(bwd_row)
        c += 1

    # verify the ring bound: three per-stage buffer families, each keyed
    # by microbatch and indexed m % n_slots —
    #   act:    saved stage input, live [F(m,p), B(m,p)]
    #   recv_h: in-transit activation, live [F(m,p-1)+1, F(m,p)]
    #   recv_g: in-transit cotangent, live [B(m,p+1)+1, B(m,p)]
    span_families = []
    for p in range(P):
        span_families.append([(f_done[(m, p)], b_done[(m, p)]) for m in range(M)])
        if p > 0:
            span_families.append(
                [(f_done[(m, p - 1)] + 1, f_done[(m, p)]) for m in range(M)]
            )
        if p < P - 1:
            span_families.append(
                [(b_done[(m, p + 1)] + 1, b_done[(m, p)]) for m in range(M)]
            )

    def max_overlap(spans):
        return max(
            sum(1 for s2, e2 in spans if s2 <= s <= e2) for s, e in spans
        )

    n_slots = min(M, max(max_overlap(sp) for sp in span_families))
    for spans in span_families:
        for m1 in range(M):
            for m2 in range(m1 + 1, M):
                if m1 % n_slots == m2 % n_slots:
                    s1, e1 = spans[m1]
                    s2, e2 = spans[m2]
                    assert e1 < s2 or e2 < s1, (
                        f"ring collision: microbatches {m1},{m2} share a slot "
                        f"(n_slots={n_slots}, spans {spans[m1]} vs {spans[m2]})"
                    )
    return (
        np.asarray(fwd_rows, np.int32),
        np.asarray(bwd_rows, np.int32),
        n_slots,
        c,
    )


class OneFOneBScheduler(GPipeScheduler):
    """1F1B (PipeDream-flush) ordering: same total clocks, but each
    stage starts its backward as soon as its first microbatch returns,
    bounding live activations at ``n_partitions`` instead of
    ``n_microbatches``; ``pipeline.one_f_one_b`` runs its timetable."""

    def tables(self):
        """Cached ``one_f_one_b_tables`` result: the (fwd, bwd, n_slots,
        n_clock) global clock timetable the runtime executes."""
        if getattr(self, "_tables", None) is None:
            self._tables = one_f_one_b_tables(
                self.n_microbatches, self.n_partitions
            )
        return self._tables

    @property
    def n_clock(self) -> int:
        return int(self.tables()[3])

    @property
    def bubble_fraction(self) -> float:
        """Idle share of the actual 1F1B timetable (not the
        inherited GPipe formula): each stage executes 2M instructions
        (one F and one B per microbatch) over ``n_clock`` clocks, so
        the per-stage-averaged idle share is ``1 - 2M/n_clock``. Equals
        GPipe's (P-1)/(M+P-1) whenever the greedy timetable achieves
        the PipeDream-flush bound of 2(M+P-1) clocks, and reports the
        true number when list-scheduling needs extra clocks."""
        return 1.0 - (2.0 * self.n_microbatches) / self.n_clock

    def timeline(self, partition_idx: int) -> List[Task]:
        """Per-stage instruction stream: warmup forwards, steady 1F1B
        pairs, cooldown backwards."""
        M, P = self.n_microbatches, self.n_partitions
        warmup = min(P - partition_idx - 1, M)
        steps: List[Task] = []
        fwd_m = bwd_m = 0
        for _ in range(warmup):
            steps.append(Task(JobType.FORWARD, fwd_m, partition_idx))
            fwd_m += 1
        while fwd_m < M:
            steps.append(Task(JobType.FORWARD, fwd_m, partition_idx))
            fwd_m += 1
            steps.append(Task(JobType.BACKWARD, bwd_m, partition_idx))
            bwd_m += 1
        while bwd_m < M:
            steps.append(Task(JobType.BACKWARD, bwd_m, partition_idx))
            bwd_m += 1
        return steps
