"""Scheduler: token-budget continuous batching (decode-first policy).

One engine step is one plan filled against ``step_token_budget``:

1. **Admit** — waiting requests take free slots, FIFO (the head blocks
   rather than being skipped) while the pool's byte budget allows.
2. **Decode first** — every live stream decodes one token per step.
3. **Prefill with the remainder** — leftover budget is spent on
   chunked-prefill segments of at most ``prefill_chunk`` real tokens,
   oldest prefilling stream first.  Non-final segments are exactly
   ``prefill_chunk`` tokens; with nothing decoding at least one segment
   always runs, so the queue cannot stall.

A preempted request re-enters the queue at the head holding its
generated prefix and re-prefills ``prompt + output`` on readmission.
Priority classes, deadlines, cancellation and load shedding come with
ROADMAP item A12.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

PyTree = Any

#: admission pads prompts (and prefill chunks) up to at least this
#: power-of-2 length bucket
PREFILL_BUCKET_MIN = 8

#: terminal request states
STATUSES = ("finished", "failed", "dropped")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int | None = None
    #: preemption-retry budget: one more eviction terminates ``dropped``
    max_preemptions: int = 8
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str | None = None
    submit_time: float | None = None
    first_token_time: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0

    @property
    def ttft(self) -> float | None:
        """Time to first token (seconds), once both ends are stamped."""
        if self.submit_time is None or self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


@dataclasses.dataclass
class PrefillStream:
    """An admitted request whose prompt is being prefilled in chunks."""
    req: Request
    slot: int
    tokens: list[int]            # prompt (+ generated prefix if resumed)
    written: int = 0             # real prompt tokens already processed
    cache: PyTree = None         # full-width staging cache (lazy)
    last_logits: Any = None      # (V,) logits at the last real row seen

    @property
    def remaining(self) -> int:
        return len(self.tokens) - self.written


class Scheduler:
    """Request lifecycle + per-step segment planning."""

    def __init__(self, slots: int, *, prefill_chunk: int,
                 step_token_budget: int):
        self.slots = slots
        self.prefill_chunk = max(1, prefill_chunk)
        self.step_token_budget = max(1, step_token_budget)
        self.waiting: deque[Request] = deque()
        self.prefilling: list[PrefillStream] = []
        self.active: list[Request | None] = [None] * slots
        self.finished: list[Request] = []
        self.preemptions = 0
        self.admit_failures = 0

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def terminal(self, req: Request, status: str) -> Request:
        """The single exit point: stamp ``status``, mark done, record."""
        if status not in STATUSES:
            raise ValueError(f"unknown terminal status {status!r}")
        req.status = status
        req.done = True
        self.finished.append(req)
        return req

    def busy(self) -> bool:
        return bool(self.waiting or self.prefilling
                    or any(r is not None for r in self.active))

    def live_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active) if r is not None]

    def admit(self, pool) -> list[PrefillStream]:
        """Move waiting requests into free slots while the byte budget
        allows (FIFO)."""
        started: list[PrefillStream] = []
        for slot in pool.free_slots():
            if not self.waiting:
                break
            req = self.waiting[0]
            toks = list(req.prompt) + list(req.output)
            if not pool.can_admit(len(toks)):
                self.admit_failures += 1
                break
            pool.allocate(slot, len(toks))
            self.waiting.popleft()
            ps = PrefillStream(req, slot, toks)
            self.prefilling.append(ps)
            started.append(ps)
        return started

    def activate(self, ps: PrefillStream) -> None:
        self.prefilling.remove(ps)
        self.active[ps.slot] = ps.req

    def _take(self, slot: int) -> Request:
        """Detach the request in ``slot`` (decode-live or mid-prefill)."""
        req = self.active[slot]
        if req is not None:
            self.active[slot] = None
            return req
        ps = next(p for p in self.prefilling if p.slot == slot)
        self.prefilling.remove(ps)
        return ps.req

    def finish(self, slot: int) -> Request:
        return self.terminal(self._take(slot), "finished")

    def quarantine(self, slot: int) -> Request:
        """Terminate the stream in ``slot`` as ``failed`` (its logits went
        non-finite); the caller reclaims the pool slot."""
        return self.terminal(self._take(slot), "failed")

    def preempt(self, slot: int) -> Request:
        """Evict the stream in ``slot``: requeue it at the head with its
        generated prefix, or past its retry budget terminate it
        ``dropped``."""
        req = self._take(slot)
        req.preemptions += 1
        self.preemptions += 1
        if req.preemptions > req.max_preemptions:
            self.terminal(req, "dropped")
        else:
            self.waiting.appendleft(req)
        return req

    def prefill_quota(self, n_live: int) -> int:
        """Real prefill tokens this step may spend (never zero when
        nothing is decoding)."""
        quota = self.step_token_budget - n_live
        if n_live == 0:
            quota = max(quota, 1)
        return max(quota, 0)

    def chunk_plan(self, n_live: int) -> list[tuple[PrefillStream, int]]:
        """(stream, real-token chunk length) segments for this step,
        oldest prefilling stream first, until the quota is spent."""
        quota = self.prefill_quota(n_live)
        plan: list[tuple[PrefillStream, int]] = []
        for ps in self.prefilling:
            if quota <= 0:
                break
            c = min(self.prefill_chunk, quota, ps.remaining)
            if c <= 0:
                continue
            if c < self.prefill_chunk and c < ps.remaining:
                continue    # runt non-final segment: wait a step
            plan.append((ps, c))
            quota -= c
        if not plan and self.prefilling and n_live == 0:
            ps = self.prefilling[0]
            c = min(self.prefill_chunk, max(quota, 1), ps.remaining)
            if c > 0:
                plan.append((ps, c))
        return plan
