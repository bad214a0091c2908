"""Scheduler: token-budget continuous batching (decode-first policy).

One engine step is one plan filled against ``step_token_budget``:

1. **Preempt** — over the pool's byte budget the youngest streams are
   evicted; an evicted request re-enters the queue at the head holding
   its generated prefix and re-prefills ``prompt + output`` on
   readmission.
2. **Admit** — waiting requests take free slots while the pool allows.
   The queue is a :class:`ClassedQueue`: FIFO within a priority class,
   ``interactive`` ahead of ``batch`` (pure submission order when
   ``priority_aware=False``); the head blocks rather than being skipped.
3. **Decode first** — every live stream decodes one token per step.
4. **Prefill with the remainder** — leftover budget is spent on
   chunked-prefill segments of at most ``prefill_chunk`` real tokens,
   interactive streams first, oldest first.  Non-final segments are
   exactly ``prefill_chunk`` tokens; with nothing decoding at least one
   segment always runs, so the queue cannot stall.

Every request that leaves carries one of :data:`STATUSES`.
:class:`LoadShedder` is the engine's pressure-watching hysteresis switch
(:class:`DegradationPolicy` its watermarks).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

from repro_torch.serve.paging import PoolExhausted

PyTree = Any

#: admission pads prompts (and prefill chunks) up to at least this
#: power-of-2 length bucket
PREFILL_BUCKET_MIN = 8

#: terminal request states:
#:
#: * ``finished`` — ran to EOS / ``max_new_tokens``;
#: * ``cancelled`` — :meth:`repro_torch.serve.engine.ServeEngine.cancel`;
#: * ``deadline_exceeded`` — ``deadline_s`` / ``max_queue_s`` expired;
#: * ``failed`` — quarantined by the numerical watchdog, or swept by the
#:   no-progress watchdog;
#: * ``dropped`` — preemption-retry budget spent.
STATUSES = ("finished", "cancelled", "deadline_exceeded", "failed",
            "dropped")

#: request priority classes, highest first
PRIORITIES = ("interactive", "batch")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: int | None = None
    #: seconds from submit to completion; an expired request terminates
    #: ``deadline_exceeded`` wherever it is
    deadline_s: float | None = None
    #: max seconds a request may wait unadmitted
    max_queue_s: float | None = None
    #: preemption-retry budget: one more eviction terminates ``dropped``
    max_preemptions: int = 8
    #: one of :data:`PRIORITIES`
    priority: str = "interactive"
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: one of :data:`STATUSES` once terminal, else ``None``
    status: str | None = None
    submit_time: float | None = None
    first_token_time: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    #: ``(engine key, engine service seconds at the last token)``: the
    #: service-time ITL mark; the key guards against a stale mark after
    #: an evacuation re-routes the request
    service_mark: tuple[int, float] | None = None

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


class ClassedQueue:
    """Per-priority-class waiting queues behind a deque's surface.

    Iteration / peek / popleft order is interactive first, FIFO within a
    class when ``aware`` (the default), or pure submission order when
    priority-blind.  Truthiness, ``len``, iteration, ``remove``,
    ``append`` / ``appendleft`` / ``popleft`` and the head peek ``q[0]``
    work as on a deque.
    """

    def __init__(self, aware: bool = True):
        self.aware = aware
        self.by_class: dict[str, deque[Request]] = (
            {p: deque() for p in PRIORITIES} if aware
            else {PRIORITIES[0]: deque()})

    def _cls(self, req: Request) -> str:
        return req.priority if self.aware else PRIORITIES[0]

    def append(self, req: Request) -> None:
        self.by_class[self._cls(req)].append(req)

    def appendleft(self, req: Request) -> None:
        self.by_class[self._cls(req)].appendleft(req)

    def popleft(self) -> Request:
        for q in self.by_class.values():
            if q:
                return q.popleft()
        raise IndexError("pop from an empty ClassedQueue")

    def remove(self, req: Request) -> None:
        self.by_class[self._cls(req)].remove(req)

    def count(self, priority: str) -> int:
        if not self.aware:
            return sum(1 for r in self.by_class[PRIORITIES[0]]
                       if r.priority == priority)
        return len(self.by_class[priority])

    def __iter__(self):
        for q in self.by_class.values():
            yield from q

    def __len__(self) -> int:
        return sum(len(q) for q in self.by_class.values())

    def __bool__(self) -> bool:
        return any(self.by_class.values())

    def __getitem__(self, i: int):
        if i == 0:
            for q in self.by_class.values():
                if q:
                    return q[0]
            raise IndexError("peek at an empty ClassedQueue")
        return list(self)[i]


class Scheduler:
    """Request lifecycle + per-step segment planning."""

    def __init__(self, slots: int, *, prefill_chunk: int,
                 step_token_budget: int, priority_aware: bool = True,
                 batch_share: float = 1.0):
        self.slots = slots
        self.prefill_chunk = max(1, prefill_chunk)
        self.step_token_budget = max(1, step_token_budget)
        #: honour :attr:`Request.priority` in queueing and planning
        self.priority_aware = priority_aware
        #: share of the per-step prefill quota that ``batch`` segments
        #: may take while interactive work is in flight
        self.batch_share = min(max(float(batch_share), 0.0), 1.0)
        self.waiting = ClassedQueue(priority_aware)
        self.prefilling: list[PrefillStream] = []
        self.active: list[Request | None] = [None] * slots
        self.finished: list[Request] = []
        self.preemptions = 0
        #: admissions refused for capacity (a pressure signal of the
        #: load shedder)
        self.admit_failures = 0

    # -- lifecycle ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.priority not in PRIORITIES:
            raise ValueError(f"unknown priority {req.priority!r} "
                             f"(want one of {PRIORITIES})")
        self.waiting.append(req)

    def terminal(self, req: Request, status: str) -> Request:
        """The single exit point: stamp ``status``, mark done, record."""
        if status not in STATUSES:
            raise ValueError(f"unknown terminal status {status!r} "
                             f"(want one of {STATUSES})")
        req.status = status
        req.done = True
        self.finished.append(req)
        return req

    def busy(self) -> bool:
        return bool(self.waiting or self.prefilling
                    or any(r is not None for r in self.active))

    def interactive_inflight(self) -> bool:
        """Any interactive stream decoding or prefilling?"""
        return (any(r is not None and r.priority == PRIORITIES[0]
                    for r in self.active)
                or any(ps.req.priority == PRIORITIES[0]
                       for ps in self.prefilling))

    def interactive_pending(self) -> bool:
        """Any interactive work in flight or waiting (the router's SLO
        gate)?"""
        return (self.interactive_inflight()
                or self.waiting.count(PRIORITIES[0]) > 0)

    def batch_pending(self) -> bool:
        """Any batch work in flight or waiting (the router asserts
        ``slo_pressure`` only where there is batch load to shed)?"""
        batch = PRIORITIES[1]
        return (any(r is not None and r.priority == batch
                    for r in self.active)
                or any(ps.req.priority == batch for ps in self.prefilling)
                or self.waiting.count(batch) > 0)

    def live_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active) if r is not None]

    def admit(self, pool) -> list[PrefillStream]:
        """Move waiting requests into free slots while the pool allows.
        A refusal — ``can_admit`` saying no, or ``allocate`` raising
        :class:`~repro_torch.serve.paging.PoolExhausted` — counts into
        ``admit_failures`` and leaves the request at the head.  A paged
        pool prefix-matches the prompt: its ``matched`` leading tokens
        are pooled already, so the stream starts with them written."""
        started: list[PrefillStream] = []
        for slot in pool.free_slots():
            if not self.waiting:
                break
            req = self.waiting[0]
            toks = list(req.prompt) + list(req.output)
            if not pool.can_admit(len(toks), tokens=toks):
                self.admit_failures += 1
                break
            try:
                matched = pool.allocate(slot, len(toks), tokens=toks)
            except PoolExhausted:
                self.admit_failures += 1
                break
            self.waiting.popleft()
            ps = PrefillStream(req, slot, toks, written=matched)
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
        non-finite); the caller reclaims the pool slot unpublished."""
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

    # -- per-step planning --------------------------------------------------

    def prefill_quota(self, n_live: int) -> int:
        """Real prefill tokens this step may spend (never zero when
        nothing is decoding)."""
        quota = self.step_token_budget - n_live
        if n_live == 0:
            quota = max(quota, 1)
        return max(quota, 0)

    def chunk_plan(self, n_live: int) -> list[tuple[PrefillStream, int]]:
        """(stream, real-token chunk length) segments for this step until
        the quota is spent.  With :attr:`priority_aware`, interactive
        streams plan ahead of batch, and while interactive work is in
        flight batch segments are capped to ``batch_share`` of the quota.
        A runt non-final segment (less than ``prefill_chunk``) waits a
        step; with nothing decoding one segment always runs."""
        quota = self.prefill_quota(n_live)
        streams = self.prefilling
        batch_quota = quota
        aware = self.priority_aware
        if aware:
            first = [ps for ps in self.prefilling
                     if ps.req.priority == PRIORITIES[0]]
            rest = [ps for ps in self.prefilling
                    if ps.req.priority != PRIORITIES[0]]
            streams = first + rest
            if self.batch_share < 1.0 and self.interactive_inflight():
                batch_quota = int(quota * self.batch_share)
        plan: list[tuple[PrefillStream, int]] = []
        for ps in streams:
            if quota <= 0:
                break
            batch = aware and ps.req.priority != PRIORITIES[0]
            c = min(self.prefill_chunk, quota, ps.remaining)
            if batch:
                c = min(c, batch_quota)
            if c <= 0:
                continue
            if c < self.prefill_chunk and c < ps.remaining:
                continue    # runt non-final segment: wait a step
            plan.append((ps, c))
            quota -= c
            if batch:
                batch_quota -= c
        if not plan and self.prefilling and n_live == 0:
            ps = self.prefilling[0]
            c = min(self.prefill_chunk, max(quota, 1), ps.remaining)
            if c > 0:
                plan.append((ps, c))
        return plan


# ---------------------------------------------------------------------------
# Graceful degradation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DegradationPolicy:
    """Watermarks of the :class:`LoadShedder` hysteresis: pressure events
    (a preemption, an admission failure or the router's SLO pressure in a
    step) over a rolling ``window`` of steps; engage at ``engage *
    window`` events, disengage at ``disengage * window`` or fewer once
    ``min_engaged_steps`` have passed."""
    window: int = 16
    engage: float = 0.5
    disengage: float = 0.0625
    #: engaged ``step_token_budget`` multiplier
    budget_factor: float = 0.5
    min_engaged_steps: int = 8


class LoadShedder:
    """Pressure-watching hysteresis switch over the step loop: one
    :meth:`observe` a step.  While engaged the engine runs with the
    shrunk :attr:`budget` and pauses admission whenever work is in flight
    (an idle engine always admits, so shedding never deadlocks)."""

    def __init__(self, policy: DegradationPolicy, base_budget: int):
        self.policy = policy
        self.base_budget = base_budget
        self.events: deque[int] = deque(maxlen=policy.window)
        self.engaged = False
        self.engaged_steps = 0
        self.engage_count = 0
        self.recover_count = 0

    @property
    def pressure_events(self) -> int:
        return sum(self.events)

    def observe(self, pressure: bool) -> bool:
        """Record one step's pressure bit; returns the engaged state."""
        self.events.append(1 if pressure else 0)
        p = self.policy
        if self.engaged:
            self.engaged_steps += 1
            if (self.engaged_steps >= p.min_engaged_steps
                    and self.pressure_events <= p.disengage * p.window):
                self.engaged = False
                self.recover_count += 1
        elif self.pressure_events >= p.engage * p.window:
            self.engaged = True
            self.engaged_steps = 0
            self.engage_count += 1
        return self.engaged

    @property
    def budget(self) -> int:
        """The step token budget to run with now."""
        if self.engaged:
            return max(1, int(self.base_budget * self.policy.budget_factor))
        return self.base_budget
