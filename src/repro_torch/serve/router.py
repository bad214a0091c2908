"""ServeRouter: a data-parallel serve tier over N replica engines.

Each replica is a whole :class:`repro_torch.serve.engine.ServeEngine`
(scheduler, pool, runner) on a ``torch.device``.  Replicas on the same
device share one set of param tensors (each load-time rewrite runs once
a device and hands the next replica the tree it made) and hold a pool
each; replicas on another device get their own copy, made once.  The
router makes three service-level decisions a single engine cannot:

**Placement** (:meth:`ServeRouter.add_request`): least KV pressure — a
replica's pool ``used_bytes`` plus the projected bytes of everything
queued or mid-prefill, over ``capacity_bytes``; paged pools add radix
prefix affinity first (a prompt whose leading blocks sit in a replica's
radix lands there).  ``priority_aware=False`` is round-robin FIFO, the
priority-blind baseline.

**SLO-aware admission** (:class:`SLOTracker`): batch requests land only
on a replica whose interactive p99 ITL (the engine's service-time ring)
has headroom under ``slo_itl_ms``; otherwise they wait in the router's
held queue (where ``deadline_s`` / ``max_queue_s`` still apply).  A
replica whose tail breaches the target gets ``engine.slo_pressure``,
tripping its load shedder a step early.

**Failure containment** (:class:`repro_torch.serve.guard.ReplicaGuard`):
a replica whose ``step`` raises — :class:`~repro_torch.kernels.ops.
KernelRejected` included — or that keeps producing quarantines leaves
the rotation: its in-flight streams are preempted (requeued with their
generated prefix) and its queue re-routed.  At least one replica always
stays routable.  One chaos spec drives the fleet through
:meth:`~repro_torch.serve.faults.FaultInjector.split`.

:meth:`step` drives every busy replica once (a *round*) and adds the
slowest replica's step seconds to ``round_seconds``: the clock of a
deployment whose replicas run side by side.  Replicas that share a card
(one H100 here) take turns on it, so a round's host time is their sum;
the per-replica engine stats keep each one's own seconds.  Routing only
picks which engine serves a request: greedy streams are the same across
replica counts.  The reference is ``repro/serve/router.py``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Sequence

import torch

from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.guard import ReplicaGuard, ReplicaGuardPolicy
from repro_torch.serve.metrics import latency_summary, percentiles
from repro_torch.serve.scheduler import PRIORITIES, Request
from repro_torch.tree import tree_map

__all__ = ["ServeRouter", "Replica", "SLOPolicy", "SLOTracker"]


@dataclasses.dataclass
class SLOPolicy:
    """The interactive-tail admission gate: ``slo_itl_ms`` is the target
    p99 ITL of interactive streams; batch lands on a replica only with at
    least ``min_samples`` samples and ``p99 <= headroom * slo_itl_ms``
    over the last ``window`` samples (a replica with no interactive work
    pending always admits)."""
    slo_itl_ms: float
    headroom: float = 0.6
    min_samples: int = 8
    window: int = 128


class SLOTracker:
    """Hysteresis switch over one replica's interactive p99 ITL: engages
    at ``p99 >= slo`` and disengages once the tail is back at ``headroom
    * slo``.  While engaged the router holds batch from the replica and
    sets its engine's ``slo_pressure``."""

    def __init__(self, policy: SLOPolicy):
        self.policy = policy
        self.engaged = False
        self.breaches = 0

    def observe(self, p99_ms: float, n_samples: int) -> bool:
        p = self.policy
        if n_samples >= p.min_samples:
            if not self.engaged and p99_ms >= p.slo_itl_ms:
                self.engaged = True
                self.breaches += 1
            elif self.engaged and p99_ms <= p.headroom * p.slo_itl_ms:
                self.engaged = False
        return self.engaged

    def idle_reset(self) -> None:
        """Stand down: no interactive work is pending, so there is no
        tail to protect and the ring has stopped moving (not a breach)."""
        self.engaged = False

    def batch_ok(self, p99_ms: float, n_samples: int) -> bool:
        """May a batch request land here without regressing the
        interactive tail?  An unmeasured tail holds."""
        if self.engaged or n_samples < self.policy.min_samples:
            return False
        return p99_ms <= self.policy.headroom * self.policy.slo_itl_ms


class Replica:
    """One engine and its routing / health bookkeeping."""

    def __init__(self, index: int, engine: ServeEngine,
                 guard: ReplicaGuard, tracker: SLOTracker | None):
        self.index = index
        self.engine = engine
        self.guard = guard
        self.tracker = tracker
        self.routed = {p: 0 for p in PRIORITIES}
        self.peak_used_bytes = 0
        self.evacuated = False

    @property
    def healthy(self) -> bool:
        return self.guard.healthy(self.engine)


class ServeRouter:
    def __init__(self, run, params, *, replicas: int = 2,
                 devices: Sequence[str | torch.device] | None = None,
                 slo_itl_ms: float | None = None,
                 slo: SLOPolicy | None = None,
                 priority_aware: bool = True,
                 guard_policy: ReplicaGuardPolicy | None = None,
                 faults: FaultInjector | None = None,
                 seed: int = 0,
                 stall_rounds: int = 64,
                 batch_pressure_cap: float = 0.5,
                 **engine_kwargs):
        """``replicas`` engines from one ``(run, params)`` pair; replica i
        on ``devices[i % len(devices)]`` (default ``["cuda"]``).
        ``slo_itl_ms`` (or a whole :class:`SLOPolicy` as ``slo``) arms the
        SLO gate; ``priority_aware=False`` is the blind baseline
        (round-robin, single-FIFO schedulers, no gate).  ``faults`` is
        split per replica.  ``batch_pressure_cap``: a batch request whose
        projected KV pressure would pass the cap waits in the held queue
        while some other replica, gated or not, would stay under it.
        Other kwargs go to every :class:`ServeEngine` (replica i seeds its
        generator with ``seed + i``)."""
        if replicas < 1:
            raise ValueError(f"need at least 1 replica, got {replicas}")
        if "device" in engine_kwargs:
            raise ValueError("place replicas with devices=, not device=")
        if slo is None and slo_itl_ms is not None:
            slo = SLOPolicy(slo_itl_ms)
        self.slo = slo if priority_aware else None
        self.priority_aware = priority_aware
        self.stall_rounds = max(1, stall_rounds)
        self.batch_pressure_cap = float(batch_pressure_cap)
        devices = [torch.device(d) for d in (devices or ["cuda"])]
        #: one served tree a device: the first replica there rewrites it
        #: (quantize / sparsify, idempotent), the next ones reuse it
        trees: dict[torch.device, Any] = {}
        self.replicas: list[Replica] = []
        for i in range(replicas):
            dev = devices[i % len(devices)]
            tree = trees.get(dev)
            if tree is None:       # a tensor already there is not copied
                tree = tree_map(lambda t, d=dev: t.to(d), params)
            inj = (faults.split(f"replica{i}")
                   if faults is not None and faults.active else faults)
            eng = ServeEngine(run, tree, seed=seed + i, device=dev,
                              priority_aware=priority_aware,
                              faults=inj, **engine_kwargs)
            trees[dev] = eng.params
            tracker = SLOTracker(self.slo) if self.slo else None
            self.replicas.append(
                Replica(i, eng, ReplicaGuard(guard_policy), tracker))
        #: batch requests the SLO gate holds back from every replica
        self.held: deque[Request] = deque()
        #: requests that went terminal in the held queue
        self.rejected: list[Request] = []
        self.rounds = 0
        #: sum over rounds of the slowest replica's step seconds
        self.round_seconds = 0.0
        self.total_tokens = 0
        self._rr = 0          # round-robin cursor (blind mode)

    # -- routing -------------------------------------------------------------

    def _routable(self) -> list[Replica]:
        """Replicas in rotation; never empty: with every guard tripped,
        the least-broken non-evacuated replica keeps serving."""
        healthy = [r for r in self.replicas if r.healthy]
        if healthy:
            return healthy
        alive = [r for r in self.replicas if not r.evacuated] \
            or self.replicas
        return [min(alive, key=lambda r: r.guard.step_failures)]

    def _pressure(self, rep: Replica) -> float:
        """Live pool bytes plus the projected bytes of queued and
        mid-prefill work, over the pool's capacity."""
        sched, pool = rep.engine.scheduler, rep.engine.pool
        backlog = sum(len(r.prompt) + len(r.output) for r in sched.waiting)
        backlog += sum(ps.remaining for ps in sched.prefilling)
        cap = pool.capacity_bytes()
        if cap:
            return (pool.used_bytes() + backlog * pool.bytes_per_token) / cap
        streams = (len(sched.live_slots()) + len(sched.prefilling)
                   + len(sched.waiting))
        return streams / max(pool.slots, 1)

    def _projected(self, rep: Replica, req: Request) -> float:
        """The pressure the replica would sit at with ``req`` on it."""
        pool = rep.engine.pool
        cap = pool.capacity_bytes()
        if not cap:
            return self._pressure(rep)
        need = (len(req.prompt) + req.max_new_tokens) * pool.bytes_per_token
        return self._pressure(rep) + need / cap

    def _interactive_p99(self, rep: Replica) -> tuple[float, int]:
        ring = rep.engine.class_itl[PRIORITIES[0]]
        window = self.slo.window if self.slo else len(ring)
        recent = list(ring)[-max(1, window):]
        (p99,) = percentiles([g * 1e3 for g in recent], (99,))
        return p99, len(recent)

    def _batch_ok(self, rep: Replica) -> bool:
        if rep.tracker is None:
            return True
        if not rep.engine.scheduler.interactive_pending():
            return True
        return rep.tracker.batch_ok(*self._interactive_p99(rep))

    def _pick(self, req: Request) -> Replica | None:
        """The replica ``req`` should land on, or None while every
        routable replica's SLO gate holds batch back."""
        pool_ = self._routable()
        if not self.priority_aware:
            rep = pool_[self._rr % len(pool_)]
            self._rr += 1
            return rep
        if req.priority != PRIORITIES[0] and self.slo is not None:
            gated = [r for r in pool_ if not self._batch_ok(r)]
            pool_ = [r for r in pool_ if self._batch_ok(r)]
            if not pool_:
                return None
            cap = self.batch_pressure_cap
            fits = [r for r in pool_ if self._projected(r, req) <= cap]
            if not fits and any(self._projected(r, req) <= cap
                                for r in gated):
                return None
            if fits:
                pool_ = fits
        aff = [(r, r.engine.pool.prefix_affinity(req.prompt))
               for r in pool_]
        best = max(a for _, a in aff)
        if best > 0:
            pool_ = [r for r, a in aff if a == best]
        return min(pool_, key=self._pressure)

    def _submit(self, rep: Replica, req: Request) -> None:
        rep.engine.add_request(req)
        rep.routed[req.priority] += 1

    def add_request(self, req: Request) -> None:
        """Route one request (``submit_time`` is stamped now: held time
        counts against TTFT and the queue deadlines)."""
        if req.priority not in PRIORITIES:
            raise ValueError(f"unknown priority {req.priority!r} "
                             f"(want one of {PRIORITIES})")
        if req.submit_time is None:
            req.submit_time = time.perf_counter()
        rep = self._pick(req)
        if rep is None:
            self.held.append(req)
            return
        self._submit(rep, req)

    # -- held-queue maintenance ---------------------------------------------

    def _expire_held(self) -> None:
        now = time.perf_counter()
        for req in list(self.held):
            if any(budget is not None and req.submit_time is not None
                   and now - req.submit_time > budget
                   for budget in (req.deadline_s, req.max_queue_s)):
                self.held.remove(req)
                req.status = "deadline_exceeded"
                req.done = True
                self.rejected.append(req)

    def _drain_held(self) -> None:
        while self.held:
            rep = self._pick(self.held[0])     # FIFO: the head blocks
            if rep is None:
                break
            self._submit(rep, self.held.popleft())

    # -- replica failure -----------------------------------------------------

    def _evacuate(self, rep: Replica) -> None:
        """Pull a tripped replica's work: preempt its in-flight streams
        (requeued with their generated prefix) and re-route its whole
        queue; nothing enters its radix."""
        if rep.evacuated:
            return
        rep.evacuated = True
        sched, pool = rep.engine.scheduler, rep.engine.pool
        for slot in list(sched.live_slots()):
            sched.preempt(slot)
            pool.release(slot, publish=False)
        for ps in list(sched.prefilling):
            sched.preempt(ps.slot)
            pool.release(ps.slot, publish=False)
        moved: list[Request] = []
        while sched.waiting:
            moved.append(sched.waiting.popleft())
        for req in moved:
            if req.done:        # retry budget spent by the preemption
                continue
            target = self._pick(req)
            if target is None:
                self.held.append(req)
            else:
                self._submit(target, req)

    # -- the round loop ------------------------------------------------------

    def step(self) -> int:
        """One round: expire and drain the held queue, step every
        routable busy replica once, update SLO trackers and health.
        Returns the tokens produced across the fleet."""
        self.rounds += 1
        self._expire_held()
        self._drain_held()
        routable = self._routable()
        produced = 0
        round_s = 0.0
        for rep in self.replicas:
            if rep not in routable:
                self._evacuate(rep)
                continue
            eng = rep.engine
            if not eng.scheduler.busy():
                continue
            t0 = time.perf_counter()
            try:
                produced += eng.step()
            except Exception as exc:  # noqa: BLE001 — contain, re-route
                rep.guard.record_failure(exc)
                continue
            round_s = max(round_s, time.perf_counter() - t0)
            self._observe(rep)
        self.total_tokens += produced
        self.round_seconds += round_s
        return produced

    def _observe(self, rep: Replica) -> None:
        rep.peak_used_bytes = max(rep.peak_used_bytes,
                                  rep.engine.pool.used_bytes())
        if rep.tracker is None:
            return
        if not rep.engine.scheduler.interactive_pending():
            rep.tracker.idle_reset()
            return
        if (rep.tracker.observe(*self._interactive_p99(rep))
                and rep.engine.scheduler.batch_pending()):
            rep.engine.slo_pressure = True

    def busy(self) -> bool:
        return bool(self.held) or any(
            r.engine.scheduler.busy() for r in self.replicas
            if not r.evacuated)

    def finished(self) -> list[Request]:
        """Every terminal request: engine order, then router-rejected."""
        out = [r for rep in self.replicas for r in rep.engine.finished]
        out.extend(self.rejected)
        return out

    def run_until_done(self, max_rounds: int = 10_000) -> list[Request]:
        """Drive rounds until every queue drains: ``stall_rounds`` rounds
        without progress fail the survivors fleet-wide, and exhausting
        ``max_rounds`` with work in flight raises."""
        start = len(self.finished())
        stalled = 0
        for _ in range(max_rounds):
            if not self.busy():
                break
            fin0 = len(self.finished())
            produced = self.step()
            progressed = produced > 0 or len(self.finished()) > fin0
            stalled = 0 if progressed else stalled + 1
            if stalled >= self.stall_rounds:
                for rep in self.replicas:
                    rep.engine._fail_survivors()
                while self.held:
                    req = self.held.popleft()
                    req.status = "failed"
                    req.done = True
                    self.rejected.append(req)
                break
        else:
            if self.busy():
                raise RuntimeError(
                    f"run_until_done: {max_rounds} rounds exhausted "
                    f"with {len(self.held)} held and "
                    f"{sum(r.engine.scheduler.busy() for r in self.replicas)}"
                    " busy replicas")
        return self.finished()[start:]

    # -- service-level stats -------------------------------------------------

    def set_slo(self, slo_itl_ms: float) -> None:
        """(Re)arm the SLO gate."""
        self.slo = SLOPolicy(slo_itl_ms) if self.priority_aware else None
        for rep in self.replicas:
            rep.tracker = SLOTracker(self.slo) if self.slo else None

    def reset_stats(self) -> None:
        """Zero every latency / throughput counter fleet-wide (pools and
        params stay)."""
        self.rounds = 0
        self.round_seconds = 0.0
        self.total_tokens = 0
        for rep in self.replicas:
            eng = rep.engine
            eng.stats.clear()
            for ring in (*eng.class_itl.values(), *eng.class_ttft.values()):
                ring.clear()
            rep.peak_used_bytes = 0
            rep.routed = {p: 0 for p in PRIORITIES}
            if rep.tracker is not None:
                rep.tracker = SLOTracker(self.slo)

    def class_stats(self, priority: str) -> dict:
        """Fleet-wide per-class p50 / p99 ITL and TTFT."""
        itl = [g for rep in self.replicas
               for g in rep.engine.class_itl[priority]]
        ttft = [t for rep in self.replicas
                for t in rep.engine.class_ttft[priority]]
        done = sum(1 for r in self.finished() if r.priority == priority)
        return latency_summary(itl, ttft, requests=done)

    def throughput(self) -> dict:
        """Service-level stats: tokens over ``round_seconds``, fleet
        per-class latency, and each replica's engine ``throughput()``
        with its routing, health and SLO counters."""
        per = []
        for rep in self.replicas:
            d = rep.engine.throughput()
            d["replica"] = rep.index
            d["routed"] = dict(rep.routed)
            d["kv_peak_bytes"] = rep.peak_used_bytes
            d["kv_capacity_bytes"] = rep.engine.pool.capacity_bytes()
            d["healthy"] = rep.healthy
            d["tripped"] = rep.guard.tripped
            d["slo_engaged"] = rep.tracker.engaged if rep.tracker else False
            d["slo_breaches"] = rep.tracker.breaches if rep.tracker else 0
            per.append(d)
        return {
            "replicas": len(self.replicas),
            "rounds": self.rounds,
            "tokens": self.total_tokens,
            "round_seconds": self.round_seconds,
            "tokens_per_s": self.total_tokens / max(self.round_seconds,
                                                    1e-9),
            "held_batch": len(self.held),
            "rejected": len(self.rejected),
            "slo_itl_ms": self.slo.slo_itl_ms if self.slo else None,
            "per_class": {p: self.class_stats(p) for p in PRIORITIES},
            "per_replica": per,
        }
