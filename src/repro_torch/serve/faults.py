"""Deterministic fault injection for the serve tier.

A seeded :class:`FaultInjector` with **named injection points** threaded
through the pool managers (allocation, radix matching, scale
corruption), the :class:`repro_torch.serve.runner.ModelRunner` step (NaN
logits, slow steps) and the kernels' entry points
(:mod:`repro_torch.kernels.ops`).  Everything is *off by default* — an
engine built without an injector carries :data:`NULL_INJECTOR`, whose
:meth:`~FaultInjector.fire` is a constant ``False`` — and completely
deterministic when on: each point draws from its own ``random.Random``
stream keyed by ``(seed, point)``, so one point's firing pattern never
depends on how often another point was consulted.  For one spec the
decisions are the reference's (``repro/serve/faults.py``) draw for draw.

Injection points
----------------

``pool_alloc``
    Slot/block allocation raises
    :class:`repro_torch.serve.paging.PoolExhausted`.  Fired in
    ``allocate`` on both managers and in the paged ``grow`` when a
    decode write crosses into an unallocated block.
``radix_match``
    The paged admission's radix lookup returns no hits (prefix reuse off
    for that admission).
``nan_logits``
    A runner step's logits are poisoned with NaN after the model's call
    (one slot row on decode — ``params={"nan_logits": {"slot": i}}`` —
    the whole segment on prefill paths; ``{"seg": kind}`` limits which
    segment kinds are consulted).  Drives the
    :mod:`repro_torch.serve.guard` quarantine path.
``kernel_gate``
    An entry point of :mod:`repro_torch.kernels.ops` refuses to dispatch
    and raises :class:`repro_torch.kernels.ops.KernelRejected`: nothing
    launches and no plain version runs in its place.  The engine
    installs its injector for the length of its own ``step()``
    (:func:`repro_torch.kernels.ops.fault_gate`), so replicas never
    charge each other's consultations.  (The reference's gate makes its
    fit predicate say no at trace time and falls back to the oracle.)
``block_scale``
    One freshly inserted int8 scale row (slot pool: the stream's slot;
    paged pool: the stream's first owned block) is set to ``+inf``; the
    stream's next logits go non-finite and the watchdog quarantines it.
    A no-op on full-width pools.
``slow_step``
    The runner step sleeps ``params={"slow_step": {"seconds": s}}``
    (default 0.05) on the host: drives the engine's
    :class:`~repro_torch.train.fault_tolerance.StragglerDetector`.
"""
from __future__ import annotations

import random
from typing import Any, Iterable, Mapping

__all__ = ["FaultInjector", "NULL_INJECTOR", "INJECTION_POINTS"]

#: every named injection point (specs naming anything else raise)
INJECTION_POINTS = (
    "pool_alloc",
    "radix_match",
    "nan_logits",
    "kernel_gate",
    "block_scale",
    "slow_step",
)


class FaultInjector:
    """Seeded, per-point-deterministic fault source.

    ``rates`` maps point -> probability per consultation; ``schedule``
    maps point -> 1-based consultation indices that fire exactly;
    ``max_fires`` caps total fires per point; ``params`` carries
    per-point knobs read via :meth:`param`.
    """

    def __init__(self, seed: int = 0,
                 rates: Mapping[str, float] | None = None,
                 schedule: Mapping[str, Iterable[int]] | None = None,
                 params: Mapping[str, Mapping[str, Any]] | None = None,
                 max_fires: Mapping[str, int] | None = None):
        self.seed = seed
        self.rates = dict(rates or {})
        self.schedule = {k: frozenset(int(i) for i in v)
                         for k, v in (schedule or {}).items()}
        self.params = {k: dict(v) for k, v in (params or {}).items()}
        self.max_fires = dict(max_fires or {})
        for point in (set(self.rates) | set(self.schedule)
                      | set(self.params) | set(self.max_fires)):
            if point not in INJECTION_POINTS:
                raise ValueError(
                    f"unknown injection point {point!r} "
                    f"(want one of {INJECTION_POINTS})")
        self.calls: dict[str, int] = {p: 0 for p in INJECTION_POINTS}
        self.fired: dict[str, int] = {p: 0 for p in INJECTION_POINTS}
        # one independent stream per point: decisions depend only on
        # (seed, point, consultation index)
        self._rng = {p: random.Random(f"{seed}:{p}")
                     for p in INJECTION_POINTS}

    def configured(self, point: str) -> bool:
        """Can this point ever fire?"""
        return point in self.rates or point in self.schedule

    @property
    def active(self) -> bool:
        return bool(self.rates or self.schedule)

    def fire(self, point: str) -> bool:
        """One consultation of ``point``: True when the fault should be
        injected (and counted)."""
        if point not in INJECTION_POINTS:
            raise ValueError(f"unknown injection point {point!r}")
        if not self.configured(point):
            return False
        self.calls[point] += 1
        cap = self.max_fires.get(point)
        if cap is not None and self.fired[point] >= cap:
            return False
        hit = self.calls[point] in self.schedule.get(point, ())
        rate = self.rates.get(point, 0.0)
        if not hit and rate > 0.0:
            hit = self._rng[point].random() < rate
        if hit:
            self.fired[point] += 1
        return hit

    def split(self, tag: str) -> "FaultInjector":
        """An independent injector with the same spec, its streams keyed
        ``(seed, tag, point)``: one chaos spec drives a replica fleet
        with per-replica-deterministic firing, and the parent's own
        streams stay untouched."""
        child = FaultInjector(seed=self.seed, rates=self.rates,
                              schedule=self.schedule, params=self.params,
                              max_fires=self.max_fires)
        child.tag = tag
        child._rng = {p: random.Random(f"{self.seed}/{tag}:{p}")
                      for p in INJECTION_POINTS}
        return child

    def param(self, point: str, key: str, default: Any = None) -> Any:
        return self.params.get(point, {}).get(key, default)

    def report(self) -> dict:
        """Consultations and fires per configured point."""
        pts = [p for p in INJECTION_POINTS if self.configured(p)]
        return {p: {"calls": self.calls[p], "fired": self.fired[p]}
                for p in pts}


#: shared inert injector: never configured, never fires
NULL_INJECTOR = FaultInjector()
