"""Fault tolerance: straggler detection, preemption, supervised restarts.

* :class:`StragglerDetector` — per-step EWMA wall-time; steps slower than
  ``threshold x`` the EWMA are flagged.  Its ``clock`` is injectable, so
  a test can drive it with recorded durations instead of sleeps.
* :class:`PreemptionHandler` — converts SIGTERM (or other signals) into a
  "checkpoint now and exit" flag the train loop checks every step.
* :func:`run_with_restart` — restarts a crashing train function (which
  resumes from its latest valid checkpoint) up to ``max_restarts``.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable


@dataclasses.dataclass
class StragglerEvent:
    step: int
    seconds: float
    ewma: float


class StragglerDetector:
    def __init__(self, threshold: float = 3.0, alpha: float = 0.2,
                 warmup: int = 3,
                 clock: Callable[[], float] = time.perf_counter):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.clock = clock
        self.ewma: float | None = None
        self._n = 0
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self, step: int) -> StragglerEvent | None:
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        dt = self.clock() - self._t0
        self._t0 = None
        self._n += 1
        if self.ewma is None:
            self.ewma = dt
            return None
        flagged = None
        if self._n > self.warmup and dt > self.threshold * self.ewma:
            flagged = StragglerEvent(step, dt, self.ewma)
            self.events.append(flagged)
            # don't poison the EWMA with the straggler sample
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return flagged

    def report(self) -> dict:
        return {"steps": self._n, "ewma_s": self.ewma,
                "stragglers": [(e.step, round(e.seconds, 4))
                               for e in self.events]}


class PreemptionHandler:
    """SIGTERM -> checkpoint-and-exit flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._signals = signals
        self._old = {}

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False

    def _handle(self, signum, frame):
        self._requested = True

    @property
    def preempted(self) -> bool:
        return self._requested

    def request(self) -> None:        # test hook
        self._requested = True


def run_with_restart(train_fn: Callable[[int], dict], *,
                     max_restarts: int = 3,
                     on_restart: Callable[[int, Exception], None]
                     | None = None) -> dict:
    """Supervise ``train_fn(attempt)``; restart on exceptions.

    ``train_fn`` must itself resume from the latest checkpoint (the loop
    does).  Returns the final result dict with a ``restarts`` count.
    """
    attempt = 0
    while True:
        try:
            result = train_fn(attempt)
            result["restarts"] = attempt
            return result
        except Exception as e:          # noqa: BLE001 — supervisor boundary
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
