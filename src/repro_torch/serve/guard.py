"""Numerical watchdog: per-slot non-finite logit detection, fused into
the batched sampler, and its fleet twin, the replica guard.

A poisoned stream (an int8 scale overflow, a corrupted block, a model
bug) must degrade **one** request, not the engine.
:func:`sample_and_flag` is the batched greedy / temperature sampler with
a per-row ``all(isfinite)`` reduction beside it; the flags come back to
the host in the same single transfer as the sampled tokens
(:meth:`repro_torch.serve.runner.ModelRunner.sample`), so the clean path
pays no extra sync.

* A flagged row's token is sampled from zeroed logits (finite, in range);
  the engine quarantines the stream before the token is appended.
* Clean rows are untouched: argmax and the Gumbel draw are per row, so
  quarantining slot ``i`` never perturbs slot ``j``'s greedy stream.

:class:`ReplicaGuard` is the router's verdict over a whole replica: one
whose ``step`` raises, or that keeps producing casualties, leaves the
rotation.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["nonfinite_rows", "sample_and_flag", "ReplicaGuard",
           "ReplicaGuardPolicy"]


def nonfinite_rows(logits: torch.Tensor) -> torch.Tensor:
    """``(rows, V) -> (rows,)`` bool: True where any logit of the row is
    NaN or infinite."""
    return ~torch.isfinite(logits).all(dim=-1)


def sample_and_flag(logits: torch.Tensor, temps: torch.Tensor,
                    generator: torch.Generator
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``logits (rows, V)``, ``temps (rows,)`` -> ``(tokens (rows,),
    bad (rows,) bool)``.  Greedy rows (``temps == 0``) take the argmax
    (first maximum on ties); temperature rows draw by the Gumbel-max
    trick from ``generator``.  A row with any non-finite logit is flagged
    and sampled from zeroed logits."""
    bad = nonfinite_rows(logits)
    clean = torch.where(bad[:, None], torch.zeros_like(logits), logits)
    greedy = torch.argmax(clean, dim=-1)
    safe = torch.where(temps > 0, temps, torch.ones_like(temps))
    u = torch.rand(clean.shape, generator=generator, device=clean.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    sampled = torch.argmax(clean / safe[:, None] + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy), bad


# ---------------------------------------------------------------------------
# Replica-level health
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReplicaGuardPolicy:
    """When the router pulls a whole replica out of rotation."""
    #: per-stream quarantines before the replica itself is suspect
    max_quarantined: int = 4
    #: uncaught ``step()`` exceptions tolerated (0 = the first trips)
    max_step_failures: int = 0


class ReplicaGuard:
    """Health verdict over one replica engine.  Trips once and stays
    tripped; the router keeps at least one replica routable whatever the
    verdicts."""

    def __init__(self, policy: ReplicaGuardPolicy | None = None):
        self.policy = policy or ReplicaGuardPolicy()
        self.step_failures = 0
        self.last_error: BaseException | None = None
        self.tripped: str | None = None

    def record_failure(self, exc: BaseException) -> None:
        """Count one uncaught step exception."""
        self.step_failures += 1
        self.last_error = exc

    def healthy(self, engine) -> bool:
        if self.tripped is not None:
            return False
        if self.step_failures > self.policy.max_step_failures:
            self.tripped = "step_failures"
        elif engine.quarantined >= max(1, self.policy.max_quarantined):
            self.tripped = "quarantined_streams"
        return self.tripped is None
