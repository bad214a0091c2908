"""Rank selection: ratio ranks, the paper's Algorithm 1, tile alignment.

* ``ratio``   -- rank from the target compression ratio (paper Eq. 7).
* ``aligned`` -- the ratio rank snapped down to a multiple of
  ``rank_align`` (the closed-form shortcut of Algorithm 1 on a stepwise
  tile cost model).
* ``search``  -- :func:`algorithm1`, the paper's search (§2.1): time the
  decomposed layer at every rank in [R_min, R], take the rank just below
  the largest latency cliff, and keep it only if it beats the original
  layer (else :data:`ORG`).  The timer is pluggable: the cost model
  (:mod:`repro_torch.core.cost_model`, the H100 by default) or a timer
  measured on the card (the paper's own mode).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.core import cost_model as cm
from repro_torch.core.svd import compression_of_rank, ratio_rank

ORG = -1   # sentinel: keep the original (dense) layer


@dataclass(frozen=True)
class RankDecision:
    rank: int                 # chosen rank, or ORG
    t_dense: float            # timer value of the original layer
    t_chosen: float           # timer value at the chosen rank (t_dense if ORG)
    searched: tuple[int, ...] = ()

    @property
    def keep_original(self) -> bool:
        return self.rank == ORG

    def speedup(self) -> float:
        return self.t_dense / self.t_chosen if self.t_chosen > 0 else 1.0


def algorithm1(timer: Callable[[int], float], t_dense: float, rank: int,
               rank_min: int, *, step: int = 1) -> RankDecision:
    """Paper Algorithm 1 with a pluggable timer.

    Scans r from ``rank`` down to ``rank_min`` recording t(r); the latency
    drop of stepping *down to* r is ``t(r + step) - t(r)``.  R_opt is the
    rank with the largest drop (ties -> the larger rank).  If t(R_opt) is
    no faster than the dense layer, the layer stays original (the
    paper's ``ORG`` rows in Table 2)."""
    rank_min = max(1, rank_min)
    ranks = list(range(rank, rank_min - 1, -step))
    times = {r: timer(r) for r in ranks}
    best_r, best_drop = None, 0.0
    for r_hi, r_lo in zip(ranks[:-1], ranks[1:]):
        drop = times[r_hi] - times[r_lo]
        if drop > best_drop + 1e-30:
            best_r, best_drop = r_lo, drop
    if best_r is None:
        # monotone / flat t(r): the fastest rank (the largest on a tie)
        best_t = min(times.values())
        best_r = max(r for r, t in times.items() if t <= best_t * (1 + 1e-12))
    if times[best_r] < t_dense:
        return RankDecision(best_r, t_dense, times[best_r], tuple(ranks))
    return RankDecision(ORG, t_dense, t_dense, tuple(ranks))


def align_rank(rank: int, align: int = 128, *, min_rank: int = 8,
               mode: str = "down") -> int:
    """Snap a rank to the tile grid.  ``down`` snaps toward more
    compression; ``nearest`` rounds.  Ranks that would vanish snap to
    ``min_rank``."""
    if rank <= min_rank:
        return min_rank
    if rank < align:
        snapped = (rank // min_rank) * min_rank if mode == "down" else \
            int(round(rank / min_rank)) * min_rank
        return max(min_rank, snapped)
    if mode == "down":
        return (rank // align) * align
    if mode == "nearest":
        return max(align, int(round(rank / align)) * align)
    raise ValueError(mode)


def search_plan(r0: int, rank_min_frac: float = 0.25
                ) -> tuple[int, int, int]:
    """``(r_start, r_min, step)`` of ``select_rank``'s search below the
    ratio rank ``r0``: the floor ``rank_min_frac * r0``; step 1 up to
    r0 = 512, else 8, starting step-aligned so the latency cliffs land
    on tile boundaries."""
    step = 1 if r0 <= 512 else 8
    return (r0 // step) * step, max(1, int(r0 * rank_min_frac)), step


def select_rank(c: int, s: int, *, compression: float, mode: str,
                align: int = 128, rank_min_frac: float = 0.25,
                m_tokens: int = 4096,
                timer: Callable[[int], float] | None = None,
                t_dense: float | None = None) -> int:
    """Rank for a ``(c, s)`` linear, or :data:`ORG` to keep it dense.
    ``search`` runs :func:`algorithm1` on ``timer`` against ``t_dense``
    (by default the cost model's, at ``m_tokens`` rows)."""
    r0 = ratio_rank(c, s, compression)
    if mode == "ratio":
        return r0
    if mode == "aligned":
        r = align_rank(r0, align)
        # alignment must not *increase* params beyond the dense layer
        return r if compression_of_rank(c, s, r) > 1.0 else ORG
    if mode == "search":
        if timer is None:
            timer = cm.make_model_timer(m_tokens, c, s)
        if t_dense is None:
            t_dense = cm.make_dense_time(m_tokens, c, s)
        r_start, r_min, step = search_plan(r0, rank_min_frac)
        return algorithm1(timer, t_dense, r_start, r_min, step=step).rank
    raise ValueError(f"unknown rank mode {mode!r}")


def max_branches(rank: int, *, min_branch_rank: int = 128) -> int:
    """Largest N with rank/N >= one column tile (the under-fill guard)."""
    return max(1, rank // min_branch_rank)
