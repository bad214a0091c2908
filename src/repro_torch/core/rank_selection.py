"""Rank selection: ratio ranks and tile alignment.

* ``ratio``   — rank from the target compression ratio (paper Eq. 7).
* ``aligned`` — the ratio rank snapped down to a multiple of
  ``rank_align`` (the closed-form shortcut of Algorithm 1 on a stepwise
  tile cost model).

Algorithm 1 itself (``search``) times candidate ranks with the cost
model; it comes with ROADMAP item A2 (``cost_model`` for the H100).
"""
from __future__ import annotations

from repro_torch.core.svd import compression_of_rank, ratio_rank

ORG = -1   # sentinel: keep the original (dense) layer


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


def select_rank(c: int, s: int, *, compression: float, mode: str,
                align: int = 128) -> int:
    """Rank for a ``(c, s)`` linear, or :data:`ORG` to keep it dense."""
    r0 = ratio_rank(c, s, compression)
    if mode == "ratio":
        return r0
    if mode == "aligned":
        r = align_rank(r0, align)
        # alignment must not *increase* params beyond the dense layer
        return r if compression_of_rank(c, s, r) > 1.0 else ORG
    if mode == "search":
        raise NotImplementedError(
            "rank_mode='search' (Algorithm 1) needs the cost model: "
            "ROADMAP item A2")
    raise ValueError(f"unknown rank mode {mode!r}")
