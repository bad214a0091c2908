"""Shared latency statistics for the serve tier (one percentile
definition everywhere a latency is recorded)."""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

__all__ = ["percentiles", "latency_summary"]


def percentiles(xs: Iterable[float],
                qs: Sequence[float] = (50, 99)) -> tuple[float, ...]:
    """``(pq for q in qs)`` over ``xs``; all-zero when ``xs`` is empty."""
    xs = np.asarray(list(xs), dtype=np.float64)
    if xs.size == 0:
        return tuple(0.0 for _ in qs)
    return tuple(float(np.percentile(xs, q)) for q in qs)


def latency_summary(itl_s: Iterable[float], ttft_s: Iterable[float],
                    requests: int = 0) -> dict:
    """p50/p99 inter-token latency + TTFT (milliseconds) over raw
    second-valued samples."""
    itl = list(itl_s)
    ttft = list(ttft_s)
    itl_p50, itl_p99 = percentiles([g * 1e3 for g in itl], (50, 99))
    ttft_p50, ttft_p99 = percentiles([t * 1e3 for t in ttft], (50, 99))
    return {
        "requests": requests,
        "itl_samples": len(itl),
        "itl_p50_ms": itl_p50,
        "itl_p99_ms": itl_p99,
        "ttft_p50_ms": ttft_p50,
        "ttft_p99_ms": ttft_p99,
    }
