"""Branched (block-diagonal) low-rank decomposition — paper §2.4.

For a linear layer, ``W = W0 @ W1`` splits column-wise into ``N`` branch
factors with identity cores — exact at init (the SVD core is diagonal,
and a diagonal matrix is block-diagonal); the cores then train as free
per-branch mixers.  Executed as one grouped chain by the branched kernel
(paper Fig. 4).  Branched Tucker for convolutions comes with ROADMAP item
A13.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.svd import svd_decompose


class BranchedFactors(NamedTuple):
    u: torch.Tensor     # (..., N, C, r1/N)
    xc: torch.Tensor    # (..., N, r1/N, r2/N)   block-diagonal core
    v: torch.Tensor     # (..., N, r2/N, S)


def quantize_ranks(r1: int, r2: int, branches: int) -> tuple[int, int]:
    """Ranks rounded up to multiples of N (paper Eq. 10-11)."""
    n = branches

    def q(r: int) -> int:
        return max(n, ((r + n - 1) // n) * n)
    return q(r1), q(r2)


def branch_svd(w: torch.Tensor, rank: int, branches: int) -> BranchedFactors:
    """Branched factors for ``w (..., C, S)`` — exact at init."""
    n = branches
    rank, _ = quantize_ranks(rank, rank, n)
    c, s = int(w.shape[-2]), int(w.shape[-1])
    rank = min(rank, (min(c, s) // n) * n) or n
    rb = rank // n
    f = svd_decompose(w, rank)
    batch = tuple(w.shape[:-2])
    # w0 (..., C, N*rb) -> (..., N, C, rb);  w1 (..., N*rb, S) -> (..., N, rb, S)
    u = torch.movedim(f.w0.reshape(*batch, c, n, rb), -2, -3).contiguous()
    v = f.w1.reshape(*batch, n, rb, s).contiguous()
    xc = torch.eye(rb, dtype=w.dtype, device=w.device).expand(
        *batch, n, rb, rb).contiguous()
    return BranchedFactors(u, xc, v)
