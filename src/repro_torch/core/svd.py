"""Truncated-SVD low-rank decomposition of linear layers (paper Eq. 1-3).

Each dense weight ``W (C, S)`` decomposes into the balanced pair

    W0 = U' sqrt(S'),   W1 = sqrt(S') V'^T          (Eq. 3)

with ``W0 (C, R)``, ``W1 (R, S)``.  The SVD runs in f32 through
``torch.linalg.svd`` on whatever device the weights are on (the
reference computes it outside any kernel too).  Leading batch dims
(stacked layers) pass through.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SVDFactors(NamedTuple):
    w0: torch.Tensor        # (..., C, R)
    w1: torch.Tensor        # (..., R, S)


def svd_decompose(w: torch.Tensor, rank: int) -> SVDFactors:
    """Truncated SVD of ``w (..., C, S)`` into balanced rank-``rank``
    factors, computed in f32 and cast back to ``w.dtype``."""
    u, s, vt = torch.linalg.svd(w.to(torch.float32), full_matrices=False)
    r = min(rank, s.shape[-1])
    sq = torch.sqrt(s[..., :r])
    w0 = u[..., :, :r] * sq[..., None, :]
    w1 = sq[..., :, None] * vt[..., :r, :]
    return SVDFactors(w0.to(w.dtype), w1.to(w.dtype))


def reconstruct(f: SVDFactors) -> torch.Tensor:
    """W' = W0 @ W1 (paper Eq. 2/3)."""
    return torch.matmul(f.w0.to(torch.float32),
                        f.w1.to(torch.float32)).to(f.w0.dtype)


def ratio_rank(c: int, s: int, compression: float) -> int:
    """Rank giving ``compression``x fewer params: R = C*S / (alpha*(C+S))."""
    r = int(math.floor(c * s / (compression * (c + s))))
    return max(1, min(r, min(c, s)))


def compression_of_rank(c: int, s: int, rank: int) -> float:
    """Achieved parameter compression ratio for a rank-R pair."""
    return (c * s) / (rank * (c + s))


def randomized_svd(w: torch.Tensor, rank: int, *, oversample: int = 8,
                   n_iter: int = 2,
                   generator: torch.Generator | None = None) -> SVDFactors:
    """Halko-style randomized SVD — O(C*S*R) instead of
    O(C*S*min(C,S)), for very large matrices."""
    wf = w.to(torch.float32)
    c, s = wf.shape[-2:]
    k = min(rank + oversample, min(c, s))
    if generator is None:
        generator = torch.Generator(device=w.device).manual_seed(0)
    omega = torch.randn((*wf.shape[:-2], s, k), generator=generator,
                        dtype=torch.float32, device=w.device)
    y = wf @ omega
    for _ in range(n_iter):                            # power iterations
        y = wf @ (wf.transpose(-1, -2) @ y)
        y, _ = torch.linalg.qr(y)
    q, _ = torch.linalg.qr(y)
    b = q.transpose(-1, -2) @ wf
    ub, sb, vtb = torch.linalg.svd(b, full_matrices=False)
    r = min(rank, sb.shape[-1])
    sq = torch.sqrt(sb[..., :r])
    w0 = (q @ ub[..., :, :r]) * sq[..., None, :]
    w1 = sq[..., :, None] * vtb[..., :r, :]
    return SVDFactors(w0.to(w.dtype), w1.to(w.dtype))


def decompose_auto(w: torch.Tensor, rank: int, *,
                   randomized_threshold: int = 4096,
                   generator: torch.Generator | None = None) -> SVDFactors:
    """Full SVD for small matrices, randomized for big ones (the
    reference's switch)."""
    c, s = int(w.shape[-2]), int(w.shape[-1])
    if min(c, s) > randomized_threshold and rank < min(c, s) // 4:
        return randomized_svd(w, rank, generator=generator)
    return svd_decompose(w, rank)
