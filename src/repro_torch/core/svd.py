"""Truncated-SVD low-rank decomposition of linear layers (paper Eq. 1-3).

Each dense weight ``W (C, S)`` decomposes into the balanced pair

    W0 = U' sqrt(S'),   W1 = sqrt(S') V'^T          (Eq. 3)

with ``W0 (C, R)``, ``W1 (R, S)``.  The SVD runs in f32 on whatever
device the weights are on (the reference computes it outside any kernel
too): through ``torch.linalg.svd``, except for a batch of matrices on a
CUDA device (a stack of layers, an MoE expert bank), whose top ``R``
singular triplets come from the eigendecomposition of each matrix's Gram
matrix on its smaller side -- cuSOLVER's SVD takes a batch one matrix
at a time, so a bank of hundreds of experts would take minutes, where
the batched Gram products and ``eigh`` take seconds -- and for a single
CUDA matrix too large for cuSOLVER's SVD (:func:`cusolver_takes`:
llama-3.2-vision's 8,192 x 128,256 unembed).  Leading batch dims pass
through.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SVDFactors(NamedTuple):
    w0: torch.Tensor        # (..., C, R)
    w1: torch.Tensor        # (..., R, S)


def _gram_svd(w: torch.Tensor, rank: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top ``rank`` singular triplets ``(u, s, vt)`` of f32 ``w (...,
    C, S)`` (descending) from ``eigh`` of the Gram matrix on the smaller
    side; a zero singular value gets zero vectors on the other side."""
    wide = w.shape[-2] < w.shape[-1]
    a = w.transpose(-1, -2) if wide else w                    # (.., M, K)
    evals, vecs = torch.linalg.eigh(a.transpose(-1, -2) @ a)  # ascending
    r = min(rank, evals.shape[-1])
    sig = torch.sqrt(torch.clamp(evals.flip(-1)[..., :r], min=0.0))
    v = vecs.flip(-1)[..., :r]                                # (.., K, r)
    inv = torch.where(sig > 0, 1.0 / torch.clamp(sig, min=1e-30), 0.0)
    other = (a @ v) * inv[..., None, :]                       # (.., M, r)
    if wide:
        return v, sig, other.transpose(-1, -2)
    return other, sig, v.transpose(-1, -2)


def cusolver_takes(w: torch.Tensor) -> bool:
    """Whether cuSOLVER's SVD takes the matrix ``w (C, S)``: its int32
    workspace count holds about two copies of the matrix and the square
    of its smaller side, so it refuses past 2^31 values (it took
    mistral-nemo's 5,120 x 131,072 and minitron's 3,072 x 256,000
    unembeds and refused llama-3.2-vision's 8,192 x 128,256)."""
    c, s = int(w.shape[-2]), int(w.shape[-1])
    return 2 * c * s + min(c, s) ** 2 < 2 ** 31


def svd_decompose(w: torch.Tensor, rank: int) -> SVDFactors:
    """Truncated SVD of ``w (..., C, S)`` into balanced rank-``rank``
    factors, computed in f32 and cast back to ``w.dtype``."""
    wf = w.to(torch.float32)
    if wf.is_cuda and (wf.ndim > 2 or not cusolver_takes(wf)):
        u, s, vt = _gram_svd(wf, rank)
    else:
        u, s, vt = torch.linalg.svd(wf, full_matrices=False)
    r = min(rank, s.shape[-1])
    sq = torch.sqrt(s[..., :r])
    w0 = u[..., :, :r] * sq[..., None, :]
    w1 = sq[..., :, None] * vt[..., :r, :]
    return SVDFactors(w0.to(w.dtype), w1.to(w.dtype))


def reconstruct(f: SVDFactors) -> torch.Tensor:
    """W' = W0 @ W1 (paper Eq. 2/3)."""
    return torch.matmul(f.w0.to(torch.float32),
                        f.w1.to(torch.float32)).to(f.w0.dtype)


def approximation_error(w: torch.Tensor, f: SVDFactors) -> float:
    """Relative Frobenius error ||W - W0 W1||_F / ||W||_F."""
    wf = w.to(torch.float32)
    err = torch.linalg.norm(wf - reconstruct(f).to(torch.float32))
    return float(err / (torch.linalg.norm(wf) + 1e-30))


def energy_rank(w: torch.Tensor, energy: float) -> int:
    """Smallest rank whose singular values keep ``energy`` of
    sum sigma_i^2."""
    s = torch.linalg.svdvals(w.to(torch.float32))
    e = torch.cumsum(s ** 2, dim=-1)
    e = e / e[-1]
    return int(torch.searchsorted(e, torch.tensor(energy,
                                                  dtype=e.dtype))) + 1


def ratio_rank(c: int, s: int, compression: float) -> int:
    """Rank giving ``compression``x fewer params: R = C*S / (alpha*(C+S))."""
    r = int(math.floor(c * s / (compression * (c + s))))
    return max(1, min(r, min(c, s)))


def compression_of_rank(c: int, s: int, rank: int) -> float:
    """Achieved parameter compression ratio for a rank-R pair."""
    return (c * s) / (rank * (c + s))


def lowrank_params(c: int, s: int, rank: int) -> int:
    return rank * (c + s)


def svd_flops_per_row(c: int, s: int, rank: int) -> float:
    """Forward matmul FLOPs per input row (2 matmuls through the
    bottleneck)."""
    return 2.0 * rank * (c + s)


def dense_flops_per_row(c: int, s: int) -> float:
    return 2.0 * c * s


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
