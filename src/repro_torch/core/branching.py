"""Branched (block-diagonal) low-rank decomposition — paper §2.4.

* Linear (SVD): ``W = W0 @ W1`` splits column-wise into ``N`` branch
  factors with identity cores — exact at init (the SVD core is diagonal,
  and a diagonal matrix is block-diagonal); the cores then train as free
  per-branch mixers.  Executed as one grouped chain by the branched
  kernel (paper Fig. 4).
* Conv (Tucker-2): the HOSVD core is dense, so branching keeps its N
  diagonal blocks and drops the rest (paper Eq. 17) — an approximation,
  measured by :func:`branch_error`, traded for the N x smaller core.
  The branched core runs as a grouped convolution
  (:mod:`repro_torch.layers.conv`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.svd import svd_decompose
from repro_torch.core.tucker import relative_error, tucker2_decompose


class BranchedFactors(NamedTuple):
    u: torch.Tensor     # (..., N, C, r1/N)
    xc: torch.Tensor    # (..., N, r1/N, r2/N)   block-diagonal core
    v: torch.Tensor     # (..., N, r2/N, S)


class BranchedConvFactors(NamedTuple):
    u: torch.Tensor     # (N, C, r1/N)             per-branch 1x1 in
    core: torch.Tensor  # (N, k, k, r1/N, r2/N)    per-branch k x k core
    v: torch.Tensor     # (N, r2/N, S)             per-branch 1x1 out


def quantize_ranks(r1: int, r2: int, branches: int) -> tuple[int, int]:
    """Ranks rounded up to multiples of N (paper Eq. 10-11)."""
    n = branches

    def q(r: int) -> int:
        return max(n, ((r + n - 1) // n) * n)
    return q(r1), q(r2)


def branch_svd(w: torch.Tensor, rank: int, branches: int) -> BranchedFactors:
    """Branched factors for ``w (..., C, S)`` — exact at init.  Batch dims
    (stacked layers, expert banks) pass through: ``u (..., N, C, rb)``,
    ``xc (..., N, rb, rb)``, ``v (..., N, rb, S)``."""
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


def branch_tucker(w: torch.Tensor, r1: int, r2: int,
                  branches: int) -> BranchedConvFactors:
    """Branched Tucker-2 of conv ``w (k, k, C, S)`` (paper Eq. 17): the N
    diagonal (r1/N x r2/N) blocks of the HOSVD core, with the matching
    column blocks of U and row blocks of V."""
    n = branches
    r1, r2 = quantize_ranks(r1, r2, n)
    _, _, c, s = w.shape
    r1 = min(r1, (c // n) * n) or n
    r2 = min(r2, (s // n) * n) or n
    b1, b2 = r1 // n, r2 // n
    f = tucker2_decompose(w, r1, r2)
    u = torch.stack([f.u[:, j * b1:(j + 1) * b1] for j in range(n)])
    v = torch.stack([f.v[j * b2:(j + 1) * b2, :] for j in range(n)])
    core = torch.stack([f.core[:, :, j * b1:(j + 1) * b1,
                               j * b2:(j + 1) * b2] for j in range(n)])
    return BranchedConvFactors(u.contiguous(), core.contiguous(),
                               v.contiguous())


def reconstruct_conv(f: BranchedConvFactors) -> torch.Tensor:
    """W' = sum_j core_j x_C U_j x_S V_j, HWIO."""
    f32 = torch.float32
    return torch.einsum("ncp,nhwpq,nqs->hwcs", f.u.to(f32), f.core.to(f32),
                        f.v.to(f32)).to(f.u.dtype)


def branch_error(w: torch.Tensor, f: BranchedConvFactors) -> float:
    """Relative Frobenius error of the block-diagonal truncation."""
    return relative_error(w, reconstruct_conv(f))


def branched_linear_params(c: int, s: int, r1: int, r2: int,
                           branches: int) -> int:
    n = branches
    return c * r1 + (r1 // n) * (r2 // n) * n + r2 * s


def branched_conv_params(c: int, s: int, k: int, r1: int, r2: int,
                         branches: int) -> int:
    """Paper Eq. 18-20: the core shrinks by N."""
    n = branches
    return c * r1 + n * (r1 // n) * (r2 // n) * k * k + r2 * s
