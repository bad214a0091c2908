"""Tucker-2 decomposition of conv weight tensors (paper Eq. 4-6, Fig. 1b).

A conv kernel ``W (C, S, k, k)`` (in-channels, out-channels, spatial)
decomposes into

    1x1 conv  U  (C, R1)
    k x k core X (R1, R2, k, k)
    1x1 conv  V  (R2, S)

by HOSVD: the mode-C and mode-S unfoldings give the factor matrices, and
the core is the double contraction of W with them.  This is the paper's
"Tucker2" (the spatial modes are too small to be worth decomposing).

Layout: conv weights are stored HWIO, ``(k, k, C, S)``, as the
reference stores them; the unfoldings run on the I/O modes.  The SVDs
run in f32 on the weight's device (``torch.linalg.svd``: each unfolding
is one matrix, at most (512, 4608) in a ResNet).  Singular vectors are
defined up to sign, so factors differ in sign from the reference's
while the reconstruction is the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_F32 = torch.float32


class TuckerFactors(NamedTuple):
    u: torch.Tensor       # (C, R1)          first 1x1
    core: torch.Tensor    # (k, k, R1, R2)
    v: torch.Tensor       # (R2, S)          last 1x1


def _left_vectors(a: torch.Tensor, r: int) -> torch.Tensor:
    u, _, _ = torch.linalg.svd(a, full_matrices=False)
    return u[:, :r]


def tucker2_decompose(w: torch.Tensor, r1: int, r2: int) -> TuckerFactors:
    """HOSVD Tucker-2 of ``w (k, k, C, S)`` with channel ranks (r1, r2)."""
    wf = w.to(_F32)
    _, _, c, s = wf.shape
    r1, r2 = min(r1, c), min(r2, s)
    u = _left_vectors(wf.permute(2, 0, 1, 3).reshape(c, -1), r1)  # (C, R1)
    v = _left_vectors(wf.permute(3, 0, 1, 2).reshape(s, -1), r2)  # (S, R2)
    core = torch.einsum("hwcs,cp,sq->hwpq", wf, u, v)             # (k,k,R1,R2)
    return TuckerFactors(u.to(w.dtype).contiguous(),
                         core.to(w.dtype).contiguous(),
                         v.t().to(w.dtype).contiguous())


def reconstruct(f: TuckerFactors) -> torch.Tensor:
    """W' = core x_C U x_S V (paper Eq. 4)."""
    return torch.einsum("hwpq,cp,qs->hwcs", f.core.to(_F32), f.u.to(_F32),
                        f.v.to(_F32)).to(f.core.dtype)


def relative_error(w: torch.Tensor, w_approx: torch.Tensor) -> float:
    """``||w - w_approx|| / ||w||`` in f32."""
    wf = w.to(_F32)
    err = torch.linalg.vector_norm(wf - w_approx.to(_F32))
    return float(err / (torch.linalg.vector_norm(wf) + 1e-30))


def approximation_error(w: torch.Tensor, f: TuckerFactors) -> float:
    return relative_error(w, reconstruct(f))


def tucker2_params(c: int, s: int, k: int, r1: int, r2: int) -> int:
    return c * r1 + r1 * r2 * k * k + r2 * s


def dense_conv_params(c: int, s: int, k: int) -> int:
    return c * s * k * k


def tucker2_flops(c: int, s: int, k: int, r1: int, r2: int,
                  out_hw: int) -> float:
    """Forward FLOPs for one image at output spatial size out_hw^2."""
    m = out_hw * out_hw
    return 2.0 * m * (c * r1 + r1 * r2 * k * k + r2 * s)


def dense_conv_flops(c: int, s: int, k: int, out_hw: int) -> float:
    return 2.0 * out_hw * out_hw * c * s * k * k


def ratio_ranks(c: int, s: int, k: int, compression: float,
                beta: float | None = None) -> tuple[int, int]:
    """Ranks (r1, r2) hitting a target compression ratio (paper Eq. 7).

    ``beta = r2 / r1`` defaults to S/C.  Solves
        c*r1 + beta*k^2*r1^2 + beta*r1*s = c*s*k^2 / alpha
    for r1 (the positive root of the quadratic)."""
    if beta is None:
        beta = s / c
    a = beta * k * k
    b = c + beta * s
    rhs = c * s * k * k / compression
    r1 = (-b + (b * b + 4.0 * a * rhs) ** 0.5) / (2.0 * a)
    r1 = max(1, min(int(r1), c))
    r2 = max(1, min(int(round(beta * r1)), s))
    return r1, r2
