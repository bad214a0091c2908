"""Plain PyTorch versions of the hand-written kernels.

They repeat the reference's rounding points exactly (every product
accumulates in f32, intermediates round to ``x.dtype`` between products,
the output rounds to ``x.dtype``): the CPU path runs them, and the card
holds each kernel against them on the same inputs.  Operands are cast
to f32 before each product — for bf16 inputs that is the f32
accumulation of exact bf16 products the reference asks for.
"""
from __future__ import annotations

import torch


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def lowrank_matmul_ref(x: torch.Tensor, w0: torch.Tensor,
                       w1: torch.Tensor) -> torch.Tensor:
    """y = (x @ w0) @ w1 through the rank bottleneck. x (M,C) -> (M,S)."""
    h = torch.matmul(_f32(x), _f32(w0))
    y = torch.matmul(_f32(h.to(x.dtype)), _f32(w1))
    return y.to(x.dtype)


def branched_matmul_ref(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """y = sum_n ((x @ u_n) @ xc_n) @ v_n  (paper Eq. 17).

    x (M,C); u (N,C,r1); xc (N,r1,r2); v (N,r2,S) -> (M,S).
    """
    h = torch.einsum("mc,ncr->nmr", _f32(x), _f32(u)).to(x.dtype)
    h = torch.einsum("nmr,nrs->nms", _f32(h), _f32(xc)).to(x.dtype)
    y = torch.einsum("nms,nso->mo", _f32(h), _f32(v))
    return y.to(x.dtype)
