"""Public entry points of the low-rank chain kernels.

Each flattens leading dims (``(..., C) -> (M, C)``) and dispatches by the
device the activation lives on: a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`; any other device goes to the CUDA kernel,
which launches or raises.  Nothing else -- no padding (the kernels mask
ragged M, C, R and S themselves) and no fit fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import branched_matmul as bk
from repro_torch.kernels import lowrank_matmul as lk
from repro_torch.kernels import ref


def lowrank_matmul(x: torch.Tensor, w0: torch.Tensor,
                   w1: torch.Tensor) -> torch.Tensor:
    """y = (x @ w0) @ w1.  x (..., C); w0 (C, R); w1 (R, S) -> (..., S)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.lowrank_matmul_ref(x2, w0, w1)
    else:
        y = lk.lowrank_matmul(x2.contiguous(), w0, w1)
    return y.reshape(*lead, w1.shape[-1])


def branched_matmul(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """y = sum_n ((x @ u_n) @ xc_n) @ v_n.  x (..., C) -> (..., S)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.branched_matmul_ref(x2, u, xc, v)
    else:
        y = bk.branched_matmul(x2.contiguous(), u, xc, v)
    return y.reshape(*lead, v.shape[-1])
