"""Wrapper of the branched low-rank CUDA kernel on 2:4-packed quantized
factors, ``y = sum_n ((x @ ds(u_n)) @ dq(xc_n)) @ ds(v_n)`` (paper
Eq. 17).

The kernel (``csrc/branched_matmul_sq.cu``) replaces the TPU kernel
``repro/kernels/branched_matmul_sq.py::branched_matmul_sq``; its source
note says what bounds it and how the design answers.  This wrapper
checks the operands, allocates the output, launches on the current
stream and counts launches.  CUDA tensors only: the CPU path is the
plain version in :mod:`repro_torch.kernels.ref`, chosen by
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES
from repro_torch.kernels.lowrank_matmul_q import QDTYPES, check_operands
from repro_torch.kernels.lowrank_matmul_sq import check_packs

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0


def branched_matmul_sq(x: torch.Tensor, u_sp: torch.Tensor,
                       u_idx: torch.Tensor, u_scale: torch.Tensor,
                       xc_q: torch.Tensor, xc_scale: torch.Tensor,
                       v_sp: torch.Tensor, v_idx: torch.Tensor,
                       v_scale: torch.Tensor) -> torch.Tensor:
    """x (M,C) f32/bf16; u_sp (N,2,C/4,r1) + u_idx (N,2,C/4,1) + u_scale
    (N,1,r1); xc_q (N,r1,r2) + xc_scale (N,1,r2); v_sp (N,2,r2/4,S) +
    v_idx (N,2,r2/4,1) + v_scale (N,1,S); the packs and the core in one
    int8 / e4m3 dtype, f32 scales -> (M,S) in x.dtype."""
    global launches
    qdtype = check_packs("branched_matmul_sq", x,
                         [("u", u_sp, u_idx, u_scale, 4),
                          ("v", v_sp, v_idx, v_scale, 4)])
    check_operands("branched_matmul_sq", x, [("xc", xc_q, xc_scale, 3)])
    if xc_q.dtype != qdtype:
        raise TypeError(f"branched_matmul_sq kernel: xc_q is {xc_q.dtype}, "
                        f"the packs {qdtype}")
    m, c = x.shape
    n, _, c4, r1 = u_sp.shape
    n2, r1b, r2 = xc_q.shape
    n3, _, r24, s = v_sp.shape
    if (c != 4 * c4 or n != n2 or n != n3 or r1 != r1b or r2 != 4 * r24):
        raise ValueError(
            f"branched_matmul_sq kernel: shapes {tuple(x.shape)} "
            f"{tuple(u_sp.shape)} {tuple(xc_q.shape)} {tuple(v_sp.shape)} "
            "do not chain in groups of 4 (C and r2 must be multiples of 4)")
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    lib = build.load()
    bm, smem = build.chain_bm(
        m, lambda bm: lib.lrk_branched_smem(DTYPES[x.dtype], bm, n, r1, r2))
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"branched_matmul_sq kernel: {n} branches of ranks "
                         f"({r1}, {r2}) need {smem} B of shared memory at "
                         f"{bm} rows (limit {build.SMEM_LIMIT})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_branched_matmul_sq(
            DTYPES[x.dtype], QDTYPES[qdtype], bm, x.data_ptr(),
            u_sp.data_ptr(), u_idx.data_ptr(), u_scale.data_ptr(),
            xc_q.data_ptr(), xc_scale.data_ptr(), v_sp.data_ptr(),
            v_idx.data_ptr(), v_scale.data_ptr(), y.data_ptr(), m, c, n, r1,
            r2, s, stream)
    build.check(lib, rc, "branched_matmul_sq")
    launches += 1
    return y
