"""Wrapper of the activation-quantized branched CUDA kernel: x quantized
per row once, each branch's three dots int8 x int8 with per-row
requantization between them, the branch sum in f32 (paper Eq. 17).

The kernel (``csrc/branched_matmul_qa.cu``) replaces the TPU kernel
``repro/kernels/branched_matmul_qa.py::branched_matmul_qa``; its source
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
from repro_torch.kernels.lowrank_matmul_q import check_operands
from repro_torch.kernels.lowrank_matmul_qa import check_int8

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0


def branched_matmul_qa(x: torch.Tensor, u_q: torch.Tensor,
                       u_scale: torch.Tensor, xc_q: torch.Tensor,
                       xc_scale: torch.Tensor, v_q: torch.Tensor,
                       v_scale: torch.Tensor) -> torch.Tensor:
    """x (M,C) f32/bf16; u_q (N,C,r1), xc_q (N,r1,r2), v_q (N,r2,S) int8
    with f32 scales (N,1,r1), (N,1,r2), (N,1,S) -> (M,S) in x.dtype."""
    global launches
    check_operands("branched_matmul_qa", x, [("u", u_q, u_scale, 3),
                                             ("xc", xc_q, xc_scale, 3),
                                             ("v", v_q, v_scale, 3)])
    check_int8("branched_matmul_qa", u_q, xc_q, v_q)
    m, c = x.shape
    n, c2, r1 = u_q.shape
    n2, r1b, r2 = xc_q.shape
    n3, r2b, s = v_q.shape
    if c != c2 or n != n2 or n != n3 or r1 != r1b or r2 != r2b:
        raise ValueError(
            f"branched_matmul_qa kernel: shapes {tuple(x.shape)} "
            f"{tuple(u_q.shape)} {tuple(xc_q.shape)} {tuple(v_q.shape)} do "
            "not chain")
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    lib = build.load()
    bm, smem = build.chain_bm(
        m, lambda bm: lib.lrk_branched_qa_smem(bm, n, r1, r2))
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"branched_matmul_qa kernel: {n} branches of ranks "
                         f"({r1}, {r2}) need {smem} B of shared memory at "
                         f"{bm} rows (limit {build.SMEM_LIMIT})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_branched_matmul_qa(
            DTYPES[x.dtype], bm, x.data_ptr(), u_q.data_ptr(),
            u_scale.data_ptr(), xc_q.data_ptr(), xc_scale.data_ptr(),
            v_q.data_ptr(), v_scale.data_ptr(), y.data_ptr(), m, c, n, r1,
            r2, s, stream)
    build.check(lib, rc, "branched_matmul_qa")
    launches += 1
    return y
