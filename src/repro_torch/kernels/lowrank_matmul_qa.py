"""Wrapper of the activation-quantized low-rank CUDA kernel: int8 rows of
x, ``y = dq(q(dq(q(x) @ w0_q)) @ w1_q)`` with every dot int8 x int8.

The kernel (``csrc/lowrank_matmul_qa.cu``) replaces the TPU kernel
``repro/kernels/lowrank_matmul_qa.py::lowrank_matmul_qa`` (with its
``quantize_rows``); its source note says what bounds it and how the
design answers.  This wrapper checks the operands, allocates the output,
launches on the current stream and counts launches.  CUDA tensors only:
the CPU path is the plain version in :mod:`repro_torch.kernels.ref`,
chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES
from repro_torch.kernels.lowrank_matmul_q import check_operands

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0


def check_int8(name: str, *factors: torch.Tensor) -> None:
    """The activation-quantized kernels take int8 factors only (fp8
    plans keep the weight-only kernels)."""
    for q in factors:
        if q.dtype != torch.int8:
            raise TypeError(f"{name} kernel takes int8 factors, got "
                            f"{q.dtype}")


def lowrank_matmul_qa(x: torch.Tensor, w0_q: torch.Tensor,
                      w0_scale: torch.Tensor, w1_q: torch.Tensor,
                      w1_scale: torch.Tensor) -> torch.Tensor:
    """x (M,C) f32/bf16; w0_q (C,R) int8 + w0_scale (1,R); w1_q (R,S)
    int8 + w1_scale (1,S); f32 scales -> (M,S) in x.dtype."""
    global launches
    check_operands("lowrank_matmul_qa", x, [("w0", w0_q, w0_scale, 2),
                                            ("w1", w1_q, w1_scale, 2)])
    check_int8("lowrank_matmul_qa", w0_q, w1_q)
    m, c = x.shape
    c2, r = w0_q.shape
    r2, s = w1_q.shape
    if c != c2 or r != r2:
        raise ValueError(f"lowrank_matmul_qa kernel: shapes "
                         f"{tuple(x.shape)} {tuple(w0_q.shape)} "
                         f"{tuple(w1_q.shape)} do not chain")
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    lib = build.load()
    bm, smem = build.chain_bm(m, lambda bm: lib.lrk_lowrank_qa_smem(bm, r))
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"lowrank_matmul_qa kernel: rank {r} needs {smem} "
                         f"B of shared memory at {bm} rows (limit "
                         f"{build.SMEM_LIMIT})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_lowrank_matmul_qa(
            DTYPES[x.dtype], bm, x.data_ptr(), w0_q.data_ptr(),
            w0_scale.data_ptr(), w1_q.data_ptr(), w1_scale.data_ptr(),
            y.data_ptr(), m, c, r, s, stream)
    build.check(lib, rc, "lowrank_matmul_qa")
    launches += 1
    return y
