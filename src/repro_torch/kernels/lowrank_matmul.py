"""Wrapper of the fused low-rank CUDA kernel ``y = (x @ w0) @ w1``.

The kernel (``csrc/lowrank_matmul.cu``) replaces the TPU kernel
``repro/kernels/lowrank_matmul.py::lowrank_matmul``; its source note says
what bounds it and how the design answers.  This wrapper checks the
operands, allocates the output, launches on the current stream and
counts launches.  It takes CUDA tensors only: the CPU path is the plain
version in :mod:`repro_torch.kernels.ref`, chosen by
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def lowrank_matmul(x: torch.Tensor, w0: torch.Tensor,
                   w1: torch.Tensor) -> torch.Tensor:
    """x (M,C); w0 (C,R); w1 (R,S) -> (M,S), all one float dtype on one
    CUDA device, contiguous."""
    global launches
    for name, t in (("x", x), ("w0", w0), ("w1", w1)):
        if t.device.type != "cuda":
            raise ValueError(f"lowrank_matmul kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.dtype != x.dtype:
            raise TypeError(f"lowrank_matmul kernel: {name} is {t.dtype}, "
                            f"x is {x.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"lowrank_matmul kernel: {name} must be a "
                             f"contiguous 2-D tensor, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("lowrank_matmul kernel: operands on "
                             f"{x.device} and {t.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"lowrank_matmul kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    m, c = x.shape
    c2, r = w0.shape
    r2, s = w1.shape
    if c != c2 or r != r2:
        raise ValueError(f"lowrank_matmul kernel: shapes {tuple(x.shape)} "
                         f"{tuple(w0.shape)} {tuple(w1.shape)} do not chain")
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    lib = build.load()
    smem = int(lib.lrk_lowrank_smem(DTYPES[x.dtype], m, r))
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"lowrank_matmul kernel: rank {r} needs {smem} B "
                         f"of shared memory (limit {build.SMEM_LIMIT})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_lowrank_matmul(DTYPES[x.dtype], x.data_ptr(),
                                    w0.data_ptr(), w1.data_ptr(),
                                    y.data_ptr(), m, c, r, s, stream)
    build.check(lib, rc, "lowrank_matmul")
    launches += 1
    return y
