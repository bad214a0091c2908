"""Wrapper of the branched low-rank CUDA kernel
``y = sum_n ((x @ u_n) @ xc_n) @ v_n`` (paper Eq. 17).

The kernel (``csrc/branched_matmul.cu``) replaces the TPU kernel
``repro/kernels/branched_matmul.py::branched_matmul``; its source note
says what bounds it and how the design answers.  This wrapper checks the
operands, allocates the output, launches on the current stream and
counts launches.  CUDA tensors only: the CPU path is the plain version in
:mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0


def branched_matmul(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """x (M,C); u (N,C,r1); xc (N,r1,r2); v (N,r2,S) -> (M,S), all one
    float dtype on one CUDA device, contiguous."""
    global launches
    for name, t, nd in (("x", x, 2), ("u", u, 3), ("xc", xc, 3),
                        ("v", v, 3)):
        if t.device.type != "cuda":
            raise ValueError(f"branched_matmul kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.dtype != x.dtype:
            raise TypeError(f"branched_matmul kernel: {name} is {t.dtype}, "
                            f"x is {x.dtype}")
        if t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"branched_matmul kernel: {name} must be a "
                             f"contiguous {nd}-D tensor, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("branched_matmul kernel: operands on "
                             f"{x.device} and {t.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"branched_matmul kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    m, c = x.shape
    n, c2, r1 = u.shape
    n2, r1b, r2 = xc.shape
    n3, r2b, s = v.shape
    if c != c2 or n != n2 or n != n3 or r1 != r1b or r2 != r2b:
        raise ValueError(
            f"branched_matmul kernel: shapes {tuple(x.shape)} "
            f"{tuple(u.shape)} {tuple(xc.shape)} {tuple(v.shape)} do not "
            "chain")
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    lib = build.load()
    smem = int(lib.lrk_branched_smem(DTYPES[x.dtype], m, n, r1, r2))
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"branched_matmul kernel: {n} branches of ranks "
                         f"({r1}, {r2}) need {smem} B of shared memory "
                         f"(limit {build.SMEM_LIMIT})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_branched_matmul(DTYPES[x.dtype], x.data_ptr(),
                                     u.data_ptr(), xc.data_ptr(),
                                     v.data_ptr(), y.data_ptr(), m, c, n,
                                     r1, r2, s, stream)
    build.check(lib, rc, "branched_matmul")
    launches += 1
    return y
