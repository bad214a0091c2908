"""Wrapper of the fused low-rank CUDA kernel on quantized factors,
``y = (x @ dq(w0)) @ dq(w1)``.

The kernel (``csrc/lowrank_matmul_q.cu``) replaces the TPU kernel
``repro/kernels/lowrank_matmul_q.py::lowrank_matmul_q``; its source note
says what bounds it and how the design answers.  This wrapper checks the
operands, allocates the output, launches on the current stream and
counts launches.  CUDA tensors only: the CPU path is the plain version
in :mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0

#: factor storage the kernels take, with its code in the C interface
QDTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}


def check_operands(name: str, x: torch.Tensor,
                   factors: list[tuple[str, torch.Tensor, torch.Tensor, int]]
                   ) -> None:
    """Raise unless ``x`` is a contiguous 2-D f32/bf16 CUDA tensor and
    every ``(label, q, scale, ndim)`` is a contiguous int8/e4m3 factor of
    ``ndim`` dims on the same device, of one storage dtype, with a
    contiguous f32 scale of its shape with the input axis collapsed."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel: x is on {x.device}, not a CUDA "
                         "device")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 "
                        f"activations, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name} kernel: x must be a contiguous 2-D "
                         f"tensor, got {tuple(x.shape)}")
    qdtype = factors[0][1].dtype
    for label, q, scale, nd in factors:
        if qdtype not in QDTYPES or q.dtype != qdtype:
            raise TypeError(f"{name} kernel: {label}_q is {q.dtype}; want "
                            "one of int8 / float8_e4m3fn for every factor")
        want = (*q.shape[:-2], 1, q.shape[-1])
        if scale.dtype != torch.float32 or tuple(scale.shape) != want:
            raise TypeError(f"{name} kernel: {label}_scale must be float32 "
                            f"{want}, got {scale.dtype} "
                            f"{tuple(scale.shape)}")
        for t in (q, scale):
            if t.device != x.device:
                raise ValueError(f"{name} kernel: operands on {x.device} "
                                 f"and {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} kernel: {label} operands must "
                                 "be contiguous")
        if q.ndim != nd:
            raise ValueError(f"{name} kernel: {label}_q must be {nd}-D, "
                             f"got {tuple(q.shape)}")


def lowrank_matmul_q(x: torch.Tensor, w0_q: torch.Tensor,
                     w0_scale: torch.Tensor, w1_q: torch.Tensor,
                     w1_scale: torch.Tensor) -> torch.Tensor:
    """x (M,C) f32/bf16; w0_q (C,R) + w0_scale (1,R); w1_q (R,S) +
    w1_scale (1,S); int8 or e4m3 values, f32 scales -> (M,S) in x.dtype."""
    global launches
    check_operands("lowrank_matmul_q", x, [("w0", w0_q, w0_scale, 2),
                                           ("w1", w1_q, w1_scale, 2)])
    m, c = x.shape
    c2, r = w0_q.shape
    r2, s = w1_q.shape
    if c != c2 or r != r2:
        raise ValueError(f"lowrank_matmul_q kernel: shapes {tuple(x.shape)} "
                         f"{tuple(w0_q.shape)} {tuple(w1_q.shape)} do not "
                         "chain")
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    lib = build.load()
    smem = int(lib.lrk_lowrank_smem(DTYPES[x.dtype], m, r))
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"lowrank_matmul_q kernel: rank {r} needs {smem} B "
                         f"of shared memory (limit {build.SMEM_LIMIT})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_lowrank_matmul_q(
            DTYPES[x.dtype], QDTYPES[w0_q.dtype], x.data_ptr(),
            w0_q.data_ptr(), w0_scale.data_ptr(), w1_q.data_ptr(),
            w1_scale.data_ptr(), y.data_ptr(), m, c, r, s, stream)
    build.check(lib, rc, "lowrank_matmul_q")
    launches += 1
    return y
