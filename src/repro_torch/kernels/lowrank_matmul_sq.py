"""Wrapper of the fused low-rank CUDA kernel on 2:4-packed quantized
factors, ``y = (x @ ds(w0)) @ ds(w1)``.

The kernel (``csrc/lowrank_matmul_sq.cu``) replaces the TPU kernel
``repro/kernels/lowrank_matmul_sq.py::lowrank_matmul_sq``; its source
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
from repro_torch.kernels.lowrank_matmul_q import QDTYPES, check_activation

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0


def check_packs(name: str, x: torch.Tensor,
                packs: list[tuple[str, torch.Tensor, torch.Tensor,
                                  torch.Tensor, int]]) -> torch.dtype:
    """Raise unless every ``(label, sp, idx, scale, ndim)`` is a contiguous
    2:4 pack on ``x``'s device: ``sp (..., 2, G, N)`` of ``ndim`` dims in
    one int8 / e4m3 dtype, ``idx (..., 2, G, 1)`` int8 and ``scale (...,
    1, N)`` f32, and ``x`` passes :func:`check_activation`.  Returns the
    packs' storage dtype."""
    check_activation(name, x)
    qdtype = packs[0][1].dtype
    for label, sp, idx, scale, nd in packs:
        if qdtype not in QDTYPES or sp.dtype != qdtype:
            raise TypeError(f"{name} kernel: {label}_sp is {sp.dtype}; want "
                            "one of int8 / float8_e4m3fn for every pack")
        if sp.ndim != nd or sp.shape[-3] != 2:
            raise ValueError(f"{name} kernel: {label}_sp must be a "
                             f"{nd}-D slot-major pack (..., 2, G, N), got "
                             f"{tuple(sp.shape)}")
        lead = tuple(sp.shape[:-2])
        if idx.dtype != torch.int8 or tuple(idx.shape) != (*lead,
                                                           sp.shape[-2], 1):
            raise ValueError(f"{name} kernel: {label}_idx must be int8 "
                             f"{(*lead, sp.shape[-2], 1)}, got {idx.dtype} "
                             f"{tuple(idx.shape)}")
        want = (*sp.shape[:-3], 1, sp.shape[-1])
        if scale.dtype != torch.float32 or tuple(scale.shape) != want:
            raise TypeError(f"{name} kernel: {label}_scale must be float32 "
                            f"{want}, got {scale.dtype} "
                            f"{tuple(scale.shape)}")
        for t in (sp, idx, scale):
            if t.device != x.device:
                raise ValueError(f"{name} kernel: operands on {x.device} "
                                 f"and {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name} kernel: {label} operands must "
                                 "be contiguous")
    return qdtype


def lowrank_matmul_sq(x: torch.Tensor, w0_sp: torch.Tensor,
                      w0_idx: torch.Tensor, w0_scale: torch.Tensor,
                      w1_sp: torch.Tensor, w1_idx: torch.Tensor,
                      w1_scale: torch.Tensor) -> torch.Tensor:
    """x (M,C) f32/bf16; w0_sp (2,C/4,R) + w0_idx (2,C/4,1) + w0_scale
    (1,R); w1_sp (2,R/4,S) + w1_idx (2,R/4,1) + w1_scale (1,S); int8 or
    e4m3 values, f32 scales -> (M,S) in x.dtype."""
    global launches
    qdtype = check_packs("lowrank_matmul_sq", x,
                         [("w0", w0_sp, w0_idx, w0_scale, 3),
                          ("w1", w1_sp, w1_idx, w1_scale, 3)])
    m, c = x.shape
    _, c4, r = w0_sp.shape
    _, r4, s = w1_sp.shape
    if c != 4 * c4 or r != 4 * r4:
        raise ValueError(
            f"lowrank_matmul_sq kernel: shapes {tuple(x.shape)} "
            f"{tuple(w0_sp.shape)} {tuple(w1_sp.shape)} do not chain in "
            "groups of 4 (C and R must be multiples of 4)")
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    lib = build.load()
    bm, smem = build.chain_bm(
        m, lambda bm: lib.lrk_lowrank_smem(DTYPES[x.dtype], bm, r))
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"lowrank_matmul_sq kernel: rank {r} needs {smem} "
                         f"B of shared memory at {bm} rows (limit "
                         f"{build.SMEM_LIMIT})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_lowrank_matmul_sq(
            DTYPES[x.dtype], QDTYPES[qdtype], bm, x.data_ptr(),
            w0_sp.data_ptr(), w0_idx.data_ptr(), w0_scale.data_ptr(),
            w1_sp.data_ptr(), w1_idx.data_ptr(), w1_scale.data_ptr(),
            y.data_ptr(), m, c, r, s, stream)
    build.check(lib, rc, "lowrank_matmul_sq")
    launches += 1
    return y
