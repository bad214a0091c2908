"""Wrapper of the branched low-rank CUDA kernels on 2:4-packed quantized
factors, ``y = sum_n ((x @ ds(u_n)) @ dq(xc_n)) @ ds(v_n)`` (paper
Eq. 17).

The kernels (``csrc/branched_matmul_sq.cu``) replace the TPU kernel
``repro/kernels/branched_matmul_sq.py::branched_matmul_sq``; the source
note says what bounds them and how the design answers.  bf16 ``x`` goes
to the split-phase tensor-core kernel of bf16 ``branched_matmul`` on
2:4-expanding (u, v) and dequantizing (xc) weight views (one cooperative
launch, the same work split,
:func:`repro_torch.kernels.branched_matmul.branched_split`); f32 ``x``
to the cluster kernel.  This wrapper checks the operands, allocates the
output (and the split's scratch), launches on the current stream and
counts launches.  CUDA tensors only: the CPU path is the plain version
in :mod:`repro_torch.kernels.ref`, chosen by
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import branched_matmul as bk
from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES
from repro_torch.kernels.lowrank_matmul_q import QDTYPES, check_operands
from repro_torch.kernels.lowrank_matmul_sq import check_packs

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0


def _check(x, u_sp, u_idx, u_scale, xc_q, xc_scale, v_sp, v_idx, v_scale
           ) -> tuple[int, int, int, int, int, int]:
    """Raise on operands the kernels do not take; return ``(m, c, n, r1,
    r2, s)``."""
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
    return m, c, n, r1, r2, s


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
    args = (x, u_sp, u_idx, u_scale, xc_q, xc_scale, v_sp, v_idx, v_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[5]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if x.dtype == torch.float32:
        _launch_cluster(*args, y, dims)
    else:
        bk.check_factors("branched_matmul_sq", dims[1:5], u_sp, xc_q,
                            v_sp)
        _launch_mma(*args, y, None, dims)
    launches += 1
    return y


def branched_matmul_sq_phase_us(x: torch.Tensor, u_sp: torch.Tensor,
                                u_idx: torch.Tensor, u_scale: torch.Tensor,
                                xc_q: torch.Tensor, xc_scale: torch.Tensor,
                                v_sp: torch.Tensor, v_idx: torch.Tensor,
                                v_scale: torch.Tensor) -> list[float]:
    """One counted launch of the bf16 split-phase kernel with its phase
    timer on: microseconds of each phase (1, 2, 3 per row block)."""
    global launches
    args = (x, u_sp, u_idx, u_scale, xc_q, xc_scale, v_sp, v_idx, v_scale)
    dims = _check(*args)
    us = bk.phase_us(lambda y, ts: _launch_mma(*args, y, ts, dims), x, dims)
    launches += 1
    return us


def cluster_branched_matmul_sq(x: torch.Tensor, u_sp: torch.Tensor,
                               u_idx: torch.Tensor, u_scale: torch.Tensor,
                               xc_q: torch.Tensor, xc_scale: torch.Tensor,
                               v_sp: torch.Tensor, v_idx: torch.Tensor,
                               v_scale: torch.Tensor) -> torch.Tensor:
    """The cluster kernel in x's dtype, bf16 included, uncounted: the
    earlier bf16 design, kept as a yardstick for the split-phase kernel
    (chip_smoke's ``prev_ms``).  The serve path never calls it."""
    args = (x, u_sp, u_idx, u_scale, xc_q, xc_scale, v_sp, v_idx, v_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[5]), dtype=x.dtype, device=x.device)
    if y.numel():
        _launch_cluster(*args, y, dims)
    return y


def _launch_mma(x, u_sp, u_idx, u_scale, xc_q, xc_scale, v_sp, v_idx,
                v_scale, y: torch.Tensor, ts: torch.Tensor | None,
                dims: tuple[int, ...]) -> None:
    """The split-phase kernel on bf16 operands already checked."""
    bk.launch_split("lrk_branched_matmul_sq_mma", (QDTYPES[u_sp.dtype],), x,
                    (u_sp, u_idx, u_scale, xc_q, xc_scale, v_sp, v_idx,
                     v_scale), y, dims, ts, "branched_matmul_sq")


def _launch_cluster(x, u_sp, u_idx, u_scale, xc_q, xc_scale, v_sp, v_idx,
                    v_scale, y: torch.Tensor, dims: tuple[int, ...]) -> None:
    """The cluster kernel (8-CTA clusters, CUDA-core FMAs): f32's kernel."""
    m, c, n, r1, r2, s = dims
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
            DTYPES[x.dtype], QDTYPES[u_sp.dtype], bm, x.data_ptr(),
            u_sp.data_ptr(), u_idx.data_ptr(), u_scale.data_ptr(),
            xc_q.data_ptr(), xc_scale.data_ptr(), v_sp.data_ptr(),
            v_idx.data_ptr(), v_scale.data_ptr(), y.data_ptr(), m, c, n, r1,
            r2, s, stream)
    build.check(lib, rc, "branched_matmul_sq")
