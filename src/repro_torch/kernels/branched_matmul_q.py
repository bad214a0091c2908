"""Wrapper of the branched low-rank CUDA kernels on quantized factors,
``y = sum_n ((x @ dq(u_n)) @ dq(xc_n)) @ dq(v_n)`` (paper Eq. 17).

The kernels (``csrc/branched_matmul_q.cu``) replace the TPU kernel
``repro/kernels/branched_matmul_q.py::branched_matmul_q``; the source
note says what bounds them and how the design answers.  bf16 ``x`` goes
to the split-phase tensor-core kernel of bf16 ``branched_matmul`` on
dequantizing weight views (one cooperative launch, the same work split,
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

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0


def _check(x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale
           ) -> tuple[int, int, int, int, int, int]:
    """Raise on operands the kernels do not take; return ``(m, c, n, r1,
    r2, s)``."""
    check_operands("branched_matmul_q", x, [("u", u_q, u_scale, 3),
                                            ("xc", xc_q, xc_scale, 3),
                                            ("v", v_q, v_scale, 3)])
    m, c = x.shape
    n, c2, r1 = u_q.shape
    n2, r1b, r2 = xc_q.shape
    n3, r2b, s = v_q.shape
    if c != c2 or n != n2 or n != n3 or r1 != r1b or r2 != r2b:
        raise ValueError(
            f"branched_matmul_q kernel: shapes {tuple(x.shape)} "
            f"{tuple(u_q.shape)} {tuple(xc_q.shape)} {tuple(v_q.shape)} do "
            "not chain")
    return m, c, n, r1, r2, s


def branched_matmul_q(x: torch.Tensor, u_q: torch.Tensor,
                      u_scale: torch.Tensor, xc_q: torch.Tensor,
                      xc_scale: torch.Tensor, v_q: torch.Tensor,
                      v_scale: torch.Tensor) -> torch.Tensor:
    """x (M,C) f32/bf16; u_q (N,C,r1), xc_q (N,r1,r2), v_q (N,r2,S) int8
    or e4m3 with f32 scales (N,1,r1), (N,1,r2), (N,1,S) -> (M,S)."""
    global launches
    args = (x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[5]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if x.dtype == torch.float32:
        _launch_cluster(*args, y, dims)
    else:
        bk.check_factors("branched_matmul_q", dims[1:5], u_q, xc_q, v_q)
        _launch_mma(*args, y, None, dims)
    launches += 1
    return y


def branched_matmul_q_phase_us(x: torch.Tensor, u_q: torch.Tensor,
                               u_scale: torch.Tensor, xc_q: torch.Tensor,
                               xc_scale: torch.Tensor, v_q: torch.Tensor,
                               v_scale: torch.Tensor) -> list[float]:
    """One counted launch of the bf16 split-phase kernel with its phase
    timer on: microseconds of each phase (1, 2, 3 per row block)."""
    global launches
    args = (x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale)
    dims = _check(*args)
    us = bk.phase_us(lambda y, ts: _launch_mma(*args, y, ts, dims), x, dims)
    launches += 1
    return us


def cluster_branched_matmul_q(x: torch.Tensor, u_q: torch.Tensor,
                              u_scale: torch.Tensor, xc_q: torch.Tensor,
                              xc_scale: torch.Tensor, v_q: torch.Tensor,
                              v_scale: torch.Tensor) -> torch.Tensor:
    """The cluster kernel in x's dtype, bf16 included, uncounted: the
    earlier bf16 design, kept as a yardstick for the split-phase kernel
    (chip_smoke's ``prev_ms``).  The serve path never calls it."""
    args = (x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[5]), dtype=x.dtype, device=x.device)
    if y.numel():
        _launch_cluster(*args, y, dims)
    return y


def _launch_mma(x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale,
                y: torch.Tensor, ts: torch.Tensor | None,
                dims: tuple[int, ...]) -> None:
    """The split-phase kernel on bf16 operands already checked."""
    bk.launch_split("lrk_branched_matmul_q_mma", (QDTYPES[u_q.dtype],), x,
                    (u_q, u_scale, xc_q, xc_scale, v_q, v_scale), y, dims,
                    ts, "branched_matmul_q")


def _launch_cluster(x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale,
                    y: torch.Tensor, dims: tuple[int, ...]) -> None:
    """The cluster kernel (8-CTA clusters, CUDA-core FMAs): f32's kernel."""
    m, c, n, r1, r2, s = dims
    lib = build.load()
    bm, _ = build.chain_fit(
        m, lambda bm: lib.lrk_branched_smem(DTYPES[x.dtype], bm, n, r1, r2),
        build.chain_heights(x.dtype),
        f"branched_matmul_q kernel at {n} branches of ranks ({r1}, {r2})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_branched_matmul_q(
            DTYPES[x.dtype], QDTYPES[u_q.dtype], bm, x.data_ptr(),
            u_q.data_ptr(), u_scale.data_ptr(), xc_q.data_ptr(),
            xc_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
            y.data_ptr(), m, c, n, r1, r2, s, stream)
    build.check(lib, rc, "branched_matmul_q")
