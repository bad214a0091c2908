"""Wrapper of the branched low-rank CUDA kernels on quantized factors,
``y = sum_n ((x @ dq(u_n)) @ dq(xc_n)) @ dq(v_n)`` (paper Eq. 17).

The kernels replace the TPU kernel
``repro/kernels/branched_matmul_q.py::branched_matmul_q`` in the forms
bf16 ``branched_matmul`` runs, as
:func:`repro_torch.kernels.branched_matmul.chain_form` names them: bf16
``x`` below ``LARGE_M_Q`` rows goes to the split-phase tensor-core kernel
(``csrc/branched_matmul_q.cu``) on dequantizing weight views (one
cooperative launch, the work split of
:func:`repro_torch.kernels.branched_matmul.branched_split`); bf16 at
``LARGE_M_Q`` rows or more to the large-M form (``csrc/chain_wgmma.cuh``)
on factors the dequantizing pass (``csrc/chain_dequant.cu``) first
writes into the call's scratch as bf16; f32 at every M to the f32 form
(``csrc/chain_f32.cu``), which reads the factors' int8 / e4m3 bytes.  The
source notes say what bounds them and how the designs answer.  This
wrapper checks the operands, allocates the output and the scratch,
launches on the current stream and counts launches (one a call, whatever
the form).  CUDA tensors only: the CPU path is the plain version in
:mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels.ops`.
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
    or e4m3 with f32 scales (N,1,r1), (N,1,r2), (N,1,S) -> (M,S), in the
    form ``branched_matmul.chain_form`` names: f32 the f32 form, bf16 at
    M >= LARGE_M_Q the large-M form, at fewer rows the split-phase kernel
    (none takes empty factors).  One counted call whatever the form."""
    global launches
    args = (x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[5]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    bk.check_factors("branched_matmul_q", dims[1:5], u_q, xc_q, v_q)
    form = bk.chain_form(x.dtype, dims[0], quantized=True)
    if form == "split":
        _launch_mma(*args, y, None, dims)
    else:
        _launch_form(form, *args, y, dims)
    launches += 1
    return y


def split_branched_matmul_q(x: torch.Tensor, u_q: torch.Tensor,
                            u_scale: torch.Tensor, xc_q: torch.Tensor,
                            xc_scale: torch.Tensor, v_q: torch.Tensor,
                            v_scale: torch.Tensor) -> torch.Tensor:
    """The bf16 split-phase kernel at any M, uncounted: the earlier form
    of a large-M call (chip_smoke's ``prev_ms``) and one side of its
    LARGE_M sweep.  The serve path never calls it."""
    return _forced("split", x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale)


def large_m_branched_matmul_q(x: torch.Tensor, u_q: torch.Tensor,
                              u_scale: torch.Tensor, xc_q: torch.Tensor,
                              xc_scale: torch.Tensor, v_q: torch.Tensor,
                              v_scale: torch.Tensor) -> torch.Tensor:
    """The large-M form at any M, uncounted: the other side of
    chip_smoke's LARGE_M sweep.  bf16 only; f32 or empty factors raise
    before anything is launched."""
    return _forced("large_m", x, u_q, u_scale, xc_q, xc_scale, v_q,
                   v_scale)


def dequant_branched_matmul_q(x: torch.Tensor, u_q: torch.Tensor,
                              u_scale: torch.Tensor, xc_q: torch.Tensor,
                              xc_scale: torch.Tensor, v_q: torch.Tensor,
                              v_scale: torch.Tensor) -> torch.Tensor | None:
    """The dequantizing pass alone of the call's form, uncounted (see
    ``lowrank_matmul_q.dequant_lowrank_matmul_q``): its scratch, or None
    where the form runs no pass."""
    args = (x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale)
    dims = _check(*args)
    bk.check_factors("branched_matmul_q", dims[1:5], u_q, xc_q, v_q)
    form = bk.chain_form(x.dtype, dims[0], quantized=True)
    if form == "split" or not dims[0] * dims[5]:
        return None
    return _launch_form(form, *args, None, dims, products=False)


def _forced(form: str, x, *factors) -> torch.Tensor:
    """B4 on bf16 ``x`` in ``form`` ("split" or "large_m") whatever M,
    uncounted."""
    args = (x, *factors)
    dims = _check(*args)
    what = f"{form}_branched_matmul_q"
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} runs bf16 activations, got {x.dtype}")
    bk.check_factors(what, dims[1:5], *factors[::2])
    y = torch.empty((dims[0], dims[5]), dtype=x.dtype, device=x.device)
    if y.numel():
        if form == "split":
            _launch_mma(*args, y, None, dims)
        else:
            _launch_form(form, *args, y, dims)
    return y


def _launch_form(form: str, x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale,
                 y: torch.Tensor | None, dims: tuple[int, ...],
                 products: bool = True) -> torch.Tensor:
    """The large-M or the f32 form (``form``) on quantized factors already
    checked: the form's launcher with the scales; its scratch."""
    launch = bk.launch_f32 if form == "f32" else bk.launch_large_m
    return launch(x, (u_q, xc_q, v_q), y, dims, "branched_matmul_q",
                  scales=(u_scale, xc_scale, v_scale),
                  qcode=QDTYPES[u_q.dtype], products=products)


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
    """The cluster kernel in x's dtype, uncounted: the earlier design of
    both dtypes, kept as a yardstick for the split-phase kernel and the
    f32 form (chip_smoke's ``prev_ms``).  The serve path never calls
    it."""
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
    """The cluster kernel (8-CTA clusters, CUDA-core FMAs): the earlier
    kernel of both dtypes, kept as the yardstick
    :func:`cluster_branched_matmul_q` launches."""
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
