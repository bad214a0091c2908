"""Wrapper of the fused low-rank CUDA kernels ``y = (x @ w0) @ w1``.

The kernels (``csrc/lowrank_matmul.cu``) replace the TPU kernel
``repro/kernels/lowrank_matmul.py::lowrank_matmul``; the source note
says what bounds them and how the design answers.  bf16 goes to the
two-phase split kernel on the split-phase tensor-core core of bf16
``branched_matmul``, one cooperative launch whose work split
:func:`repro_torch.kernels.branched_matmul.lowrank_split` computes, or,
at ``LARGE_M`` rows or more, to the large-M form
(``csrc/chain_wgmma.cuh``, two ``wgmma`` launches: h, then y); f32
goes at every M to the f32 form (``csrc/chain_f32.cu``, two
output-tiled, K-sliced split-TF32 ``mma.sync`` launches planned by
:func:`repro_torch.kernels.branched_matmul.f32_plan`).  This wrapper
checks the operands, allocates the output and the scratch, launches on
the current stream and counts launches.  CUDA tensors only: the CPU path
is the plain version in
:mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import branched_matmul as bk
from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPES

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0


def check_operands(x: torch.Tensor, w0: torch.Tensor,
                   w1: torch.Tensor) -> tuple[int, int, int, int]:
    """Raise on operands the kernels do not take; return ``(M, C, R,
    S)``."""
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
    return m, c, r, s


def lowrank_matmul(x: torch.Tensor, w0: torch.Tensor,
                   w1: torch.Tensor) -> torch.Tensor:
    """x (M,C); w0 (C,R); w1 (R,S) -> (M,S), all one float dtype on one
    CUDA device, contiguous, in the form ``branched_matmul.chain_form``
    names: f32 the f32 form, bf16 at M >= LARGE_M the large-M form, at
    fewer rows the two-phase split kernel (none takes empty factors: C or
    R of 0 raise)."""
    return lowrank_matmul_split(x, w0, w1)


def lowrank_matmul_split(x: torch.Tensor, w0: torch.Tensor,
                         w1: torch.Tensor, **knobs) -> torch.Tensor:
    """:func:`lowrank_matmul`, one counted call; ``knobs``, the split
    plan's ``items`` and ``ctas`` asked of
    :func:`~repro_torch.kernels.branched_matmul.lowrank_split` (its
    defaults where not given), for a call that takes the split kernel
    (chip_smoke times other plans with it): a large-M or f32 call refuses
    them."""
    global launches
    dims = check_operands(x, w0, w1)
    y = torch.empty((dims[0], dims[3]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    bk.check_factors("lowrank_matmul", dims[1:3], w0, w1)
    form = bk.chain_form(x.dtype, dims[0])
    if form != "split" and knobs:
        raise ValueError(f"lowrank_matmul of {x.dtype} at M = {dims[0]} "
                         f"takes the {form} form, which has no {knobs}")
    if form == "f32":
        bk.launch_f32(x, (w0, w1), y, dims, "lowrank_matmul")
    elif form == "large_m":
        bk.launch_large_m(x, (w0, w1), y, dims, "lowrank_matmul")
    else:
        _launch_mma(x, w0, w1, y, None, dims, **knobs)
    launches += 1
    return y


def split_lowrank_matmul(x: torch.Tensor, w0: torch.Tensor,
                         w1: torch.Tensor) -> torch.Tensor:
    """The bf16 two-phase split kernel at any M, uncounted: the earlier
    form of a large-M call (chip_smoke's ``prev_ms``) and one side of its
    LARGE_M sweep.  The serve and train paths never call it."""
    return bk._forced("split_lowrank_matmul", x, (w0, w1),
                      check_operands(x, w0, w1))


def large_m_lowrank_matmul(x: torch.Tensor, w0: torch.Tensor,
                           w1: torch.Tensor) -> torch.Tensor:
    """The large-M form at any M, uncounted: the other side of
    chip_smoke's LARGE_M sweep.  bf16 only; f32 or empty factors raise
    before anything is launched."""
    return bk._forced("large_m_lowrank_matmul", x, (w0, w1),
                      check_operands(x, w0, w1))


def lowrank_matmul_phase_us(x: torch.Tensor, w0: torch.Tensor,
                            w1: torch.Tensor, **knobs) -> list[float]:
    """One counted launch of the bf16 two-phase split kernel with its
    phase timer on: microseconds of each phase (1, 2 per row block), read
    by CTA 0 from %globaltimer.  ``knobs``: the plan's ``items`` and
    ``ctas``, as for :func:`lowrank_matmul_split`."""
    global launches
    dims = check_operands(x, w0, w1)
    us = bk.phase_us(lambda y, ts: _launch_mma(x, w0, w1, y, ts, dims,
                                               **knobs), x, dims)
    launches += 1
    return us


def cluster_lowrank_matmul(x: torch.Tensor, w0: torch.Tensor,
                           w1: torch.Tensor) -> torch.Tensor:
    """The cluster kernel in x's dtype, uncounted: the earlier design of
    both dtypes, kept as a yardstick for the split kernel and the f32
    form (chip_smoke's ``prev_ms``).  The serve and train paths never call
    it."""
    dims = check_operands(x, w0, w1)
    y = torch.empty((dims[0], dims[3]), dtype=x.dtype, device=x.device)
    if y.numel():
        _launch_cluster(x, w0, w1, y, dims)
    return y


def _launch_mma(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                y: torch.Tensor, ts: torch.Tensor | None,
                dims: tuple[int, ...], **knobs) -> None:
    """The two-phase split kernel on bf16 operands already checked."""
    bk.launch_split("lrk_lowrank_matmul_mma", (), x, (w0, w1), y, dims, ts,
                    "lowrank_matmul", **knobs)


def _launch_cluster(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
                    y: torch.Tensor, dims: tuple[int, ...]) -> None:
    """The cluster kernel (8-CTA clusters, CUDA-core FMAs): the earlier
    f32 kernel, kept as the yardstick :func:`cluster_lowrank_matmul`
    launches."""
    m, c, r, s = dims
    lib = build.load()
    bm, _ = build.chain_fit(
        m, lambda bm: lib.lrk_lowrank_smem(DTYPES[x.dtype], bm, r),
        build.chain_heights(x.dtype), f"lowrank_matmul kernel at rank {r}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_lowrank_matmul(DTYPES[x.dtype], bm, x.data_ptr(),
                                    w0.data_ptr(), w1.data_ptr(),
                                    y.data_ptr(), m, c, r, s, stream)
    build.check(lib, rc, "lowrank_matmul")
