"""Wrapper of the fused low-rank CUDA kernels on 2:4-packed quantized
factors, ``y = (x @ ds(w0)) @ ds(w1)``.

The kernels (``csrc/lowrank_matmul_sq.cu``) replace the TPU kernel
``repro/kernels/lowrank_matmul_sq.py::lowrank_matmul_sq``; the source
note says what bounds them and how the design answers.  bf16 goes to
the two-phase split kernel on the split-phase tensor-core core of bf16
``branched_matmul``, one cooperative launch whose work split
:func:`repro_torch.kernels.branched_matmul.lowrank_split` computes; f32
goes to the cluster kernel (tensor cores in TF32 cannot hold f32's
tolerance).  This wrapper checks the operands, allocates the output and
the scratch, launches on the current stream and counts launches.  CUDA
tensors only: the CPU path is the plain version in
:mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import branched_matmul as bk
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


def _check(x: torch.Tensor, w0_sp: torch.Tensor, w0_idx: torch.Tensor,
           w0_scale: torch.Tensor, w1_sp: torch.Tensor, w1_idx: torch.Tensor,
           w1_scale: torch.Tensor) -> tuple[int, int, int, int]:
    """Raise on operands the kernels do not take; return ``(M, C, R,
    S)``."""
    check_packs("lowrank_matmul_sq", x,
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
    return m, c, r, s


def lowrank_matmul_sq(x: torch.Tensor, w0_sp: torch.Tensor,
                      w0_idx: torch.Tensor, w0_scale: torch.Tensor,
                      w1_sp: torch.Tensor, w1_idx: torch.Tensor,
                      w1_scale: torch.Tensor) -> torch.Tensor:
    """x (M,C) f32/bf16; w0_sp (2,C/4,R) + w0_idx (2,C/4,1) + w0_scale
    (1,R); w1_sp (2,R/4,S) + w1_idx (2,R/4,1) + w1_scale (1,S); int8 or
    e4m3 values, f32 scales -> (M,S) in x.dtype.  bf16 takes the
    two-phase split kernel, which takes no empty factors (C or R of 0
    raise); f32 the cluster kernel."""
    return lowrank_matmul_sq_split(x, w0_sp, w0_idx, w0_scale, w1_sp,
                                   w1_idx, w1_scale)


def lowrank_matmul_sq_split(x: torch.Tensor, w0_sp: torch.Tensor,
                            w0_idx: torch.Tensor, w0_scale: torch.Tensor,
                            w1_sp: torch.Tensor, w1_idx: torch.Tensor,
                            w1_scale: torch.Tensor, **knobs) -> torch.Tensor:
    """:func:`lowrank_matmul_sq` with the bf16 plan's ``items`` and
    ``ctas`` asked of
    :func:`~repro_torch.kernels.branched_matmul.lowrank_split` (its
    defaults where not given), one counted launch; chip_smoke times other
    plans with it."""
    global launches
    args = (x, w0_sp, w0_idx, w0_scale, w1_sp, w1_idx, w1_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[3]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if x.dtype == torch.float32:
        _launch_cluster(*args, y, dims)
    else:
        bk.check_factors("lowrank_matmul_sq", dims[1:3], w0_sp, w1_sp)
        _launch_mma(*args, y, None, dims, **knobs)
    launches += 1
    return y


def lowrank_matmul_sq_phase_us(x: torch.Tensor, w0_sp: torch.Tensor,
                               w0_idx: torch.Tensor, w0_scale: torch.Tensor,
                               w1_sp: torch.Tensor, w1_idx: torch.Tensor,
                               w1_scale: torch.Tensor, **knobs
                               ) -> list[float]:
    """One counted launch of the bf16 two-phase split kernel with its
    phase timer on: microseconds of each phase (1, 2 per row block), read
    by CTA 0 from %globaltimer.  ``knobs``: the plan's ``items`` and
    ``ctas`` (:func:`~repro_torch.kernels.branched_matmul.lowrank_split`;
    its defaults where not given), so a caller can time coarser or finer
    K slices and smaller grids."""
    global launches
    args = (x, w0_sp, w0_idx, w0_scale, w1_sp, w1_idx, w1_scale)
    dims = _check(*args)
    us = bk.phase_us(lambda y, ts: _launch_mma(*args, y, ts, dims, **knobs),
                     x, dims)
    launches += 1
    return us


def cluster_lowrank_matmul_sq(x: torch.Tensor, w0_sp: torch.Tensor,
                              w0_idx: torch.Tensor, w0_scale: torch.Tensor,
                              w1_sp: torch.Tensor, w1_idx: torch.Tensor,
                              w1_scale: torch.Tensor) -> torch.Tensor:
    """The cluster kernel in x's dtype, bf16 included, uncounted: the
    earlier bf16 design, kept as a yardstick for the split kernel
    (chip_smoke's ``prev_ms``).  The serve path never calls it."""
    args = (x, w0_sp, w0_idx, w0_scale, w1_sp, w1_idx, w1_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[3]), dtype=x.dtype, device=x.device)
    if y.numel():
        _launch_cluster(*args, y, dims)
    return y


def _launch_mma(x, w0_sp, w0_idx, w0_scale, w1_sp, w1_idx, w1_scale,
                y: torch.Tensor, ts: torch.Tensor | None,
                dims: tuple[int, ...], **knobs) -> None:
    """The two-phase split kernel on bf16 operands already checked."""
    bk.launch_split("lrk_lowrank_matmul_sq_mma", (QDTYPES[w0_sp.dtype],), x,
                    (w0_sp, w0_idx, w0_scale, w1_sp, w1_idx, w1_scale), y,
                    dims, ts, "lowrank_matmul_sq", **knobs)


def _launch_cluster(x, w0_sp, w0_idx, w0_scale, w1_sp, w1_idx, w1_scale,
                    y: torch.Tensor, dims: tuple[int, ...]) -> None:
    """The cluster kernel (8-CTA clusters, CUDA-core FMAs): f32's kernel."""
    m, c, r, s = dims
    lib = build.load()
    bm, _ = build.chain_fit(
        m, lambda bm: lib.lrk_lowrank_smem(DTYPES[x.dtype], bm, r),
        build.chain_heights(x.dtype), f"lowrank_matmul_sq kernel at rank {r}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_lowrank_matmul_sq(
            DTYPES[x.dtype], QDTYPES[w0_sp.dtype], bm, x.data_ptr(),
            w0_sp.data_ptr(), w0_idx.data_ptr(), w0_scale.data_ptr(),
            w1_sp.data_ptr(), w1_idx.data_ptr(), w1_scale.data_ptr(),
            y.data_ptr(), m, c, r, s, stream)
    build.check(lib, rc, "lowrank_matmul_sq")
