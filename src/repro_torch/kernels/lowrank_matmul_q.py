"""Wrapper of the fused low-rank CUDA kernels on quantized factors,
``y = (x @ dq(w0)) @ dq(w1)``.

The kernels replace the TPU kernel
``repro/kernels/lowrank_matmul_q.py::lowrank_matmul_q`` in the forms
bf16 ``lowrank_matmul`` runs, as
:func:`repro_torch.kernels.branched_matmul.chain_form` names them: bf16
below ``LARGE_M_Q`` rows goes to the two-phase split kernel
(``csrc/lowrank_matmul_q.cu``, on the split-phase tensor-core core of
bf16 ``branched_matmul``), one cooperative launch whose work split
:func:`repro_torch.kernels.branched_matmul.lowrank_split` computes; bf16
at ``LARGE_M_Q`` rows or more to the large-M form
(``csrc/chain_wgmma.cuh``: two ``wgmma`` launches whose CTAs read the
factors' int8 / e4m3 bytes by TMA and convert them to bf16 in registers,
the first product K-sliced where its tiles leave the card idle); f32 at every M to the f32 form (``csrc/chain_f32.cu``), which
reads the factors' bytes too.  No dequantized factor goes through device
memory, as in the TPU kernel, but for the f32 form's factors of rows that
are not whole words (the dequantizing pass, ``csrc/chain_dequant.cu``).
The source notes say what bounds them and how the designs answer.  This
wrapper checks the operands, allocates the output and the scratch,
launches on the current stream and counts launches (one a call, whatever
the form).  CUDA tensors only: the CPU path is the plain version in
:mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import branched_matmul as bk
from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPES

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0

#: factor storage the kernels take, with its code in the C interface
QDTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}


def check_activation(name: str, x: torch.Tensor) -> None:
    """Raise unless ``x`` is a contiguous 2-D f32/bf16 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel: x is on {x.device}, not a CUDA "
                         "device")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 "
                        f"activations, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{name} kernel: x must be a contiguous 2-D "
                         f"tensor, got {tuple(x.shape)}")


def check_operands(name: str, x: torch.Tensor,
                   factors: list[tuple[str, torch.Tensor, torch.Tensor, int]]
                   ) -> None:
    """Raise unless ``x`` passes :func:`check_activation` and every
    ``(label, q, scale, ndim)`` is a contiguous int8/e4m3 factor of
    ``ndim`` dims on the same device, of one storage dtype, with a
    contiguous f32 scale of its shape with the input axis collapsed."""
    check_activation(name, x)
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


def _check(x: torch.Tensor, w0_q: torch.Tensor, w0_scale: torch.Tensor,
           w1_q: torch.Tensor, w1_scale: torch.Tensor
           ) -> tuple[int, int, int, int]:
    """Raise on operands the kernels do not take; return ``(M, C, R,
    S)``."""
    check_operands("lowrank_matmul_q", x, [("w0", w0_q, w0_scale, 2),
                                           ("w1", w1_q, w1_scale, 2)])
    m, c = x.shape
    c2, r = w0_q.shape
    r2, s = w1_q.shape
    if c != c2 or r != r2:
        raise ValueError(f"lowrank_matmul_q kernel: shapes {tuple(x.shape)} "
                         f"{tuple(w0_q.shape)} {tuple(w1_q.shape)} do not "
                         "chain")
    return m, c, r, s


def lowrank_matmul_q(x: torch.Tensor, w0_q: torch.Tensor,
                     w0_scale: torch.Tensor, w1_q: torch.Tensor,
                     w1_scale: torch.Tensor) -> torch.Tensor:
    """x (M,C) f32/bf16; w0_q (C,R) + w0_scale (1,R); w1_q (R,S) +
    w1_scale (1,S); int8 or e4m3 values, f32 scales -> (M,S) in x.dtype,
    in the form ``branched_matmul.chain_form`` names: f32 the f32 form,
    bf16 at M >= LARGE_M_Q the large-M form, at fewer rows the two-phase
    split kernel (none takes empty factors: C or R of 0 raise)."""
    return lowrank_matmul_q_split(x, w0_q, w0_scale, w1_q, w1_scale)


def lowrank_matmul_q_split(x: torch.Tensor, w0_q: torch.Tensor,
                           w0_scale: torch.Tensor, w1_q: torch.Tensor,
                           w1_scale: torch.Tensor, **knobs) -> torch.Tensor:
    """:func:`lowrank_matmul_q`, one counted call; ``knobs``, the split
    plan's ``items`` and ``ctas`` asked of
    :func:`~repro_torch.kernels.branched_matmul.lowrank_split` (its
    defaults where not given), for a call that takes the split kernel
    (chip_smoke times other plans with it): a large-M or f32 call refuses
    them."""
    global launches
    args = (x, w0_q, w0_scale, w1_q, w1_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[3]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    bk.check_factors("lowrank_matmul_q", dims[1:3], w0_q, w1_q)
    form = bk.chain_form(x.dtype, dims[0], quantized=True)
    if form != "split" and knobs:
        raise ValueError(f"lowrank_matmul_q of {x.dtype} at M = {dims[0]} "
                         f"takes the {form} form, which has no {knobs}")
    if form == "split":
        _launch_mma(*args, y, None, dims, **knobs)
    else:
        _launch_form(form, *args, y, dims)
    launches += 1
    return y


def split_lowrank_matmul_q(x: torch.Tensor, w0_q: torch.Tensor,
                           w0_scale: torch.Tensor, w1_q: torch.Tensor,
                           w1_scale: torch.Tensor) -> torch.Tensor:
    """The bf16 two-phase split kernel at any M, uncounted: the earlier
    form of a large-M call (chip_smoke's ``prev_ms``) and one side of its
    LARGE_M sweep.  The serve and train paths never call it."""
    return _forced("split", x, w0_q, w0_scale, w1_q, w1_scale)


def large_m_lowrank_matmul_q(x: torch.Tensor, w0_q: torch.Tensor,
                             w0_scale: torch.Tensor, w1_q: torch.Tensor,
                             w1_scale: torch.Tensor) -> torch.Tensor:
    """The large-M form at any M, uncounted: the other side of
    chip_smoke's LARGE_M sweep.  bf16 only; f32 or empty factors raise
    before anything is launched."""
    return _forced("large_m", x, w0_q, w0_scale, w1_q, w1_scale)


def prev_large_m_lowrank_matmul_q(x: torch.Tensor, w0_q: torch.Tensor,
                                  w0_scale: torch.Tensor, w1_q: torch.Tensor,
                                  w1_scale: torch.Tensor) -> torch.Tensor:
    """The earlier large-M design at any M, uncounted: the dequantizing
    pass writes both factors as bf16 into scratch, then bf16 B1's large-M
    products run on them (chip_smoke's ``prev_ms``).  The serve and train
    paths never call it.  bf16 only."""
    return _forced("prev_large_m", x, w0_q, w0_scale, w1_q, w1_scale)


def dequant_lowrank_matmul_q(x: torch.Tensor, w0_q: torch.Tensor,
                             w0_scale: torch.Tensor, w1_q: torch.Tensor,
                             w1_scale: torch.Tensor) -> torch.Tensor | None:
    """The dequantizing pass alone, uncounted, for chip_smoke's ``dq_us``:
    at bf16 M >= LARGE_M_Q the earlier large-M design's (every factor into
    bf16 scratch; the large-M form runs none), in the f32 form the one it
    runs (the factors of rows that are not whole words, into f32 scratch):
    its scratch, or None where there is none."""
    args = (x, w0_q, w0_scale, w1_q, w1_scale)
    dims = _check(*args)
    bk.check_factors("lowrank_matmul_q", dims[1:3], w0_q, w1_q)
    form = bk.chain_form(x.dtype, dims[0], quantized=True)
    if form == "split" or not dims[0] * dims[3]:
        return None
    return _launch_form(form, *args, None, dims, products=False,
                        dequant=True)


def _forced(form: str, x, w0_q, w0_scale, w1_q, w1_scale) -> torch.Tensor:
    """B3 on bf16 ``x`` in ``form`` ("split", "large_m" or "prev_large_m",
    the earlier large-M design) whatever M, uncounted."""
    args = (x, w0_q, w0_scale, w1_q, w1_scale)
    dims = _check(*args)
    what = f"{form}_lowrank_matmul_q"
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} runs bf16 activations, got {x.dtype}")
    bk.check_factors(what, dims[1:3], w0_q, w1_q)
    y = torch.empty((dims[0], dims[3]), dtype=x.dtype, device=x.device)
    if y.numel():
        if form == "split":
            _launch_mma(*args, y, None, dims)
        else:
            _launch_form("large_m", *args, y, dims,
                         dequant=form == "prev_large_m")
    return y


def _launch_form(form: str, x, w0_q, w0_scale, w1_q, w1_scale,
                 y: torch.Tensor | None, dims: tuple[int, ...],
                 products: bool = True, dequant: bool = False
                 ) -> torch.Tensor:
    """The large-M or the f32 form (``form``) on quantized factors already
    checked: the form's launcher with the scales (``dequant``: the earlier
    large-M design); its scratch."""
    kw = dict(scales=(w0_scale, w1_scale), qcode=QDTYPES[w0_q.dtype],
              products=products)
    if form == "f32":
        return bk.launch_f32(x, (w0_q, w1_q), y, dims, "lowrank_matmul_q",
                             **kw)
    return bk.launch_large_m(x, (w0_q, w1_q), y, dims, "lowrank_matmul_q",
                             dequant=dequant, **kw)


def lowrank_matmul_q_phase_us(x: torch.Tensor, w0_q: torch.Tensor,
                              w0_scale: torch.Tensor, w1_q: torch.Tensor,
                              w1_scale: torch.Tensor, **knobs
                              ) -> list[float]:
    """One counted launch of the bf16 two-phase split kernel with its
    phase timer on: microseconds of each phase (1, 2 per row block), read
    by CTA 0 from %globaltimer.  ``knobs``: the plan's ``items`` and
    ``ctas``, as for :func:`lowrank_matmul_q_split`."""
    global launches
    args = (x, w0_q, w0_scale, w1_q, w1_scale)
    dims = _check(*args)
    us = bk.phase_us(lambda y, ts: _launch_mma(*args, y, ts, dims, **knobs),
                     x, dims)
    launches += 1
    return us


def cluster_lowrank_matmul_q(x: torch.Tensor, w0_q: torch.Tensor,
                             w0_scale: torch.Tensor, w1_q: torch.Tensor,
                             w1_scale: torch.Tensor) -> torch.Tensor:
    """The cluster kernel in x's dtype, uncounted: the earlier design of
    both dtypes, kept as a yardstick for the split kernel and the f32 form
    (chip_smoke's ``prev_ms``).  The serve path never calls it."""
    args = (x, w0_q, w0_scale, w1_q, w1_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[3]), dtype=x.dtype, device=x.device)
    if y.numel():
        _launch_cluster(*args, y, dims)
    return y


def _launch_mma(x, w0_q, w0_scale, w1_q, w1_scale, y: torch.Tensor,
                ts: torch.Tensor | None, dims: tuple[int, ...],
                **knobs) -> None:
    """The two-phase split kernel on bf16 operands already checked."""
    bk.launch_split("lrk_lowrank_matmul_q_mma", (QDTYPES[w0_q.dtype],), x,
                    (w0_q, w0_scale, w1_q, w1_scale), y, dims, ts,
                    "lowrank_matmul_q", **knobs)


def _launch_cluster(x, w0_q, w0_scale, w1_q, w1_scale, y: torch.Tensor,
                    dims: tuple[int, ...]) -> None:
    """The cluster kernel (8-CTA clusters, CUDA-core FMAs): the earlier
    kernel of both dtypes, kept as the yardstick
    :func:`cluster_lowrank_matmul_q` launches."""
    m, c, r, s = dims
    lib = build.load()
    bm, _ = build.chain_fit(
        m, lambda bm: lib.lrk_lowrank_smem(DTYPES[x.dtype], bm, r),
        build.chain_heights(x.dtype), f"lowrank_matmul_q kernel at rank {r}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_lowrank_matmul_q(
            DTYPES[x.dtype], QDTYPES[w0_q.dtype], bm, x.data_ptr(),
            w0_q.data_ptr(), w0_scale.data_ptr(), w1_q.data_ptr(),
            w1_scale.data_ptr(), y.data_ptr(), m, c, r, s, stream)
    build.check(lib, rc, "lowrank_matmul_q")
