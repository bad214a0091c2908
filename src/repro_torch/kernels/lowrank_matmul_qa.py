"""Wrapper of the activation-quantized low-rank CUDA kernels: int8 rows of
x, ``y = dq(q(dq(q(x) @ w0_q)) @ w1_q)`` with every dot int8 x int8.

The kernels (``csrc/lowrank_matmul_qa.cu`` on ``csrc/qa_mma.cuh``)
replace the TPU kernel
``repro/kernels/lowrank_matmul_qa.py::lowrank_matmul_qa`` (with its
``quantize_rows``); the source note says what bounds them and how the
design answers.  Both activation types run the split-phase s8 kernel of
``branched_matmul_qa`` in two product phases: one cooperative launch
whose work split :func:`lowrank_qa_split` computes here.  This wrapper
checks the operands, allocates the output and the split's scratch,
launches on the current stream and counts launches; the earlier cluster
kernel stays callable, uncounted, as a yardstick
(:func:`cluster_lowrank_matmul_qa`).  CUDA tensors only: the CPU path is
the plain version in :mod:`repro_torch.kernels.ref`, chosen by
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import branched_matmul as bk
from repro_torch.kernels import branched_matmul_qa as bak
from repro_torch.kernels import build
from repro_torch.kernels.branched_matmul_qa import check_int8, kpad
from repro_torch.kernels.lowrank_matmul import DTYPES
from repro_torch.kernels.lowrank_matmul_q import check_operands

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0

#: items per SM each phase aims for by default, phase 1 and phase 2: with
#: both under one round of SMs the launch takes one CTA a SM (grid syncs
#: of 132 CTAs, each CTA an SM's bandwidth to itself), and phase 1 takes
#: half of that -- each more K slice of it is one more int32 partial for
#: the requantization pass (one CTA a row) to sum.  On an H100 at 700 W
#: this took the q,o / gate,up / down pairs' M = 64 launches 6-25 % under
#: two items a SM in both phases and tied at k/v (PERF.md)
ITEMS_PER_SM = (0.5, 1.0)


@dataclass(frozen=True)
class LowrankQaSplit(bk._Split):
    """The split-phase s8 kernel's two-phase work split for one call:
    ``k1``, ``k2`` are the K-slice lengths of phase 1 (xq @ w0_q, K = C,
    width R) and phase 2 (hq @ w1_q, K = R, width S), ``rows`` the rows of
    a row block, ``ctas`` the CTAs the launch takes at most (0: the whole
    persistent grid)."""
    m: int
    c: int
    r: int
    s: int
    rows: int
    k1: int
    k2: int
    ctas: int = 0
    PHASES = (1, 2)

    def phase(self, i: int) -> tuple[int, int, int, int]:
        """Phase ``i`` (1, 2) as ``(K, branches, columns, K slice)``, one
        branch each."""
        if i == 1:
            return self.c, 1, self.r, self.k1
        if i == 2:
            return self.r, 1, self.s, self.k2
        raise ValueError(f"phase {i}: the kernel has phases 1, 2")

    def region_bytes(self) -> dict[str, int]:
        """p (the int32 partials of the larger phase, slices x rows x
        width), xq (M, kpad(C)) int8 and xs (M) f32 for every row, hq
        (rows, kpad(R)) int8 and hs (rows) f32."""
        part = max(self.slices(i) * self.rows * self.phase(i)[2] * 4
                   for i in self.PHASES)
        return {"p": part, "xq": self.m * kpad(self.c), "xs": 4 * self.m,
                "hq": self.rows * kpad(self.r), "hs": 4 * self.rows}

    @property
    def c_args(self) -> tuple[int, int, int]:
        """The integers C takes after the sizes: the K-slice lengths and
        the CTA cap."""
        return self.k1, self.k2, self.ctas


def lowrank_qa_split(m: int, c: int, r: int, s: int, sms: int,
                     items: int | tuple | None = None,
                     ctas: int | None = None) -> LowrankQaSplit:
    """Work split of the split-phase s8 lowrank kernel on a card of ``sms``
    SMs: each phase slices its reduction axis (C, R) in multiples of QBK
    so that with its column tiles (tiles(R), tiles(S)) it has about
    ``items`` items (one count for both phases or one each, None its
    ITEMS_PER_SM per SM; a count at or under a phase's tiles gives it one
    slice).  ``ctas``: the CTAs the launch takes at most (0: the whole
    persistent grid; default LOWRANK_CTAS_PER_SM per SM where no phase has
    more items than ``sms``, else the whole grid)."""
    n1, n2 = items if isinstance(items, tuple) else (items, items)
    n1, n2 = (max(1, int(per * sms)) if n is None else n
              for n, per in zip((n1, n2), ITEMS_PER_SM))
    if min(m, c, r, s, sms, n1, n2) <= 0 or (ctas or 0) < 0:
        raise ValueError(f"qa lowrank split of ({m}, {c}, {r}, {s}) on "
                         f"{sms} SMs, {items} items, {ctas} CTAs: every "
                         "size must be positive")
    tiles1, tiles2 = math.ceil(r / bk.BN), math.ceil(s / bk.BN)
    k1 = bak._slice(c, tiles1, n1)
    k2 = bak._slice(r, tiles2, n2)
    if ctas is None:
        most = max(math.ceil(c / k1) * tiles1, math.ceil(r / k2) * tiles2)
        ctas = bk.LOWRANK_CTAS_PER_SM * sms if most <= sms else 0
    return LowrankQaSplit(m=m, c=c, r=r, s=s, rows=min(m, bk.BM), k1=k1,
                          k2=k2, ctas=ctas)


@functools.lru_cache(maxsize=256)
def _plan(dims: tuple[int, ...], sms: int, knobs: tuple
          ) -> tuple[tuple[int, ...], int, tuple[int, ...]]:
    """What one launch passes to C (cached per shape): the split's
    integers after the sizes (:attr:`~LowrankQaSplit.c_args`), its scratch
    bytes and the offsets of its regions; ``knobs`` the keyword arguments
    of :func:`lowrank_qa_split` as pairs."""
    sp = lowrank_qa_split(*dims, sms, **dict(knobs))
    return sp.c_args, sp.scratch_bytes, tuple(sp.offsets().values())


def _check(x, w0_q, w0_scale, w1_q, w1_scale) -> tuple[int, int, int, int]:
    """Raise on operands the kernels do not take; return ``(m, c, r,
    s)``."""
    check_operands("lowrank_matmul_qa", x, [("w0", w0_q, w0_scale, 2),
                                            ("w1", w1_q, w1_scale, 2)])
    check_int8("lowrank_matmul_qa", w0_q, w1_q)
    m, c = x.shape
    c2, r = w0_q.shape
    r2, s = w1_q.shape
    if c != c2 or r != r2:
        raise ValueError(f"lowrank_matmul_qa kernel: shapes "
                         f"{tuple(x.shape)} {tuple(w0_q.shape)} "
                         f"{tuple(w1_q.shape)} do not chain")
    return m, c, r, s


def lowrank_matmul_qa(x: torch.Tensor, w0_q: torch.Tensor,
                      w0_scale: torch.Tensor, w1_q: torch.Tensor,
                      w1_scale: torch.Tensor) -> torch.Tensor:
    """x (M,C) f32/bf16; w0_q (C,R) int8 + w0_scale (1,R); w1_q (R,S)
    int8 + w1_scale (1,S); f32 scales -> (M,S) in x.dtype.  The split
    kernel takes no empty factors (C or R of 0 raise)."""
    return lowrank_matmul_qa_split(x, w0_q, w0_scale, w1_q, w1_scale)


def lowrank_matmul_qa_split(x: torch.Tensor, w0_q: torch.Tensor,
                            w0_scale: torch.Tensor, w1_q: torch.Tensor,
                            w1_scale: torch.Tensor, **knobs) -> torch.Tensor:
    """:func:`lowrank_matmul_qa` on the plan of :func:`lowrank_qa_split`
    with ``knobs`` (its ``items`` and ``ctas``; its defaults where not
    given), one counted launch; the card tests hold other plans to the
    default's bits."""
    global launches
    args = (x, w0_q, w0_scale, w1_q, w1_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[3]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    _launch_mma(*args, y, None, dims, knobs)
    launches += 1
    return y


def lowrank_matmul_qa_phase_us(x: torch.Tensor, w0_q: torch.Tensor,
                               w0_scale: torch.Tensor, w1_q: torch.Tensor,
                               w1_scale: torch.Tensor, **knobs
                               ) -> list[float]:
    """One counted launch with the phase timer on (on the plan of
    ``knobs``, as :func:`lowrank_matmul_qa_split`): microseconds of phase
    0 (x quantized) and, in each row block, of phase 1's items, the
    requantization, phase 2's items and the fold (four a block), each up
    to the grid sync that ends it, read by CTA 0 from %globaltimer."""
    global launches
    args = (x, w0_q, w0_scale, w1_q, w1_scale)
    dims = _check(*args)
    m, s = dims[0], dims[3]
    if min(dims) == 0:
        raise ValueError("the phase timer runs on non-empty operands")
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    ts = torch.zeros(2 + 4 * math.ceil(m / bk.BM), dtype=torch.int64,
                     device=x.device)
    _launch_mma(*args, y, ts, dims, knobs)
    launches += 1
    t = ts.tolist()
    return [(b - a) / 1e3 for a, b in zip(t, t[1:])]


def _launch_mma(x, w0_q, w0_scale, w1_q, w1_scale, y: torch.Tensor,
                ts: torch.Tensor | None, dims: tuple[int, ...],
                knobs: dict) -> None:
    """The split-phase s8 kernel on operands already checked; plans the
    work split and allocates its scratch."""
    if min(dims[1:3]) == 0:
        raise ValueError("lowrank_matmul_qa kernel: empty factors "
                         f"{tuple(w0_q.shape)} {tuple(w1_q.shape)}")
    lib = build.load()
    smem = int(lib.lrk_lowrank_qa_mma_smem())
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"lowrank_matmul_qa kernel: its tile needs {smem} "
                         f"B of shared memory (limit {build.SMEM_LIMIT})")
    ks, nbytes, off = _plan(dims, bk._sm_count(x.device.index),
                            tuple(sorted(knobs.items())))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_lowrank_matmul_qa_mma(
            DTYPES[x.dtype], x.data_ptr(), w0_q.data_ptr(),
            w0_scale.data_ptr(), w1_q.data_ptr(), w1_scale.data_ptr(),
            y.data_ptr(), *(base + o for o in off), *dims, *ks,
            None if ts is None else ts.data_ptr(), stream)
    build.check(lib, rc, "lowrank_matmul_qa")


def cluster_lowrank_matmul_qa(x: torch.Tensor, w0_q: torch.Tensor,
                              w0_scale: torch.Tensor, w1_q: torch.Tensor,
                              w1_scale: torch.Tensor) -> torch.Tensor:
    """The earlier kernel (8-CTA clusters, ``__dp4a``), uncounted: kept as
    a yardstick for the split-phase kernel (chip_smoke's ``prev_ms``).
    The serve path never calls it."""
    args = (x, w0_q, w0_scale, w1_q, w1_scale)
    m, c, r, s = _check(*args)
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    lib = build.load()
    bm, _ = build.chain_fit(m, lambda bm: lib.lrk_lowrank_qa_smem(bm, r),
                            build.HEIGHTS,
                            f"lowrank_matmul_qa kernel at rank {r}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_lowrank_matmul_qa(
            DTYPES[x.dtype], bm, x.data_ptr(), w0_q.data_ptr(),
            w0_scale.data_ptr(), w1_q.data_ptr(), w1_scale.data_ptr(),
            y.data_ptr(), m, c, r, s, stream)
    build.check(lib, rc, "lowrank_matmul_qa (cluster kernel)")
    return y
