"""Wrapper of the activation-quantized branched CUDA kernels: x quantized
per row once, each branch's three dots int8 x int8 with per-row
requantization between them, the branch sum in f32 (paper Eq. 17).

The kernels (``csrc/branched_matmul_qa.cu`` on ``csrc/qa_mma.cuh``)
replace the TPU kernel
``repro/kernels/branched_matmul_qa.py::branched_matmul_qa``; the source
note says what bounds them and how the design answers.  Both activation
types run the split-phase s8 tensor-core kernel: one cooperative launch
whose work split :func:`qa_split` computes here.  This wrapper checks the
operands, allocates the output and the split's scratch, launches on the
current stream and counts launches; the earlier cluster kernel stays
callable, uncounted, as a yardstick (:func:`cluster_branched_matmul_qa`).
CUDA tensors only: the CPU path is the plain version in
:mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import branched_matmul as bk
from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES
from repro_torch.kernels.lowrank_matmul_q import check_operands

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0

#: the s8 tile (csrc/qa_mma.cuh): int8 reduction rows of a stage, which
#: every K slice and every padded int8 row is a multiple of
QBK = 64
#: its dynamic shared memory (bytes): a ring of 4 stages of 64 A rows of
#: QBK + 16 bytes and QBK W rows of 128 + 16 bytes, whatever the ranks
QA_SMEM = 4 * (bk.BM * (QBK + 16) + QBK * (bk.BN + 16))


def check_int8(name: str, *factors: torch.Tensor) -> None:
    """The activation-quantized kernels take int8 factors only (fp8
    plans keep the weight-only kernels)."""
    for q in factors:
        if q.dtype != torch.int8:
            raise TypeError(f"{name} kernel takes int8 factors, got "
                            f"{q.dtype}")


def kpad(k: int) -> int:
    """An int8 activation row of ``k`` values padded to whole stages."""
    return math.ceil(k / QBK) * QBK


def _slice(k: int, tiles: int, target: int) -> int:
    """K-slice length (a multiple of QBK) that gives ``tiles`` items per
    slice about ``target`` items in all."""
    chunks = math.ceil(k / QBK)
    want = max(1, target // tiles)
    return math.ceil(chunks / want) * QBK


@dataclass(frozen=True)
class QaSplit(bk._Split):
    """The split-phase s8 kernel's work split for one call: ``k1``, ``k2``,
    ``k3`` are the K-slice lengths of phase 1 (xq @ u_n, K = C), phase 2
    (h1q_n @ xc_n, K = r1) and phase 3 (h2q_n @ v_n, K = r2: each branch's
    own slices, so none straddles two branches), ``rows`` the rows of a
    row block.  Every phase stores int32 partials, one rows x width block
    per (slice, branch)."""
    m: int
    c: int
    n: int
    r1: int
    r2: int
    s: int
    rows: int
    k1: int
    k2: int
    k3: int
    PHASES = (1, 2, 3)

    def phase(self, i: int) -> tuple[int, int, int, int]:
        """Phase ``i`` (1, 2, 3) as ``(K, branches, columns per branch, K
        slice)``: phase 1 reads u (N of (C, r1)), phase 2 xc (N of (r1,
        r2)), phase 3 v (N of (r2, S))."""
        if i == 1:
            return self.c, self.n, self.r1, self.k1
        if i == 2:
            return self.r1, self.n, self.r2, self.k2
        if i == 3:
            return self.r2, self.n, self.s, self.k3
        raise ValueError(f"phase {i}: the kernel has phases 1, 2, 3")

    def region_bytes(self) -> dict[str, int]:
        """p (the int32 partials of the largest phase, slices x branches x
        rows x width), xq (M, kpad(C)) int8 and xs (M) f32 for every row,
        h1q / h2q (rows, N * kpad(r)) int8 with their (rows, N) f32
        scales."""
        part = max(self.slices(i) * nbr * self.rows * width * 4
                   for i in self.PHASES
                   for _, nbr, width, _ in [self.phase(i)])
        rn = self.rows * self.n
        return {"p": part, "xq": self.m * kpad(self.c), "xs": 4 * self.m,
                "h1q": rn * kpad(self.r1), "h1s": 4 * rn,
                "h2q": rn * kpad(self.r2), "h2s": 4 * rn}

    @property
    def c_args(self) -> tuple[int, int, int]:
        """The integers C takes after the sizes: the K-slice lengths."""
        return self.k1, self.k2, self.k3


def qa_split(m: int, c: int, n: int, r1: int, r2: int, s: int, sms: int,
             items: int | None = None) -> QaSplit:
    """Work split of the split-phase s8 kernel on a card of ``sms`` SMs:
    each phase slices its reduction axis (C, r1, and each branch's r2) in
    multiples of QBK so that with its N x column tiles it has about
    ``items`` items (default ITEMS_PER_SM per SM, one round of the
    persistent grid)."""
    target = bk.ITEMS_PER_SM * sms if items is None else items
    if min(m, c, n, r1, r2, s, sms, target) <= 0:
        raise ValueError(f"qa split of ({m}, {c}, {n}, {r1}, {r2}, {s}) on "
                         f"{sms} SMs, {items} items: every size must be "
                         "positive")
    return QaSplit(
        m=m, c=c, n=n, r1=r1, r2=r2, s=s, rows=min(m, bk.BM),
        k1=_slice(c, n * math.ceil(r1 / bk.BN), target),
        k2=_slice(r1, n * math.ceil(r2 / bk.BN), target),
        k3=_slice(r2, n * math.ceil(s / bk.BN), target))


@functools.lru_cache(maxsize=256)
def _plan(dims: tuple[int, ...], sms: int, items: int | None
          ) -> tuple[tuple[int, ...], int, tuple[int, ...]]:
    """What one launch passes to C (cached per shape): the split's K-slice
    lengths, its scratch bytes and the offsets of its regions."""
    sp = qa_split(*dims, sms, items)
    return sp.c_args, sp.scratch_bytes, tuple(sp.offsets().values())


def _check(x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale
           ) -> tuple[int, int, int, int, int, int]:
    """Raise on operands the kernels do not take; return ``(m, c, n, r1,
    r2, s)``."""
    check_operands("branched_matmul_qa", x, [("u", u_q, u_scale, 3),
                                             ("xc", xc_q, xc_scale, 3),
                                             ("v", v_q, v_scale, 3)])
    check_int8("branched_matmul_qa", u_q, xc_q, v_q)
    m, c = x.shape
    n, c2, r1 = u_q.shape
    n2, r1b, r2 = xc_q.shape
    n3, r2b, s = v_q.shape
    if c != c2 or n != n2 or n != n3 or r1 != r1b or r2 != r2b:
        raise ValueError(
            f"branched_matmul_qa kernel: shapes {tuple(x.shape)} "
            f"{tuple(u_q.shape)} {tuple(xc_q.shape)} {tuple(v_q.shape)} do "
            "not chain")
    return m, c, n, r1, r2, s


def branched_matmul_qa(x: torch.Tensor, u_q: torch.Tensor,
                       u_scale: torch.Tensor, xc_q: torch.Tensor,
                       xc_scale: torch.Tensor, v_q: torch.Tensor,
                       v_scale: torch.Tensor) -> torch.Tensor:
    """x (M,C) f32/bf16; u_q (N,C,r1), xc_q (N,r1,r2), v_q (N,r2,S) int8
    with f32 scales (N,1,r1), (N,1,r2), (N,1,S) -> (M,S) in x.dtype."""
    return branched_matmul_qa_split(x, u_q, u_scale, xc_q, xc_scale, v_q,
                                    v_scale)


def branched_matmul_qa_split(x: torch.Tensor, u_q: torch.Tensor,
                             u_scale: torch.Tensor, xc_q: torch.Tensor,
                             xc_scale: torch.Tensor, v_q: torch.Tensor,
                             v_scale: torch.Tensor, *,
                             items: int | None = None) -> torch.Tensor:
    """:func:`branched_matmul_qa` on the plan of :func:`qa_split` with
    ``items`` items a phase (``None``: its default), one counted launch;
    the card tests hold other plans to the default's bits."""
    global launches
    args = (x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale)
    dims = _check(*args)
    y = torch.empty((dims[0], dims[5]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    _launch_mma(*args, y, None, dims, items)
    launches += 1
    return y


def branched_matmul_qa_phase_us(x: torch.Tensor, u_q: torch.Tensor,
                                u_scale: torch.Tensor, xc_q: torch.Tensor,
                                xc_scale: torch.Tensor, v_q: torch.Tensor,
                                v_scale: torch.Tensor, *,
                                items: int | None = None) -> list[float]:
    """One counted launch with the phase timer on (on the plan of ``items``
    items a phase, as :func:`branched_matmul_qa_split`): microseconds of
    phase 0 (x quantized) and, in each row block, of each product phase's
    items and of the pass that sums its partials (six a block), each up
    to the grid sync that ends it, read by CTA 0 from %globaltimer."""
    global launches
    args = (x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale)
    dims = _check(*args)
    m, s = dims[0], dims[5]
    if min(dims) == 0:
        raise ValueError("the phase timer runs on non-empty operands")
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    ts = torch.zeros(2 + 6 * math.ceil(m / bk.BM), dtype=torch.int64,
                     device=x.device)
    _launch_mma(*args, y, ts, dims, items)
    launches += 1
    t = ts.tolist()
    return [(b - a) / 1e3 for a, b in zip(t, t[1:])]


def _launch_mma(x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale,
                y: torch.Tensor, ts: torch.Tensor | None,
                dims: tuple[int, ...], items: int | None) -> None:
    """The split-phase s8 kernel on operands already checked; plans the
    work split and allocates its scratch."""
    if min(dims[1:5]) == 0:
        raise ValueError("branched_matmul_qa kernel: empty factors "
                         + " ".join(str(tuple(f.shape))
                                    for f in (u_q, xc_q, v_q)))
    lib = build.load()
    smem = int(lib.lrk_branched_qa_mma_smem())
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"branched_matmul_qa kernel: its tile needs {smem} "
                         f"B of shared memory (limit {build.SMEM_LIMIT})")
    ks, nbytes, off = _plan(dims, bk._sm_count(x.device.index), items)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_branched_matmul_qa_mma(
            DTYPES[x.dtype], x.data_ptr(), u_q.data_ptr(),
            u_scale.data_ptr(), xc_q.data_ptr(), xc_scale.data_ptr(),
            v_q.data_ptr(), v_scale.data_ptr(), y.data_ptr(),
            *(base + o for o in off), *dims, *ks,
            None if ts is None else ts.data_ptr(), stream)
    build.check(lib, rc, "branched_matmul_qa")


def cluster_branched_matmul_qa(x: torch.Tensor, u_q: torch.Tensor,
                               u_scale: torch.Tensor, xc_q: torch.Tensor,
                               xc_scale: torch.Tensor, v_q: torch.Tensor,
                               v_scale: torch.Tensor) -> torch.Tensor:
    """The earlier kernel (8-CTA clusters, ``__dp4a``), uncounted: kept as
    a yardstick for the split-phase kernel (chip_smoke's ``prev_ms``).
    The serve path never calls it."""
    args = (x, u_q, u_scale, xc_q, xc_scale, v_q, v_scale)
    m, c, n, r1, r2, s = _check(*args)
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    lib = build.load()
    bm, _ = build.chain_fit(
        m, lambda bm: lib.lrk_branched_qa_smem(bm, n, r1, r2), build.HEIGHTS,
        f"branched_matmul_qa kernel at {n} branches of ranks ({r1}, {r2})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_branched_matmul_qa(
            DTYPES[x.dtype], bm, x.data_ptr(), u_q.data_ptr(),
            u_scale.data_ptr(), xc_q.data_ptr(), xc_scale.data_ptr(),
            v_q.data_ptr(), v_scale.data_ptr(), y.data_ptr(), m, c, n, r1,
            r2, s, stream)
    build.check(lib, rc, "branched_matmul_qa (cluster kernel)")
    return y
