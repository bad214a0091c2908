"""Wrapper of the branched low-rank CUDA kernels
``y = sum_n ((x @ u_n) @ xc_n) @ v_n`` (paper Eq. 17).

The kernels (``csrc/branched_matmul.cu``) replace the TPU kernel
``repro/kernels/branched_matmul.py::branched_matmul``; the source note
says what bounds them and how the design answers.  bf16 goes to the
split-phase tensor-core kernel, one cooperative launch whose work split
:func:`branched_split` computes here (:func:`lowrank_split` plans its
two-phase form, which bf16 ``lowrank_matmul``, ``lowrank_matmul_q`` and
``lowrank_matmul_sq`` run); f32 goes to the
cluster kernel (tensor cores in TF32 cannot hold f32's tolerance).
This wrapper checks the operands, allocates the output and the scratch,
launches on the current stream and counts launches.  CUDA tensors only:
the CPU path is the plain version in :mod:`repro_torch.kernels.ref`,
chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import DTYPES

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0

#: the split-phase kernel's tile (csrc/mma_chain.cuh): rows of a row
#: block, columns of a tile, reduction rows per stage, ring depth, and the
#: padding (elements) of a shared-memory row
BM, BN, BK, STAGES, PAD = 64, 128, 32, 6, 8
#: bytes of one ring stage of each weight view (csrc/mma_chain.cuh): a
#: padded bf16 tile; BK rows of BN int8 / e4m3 values and BN f32 scales,
#: or, for u's view, BK rows of the two 128-byte lines that may hold a
#: row's BN values; the 2:4 pack's two slots of BK/4 value rows, a 4-byte
#: word per index byte and BN scales
RAW_STAGE = {"plain": BK * (BN + PAD) * 2, "dequant": BK * BN + 4 * BN,
             "dequant_lines": BK * 2 * BN + 4 * BN,
             "sparse24": 2 * (BK // 4) * BN + 2 * (BK // 4) * 4 + 4 * BN}
#: the views of u, xc and v of each branched split-phase kernel: bf16
#: factors (this module), quantized factors (branched_matmul_q), 2:4
#: packs (branched_matmul_sq); and of w0, w1 of each two-phase lowrank
#: one: bf16 factors (lowrank_matmul), quantized factors
#: (lowrank_matmul_q), 2:4 packs (lowrank_matmul_sq)
VIEWS = {"bf16": ("plain",) * 3, "q": ("dequant_lines", "dequant", "dequant"),
         "sq": ("sparse24", "dequant", "sparse24"),
         "lowrank_bf16": ("plain", "plain"),
         "lowrank_q": ("dequant", "dequant"),
         "lowrank_sq": ("sparse24", "sparse24")}
#: work items per SM each phase aims for (one round of the persistent
#: grid, two CTAs per SM)
ITEMS_PER_SM = 2
#: CTAs per SM the two-phase lowrank kernel launches (of the two the
#: persistent grid holds) where no phase has more items than the card has
#: SMs: at llama's k/v pair (at most 64 items a phase) a grid sync of 132
#: CTAs is cheaper than one of 264, so a launch took 10.1 against 10.9 us
#: (bf16) on an H100 at 700 W; where a phase has more (gate/up of
#: branches = 1, 256 items), the whole grid streams more bytes at once and
#: won, 14.1 against 15.9 us (PERF.md)
LOWRANK_CTAS_PER_SM = 1
#: alignment of each scratch region (bytes)
ALIGN = 256


def mma_smem_bytes(kind: str = "bf16") -> int:
    """Dynamic shared memory of a split-phase kernel (bytes; ``kind`` a key
    of VIEWS), fixed by the tile whatever the ranks: the ring of (A,
    weight) stage pairs and, for a converting view, two converted bf16
    tiles -- the largest of its views'."""
    return max(STAGES * (BM * (BK + PAD) * 2 + RAW_STAGE[view])
               + (0 if view == "plain" else 2 * BK * (BN + PAD) * 2)
               for view in VIEWS[kind])


def _slice(k: int, tiles: int, target: int) -> int:
    """K-slice length (a multiple of BK) that gives ``tiles`` column tiles
    about ``target`` items in all, and no more than ``target`` where the
    tiles alone do not exceed it."""
    chunks = math.ceil(k / BK)
    want = max(1, target // tiles)
    return math.ceil(chunks / want) * BK


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


class _Split:
    """What the split-phase kernels' plans share: each phase's K slices
    and work items, and the scratch layout -- P, the f32 partials of the
    largest K-sliced phase, then the bf16 intermediates
    (:meth:`intermediates`), each region aligned to ALIGN bytes.  A plan
    names its phases (``PHASES``), their ``(K, branches, columns per
    branch, K slice)`` (:meth:`phase`) and its rows of a row block."""
    PHASES: tuple[int, ...] = ()
    rows: int

    def phase(self, i: int) -> tuple[int, int, int, int]:
        raise NotImplementedError

    def intermediates(self) -> dict[str, int]:
        raise NotImplementedError

    def slices(self, i: int) -> int:
        k, _, _, ks = self.phase(i)
        return math.ceil(k / ks)

    def region_bytes(self) -> dict[str, int]:
        """Bytes of each scratch region: P (slices x rows x the phase's
        branches*width, f32, the largest over the K-sliced phases), then
        the intermediates."""
        partials = [self.slices(i) * self.rows * nbr * width * 4
                    for i in self.PHASES
                    for _, nbr, width, _ in [self.phase(i)]
                    if self.slices(i) > 1]
        return {"p": max(partials, default=0), **self.intermediates()}

    def offsets(self) -> dict[str, int]:
        out, at = {}, 0
        for name, nbytes in self.region_bytes().items():
            out[name] = at
            at += _align(nbytes)
        return out

    @property
    def scratch_bytes(self) -> int:
        return sum(_align(b) for b in self.region_bytes().values())

    def items(self, i: int) -> list[tuple[int, int, int, int, int]]:
        """Work items of phase ``i`` in the order the kernel decodes its
        item index: ``(branch, k0, k1, c0, c1)``, the block of the branch's
        weight (rows k0:k1, columns c0:c1) the item reads."""
        k, nbr, width, ks = self.phase(i)
        return [(b, q * ks, min(k, q * ks + ks), t * BN,
                 min(width, t * BN + BN))
                for q in range(self.slices(i)) for b in range(nbr)
                for t in range(math.ceil(width / BN))]


@dataclass(frozen=True)
class BranchedSplit(_Split):
    """The branched split-phase kernel's work split for one call: ``k1``,
    ``k2``, ``k3`` are the K-slice lengths of phases 1-3 (passed to C)
    and ``rows`` the rows of a row block."""
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
        r2)), phase 3 v as one (N*r2, S) matrix."""
        if i == 1:
            return self.c, self.n, self.r1, self.k1
        if i == 2:
            return self.r1, self.n, self.r2, self.k2
        if i == 3:
            return self.n * self.r2, 1, self.s, self.k3
        raise ValueError(f"phase {i}: the kernel has phases 1, 2, 3")

    def intermediates(self) -> dict[str, int]:
        """h1 (rows, N*r1) and h2 (rows, N*r2) in bf16."""
        return {"h1": self.rows * self.n * self.r1 * 2,
                "h2": self.rows * self.n * self.r2 * 2}

    @property
    def c_args(self) -> tuple[int, int, int]:
        """The integers C takes after the sizes: the K-slice lengths."""
        return self.k1, self.k2, self.k3


@dataclass(frozen=True)
class LowrankSplit(_Split):
    """The two-phase lowrank kernel's work split for one call
    ``y = (x @ W(w0)) @ W(w1)``: ``k1``, ``k2`` are the K-slice lengths of
    phase 1 (x @ w0, K = C, width R) and phase 2 (h @ w1, K = R, width S),
    ``rows`` the rows of a row block, ``ctas`` the CTAs the launch takes
    at most (0: the whole persistent grid)."""
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

    def intermediates(self) -> dict[str, int]:
        """h (rows, R) in bf16."""
        return {"h": self.rows * self.r * 2}

    @property
    def c_args(self) -> tuple[int, int, int]:
        """The integers C takes after the sizes: the K-slice lengths and
        the CTA cap."""
        return self.k1, self.k2, self.ctas


def branched_split(m: int, c: int, n: int, r1: int, r2: int, s: int,
                   sms: int) -> BranchedSplit:
    """Work split of the split-phase kernel on a card of ``sms`` SMs: each
    phase slices its reduction axis (C, r1, N*r2) so that with its column
    tiles (N x tiles(r1), N x tiles(r2), tiles(S)) it has about
    ITEMS_PER_SM items per SM."""
    if min(m, c, n, r1, r2, s, sms) <= 0:
        raise ValueError(f"branched split of ({m}, {c}, {n}, {r1}, {r2}, "
                         f"{s}) on {sms} SMs: every size must be positive")
    target = ITEMS_PER_SM * sms
    return BranchedSplit(
        m=m, c=c, n=n, r1=r1, r2=r2, s=s, rows=min(m, BM),
        k1=_slice(c, n * math.ceil(r1 / BN), target),
        k2=_slice(r1, n * math.ceil(r2 / BN), target),
        k3=_slice(n * r2, math.ceil(s / BN), target))


def lowrank_split(m: int, c: int, r: int, s: int, sms: int,
                  items: int | tuple[int, int] | None = None,
                  ctas: int | None = None) -> LowrankSplit:
    """Work split of the two-phase lowrank kernel on a card of ``sms``
    SMs: each phase slices its reduction axis (C, R) so that with its
    column tiles (tiles(R), tiles(S)) it has about ``items`` items (one
    count for both phases or one each; None, or None for a phase, is
    ITEMS_PER_SM per SM, one round of the persistent grid); fewer items
    give longer slices, fewer partials to sum.  ``ctas``: the CTAs the launch takes at most (0: the
    whole persistent grid; default LOWRANK_CTAS_PER_SM per SM where no
    phase has more items than ``sms``, else the whole grid)."""
    n1, n2 = items if isinstance(items, tuple) else (items, items)
    n1, n2 = (ITEMS_PER_SM * sms if n is None else n for n in (n1, n2))
    if min(m, c, r, s, sms, n1, n2) <= 0 or (ctas or 0) < 0:
        raise ValueError(f"lowrank split of ({m}, {c}, {r}, {s}) on {sms} "
                         f"SMs, {items} items, {ctas} CTAs: every size must "
                         "be positive")
    k1 = _slice(c, math.ceil(r / BN), n1)
    k2 = _slice(r, math.ceil(s / BN), n2)
    if ctas is None:
        most = max(math.ceil(c / k1) * math.ceil(r / BN),
                   math.ceil(r / k2) * math.ceil(s / BN))
        ctas = LOWRANK_CTAS_PER_SM * sms if most <= sms else 0
    return LowrankSplit(m=m, c=c, r=r, s=s, rows=min(m, BM), k1=k1, k2=k2,
                        ctas=ctas)


@functools.lru_cache(maxsize=256)
def _plan(dims: tuple[int, ...], sms: int, knobs: tuple
          ) -> tuple[tuple[int, ...], int, tuple[int, ...]]:
    """What one launch passes to C (cached per shape): the split's
    integers after the sizes (:attr:`c_args`), its scratch bytes and the
    offsets of its regions -- a branched split for ``dims`` (M, C, N, r1,
    r2, S), a lowrank split for (M, C, R, S) with ``knobs`` the keyword
    arguments of :func:`lowrank_split` as pairs."""
    sp = branched_split(*dims, sms) if len(dims) == 6 else \
        lowrank_split(*dims, sms, **dict(knobs))
    return sp.c_args, sp.scratch_bytes, tuple(sp.offsets().values())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_operands(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                   v: torch.Tensor) -> tuple[int, int, int, int, int, int]:
    """Raise on an operand the kernels do not take; return ``(m, c, n, r1,
    r2, s)``."""
    for name, t, nd in (("x", x, 2), ("u", u, 3), ("xc", xc, 3),
                        ("v", v, 3)):
        if t.device.type != "cuda":
            raise ValueError(f"branched_matmul kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.dtype != x.dtype:
            raise TypeError(f"branched_matmul kernel: {name} is {t.dtype}, "
                            f"x is {x.dtype}")
        if t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"branched_matmul kernel: {name} must be a "
                             f"contiguous {nd}-D tensor, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("branched_matmul kernel: operands on "
                             f"{x.device} and {t.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"branched_matmul kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    m, c = x.shape
    n, c2, r1 = u.shape
    n2, r1b, r2 = xc.shape
    n3, r2b, s = v.shape
    if c != c2 or n != n2 or n != n3 or r1 != r1b or r2 != r2b:
        raise ValueError(
            f"branched_matmul kernel: shapes {tuple(x.shape)} "
            f"{tuple(u.shape)} {tuple(xc.shape)} {tuple(v.shape)} do not "
            "chain")
    return m, c, n, r1, r2, s


def branched_matmul(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """x (M,C); u (N,C,r1); xc (N,r1,r2); v (N,r2,S) -> (M,S), all one
    float dtype on one CUDA device, contiguous."""
    global launches
    dims = check_operands(x, u, xc, v)
    y = torch.empty((dims[0], dims[5]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if x.dtype == torch.float32:
        _launch_cluster(x, u, xc, v, y)
    else:
        check_factors("branched_matmul", dims[1:5], u, xc, v)
        _launch_mma(x, u, xc, v, y, None, dims)
    launches += 1
    return y


def branched_matmul_phase_us(x: torch.Tensor, u: torch.Tensor,
                             xc: torch.Tensor, v: torch.Tensor
                             ) -> list[float]:
    """One counted launch of the bf16 split-phase kernel with its phase
    timer on: microseconds of each phase (1, 2, 3 per row block, each up
    to the grid sync that ends it), read by CTA 0 from %globaltimer."""
    global launches
    dims = check_operands(x, u, xc, v)
    us = phase_us(lambda y, ts: _launch_mma(x, u, xc, v, y, ts, dims), x,
                  dims)
    launches += 1
    return us


def check_factors(what: str, sizes: tuple[int, ...], *factors) -> None:
    """Raise on empty factors (a zero in ``sizes``, the factors' widths):
    the split-phase kernels take none."""
    if min(sizes) == 0:
        raise ValueError(f"{what} kernel: empty factors "
                         + " ".join(str(tuple(f.shape)) for f in factors))


def phase_us(launch, x: torch.Tensor, dims: tuple[int, ...]) -> list[float]:
    """Run ``launch(y, ts)``, one launch of a split-phase kernel on bf16
    ``x`` with its phase timer ``ts`` on, and return the microseconds of
    each phase (1, 2, 3 per row block for a branched kernel, ``dims`` (M,
    C, N, r1, r2, S); 1, 2 for the lowrank kernel, (M, C, R, S)), each up
    to the grid sync that ends it, read by CTA 0 from %globaltimer."""
    m, s = dims[0], dims[-1]
    if x.dtype != torch.bfloat16 or min(dims) == 0:
        raise ValueError("the phase timer runs the bf16 kernel on "
                         "non-empty operands")
    phases = 3 if len(dims) == 6 else 2
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    ts = torch.zeros(1 + phases * math.ceil(m / BM), dtype=torch.int64,
                     device=x.device)
    launch(y, ts)
    t = ts.tolist()
    return [(b - a) / 1e3 for a, b in zip(t, t[1:])]


def launch_split(entry: str, lead: tuple, x: torch.Tensor,
                 weights: tuple[torch.Tensor, ...], y: torch.Tensor,
                 dims: tuple[int, ...], ts: torch.Tensor | None,
                 what: str, **knobs) -> None:
    """One cooperative launch of a split-phase kernel, the library's C
    function ``entry``, on operands already checked: ``lead`` the
    arguments before x (the factors' storage code), ``weights`` the
    factor tensors in the C order, ``dims`` (M, C, N, r1, r2, S) for a
    branched kernel or (M, C, R, S) for the lowrank one (``knobs``: its
    plan's ``items`` and ``ctas``, see :func:`lowrank_split`).  Plans the
    work split and allocates its scratch."""
    lib = build.load()
    ks, nbytes, off = _plan(dims, _sm_count(x.device.index),
                            tuple(sorted(knobs.items())))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            *lead, x.data_ptr(), *(w.data_ptr() for w in weights),
            y.data_ptr(), *(base + o for o in off), *dims, *ks,
            None if ts is None else ts.data_ptr(), stream)
    build.check(lib, rc, what)


def _launch_mma(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                v: torch.Tensor, y: torch.Tensor, ts: torch.Tensor | None,
                dims: tuple[int, ...]) -> None:
    """The split-phase kernel on bf16 operands already checked."""
    launch_split("lrk_branched_matmul_mma", (), x, (u, xc, v), y, dims, ts,
                 "branched_matmul")


def _launch_cluster(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                    v: torch.Tensor, y: torch.Tensor) -> None:
    """The cluster kernel (8-CTA clusters, CUDA-core FMAs): f32's kernel."""
    m, c = x.shape
    n, _, r1 = u.shape
    r2, s = v.shape[1:]
    lib = build.load()
    bm, smem = build.chain_bm(
        m, lambda bm: lib.lrk_branched_smem(DTYPES[x.dtype], bm, n, r1, r2))
    if smem > build.SMEM_LIMIT:
        raise ValueError(f"branched_matmul kernel: {n} branches of ranks "
                         f"({r1}, {r2}) need {smem} B of shared memory at "
                         f"{bm} rows (limit {build.SMEM_LIMIT})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_branched_matmul(DTYPES[x.dtype], bm, x.data_ptr(),
                                     u.data_ptr(), xc.data_ptr(),
                                     v.data_ptr(), y.data_ptr(), m, c, n,
                                     r1, r2, s, stream)
    build.check(lib, rc, "branched_matmul")


def cluster_branched_matmul(x: torch.Tensor, u: torch.Tensor,
                            xc: torch.Tensor, v: torch.Tensor
                            ) -> torch.Tensor:
    """The cluster kernel in x's dtype, bf16 included, uncounted: the
    earlier bf16 design, kept as a yardstick for the split-phase kernel
    (chip_smoke's ``prev_ms``).  The serve path never calls it."""
    m, _, _, _, _, s = check_operands(x, u, xc, v)
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m and s:
        _launch_cluster(x, u, xc, v, y)
    return y
