"""Wrapper of the branched low-rank CUDA kernels
``y = sum_n ((x @ u_n) @ xc_n) @ v_n`` (paper Eq. 17).

The kernels (``csrc/branched_matmul.cu``) replace the TPU kernel
``repro/kernels/branched_matmul.py::branched_matmul``; the source note
says what bounds them and how the design answers.  bf16 goes to the
split-phase tensor-core kernel, one cooperative launch whose work split
:func:`branched_split` computes here (:func:`lowrank_split` plans its
two-phase form, which bf16 ``lowrank_matmul``, ``lowrank_matmul_q`` and
``lowrank_matmul_sq`` run), or, at LARGE_M rows or more, to the large-M
form (``csrc/chain_wgmma.cuh``: one output-tiled ``wgmma`` launch per
product, planned by :func:`large_m_plan`, which bf16 ``lowrank_matmul``
takes too); f32 goes at every M to the f32 form (``csrc/chain_f32.cu``:
one output-tiled, K-sliced split-TF32 ``mma.sync`` launch per product,
planned by :func:`f32_plan`, which f32 ``lowrank_matmul`` takes too).
The quantized chains ``lowrank_matmul_q`` and ``branched_matmul_q`` run
both forms too: the large-M form on factors that the dequantizing pass
(``csrc/chain_dequant.cu``) writes into the plan's scratch as bf16 first,
the f32 form reading their int8 / e4m3 bytes (``launch_large_m`` and
``launch_f32`` with ``scales``).
This wrapper checks the operands, allocates the output and the scratch,
launches on the current stream and counts launches.  CUDA tensors only:
the CPU path is the plain version in :mod:`repro_torch.kernels.ref`,
chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes
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
#: the large-M form (csrc/chain_wgmma.cuh): the K depth of a ring stage,
#: the output tile heights and widths it is built for, and its ring depth
#: (stages of a BM x 64 A tile and a 64 x BN B tile): the deepest with one
#: CTA a SM, or as many as fit 96 KB where a product has more tiles than
#: the card has SMs, so that two CTAs share one
WG_BK = 64
WG_BM = (128, 64)
WG_BN = (128, 64)
WG_STAGES, WG_TWO_CTA_RING = 6, 96 * 1024
#: the fewest activation rows at which bf16 B1 and B2 take the large-M
#: form; fewer rows take the split-phase form.  From chip_smoke's LARGE_M
#: sweep on an H100 at 700 W (PERF.md): at M = 128 the large-M form was
#: the faster at every swept shape (1.2-2.8x; the split form walks two
#: 64-row blocks), at M = 64 the split form at the k/v pair and the down
#: projections (1.04-1.6x)
LARGE_M = 128
#: the same for bf16 B3 and B4, whose large-M form runs the dequantizing
#: pass first.  From chip_smoke's LARGE_M sweep of B3 / B4 on int8
#: factors on an H100 at 700 W (PERF.md): at M = 128 the split
#: form was the faster at the VLM's k,v (0.0391 against 0.0548 ms; the
#: large-M form's first product has 12 tiles over K = 8,192) and its down
#: (0.2908 / 0.3105), the large-M form at its q,o and gate,up and at
#: zamba2's shapes (1.15-1.88x); at M = 256 the large-M form at every
#: swept shape (1.38-3.63x)
LARGE_M_Q = 256
#: the f32 form (csrc/chain_f32.cu): the output tile's width, the K depth
#: of a ring stage, the tile heights it is built for (the lowest that
#: holds M, 64 past 32 rows; two CTAs an SM at each), the work items per
#: SM a product's K slices aim for, and the shortest K slice (the 4-stage
#: ring's worth)
F32_BN, F32_BK, F32_BM = 128, 32, (16, 32, 64)
F32_ITEMS_PER_SM = 2
F32_MIN_SLICE = 4 * F32_BK


def chain_form(dtype: torch.dtype, m: int, quantized: bool = False) -> str:
    """The form a B1 or B2 call (``quantized``: B3 or B4) on ``m`` rows of
    ``dtype`` activations runs: "f32" for f32 at every M (split TF32 on
    the tensor cores), "large_m" for bf16 at LARGE_M rows or more
    (LARGE_M_Q for B3 / B4), else "split"."""
    if dtype == torch.float32:
        return "f32"
    return "large_m" if m >= (LARGE_M_Q if quantized else LARGE_M) \
        else "split"


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


class _Scratch:
    """The scratch layout a plan of named regions shares: each region at an
    offset aligned to ALIGN bytes, in the order of ``region_bytes()``."""

    def region_bytes(self) -> dict[str, int]:
        raise NotImplementedError

    def offsets(self) -> dict[str, int]:
        out, at = {}, 0
        for name, nbytes in self.region_bytes().items():
            out[name] = at
            at += _align(nbytes)
        return out

    @property
    def scratch_bytes(self) -> int:
        return sum(_align(b) for b in self.region_bytes().values())


class _Split(_Scratch):
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


def _pad(n: int, to: int) -> int:
    return -(-n // to) * to


def _pad8(n: int) -> int:
    """``n`` elements rounded up to whole 16-byte granules of bf16."""
    return _pad(n, 8)


def _tile(cols: int, rows: int, groups: int, sms: int
          ) -> tuple[int, int, int]:
    """The large-M form's output tile ``(bm, bn)`` and ring depth for a
    product of ``groups`` x ``rows`` x ``cols`` outputs on a card of
    ``sms`` SMs: 128 x 128; 64 wide where 128-wide tiles pad more columns
    than 64-wide ones (a branch of 192) or leave SMs idle; then 64 high
    where the card is still not full."""
    def count(bm, bn):
        return math.ceil(cols / bn) * math.ceil(rows / bm) * groups
    bn = 128
    if math.ceil(cols / 128) * 128 > _pad(cols, 64) or \
            count(128, 128) < sms:
        bn = 64
    bm = 64 if count(128, bn) < sms else 128
    stage = (bm + bn) * WG_BK * 2
    stages = (min(WG_STAGES, WG_TWO_CTA_RING // stage)
              if count(bm, bn) > sms else WG_STAGES)
    return bm, bn, stages


@dataclass(frozen=True)
class Product:
    """One product of the large-M form, one launch of
    ``csrc/chain_wgmma.cuh``'s kernel:
    ``out_z[m, n] = rnd(sum_{s < sum_groups} A_g[m, :k] @ B_g[:k, n])``
    with ``g = z + s``, ``z < out_groups``, ``m < M``, ``n < cols`` (one
    of out_groups and sum_groups is 1).  ``a``, ``b`` and ``out`` name the
    operands: the call's inputs ("x", the factors), a scratch region, or
    "y".  Strides in elements: A_g's row m at ``m * a_ld + g * a_group``
    (g taken as 0 where ``a_groups`` is 1), B_g's row k at ``g * b_group +
    k * b_ld``, out_z's row m at ``z * c_group + m * c_ld``.  ``bm`` x
    ``bn``: the output tile, ``stages`` the depth of its ring."""
    a: str
    b: str
    out: str
    m: int
    cols: int
    k: int
    out_groups: int
    sum_groups: int
    a_groups: int
    b_groups: int
    a_ld: int
    a_group: int
    b_ld: int
    b_group: int
    c_ld: int
    c_group: int
    bm: int
    bn: int
    stages: int

    def tiles(self) -> list[tuple[int, int, int, int, int]]:
        """The output tiles, one a CTA, in the grid's order (columns
        fastest, then rows, then the group): ``(z, r0, r1, c0, c1)``."""
        return [(z, r0, min(self.m, r0 + self.bm), c0,
                 min(self.cols, c0 + self.bn))
                for z in range(self.out_groups)
                for r0 in range(0, self.m, self.bm)
                for c0 in range(0, self.cols, self.bn)]

    def spec(self, slot: dict[str, int]) -> tuple[int, ...]:
        """The product's 19 integers in ``lrk_chain_wgmma``'s spec, its
        operands as their ``slot`` in the call's pointer array."""
        return (slot[self.a], self.a_ld, self.a_group, self.a_groups,
                slot[self.b], self.b_ld, self.b_group, self.b_groups,
                slot[self.out], self.c_ld, self.c_group, self.m, self.cols,
                self.k, self.out_groups, self.sum_groups, self.bm, self.bn,
                self.stages)


@dataclass(frozen=True)
class LargeMPlan(_Scratch):
    """The large-M form's plan of one call: its products in launch order
    and its scratch regions ``(name, padded shape)``, bf16, each aligned
    to ALIGN bytes -- the padded copies of the inputs in ``copies`` (TMA
    wants rows of whole 16-byte granules and 16-byte aligned bases), then
    the intermediates (B1's h; B2's h1 and h2, each (M, N, r) with r
    padded to a granule).  ``dequant``: the quantized factors (B3 / B4)
    among the copies, which the dequantizing pass writes instead."""
    products: tuple[Product, ...]
    regions: tuple[tuple[str, tuple[int, ...]], ...]
    copies: frozenset
    dequant: frozenset = frozenset()

    def region_bytes(self) -> dict[str, int]:
        return {name: math.prod(shape) * 2 for name, shape in self.regions}


def _input_shapes(dims: tuple[int, ...]) -> dict[str, tuple[int, ...]]:
    """The input operands' shapes of a B1 (``dims`` (M, C, R, S)) or B2
    ((M, C, N, r1, r2, S)) call, by name, in the C side's pointer
    order."""
    m, c, s = dims[0], dims[1], dims[-1]
    if len(dims) == 4:
        r = dims[2]
        return {"x": (m, c), "w0": (c, r), "w1": (r, s)}
    n, r1, r2 = dims[2:5]
    return {"x": (m, c), "u": (n, c, r1), "xc": (n, r1, r2),
            "v": (n, r2, s)}


def large_m_plan(dims: tuple[int, ...], sms: int,
                 copies: frozenset = frozenset(),
                 quantized: bool = False) -> LargeMPlan:
    """The large-M form's plan for B1 (``dims`` (M, C, R, S): h = rnd(x @
    w0), y = rnd(h @ w1)) or B2 ((M, C, N, r1, r2, S): h1 = rnd(x @ u_n)
    per branch, h2 = rnd(h1_n @ xc_n) per branch, y = rnd(h2 @ v) with the
    branches summed in the K loop) on a card of ``sms`` SMs.  ``copies``:
    the inputs the wrapper copies into padded scratch rows (a misaligned
    base); an input whose row is not whole granules is always copied.
    ``quantized`` (B3 / B4): every factor takes a region, which the
    dequantizing pass fills (``dequant``)."""
    if len(dims) not in (4, 6) or min(*dims, sms) <= 0:
        raise ValueError(f"large-M plan of {dims} on {sms} SMs: a B1 (M, C, "
                         "R, S) or B2 (M, C, N, r1, r2, S) call of positive "
                         "sizes")
    m, c, s = dims[0], dims[1], dims[-1]
    shapes = _input_shapes(dims)
    if len(dims) == 4:
        r = dims[2]
        inter = {"h": (m, r)}
    else:
        n, r1, r2 = dims[2:5]
        inter = {"h1": (m, n, r1), "h2": (m, n, r2)}
    if set(copies) - set(shapes):
        raise ValueError(f"copies {sorted(copies)}: not inputs of {dims}")
    dequant = frozenset(k for k in shapes if k != "x" and quantized)
    copies = frozenset(copies) | dequant | {k for k, sh in shapes.items()
                                            if sh[-1] % 8}
    ld = {k: _pad8(sh[-1]) if k in copies else sh[-1]
          for k, sh in shapes.items()}
    regions = tuple((k, sh[:-1] + (ld[k],)) for k, sh in shapes.items()
                    if k in copies) + tuple(
        (k, sh[:-1] + (_pad8(sh[-1]),)) for k, sh in inter.items())

    def product(a, b, out, cols, k, *, a_ld, c_ld, a_groups=1, a_group=0,
                b_groups=1, c_group=0, out_groups=1, sum_groups=1):
        bm, bn, stages = _tile(cols, m, out_groups, sms)
        return Product(
            a=a, b=b, out=out, m=m, cols=cols, k=k, out_groups=out_groups,
            sum_groups=sum_groups, a_groups=a_groups, b_groups=b_groups,
            a_ld=a_ld, a_group=a_group or a_ld, b_ld=ld[b],
            b_group=k * ld[b], c_ld=c_ld, c_group=c_group, bm=bm, bn=bn,
            stages=stages)
    if len(dims) == 4:
        rp = _pad8(r)
        products = (product("x", "w0", "h", r, c, a_ld=ld["x"], c_ld=rp),
                    product("h", "w1", "y", s, r, a_ld=rp, c_ld=s))
    else:
        r1p, r2p = _pad8(r1), _pad8(r2)
        products = (
            product("x", "u", "h1", r1, c, a_ld=ld["x"], b_groups=n,
                    c_ld=n * r1p, c_group=r1p, out_groups=n),
            product("h1", "xc", "h2", r2, r1, a_ld=n * r1p, a_groups=n,
                    a_group=r1p, b_groups=n, c_ld=n * r2p, c_group=r2p,
                    out_groups=n),
            product("h2", "v", "y", s, r2, a_ld=n * r2p, a_groups=n,
                    a_group=r2p, b_groups=n, c_ld=s, sum_groups=n))
    return LargeMPlan(products=products, regions=regions, copies=copies,
                      dequant=dequant)


def _inputs(dims: tuple[int, ...]) -> tuple[str, ...]:
    """The input operands' names of a B1 (``dims`` (M, C, R, S)) or B2
    ((M, C, N, r1, r2, S)) call, in the C side's pointer order."""
    return ("x", "w0", "w1") if len(dims) == 4 else ("x", "u", "xc", "v")


def _quant_names(dims: tuple[int, ...], quantized) -> tuple[str, ...]:
    """The pointer array's extra names of a quantized call (B3 / B4): each
    factor's values ("<f>_q") and scales ("<f>_scale"), in order."""
    if not quantized:
        return ()
    return tuple(f"{f}_{k}" for f in _inputs(dims)[1:]
                 for k in ("q", "scale"))


def dequant_spec(dims: tuple[int, ...], regions, dequant, slot: dict
                 ) -> list[int]:
    """The dequantizing pass's spec (``lrk_dequant_rows``: 7 integers a
    factor) for the factors named in ``dequant``, each into its region of
    ``regions`` (padded rows), its operands as their ``slot``."""
    shapes = _input_shapes(dims)
    out = []
    for name, shape in regions:
        if name not in dequant:
            continue
        full = shapes[name]
        groups = full[0] if len(full) == 3 else 1
        out += [slot[f"{name}_q"], slot[f"{name}_scale"], slot[name],
                groups, full[-2], full[-1], shape[-1]]
    return out


@functools.lru_cache(maxsize=256)
def _large_launch(dims: tuple[int, ...], sms: int, copies: frozenset,
                  quantized: bool = False
                  ) -> tuple[LargeMPlan, tuple[str, ...], object, tuple,
                             object]:
    """What a large-M call passes to C, cached per shape: its plan, the
    operand names in the order of the pointer array, the products' spec
    as a ctypes array, the scratch regions' offsets, and the dequantizing
    pass's spec (a ctypes array; None for B1 / B2)."""
    plan = large_m_plan(dims, sms, copies, quantized)
    names = _inputs(dims) + ("y",) + tuple(
        name for name, _ in plan.regions) + _quant_names(dims, quantized)
    slot = {name: i for i, name in enumerate(names)}
    flat = [v for p in plan.products for v in p.spec(slot)]
    dq = dequant_spec(dims, plan.regions, plan.dequant, slot)
    return plan, names, (ctypes.c_longlong * len(flat))(*flat), tuple(
        plan.offsets().values()), (ctypes.c_longlong * len(dq))(*dq) \
        if dq else None


def _launch_dequant(lib, spec, n: int, ptrs, qcode: int, out_dtype: int,
                    stream, what: str) -> None:
    """One launch of the dequantizing pass over ``n`` factors."""
    build.check(lib, lib.lrk_dequant_rows(n, spec, ptrs, qcode, out_dtype,
                                          stream), what)


def launch_large_m(x: torch.Tensor, weights: tuple[torch.Tensor, ...],
                   y: torch.Tensor, dims: tuple[int, ...], what: str,
                   scales: tuple | None = None, qcode: int = 0,
                   products: bool = True) -> torch.Tensor:
    """The large-M form on bf16 ``x`` already checked: B1's (w0, w1) with
    ``dims`` (M, C, R, S) or B2's (u, xc, v) with (M, C, N, r1, r2, S),
    bf16; or, with ``scales`` (one a factor), B3's / B4's int8 / e4m3
    factors (``qcode``, ``lowrank_matmul_q.QDTYPES``).  The copies its
    plan asks for, then the dequantizing pass (B3 / B4: every factor into
    its scratch region, as bf16) and one host call that launches every
    product of the plan in order on the current stream.  ``products``
    False stops after the pass (chip_smoke times it alone).  Returns the
    scratch."""
    quantized = scales is not None
    inputs = (x, *weights)
    names = _inputs(dims)
    misaligned = frozenset(n for n, t in zip(names, inputs)
                           if t.data_ptr() % 16)
    plan, slots, spec, offsets, dq = _large_launch(
        dims, _sm_count(x.device.index), misaligned, quantized)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    ptr = {n: t.data_ptr() for n, t in zip(names, inputs)}
    ptr["y"] = 0 if y is None else y.data_ptr()
    if quantized:
        for n, t, sc in zip(names[1:], weights, scales):
            ptr[f"{n}_q"], ptr[f"{n}_scale"] = t.data_ptr(), sc.data_ptr()
    for (name, shape), at in zip(plan.regions, offsets):
        ptr[name] = scratch.data_ptr() + at
        if name in plan.copies and name not in plan.dequant:
            t = inputs[names.index(name)]
            region = scratch[at:at + math.prod(shape) * 2].view(
                torch.bfloat16).view(shape)
            region[..., :t.shape[-1]].copy_(t)
    ptrs = (ctypes.c_void_p * len(slots))(*(ptr[n] for n in slots))
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if dq is not None:
            _launch_dequant(lib, dq, len(plan.dequant), ptrs, qcode,
                            DTYPES[torch.bfloat16], stream, what)
        if products:
            build.check(lib, lib.lrk_chain_wgmma(len(plan.products), spec,
                                                 ptrs, stream), what)
    return scratch


def _pad4(n: int) -> int:
    """``n`` elements rounded up to whole 16-byte granules of f32."""
    return _pad(n, 4)


@dataclass(frozen=True)
class F32Product:
    """One product of the f32 form, one launch of ``csrc/chain_f32.cu``'s
    kernel: ``out_z[m, n] = sum_{k < k} A_z[m, k] @ B_z[k, n]`` for ``z <
    groups``, ``m < M``, ``n < cols``, in f32.  ``a``, ``b`` and ``out``
    name the operands (the call's inputs, a scratch region, or "y").
    Strides in elements: A_z's row m at ``z * a_group + m * a_ld``
    (a_group 0: one A for every group), B_z's row k at ``z * b_group + k *
    b_ld``, out_z's row m at ``z * c_group + m * c_ld``.  ``bm`` x F32_BN:
    the output tile; ``ks`` the K slice (a multiple of F32_BK).  A
    quantized B (B3 / B4): ``bq`` its storage code
    (``lowrank_matmul_q.QDTYPES``; -1 an f32 B), ``scale`` its scales'
    operand, B_z[k, n] times ``scale[(z + k // s_rows) * cols + n]``."""
    a: str
    b: str
    out: str
    m: int
    cols: int
    k: int
    groups: int
    a_ld: int
    a_group: int
    b_ld: int
    b_group: int
    c_ld: int
    c_group: int
    bm: int
    ks: int
    bq: int = -1
    scale: str | None = None
    s_rows: int = 0

    @property
    def slices(self) -> int:
        return math.ceil(self.k / self.ks)

    def k_slices(self) -> list[tuple[int, int]]:
        """The K slices ``[k0, k1)`` in order, one a work item of a
        tile."""
        return [(q * self.ks, min(self.k, q * self.ks + self.ks))
                for q in range(self.slices)]

    def tiles(self) -> list[tuple[int, int, int, int, int]]:
        """The output tiles in the grid's order (rows fastest, so the row
        tiles of a column tile read its B together, then columns, then
        the group): ``(z, r0, r1, c0, c1)``."""
        return [(z, r0, min(self.m, r0 + self.bm), c0,
                 min(self.cols, c0 + F32_BN))
                for z in range(self.groups)
                for c0 in range(0, self.cols, F32_BN)
                for r0 in range(0, self.m, self.bm)]

    def granules(self) -> tuple[bool, bool]:
        """Whether A's and B's strides are whole 16-byte granules (B's of
        one byte a value where quantized): the kernel copies an operand 16
        bytes at a time where they are (and its base is 16-byte aligned),
        else 4 bytes at a time."""
        per = 16 if self.bq >= 0 else 4
        return (self.a_ld % 4 == 0 and self.a_group % 4 == 0,
                self.b_ld % per == 0 and self.b_group % per == 0)

    @property
    def p_ld(self) -> int:
        """The row of a partial: the columns padded to a granule, so the
        last CTA of a tile reads them 16 bytes at a time."""
        return _pad4(self.cols)

    def partial_floats(self) -> int:
        """f32 partials of a sliced product: slices x groups x M x
        p_ld."""
        return (self.slices * self.groups * self.m * self.p_ld
                if self.slices > 1 else 0)

    def spec(self, slot: dict[str, int]) -> tuple[int, ...]:
        """The product's 20 integers in ``lrk_chain_f32``'s spec, its
        operands (and the partials' region "p", -1 where unsliced; the
        scales, -1 for an f32 B) as their ``slot`` in the call's pointer
        array."""
        return (slot[self.a], self.a_ld, self.a_group, slot[self.b],
                self.b_ld, self.b_group, slot[self.out], self.c_ld,
                self.c_group, self.m, self.cols, self.k, self.groups,
                self.bm, self.ks,
                slot["p"] if self.slices > 1 else -1, self.p_ld, self.bq,
                -1 if self.scale is None else slot[self.scale], self.s_rows)


@dataclass(frozen=True)
class F32Plan(_Scratch):
    """The f32 form's plan of one call: its products in launch order, its
    scratch regions ``(name, shape)`` in f32, each aligned to ALIGN bytes
    -- the intermediates (B1's h (M, R); B2's h1 (M, N, r1) and h2 (M,
    N*r2), rows padded to a granule), then "p", the partials of the
    largest sliced product -- and the tickets its sliced products take
    (one an output tile).  A quantized call's (B3 / B4) factors in
    ``dequant`` (rows not whole 4-byte words) come first among the
    regions: the dequantizing pass writes them as f32 padded rows, read by
    their products as f32 factors."""
    products: tuple[F32Product, ...]
    regions: tuple[tuple[str, tuple[int, ...]], ...]
    tickets: int
    dequant: frozenset = frozenset()

    def region_bytes(self) -> dict[str, int]:
        return {name: math.prod(shape) * 4 for name, shape in self.regions}


def f32_plan(dims: tuple[int, ...], sms: int, qcode: int | None = None,
             misaligned: frozenset = frozenset()) -> F32Plan:
    """The f32 form's plan for B1 (``dims`` (M, C, R, S): h = x @ w0, y =
    h @ w1) or B2 ((M, C, N, r1, r2, S): h1 = x @ u_n per branch, h2 =
    h1_n @ xc_n per branch, y = h2 @ v with v read as one (N*r2, S)
    matrix) on a card of ``sms`` SMs.  Each product takes the lowest tile
    of F32_BM that holds M (64 past 32 rows) and, where its tiles number
    fewer than F32_ITEMS_PER_SM x sms, K slices of at least F32_MIN_SLICE
    so that tiles x slices come near that many.  ``qcode`` (B3 / B4: the
    factors' storage code, ``lowrank_matmul_q.QDTYPES``): the products
    read the factors' bytes and scales (v's scales by branch, every r2
    rows), but a factor whose rows are not whole 4-byte words, or whose
    base is not (``misaligned``), is dequantized first into an f32 region
    of padded rows (``dequant``)."""
    if len(dims) not in (4, 6) or min(*dims, sms) <= 0:
        raise ValueError(f"f32 plan of {dims} on {sms} SMs: a B1 (M, C, R, "
                         "S) or B2 (M, C, N, r1, r2, S) call of positive "
                         "sizes")
    m, c, s = dims[0], dims[1], dims[-1]
    bm = next(h for h in F32_BM if m <= h or h == F32_BM[-1])
    target = F32_ITEMS_PER_SM * sms
    shapes = _input_shapes(dims)
    dequant = frozenset(
        f for f, sh in shapes.items() if f != "x" and qcode is not None
        and (sh[-1] % 4 or f in misaligned))
    regions = [(f, sh[:-1] + (_pad4(sh[-1]),)) for f, sh in shapes.items()
               if f in dequant]
    ld = {f: (_pad4(sh[-1]) if f in dequant else sh[-1])
          for f, sh in shapes.items()}

    def product(a, b, out, cols, k, *, a_ld, c_ld, groups=1, a_group=0,
                b_rows=0, c_group=0, s_rows=None):
        tiles = groups * math.ceil(m / bm) * math.ceil(cols / F32_BN)
        ks = _pad(k, F32_BK)
        if tiles < target:
            want = target // tiles
            ks = min(ks, max(F32_MIN_SLICE, math.ceil(
                math.ceil(k / F32_BK) / want) * F32_BK))
        quant = qcode is not None and b not in dequant
        return F32Product(a=a, b=b, out=out, m=m, cols=cols, k=k,
                          groups=groups, a_ld=a_ld, a_group=a_group,
                          b_ld=ld[b], b_group=b_rows * ld[b], c_ld=c_ld,
                          c_group=c_group, bm=bm, ks=ks,
                          bq=qcode if quant else -1,
                          scale=f"{b}_scale" if quant else None,
                          s_rows=(s_rows or k) if quant else 0)
    if len(dims) == 4:
        r = dims[2]
        rp = _pad4(r)
        regions += [("h", (m, rp))]
        products = (product("x", "w0", "h", r, c, a_ld=c, c_ld=rp),
                    product("h", "w1", "y", s, r, a_ld=rp, c_ld=s))
    else:
        n, r1, r2 = dims[2:5]
        r1p, h2ld = _pad4(r1), _pad4(n * r2)
        regions += [("h1", (m, n, r1p)), ("h2", (m, h2ld))]
        products = (
            product("x", "u", "h1", r1, c, a_ld=c, c_ld=n * r1p,
                    groups=n, b_rows=c, c_group=r1p),
            product("h1", "xc", "h2", r2, r1, a_ld=n * r1p, c_ld=h2ld,
                    groups=n, a_group=r1p, b_rows=r1, c_group=r2),
            product("h2", "v", "y", s, n * r2, a_ld=h2ld, c_ld=s,
                    s_rows=r2))
    sliced = [p for p in products if p.slices > 1]
    if sliced:
        regions.append(("p", (max(p.partial_floats() for p in sliced),)))
    return F32Plan(products=products, regions=tuple(regions),
                   tickets=max((len(p.tiles()) for p in sliced), default=0),
                   dequant=dequant)


@functools.lru_cache(maxsize=256)
def _f32_launch(dims: tuple[int, ...], sms: int, qcode: int | None = None,
                misaligned: frozenset = frozenset()
                ) -> tuple[F32Plan, tuple[str, ...], object, tuple, object]:
    """What an f32 call passes to C, cached per shape: its plan, the
    operand names in the order of the pointer array, the products' spec
    as a ctypes array, the scratch regions' offsets, and the dequantizing
    pass's spec (a ctypes array; None where no factor is dequantized
    first)."""
    plan = f32_plan(dims, sms, qcode, misaligned)
    names = _inputs(dims) + ("y",) + tuple(
        name for name, _ in plan.regions) + _quant_names(
            dims, qcode is not None)
    slot = {name: i for i, name in enumerate(names)}
    flat = [v for p in plan.products for v in p.spec(slot)]
    dq = dequant_spec(dims, plan.regions, plan.dequant, slot)
    return plan, names, (ctypes.c_longlong * len(flat))(*flat), tuple(
        plan.offsets().values()), (ctypes.c_longlong * len(dq))(*dq) \
        if dq else None


def launch_f32(x: torch.Tensor, weights: tuple[torch.Tensor, ...],
               y: torch.Tensor, dims: tuple[int, ...], what: str,
               scales: tuple | None = None, qcode: int = 0,
               products: bool = True) -> torch.Tensor:
    """The f32 form on f32 ``x`` already checked: B1's (w0, w1) with
    ``dims`` (M, C, R, S) or B2's (u, xc, v) with (M, C, N, r1, r2, S), f32;
    or, with ``scales`` (one a factor), B3's / B4's int8 / e4m3 factors
    (``qcode``, ``lowrank_matmul_q.QDTYPES``): the dequantizing pass where
    the plan asks for it (factors of ragged rows), then one host call that
    launches every product of the plan in order on the current stream.
    ``products`` False stops after the pass (chip_smoke times it alone).
    Returns the scratch (with ``products`` False, None where the plan
    runs no pass)."""
    quantized = scales is not None
    names = _inputs(dims)
    misaligned = frozenset(n for n, t in zip(names[1:], weights)
                           if quantized and t.data_ptr() % 4)
    plan, slots, spec, offsets, dq = _f32_launch(
        dims, _sm_count(x.device.index), qcode if quantized else None,
        misaligned)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                          device=x.device)
    ptr = {n: t.data_ptr() for n, t in zip(names, (x, *weights))}
    ptr["y"] = 0 if y is None else y.data_ptr()
    if quantized:
        for n, t, sc in zip(names[1:], weights, scales):
            ptr[f"{n}_q"], ptr[f"{n}_scale"] = t.data_ptr(), sc.data_ptr()
    for (name, _), at in zip(plan.regions, offsets):
        ptr[name] = scratch.data_ptr() + at
    ptrs = (ctypes.c_void_p * len(slots))(*(ptr[n] for n in slots))
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if dq is not None:
            _launch_dequant(lib, dq, len(plan.dequant), ptrs, qcode,
                            DTYPES[torch.float32], stream, what)
        if not products:
            return None if dq is None else scratch
        tickets = build.tickets(x.device, plan.tickets) if plan.tickets \
            else None
        rc = lib.lrk_chain_f32(len(plan.products), spec, ptrs,
                               None if tickets is None else
                               tickets.data_ptr(),
                               0 if tickets is None else tickets.numel(),
                               stream)
    build.check(lib, rc, what)
    return scratch


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
    float dtype on one CUDA device, contiguous, in the form
    :func:`chain_form` names: f32 the f32 form, bf16 at M >= LARGE_M the
    large-M form, at fewer rows the split-phase kernel (none takes empty
    factors).  One counted call whatever the form."""
    global launches
    dims = check_operands(x, u, xc, v)
    y = torch.empty((dims[0], dims[5]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    check_factors("branched_matmul", dims[1:5], u, xc, v)
    form = chain_form(x.dtype, dims[0])
    if form == "f32":
        launch_f32(x, (u, xc, v), y, dims, "branched_matmul")
    elif form == "large_m":
        launch_large_m(x, (u, xc, v), y, dims, "branched_matmul")
    else:
        _launch_mma(x, u, xc, v, y, None, dims)
    launches += 1
    return y


def split_branched_matmul(x: torch.Tensor, u: torch.Tensor,
                          xc: torch.Tensor, v: torch.Tensor
                          ) -> torch.Tensor:
    """The bf16 split-phase kernel at any M, uncounted: the earlier form
    of a large-M call (chip_smoke's ``prev_ms``) and one side of its
    LARGE_M sweep.  The serve and train paths never call it."""
    return _forced("split_branched_matmul", x, (u, xc, v),
                   check_operands(x, u, xc, v))


def large_m_branched_matmul(x: torch.Tensor, u: torch.Tensor,
                            xc: torch.Tensor, v: torch.Tensor
                            ) -> torch.Tensor:
    """The large-M form at any M, uncounted: the other side of
    chip_smoke's LARGE_M sweep.  bf16 only; f32 or empty factors raise
    before anything is launched."""
    return _forced("large_m_branched_matmul", x, (u, xc, v),
                   check_operands(x, u, xc, v))


def _forced(what: str, x: torch.Tensor, weights: tuple,
            dims: tuple[int, ...]) -> torch.Tensor:
    """B1 (two ``weights``, ``dims`` (M, C, R, S)) or B2 (three, (M, C,
    N, r1, r2, S)) on operands already checked, in the form ``what``
    names ("split_..." or "large_m_..."), whatever M, uncounted."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what} runs bf16 activations, got {x.dtype}")
    check_factors(what, dims[1:-1], *weights)
    y = torch.empty((dims[0], dims[-1]), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if what.startswith("large_m"):
        launch_large_m(x, weights, y, dims, what)
    elif len(weights) == 2:
        launch_split("lrk_lowrank_matmul_mma", (), x, weights, y, dims, None,
                     what)
    else:
        _launch_mma(x, *weights, y, None, dims)
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
    the split-phase kernels, the large-M form and the f32 form take
    none."""
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
    """The cluster kernel (8-CTA clusters, CUDA-core FMAs): the earlier
    f32 kernel, kept as the yardstick :func:`cluster_branched_matmul`
    launches."""
    m, c = x.shape
    n, _, r1 = u.shape
    r2, s = v.shape[1:]
    lib = build.load()
    bm, _ = build.chain_fit(
        m, lambda bm: lib.lrk_branched_smem(DTYPES[x.dtype], bm, n, r1, r2),
        build.chain_heights(x.dtype),
        f"branched_matmul kernel at {n} branches of ranks ({r1}, {r2})")
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
    """The cluster kernel in x's dtype, uncounted: the earlier design of
    both dtypes, kept as a yardstick for the split-phase kernel and the
    f32 form (chip_smoke's ``prev_ms``).  The serve and train paths never
    call it."""
    m, _, _, _, _, s = check_operands(x, u, xc, v)
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m and s:
        _launch_cluster(x, u, xc, v, y)
    return y
