"""Wrappers of the paged decode attention CUDA kernels: one query row per
slot against a pool of fixed-size physical KV blocks reached through
per-slot block tables -- full width (:func:`decode_attention_paged`) or
int8 with one scale row per block (:func:`decode_attention_paged_q`).

The kernels (``csrc/decode_attention_paged.cu``) replace the TPU kernels
``repro/kernels/decode_attention_paged.py::decode_attention_paged`` and
``::decode_attention_paged_q``; the source note says what bounds them and
how the design answers.  Both pools run one sequence-split kernel: it
splits each slot's table across CTAs (:func:`paged_split`, plain Python,
so the CPU tests check it) and folds the splits inside the launch.  These
wrappers check the operands, allocate the output and the partials,
launch on the current stream and count launches, each pool on its own
counter; the earlier one-CTA-per-slot kernel stays callable, uncounted,
as a yardstick (``prev_*``).  CUDA tensors only: the CPU path is the
plain versions in :mod:`repro_torch.kernels.ref`, chosen by
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES

#: launches of the split kernel on a full-width pool since the last reset
#: (set to 0 to reset)
launches = 0
#: launches of the split kernel on an int8 pool since the last reset
launches_q = 0

#: most splits of one (slot, KV head): a lane of the fold's warp each
MAX_SPLITS = 32
#: CTAs per SM the split aims for: small CTAs (one warp per query row,
#: ~40 KB of shared memory at the served pool), several per SM
CTAS_PER_SM = 4


@dataclass(frozen=True)
class PagedSplit:
    """The split kernel's plan for one call: ``splits`` splits of ``span``
    table entries of each slot's ``nblk``-entry table."""
    b: int
    kh: int
    nblk: int
    span: int
    splits: int

    def entries(self) -> list[tuple[int, int]]:
        """Each split's table entries ``[begin, end)``, in split order."""
        return [(j * self.span, min(self.nblk, (j + 1) * self.span))
                for j in range(self.splits)]

    @property
    def ctas(self) -> int:
        return self.kh * self.b * self.splits

    def scratch_floats(self, g: int, d: int) -> int:
        """The partials: acc (G, D) and (m, l) per query row, per CTA."""
        return self.ctas * g * (d + 2)


#: positions of one staged pass and most table entries a pass takes where
#: bs < 64; ring depth in passes (csrc/decode_attention_paged.cu)
SPLIT_P, MAX_CE, SPLIT_STAGES = 64, 16, 3


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def split_smem(g: int, d: int, bs: int, esize: int, quant: bool,
               span: int) -> int:
    """Dynamic shared memory (bytes) of the split kernel at query rows
    ``g``, head dim ``d``, block size ``bs``, ``esize`` bytes a pool value
    (1 int8, 2 bf16, 4 f32), scale rows (``quant``) and ``span`` table
    entries a split, as the C side's ``split_smem`` counts it: the ring
    (one stage a pass, at most SPLIT_STAGES: 64 K and 64 V rows padded by
    16 bytes, the pass's scale rows), the query rows, the folded query
    rows (int8), the weights, the split's table entries and a flag."""
    entries = 2 if bs >= SPLIT_P else min(SPLIT_P // bs, MAX_CE)
    positions = SPLIT_P if bs >= SPLIT_P else entries * bs
    stages = min(math.ceil(span * bs / positions), SPLIT_STAGES)
    stage = _align16(2 * SPLIT_P * (d * esize + 16)
                     + (2 * entries * (d + 4) * 4 if quant else 0))
    return (stages * stage + _align16(g * d * 4)
            + (_align16(g * entries * d * 4) if quant else 0)
            + _align16(g * SPLIT_P * 4) + _align16(span * 4) + 16)


def paged_split(b: int, kh: int, nblk: int, sms: int,
                splits: int | None = None, *,
                fit: tuple[int, int, int, int, bool] | None = None
                ) -> PagedSplit:
    """Plan the split kernel for ``b`` slots of ``kh`` KV heads over
    tables of ``nblk`` entries on a card of ``sms`` SMs: about
    :data:`CTAS_PER_SM` CTAs per SM (``splits`` asks for that many splits
    instead), each split a run of whole table entries.  ``fit``, the
    geometry ``(g, d, bs, esize, quant)`` of :func:`split_smem`: a span
    whose ring would not fit shared memory shrinks (more splits, each of
    fewer passes) until it does, and raises where even the shortest span
    the fold takes (at most MAX_SPLITS splits) does not."""
    if min(b, kh, nblk, sms) <= 0:
        raise ValueError(f"paged split of ({b}, {kh}, {nblk}) on {sms} "
                         "SMs: every size must be positive")
    want = splits if splits is not None else \
        math.ceil(sms * CTAS_PER_SM / (b * kh))
    want = max(1, min(want, nblk, MAX_SPLITS))
    span = math.ceil(nblk / want)
    if fit is not None:
        while split_smem(*fit, span) > build.SMEM_LIMIT:
            if span == 1 or math.ceil(nblk / (span - 1)) > MAX_SPLITS:
                raise ValueError(
                    f"paged split of {nblk} entries at (G, D, bs, bytes, "
                    f"scales) {fit}: no span of at most {MAX_SPLITS} "
                    f"splits fits its ring in {build.SMEM_LIMIT} B of "
                    "shared memory")
            span -= 1
    return PagedSplit(b=b, kh=kh, nblk=nblk, span=span,
                      splits=math.ceil(nblk / span))


@functools.lru_cache(maxsize=256)
def _plan(b: int, kh: int, nblk: int, sms: int, splits: int | None,
          fit: tuple[int, int, int, int, bool]) -> PagedSplit:
    return paged_split(b, kh, nblk, sms, splits, fit=fit)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name: str, want: dict, device: torch.device) -> None:
    for label, (t, dtype, shape) in want.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} kernel: {label} is on {t.device}, q "
                             f"on {device} (CUDA only)")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"{name} kernel: {label} must be {dtype} "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {label} must be contiguous")


def _geometry(name: str, q: torch.Tensor, k: torch.Tensor,
              block_tables: torch.Tensor) -> tuple[int, ...]:
    if q.ndim != 4 or q.dtype not in DTYPES or k.ndim != 4 \
            or block_tables.ndim != 2:
        raise TypeError(f"{name} kernel: q must be a 4-D float32/bfloat16 "
                        f"tensor, the pool 4-D and the tables 2-D, got q "
                        f"{q.dtype} {tuple(q.shape)}, pool "
                        f"{tuple(k.shape)}, tables "
                        f"{tuple(block_tables.shape)}")
    b, kh, g, d = q.shape
    nb1, bs = k.shape[:2]
    return b, kh, g, d, nb1, bs, block_tables.shape[1]


def _fits(lib, name: str, g: int, d: int, bs: int, esize: int) -> None:
    if not lib.lrk_decode_attention_paged_fits(g, d, bs, esize):
        raise ValueError(f"{name} kernel: G={g}, D={d}, block size {bs} "
                         "outside what it takes (D a multiple of 16 up to "
                         "256, G <= 16, G*D <= 1024, one pass in shared "
                         f"memory of {build.SMEM_LIMIT} B)")


def _check_full(name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, block_tables: torch.Tensor,
                cache_pos: torch.Tensor) -> tuple[int, ...]:
    b, kh, g, d, nb1, bs, nblk = _geometry(name, q, k, block_tables)
    pool = (nb1, bs, kh, d)
    _check(name, {"q": (q, q.dtype, (b, kh, g, d)),
                  "k": (k, q.dtype, pool), "v": (v, q.dtype, pool),
                  "block_tables": (block_tables, torch.int32, (b, nblk)),
                  "cache_pos": (cache_pos, torch.int32, (b,))}, q.device)
    return b, kh, g, d, nb1, bs, nblk


def _split_plan(name: str, lib, q: torch.Tensor, b: int, kh: int, g: int,
                d: int, bs: int, nblk: int, esize: int, quant: bool,
                splits: int | None,
                pools: tuple[tuple[str, torch.Tensor], ...]) -> PagedSplit:
    """The split kernel's plan for one call; raises where the kernel does
    not take the geometry or a pool tensor is not 16-byte aligned."""
    fit = (g, d, bs, esize, quant)
    plan = _plan(b, kh, nblk, _sm_count(q.device.index), splits, fit)
    if not lib.lrk_decode_attention_paged_split_fits(g, d, bs, esize,
                                                     int(quant), plan.span):
        raise ValueError(f"{name} kernel: G={g}, D={d}, block size {bs} "
                         "outside what it takes (D a multiple of 16 up to "
                         "256, G <= 16, a ring of up to 3 passes and the "
                         f"split's {plan.span} table entries in shared "
                         f"memory of {build.SMEM_LIMIT} B)")
    for label, t in pools:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {label} must be 16-byte "
                             "aligned")
    return plan


def decode_attention_paged(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, block_tables: torch.Tensor,
                           cache_pos: torch.Tensor, *,
                           softcap: float = 0.0) -> torch.Tensor:
    """q (B,KH,G,D) f32/bf16; k/v (NB+1,bs,KH,D) in q's dtype;
    block_tables (B,nblk) int32 of physical block ids; cache_pos (B,)
    int32 -> (B,KH,G,D) in q.dtype, all contiguous on one CUDA device.
    Position ``p`` of slot ``b`` is live iff ``p <= cache_pos[b]``.

    Runs the split kernel, which raises (and nothing else runs) where D
    is not a multiple of 16 up to 256, G exceeds 16, the pool is not
    16-byte aligned, or no span of at most MAX_SPLITS splits fits its
    ring in shared memory (:func:`split_smem`).  A pass stages 64 K and
    64 V rows of D * esize + 16 bytes, so an f32 pool with D above 128
    fits only one or two passes (64 or 128 positions) a split and raises
    past 2,048 to 4,096 positions a slot (fewer at G = 16); bf16 pools,
    and f32 pools with D <= 128, take tables of thousands of entries."""
    return decode_attention_paged_split(q, k, v, block_tables, cache_pos,
                                        softcap=softcap)


def decode_attention_paged_split(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, block_tables: torch.Tensor,
                                 cache_pos: torch.Tensor, *,
                                 softcap: float = 0.0,
                                 splits: int | None = None) -> torch.Tensor:
    """:func:`decode_attention_paged` with ``splits`` splits per slot
    asked of :func:`paged_split` (``None``: its own plan), one counted
    launch; the card tests hold a forced single split against the
    planned run."""
    global launches
    name = "decode_attention_paged"
    b, kh, g, d, _, bs, nblk = _check_full(name, q, k, v, block_tables,
                                           cache_pos)
    out = torch.empty_like(q)
    if b == 0 or kh == 0 or nblk == 0:
        return out
    lib = build.load()
    plan = _split_plan(name, lib, q, b, kh, g, d, bs, nblk, q.element_size(),
                       False, splits, (("k", k), ("v", v)))
    part = torch.empty(plan.scratch_floats(g, d), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        tickets = build.tickets(q.device, b * kh)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_paged(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            block_tables.data_ptr(), cache_pos.data_ptr(), out.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), b, nblk, bs, kh, g, d,
            plan.span, plan.splits, float(softcap), stream)
    build.check(lib, rc, name)
    launches += 1
    return out


def prev_decode_attention_paged(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, block_tables: torch.Tensor,
                                cache_pos: torch.Tensor, *,
                                softcap: float = 0.0) -> torch.Tensor:
    """The earlier full-width kernel (one CTA per slot and KV head walking
    the whole table), uncounted: kept as a yardstick for the split kernel
    (chip_smoke's ``prev_ms``).  The serve path never calls it."""
    name = "decode_attention_paged (earlier kernel)"
    b, kh, g, d, _, bs, nblk = _check_full(name, q, k, v, block_tables,
                                           cache_pos)
    out = torch.empty_like(q)
    if b == 0 or kh == 0 or nblk == 0:
        return out
    lib = build.load()
    _fits(lib, name, g, d, bs, q.element_size())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_paged_prev(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            block_tables.data_ptr(), cache_pos.data_ptr(), out.data_ptr(),
            b, nblk, bs, kh, g, d, float(softcap), stream)
    build.check(lib, rc, name)
    return out


def _check_q(name: str, q: torch.Tensor, k_q: torch.Tensor,
             k_scale: torch.Tensor, v_q: torch.Tensor, v_scale: torch.Tensor,
             block_tables: torch.Tensor, cache_pos: torch.Tensor
             ) -> tuple[int, ...]:
    b, kh, g, d, nb1, bs, nblk = _geometry(name, q, k_q, block_tables)
    pool, rows = (nb1, bs, kh, d), (nb1, kh, d)
    _check(name, {"q": (q, q.dtype, (b, kh, g, d)),
                  "k_q": (k_q, torch.int8, pool),
                  "v_q": (v_q, torch.int8, pool),
                  "k_scale": (k_scale, torch.float32, rows),
                  "v_scale": (v_scale, torch.float32, rows),
                  "block_tables": (block_tables, torch.int32, (b, nblk)),
                  "cache_pos": (cache_pos, torch.int32, (b,))}, q.device)
    return b, kh, g, d, nb1, bs, nblk


def decode_attention_paged_q(q: torch.Tensor, k_q: torch.Tensor,
                             k_scale: torch.Tensor, v_q: torch.Tensor,
                             v_scale: torch.Tensor,
                             block_tables: torch.Tensor,
                             cache_pos: torch.Tensor, *,
                             softcap: float = 0.0) -> torch.Tensor:
    """q (B,KH,G,D) f32/bf16; k_q/v_q (NB+1,bs,KH,D) int8 with per-block
    k/v_scale (NB+1,KH,D) f32; block_tables (B,nblk) int32; cache_pos
    (B,) int32 -> (B,KH,G,D) in q.dtype."""
    return decode_attention_paged_q_split(q, k_q, k_scale, v_q, v_scale,
                                          block_tables, cache_pos,
                                          softcap=softcap)


def decode_attention_paged_q_split(q: torch.Tensor, k_q: torch.Tensor,
                                   k_scale: torch.Tensor, v_q: torch.Tensor,
                                   v_scale: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   cache_pos: torch.Tensor, *,
                                   softcap: float = 0.0,
                                   splits: int | None = None
                                   ) -> torch.Tensor:
    """:func:`decode_attention_paged_q` with ``splits`` splits per slot
    asked of :func:`paged_split` (``None``: its own plan), one counted
    launch; the card tests hold a forced single split against the
    planned run."""
    global launches_q
    name = "decode_attention_paged_q"
    b, kh, g, d, _, bs, nblk = _check_q(name, q, k_q, k_scale, v_q,
                                        v_scale, block_tables, cache_pos)
    out = torch.empty_like(q)
    if b == 0 or kh == 0 or nblk == 0:
        return out
    lib = build.load()
    plan = _split_plan(name, lib, q, b, kh, g, d, bs, nblk, 1, True, splits,
                       (("k_q", k_q), ("v_q", v_q), ("k_scale", k_scale),
                        ("v_scale", v_scale)))
    part = torch.empty(plan.scratch_floats(g, d), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        tickets = build.tickets(q.device, b * kh)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_paged_q(
            DTYPES[q.dtype], q.data_ptr(), k_q.data_ptr(),
            k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
            block_tables.data_ptr(), cache_pos.data_ptr(), out.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), b, nblk, bs, kh, g, d,
            plan.span, plan.splits, float(softcap), stream)
    build.check(lib, rc, name)
    launches_q += 1
    return out


def prev_decode_attention_paged_q(q: torch.Tensor, k_q: torch.Tensor,
                                  k_scale: torch.Tensor, v_q: torch.Tensor,
                                  v_scale: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  cache_pos: torch.Tensor, *,
                                  softcap: float = 0.0) -> torch.Tensor:
    """The earlier int8 kernel (one CTA per slot and KV head walking the
    whole table), uncounted: kept as a yardstick for the split kernel
    (chip_smoke's ``prev_ms``).  The serve path never calls it."""
    name = "decode_attention_paged_q (earlier kernel)"
    b, kh, g, d, _, bs, nblk = _check_q(name, q, k_q, k_scale, v_q,
                                        v_scale, block_tables, cache_pos)
    out = torch.empty_like(q)
    if b == 0 or kh == 0 or nblk == 0:
        return out
    lib = build.load()
    _fits(lib, name, g, d, bs, 1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_paged_q_prev(
            DTYPES[q.dtype], q.data_ptr(), k_q.data_ptr(),
            k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
            block_tables.data_ptr(), cache_pos.data_ptr(), out.data_ptr(),
            b, nblk, bs, kh, g, d, float(softcap), stream)
    build.check(lib, rc, name)
    return out
