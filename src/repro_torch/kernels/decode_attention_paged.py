"""Wrappers of the paged decode attention CUDA kernels: one query row per
slot against a pool of fixed-size physical KV blocks reached through
per-slot block tables -- full width (:func:`decode_attention_paged`) or
int8 with one scale row per block (:func:`decode_attention_paged_q`).

The kernels (``csrc/decode_attention_paged.cu``) replace the TPU kernels
``repro/kernels/decode_attention_paged.py::decode_attention_paged`` and
``::decode_attention_paged_q``; the source note says what bounds them and
how the design answers.  The int8 kernel splits each slot's table across
CTAs (:func:`paged_split`, plain Python, so the CPU tests check it) and
folds the splits inside the launch.  These wrappers check the operands,
allocate the output (and the int8 kernel's partials), launch on the
current stream and count launches, each kernel on its own counter.  CUDA tensors only: the CPU path is the plain versions
in :mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES

#: launches of the full-width kernel since the last reset (set to 0 to
#: reset)
launches = 0
#: launches of the int8 kernel since the last reset
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


def paged_split(b: int, kh: int, nblk: int, sms: int,
                splits: int | None = None) -> PagedSplit:
    """Plan the split kernel for ``b`` slots of ``kh`` KV heads over
    tables of ``nblk`` entries on a card of ``sms`` SMs: about
    :data:`CTAS_PER_SM` CTAs per SM (``splits`` asks for that many splits
    instead), each split a run of whole table entries."""
    if min(b, kh, nblk, sms) <= 0:
        raise ValueError(f"paged split of ({b}, {kh}, {nblk}) on {sms} "
                         "SMs: every size must be positive")
    want = splits if splits is not None else \
        math.ceil(sms * CTAS_PER_SM / (b * kh))
    want = max(1, min(want, nblk, MAX_SPLITS))
    span = math.ceil(nblk / want)
    return PagedSplit(b=b, kh=kh, nblk=nblk, span=span,
                      splits=math.ceil(nblk / span))


@functools.lru_cache(maxsize=256)
def _plan(b: int, kh: int, nblk: int, sms: int, splits: int | None
          ) -> PagedSplit:
    return paged_split(b, kh, nblk, sms, splits)


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


def decode_attention_paged(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, block_tables: torch.Tensor,
                           cache_pos: torch.Tensor, *,
                           softcap: float = 0.0) -> torch.Tensor:
    """q (B,KH,G,D) f32/bf16; k/v (NB+1,bs,KH,D) in q's dtype;
    block_tables (B,nblk) int32 of physical block ids; cache_pos (B,)
    int32 -> (B,KH,G,D) in q.dtype, all contiguous on one CUDA device.
    Position ``p`` of slot ``b`` is live iff ``p <= cache_pos[b]``."""
    global launches
    name = "decode_attention_paged"
    b, kh, g, d, nb1, bs, nblk = _geometry(name, q, k, block_tables)
    pool = (nb1, bs, kh, d)
    _check(name, {"q": (q, q.dtype, (b, kh, g, d)),
                  "k": (k, q.dtype, pool), "v": (v, q.dtype, pool),
                  "block_tables": (block_tables, torch.int32, (b, nblk)),
                  "cache_pos": (cache_pos, torch.int32, (b,))}, q.device)
    out = torch.empty_like(q)
    if b == 0 or kh == 0 or nblk == 0:
        return out
    lib = build.load()
    _fits(lib, name, g, d, bs, q.dtype.itemsize)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_paged(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            block_tables.data_ptr(), cache_pos.data_ptr(), out.data_ptr(),
            b, nblk, bs, kh, g, d, float(softcap), stream)
    build.check(lib, rc, name)
    launches += 1
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
    plan = _plan(b, kh, nblk, _sm_count(q.device.index), splits)
    if not lib.lrk_decode_attention_paged_split_fits(g, d, bs, 1, 1,
                                                     plan.span):
        raise ValueError(f"{name} kernel: G={g}, D={d}, block size {bs} "
                         "outside what it takes (D a multiple of 16 up to "
                         "256, G <= 16, a 3-pass ring and the split's "
                         f"{plan.span} table entries in shared memory of "
                         f"{build.SMEM_LIMIT} B)")
    for label, t in (("k_q", k_q), ("v_q", v_q), ("k_scale", k_scale),
                     ("v_scale", v_scale)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: {label} must be 16-byte "
                             "aligned")
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
