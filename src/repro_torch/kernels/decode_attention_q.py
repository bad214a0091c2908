"""Wrapper of the int8-KV decode attention CUDA kernels: one query row
per slot against a quantized slot pool.

The kernels replace the TPU kernel
``repro/kernels/decode_attention_q.py::decode_attention_q``.  The serve
path runs the sequence-split kernel of the paged pools
(``csrc/decode_attention_paged.cu``, ``paged_split_kernel``) through its
slot view: a slot's positions are one contiguous run of the pool, cut into
entries of :data:`SLOT_ENTRY` positions that :func:`slot_split` spreads
over the card (the paged planner on those entries).  The source note says
what bounds it and how the design answers.  The earlier one-CTA-per-slot
kernel (``csrc/decode_attention_q.cu``) stays callable, uncounted, as a
yardstick (:func:`prev_decode_attention_q`).  This wrapper checks the
operands, allocates the output and the partials, launches on the current
stream and counts launches.  CUDA tensors only: the CPU path is the plain
version in :mod:`repro_torch.kernels.ref`, chosen by
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention_paged as dpk
from repro_torch.kernels.lowrank_matmul import DTYPES

#: launches of the split kernel on a slot pool since the last reset (set
#: to 0 to reset)
launches = 0

#: positions of one entry of the slot pool: one pass of the split kernel
#: (csrc/decode_attention_paged.cu SLOT_ENTRY)
SLOT_ENTRY = 64


def slot_split(b: int, kh: int, s: int, sms: int, splits: int | None = None,
               *, g: int, d: int) -> dpk.PagedSplit:
    """The split kernel's plan for ``b`` slots of ``kh`` KV heads over ``s``
    positions on a card of ``sms`` SMs: :func:`dpk.paged_split` on the
    slot's ``ceil(s / SLOT_ENTRY)`` entries (the last one ragged where
    ``s`` is not a multiple), the ring of int8 rows of width ``d`` for
    ``g`` query rows fitted to shared memory.  Split j holds positions
    ``[e0 * SLOT_ENTRY, min(e1 * SLOT_ENTRY, s))`` of its entries ``(e0,
    e1)``.  The wrapper plans the same way (``dpk._split_plan``)."""
    return dpk.paged_split(b, kh, math.ceil(s / SLOT_ENTRY), sms, splits,
                           fit=(g, d, SLOT_ENTRY, 1, False))


def _check(name: str, q: torch.Tensor, k_q: torch.Tensor,
           k_scale: torch.Tensor, v_q: torch.Tensor, v_scale: torch.Tensor,
           cache_pos: torch.Tensor) -> tuple[int, int, int, int, int]:
    """Raise on operands the kernels do not take; return ``(b, kh, g, d,
    s)``."""
    if q.ndim != 4 or q.dtype not in DTYPES or k_q.ndim != 4:
        raise TypeError(f"{name} kernel: q must be a 4-D float32/bfloat16 "
                        f"tensor and k_q 4-D, got q {q.dtype} "
                        f"{tuple(q.shape)}, k_q {tuple(k_q.shape)}")
    b, kh, g, d = q.shape
    s = k_q.shape[1]
    pool, rows = (b, s, kh, d), (b, kh, d)
    dpk._check(name, {"q": (q, q.dtype, (b, kh, g, d)),
                      "k_q": (k_q, torch.int8, pool),
                      "v_q": (v_q, torch.int8, pool),
                      "k_scale": (k_scale, torch.float32, rows),
                      "v_scale": (v_scale, torch.float32, rows),
                      "cache_pos": (cache_pos, torch.int32, (b,))},
               q.device)
    return b, kh, g, d, s


def decode_attention_q(q: torch.Tensor, k_q: torch.Tensor,
                       k_scale: torch.Tensor, v_q: torch.Tensor,
                       v_scale: torch.Tensor, cache_pos: torch.Tensor, *,
                       softcap: float = 0.0) -> torch.Tensor:
    """q (B,KH,G,D) f32/bf16; k_q/v_q (B,S,KH,D) int8; k/v_scale
    (B,KH,D) f32; cache_pos (B,) int32 -> (B,KH,G,D) in q.dtype, all
    contiguous on one CUDA device.  Position ``p`` of slot ``b`` is live
    iff ``p <= cache_pos[b]``.  Runs the split kernel, which raises (and
    nothing else runs) where D is not a multiple of 16 up to 256, G
    exceeds 16, the pool is not 16-byte aligned, or S needs more than
    MAX_SPLITS splits of entries whose ring fits shared memory."""
    return decode_attention_q_split(q, k_q, k_scale, v_q, v_scale,
                                    cache_pos, softcap=softcap)


def decode_attention_q_split(q: torch.Tensor, k_q: torch.Tensor,
                             k_scale: torch.Tensor, v_q: torch.Tensor,
                             v_scale: torch.Tensor, cache_pos: torch.Tensor,
                             *, softcap: float = 0.0,
                             splits: int | None = None) -> torch.Tensor:
    """:func:`decode_attention_q` with ``splits`` splits per slot asked of
    :func:`slot_split` (``None``: its own plan), one counted launch; the
    card tests hold a forced single split against the planned run."""
    global launches
    name = "decode_attention_q"
    b, kh, g, d, s = _check(name, q, k_q, k_scale, v_q, v_scale, cache_pos)
    out = torch.empty_like(q)
    if b == 0 or kh == 0 or s == 0:
        return out
    lib = build.load()
    nblk = math.ceil(s / SLOT_ENTRY)
    plan = dpk._split_plan(name, lib, q, b, kh, g, d, SLOT_ENTRY, nblk, 1,
                           False, splits, (("k_q", k_q), ("v_q", v_q)))
    part = torch.empty(plan.scratch_floats(g, d), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        tickets = build.tickets(q.device, b * kh)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_q(
            DTYPES[q.dtype], q.data_ptr(), k_q.data_ptr(),
            k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
            cache_pos.data_ptr(), out.data_ptr(), part.data_ptr(),
            tickets.data_ptr(), b, s, kh, g, d, plan.span, plan.splits,
            float(softcap), stream)
    build.check(lib, rc, name)
    launches += 1
    return out


def prev_decode_attention_q(q: torch.Tensor, k_q: torch.Tensor,
                            k_scale: torch.Tensor, v_q: torch.Tensor,
                            v_scale: torch.Tensor, cache_pos: torch.Tensor,
                            *, softcap: float = 0.0) -> torch.Tensor:
    """The earlier kernel (one CTA per slot and KV head walking every
    position), uncounted: kept as a yardstick for the split kernel
    (chip_smoke's ``prev_ms``).  The serve path never calls it."""
    name = "decode_attention_q (earlier kernel)"
    b, kh, g, d, s = _check(name, q, k_q, k_scale, v_q, v_scale, cache_pos)
    out = torch.empty_like(q)
    if b == 0 or kh == 0:
        return out
    lib = build.load()
    if not lib.lrk_decode_attention_q_fits(s, g, d):
        raise ValueError(f"{name}: S={s}, G={g}, D={d} outside what it "
                         "takes (S >= 1, D a multiple of 16 up to 256, "
                         "G <= 16, G*D <= 1024)")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_q_prev(
            DTYPES[q.dtype], q.data_ptr(), k_q.data_ptr(),
            k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
            cache_pos.data_ptr(), out.data_ptr(), b, s, kh, g, d,
            float(softcap), stream)
    build.check(lib, rc, name)
    return out
