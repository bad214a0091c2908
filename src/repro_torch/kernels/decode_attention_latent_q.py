"""Wrapper of the int8 latent decode attention CUDA kernel: MLA's absorbed
form, every head of a slot against the slot's int8 latent stream.

The kernel (``csrc/decode_attention_latent_q.cu``) replaces the TPU
kernel ``repro/kernels/decode_attention_q.py::decode_attention_latent_q``;
its source note says what bounds it and how the design answers.  It splits
each slot's sequence across CTAs (:func:`latent_split`, plain Python, so
the CPU tests check it) and folds the splits inside the launch.  This
wrapper checks the operands, plans the split, allocates the output and the
partials' scratch, launches on the current stream and counts launches.
CUDA tensors only: the CPU path is the plain version in
:mod:`repro_torch.kernels.ref`, chosen by :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0

#: the split kernel's tile (csrc/decode_attention_latent_q.cu): heads of
#: an m16 tile, bf16 / f32 row padding (elements), 16-column context
#: groups a warp holds, warps of a CTA, most splits of one (slot, head
#: tile)
MMA_ROWS, PAD, SPAD, MAX_GROUPS, WARPS, MAX_SPLITS = 16, 8, 8, 4, 16, 32
#: positions of one stage, largest first: the largest whose layout fits
STAGE_POSITIONS = (64, 32, 16)
#: CTAs per SM the split aims for: one CTA of ~200 KB of shared memory
#: fits an SM at the served widths
CTAS_PER_SM = 1
#: query heads per CTA of the earlier kernel (``prev_decode_attention_latent_q``)
PREV_HEADS_PER_CTA = 4


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def latent_smem(lora: int, rope: int, bs: int, mt: int) -> int:
    """Dynamic shared memory (bytes) of the split kernel at latent width
    ``lora``, rope width ``rope``, ``bs`` positions per stage and ``mt``
    m16 tiles of heads per CTA (the C side's ``dal::layout``)."""
    k, ht = (lora + rope + 15) // 16 * 16, MMA_ROWS * mt
    return (2 * _align16(ht * (k + PAD) * 2) + _align16(bs * (k + PAD) * 2)
            + _align16(bs * (lora + rope))
            + 2 * _align16(ht * (bs + SPAD) * 4)
            + 2 * _align16(ht * (bs + PAD) * 2) + 4 * _align16(ht * 4)
            + _align16(ht * MAX_SPLITS * 4) + 16)


@dataclass(frozen=True)
class LatentSplit:
    """The split kernel's plan for one call: ``mt`` m16 tiles of heads per
    CTA, ``bs`` positions per stage, ``tiles`` head tiles, and ``splits``
    splits of ``span`` positions (a multiple of ``bs``) of each slot's
    sequence of ``s`` positions."""
    b: int
    h: int
    s: int
    lora: int
    mt: int
    bs: int
    tiles: int
    span: int
    splits: int

    @property
    def heads(self) -> int:
        """Heads of one tile (the last tile pads to it)."""
        return MMA_ROWS * self.mt

    def ranges(self) -> list[tuple[int, int]]:
        """Each split's positions ``[begin, end)``, in split order."""
        return [(j * self.span, min(self.s, (j + 1) * self.span))
                for j in range(self.splits)]

    @property
    def ctas(self) -> int:
        return self.tiles * self.b * self.splits

    @property
    def scratch_floats(self) -> int:
        """The partials: O (heads, L) and (m, l) per head, per CTA."""
        return self.ctas * self.heads * (self.lora + 2)


def latent_split(b: int, h: int, s: int, lora: int, rope: int, sms: int,
                 splits: int | None = None) -> LatentSplit:
    """Plan the split kernel for ``b`` slots of ``h`` heads over ``s``
    positions on a card of ``sms`` SMs: 2 m16 tiles of heads per CTA where
    ``h > 16`` and ``lora <= 512`` (else 1), the largest stage whose
    layout fits shared memory, and about :data:`CTAS_PER_SM` CTAs per SM
    (``splits`` asks for that many splits instead), each split a whole
    number of stages.  Raises where the kernel does not take the
    geometry."""
    if min(b, h, s, sms) <= 0:
        raise ValueError(f"latent split of ({b}, {h}, {s}) on {sms} SMs: "
                         "every size must be positive")
    mt = 2 if h > MMA_ROWS and lora <= 512 else 1
    if lora < 16 or lora % 16 or rope < 4 or rope % 4 \
            or lora // 16 > MAX_GROUPS * (WARPS // mt):
        raise ValueError(
            f"decode_attention_latent_q kernel: latent width {lora}, rope "
            f"width {rope} outside what it takes (L a multiple of 16 up to "
            "1024, R a multiple of 4)")
    bs = next((p for p in STAGE_POSITIONS
               if latent_smem(lora, rope, p, mt) <= build.SMEM_LIMIT), None)
    if bs is None:
        raise ValueError(
            f"decode_attention_latent_q kernel: latent width {lora}, rope "
            f"width {rope} need {latent_smem(lora, rope, 16, mt)} B of "
            f"shared memory at 16 positions (limit {build.SMEM_LIMIT})")
    tiles = math.ceil(h / (MMA_ROWS * mt))
    stages = math.ceil(s / bs)
    want = splits if splits is not None else \
        math.ceil(sms * CTAS_PER_SM / (b * tiles))
    want = max(1, min(want, stages, MAX_SPLITS))
    per = math.ceil(stages / want)
    return LatentSplit(b=b, h=h, s=s, lora=lora, mt=mt, bs=bs, tiles=tiles,
                       span=per * bs, splits=math.ceil(stages / per))


@functools.lru_cache(maxsize=256)
def _plan(b: int, h: int, s: int, lora: int, rope: int, sms: int,
          splits: int | None) -> LatentSplit:
    return latent_split(b, h, s, lora, rope, sms, splits)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q_lat: torch.Tensor, q_rope: torch.Tensor, ckv_q: torch.Tensor,
           ckv_scale: torch.Tensor, krope_q: torch.Tensor,
           krope_scale: torch.Tensor, cache_pos: torch.Tensor
           ) -> tuple[int, int, int, int, int]:
    """Raise on an operand the kernels do not take; return ``(b, h, s,
    lora, rope)``."""
    if q_lat.ndim != 3 or q_lat.dtype not in DTYPES or ckv_q.ndim != 3:
        raise TypeError("decode_attention_latent_q kernel: q_lat must be a "
                        "3-D float32/bfloat16 tensor and ckv_q 3-D, got "
                        f"q_lat {q_lat.dtype} {tuple(q_lat.shape)}, ckv_q "
                        f"{tuple(ckv_q.shape)}")
    b, h, lora = q_lat.shape
    s = ckv_q.shape[1]
    rope = q_rope.shape[-1]
    want = {"q_lat": (q_lat, q_lat.dtype, (b, h, lora)),
            "q_rope": (q_rope, q_lat.dtype, (b, h, rope)),
            "ckv_q": (ckv_q, torch.int8, (b, s, lora)),
            "krope_q": (krope_q, torch.int8, (b, s, rope)),
            "ckv_scale": (ckv_scale, torch.float32, (b, lora)),
            "krope_scale": (krope_scale, torch.float32, (b, rope)),
            "cache_pos": (cache_pos, torch.int32, (b,))}
    for name, (t, dtype, shape) in want.items():
        if t.device.type != "cuda" or t.device != q_lat.device:
            raise ValueError(f"decode_attention_latent_q kernel: {name} is "
                             f"on {t.device}, q_lat on {q_lat.device} (CUDA "
                             "only)")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"decode_attention_latent_q kernel: {name} must "
                            f"be {dtype} {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        align = 4 if t.dtype in (torch.int8, torch.int32) else 16
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"decode_attention_latent_q kernel: {name} "
                             f"must be contiguous and {align}-byte aligned")
    if b and h and s == 0:
        raise ValueError("decode_attention_latent_q kernel: empty pool")
    return b, h, s, lora, rope


def decode_attention_latent_q(q_lat: torch.Tensor, q_rope: torch.Tensor,
                              ckv_q: torch.Tensor, ckv_scale: torch.Tensor,
                              krope_q: torch.Tensor,
                              krope_scale: torch.Tensor,
                              cache_pos: torch.Tensor, *,
                              scale: float) -> torch.Tensor:
    """q_lat (B,H,L), q_rope (B,H,R) f32/bf16; ckv_q (B,S,L), krope_q
    (B,S,R) int8; ckv_scale (B,L), krope_scale (B,R) f32; cache_pos (B,)
    int32 -> context latents (B,H,L) in q_lat.dtype, all contiguous on
    one CUDA device.  Position ``p`` of slot ``b`` is live iff ``p <=
    cache_pos[b]``; ``scale`` is the logit scale."""
    return decode_attention_latent_q_split(
        q_lat, q_rope, ckv_q, ckv_scale, krope_q, krope_scale, cache_pos,
        scale=scale)


def decode_attention_latent_q_split(q_lat: torch.Tensor,
                                    q_rope: torch.Tensor,
                                    ckv_q: torch.Tensor,
                                    ckv_scale: torch.Tensor,
                                    krope_q: torch.Tensor,
                                    krope_scale: torch.Tensor,
                                    cache_pos: torch.Tensor, *,
                                    scale: float,
                                    splits: int | None = None
                                    ) -> torch.Tensor:
    """:func:`decode_attention_latent_q` with ``splits`` splits per slot
    asked of :func:`latent_split` (``None``: its own plan), one counted
    launch; the card tests hold a forced single split against the
    planned run."""
    global launches
    b, h, s, lora, rope = _check(q_lat, q_rope, ckv_q, ckv_scale, krope_q,
                                 krope_scale, cache_pos)
    out = torch.empty_like(q_lat)
    if b == 0 or h == 0:
        return out
    plan = _plan(b, h, s, lora, rope, _sm_count(q_lat.device.index), splits)
    part = torch.empty(plan.scratch_floats, dtype=torch.float32,
                       device=q_lat.device)
    lib = build.load()
    with torch.cuda.device(q_lat.device):
        tickets = build.tickets(q_lat.device, plan.tiles * b)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_latent_q(
            DTYPES[q_lat.dtype], q_lat.data_ptr(), q_rope.data_ptr(),
            ckv_q.data_ptr(), ckv_scale.data_ptr(), krope_q.data_ptr(),
            krope_scale.data_ptr(), cache_pos.data_ptr(), out.data_ptr(),
            part.data_ptr(), tickets.data_ptr(), b, s, h, lora, rope,
            plan.mt, plan.bs, plan.span, plan.splits, float(scale), stream)
    build.check(lib, rc, "decode_attention_latent_q")
    launches += 1
    return out


def prev_decode_attention_latent_q(q_lat: torch.Tensor,
                                   q_rope: torch.Tensor, ckv_q: torch.Tensor,
                                   ckv_scale: torch.Tensor,
                                   krope_q: torch.Tensor,
                                   krope_scale: torch.Tensor,
                                   cache_pos: torch.Tensor, *,
                                   scale: float) -> torch.Tensor:
    """The earlier kernel (one CTA per 4-head group and slot, f32 FMAs),
    uncounted: kept as a yardstick for the split kernel (chip_smoke's
    ``prev_ms``).  The serve path never calls it."""
    b, h, s, lora, rope = _check(q_lat, q_rope, ckv_q, ckv_scale, krope_q,
                                 krope_scale, cache_pos)
    out = torch.empty_like(q_lat)
    if b == 0 or h == 0:
        return out
    lib = build.load()
    hg = min(PREV_HEADS_PER_CTA, h)
    smem = int(lib.lrk_decode_attention_latent_q_prev_smem(lora, rope, hg))
    if smem == 0 or smem > build.SMEM_LIMIT:
        raise ValueError(f"decode_attention_latent_q earlier kernel: latent "
                         f"width {lora}, rope width {rope} not taken")
    with torch.cuda.device(q_lat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_latent_q_prev(
            DTYPES[q_lat.dtype], q_lat.data_ptr(), q_rope.data_ptr(),
            ckv_q.data_ptr(), ckv_scale.data_ptr(), krope_q.data_ptr(),
            krope_scale.data_ptr(), cache_pos.data_ptr(), out.data_ptr(), b,
            s, h, lora, rope, hg, float(scale), stream)
    build.check(lib, rc, "decode_attention_latent_q (earlier kernel)")
    return out
