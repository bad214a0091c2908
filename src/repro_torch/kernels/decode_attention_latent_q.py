"""Wrapper of the int8 latent decode attention CUDA kernel: MLA's absorbed
form, every head of a slot against the slot's int8 latent stream.

The kernel (``csrc/decode_attention_latent_q.cu``) replaces the TPU
kernel ``repro/kernels/decode_attention_q.py::decode_attention_latent_q``;
its source note says what bounds it and how the design answers.  This
wrapper checks the operands, allocates the output, launches on the
current stream and counts launches.  CUDA tensors only: the CPU path is
the plain version in :mod:`repro_torch.kernels.ref`, chosen by
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0

#: query heads per CTA: 4 gives 256 CTAs for 8 slots of 128 heads, two
#: per SM of an H100
HEADS_PER_CTA = 4


def smem_bytes(lora: int, rope: int, heads: int) -> int:
    """Dynamic shared memory of one launch at latent width ``lora``, rope
    width ``rope`` and ``heads`` query heads (at most
    :data:`HEADS_PER_CTA` per CTA); raises where the kernel does not take
    the geometry or it does not fit."""
    hg = min(HEADS_PER_CTA, heads)
    smem = int(build.load().lrk_decode_attention_latent_q_smem(lora, rope,
                                                                hg))
    if smem == 0:
        raise ValueError(
            f"decode_attention_latent_q kernel: latent width {lora}, rope "
            f"width {rope}, {hg} heads per CTA outside what it takes (L a "
            "multiple of 4 with L/4 dividing 256, R a multiple of 4)")
    if smem > build.SMEM_LIMIT:
        raise ValueError(
            f"decode_attention_latent_q kernel: latent width {lora} needs "
            f"{smem} B of shared memory (limit {build.SMEM_LIMIT})")
    return smem


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
    global launches
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
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"decode_attention_latent_q kernel: {name} "
                             "must be contiguous and 4-byte aligned")
    out = torch.empty_like(q_lat)
    if b == 0 or h == 0:
        return out
    if s == 0:
        raise ValueError("decode_attention_latent_q kernel: empty pool")
    smem_bytes(lora, rope, h)
    lib = build.load()
    with torch.cuda.device(q_lat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_latent_q(
            DTYPES[q_lat.dtype], q_lat.data_ptr(), q_rope.data_ptr(),
            ckv_q.data_ptr(), ckv_scale.data_ptr(), krope_q.data_ptr(),
            krope_scale.data_ptr(), cache_pos.data_ptr(), out.data_ptr(), b,
            s, h, lora, rope, min(HEADS_PER_CTA, h), float(scale), stream)
    build.check(lib, rc, "decode_attention_latent_q")
    launches += 1
    return out
