"""Wrapper of the int8-KV decode attention CUDA kernel: one query row
per slot against a quantized slot pool.

The kernel (``csrc/decode_attention_q.cu``) replaces the TPU kernel
``repro/kernels/decode_attention_q.py::decode_attention_q``; its source
note says what bounds it and how the design answers.  This wrapper
checks the operands, allocates the output, launches on the current
stream and counts launches.  CUDA tensors only: the CPU path is the
plain version in :mod:`repro_torch.kernels.ref`, chosen by
:mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.lowrank_matmul import DTYPES

#: launches of the kernel since the last reset (set to 0 to reset)
launches = 0


def decode_attention_q(q: torch.Tensor, k_q: torch.Tensor,
                       k_scale: torch.Tensor, v_q: torch.Tensor,
                       v_scale: torch.Tensor, cache_pos: torch.Tensor, *,
                       softcap: float = 0.0) -> torch.Tensor:
    """q (B,KH,G,D) f32/bf16; k_q/v_q (B,S,KH,D) int8; k/v_scale
    (B,KH,D) f32; cache_pos (B,) int32 -> (B,KH,G,D) in q.dtype, all
    contiguous on one CUDA device.  Position ``p`` of slot ``b`` is live
    iff ``p <= cache_pos[b]``."""
    global launches
    if q.ndim != 4 or q.dtype not in DTYPES or k_q.ndim != 4:
        raise TypeError("decode_attention_q kernel: q must be a 4-D "
                        f"float32/bfloat16 tensor and k_q 4-D, got q "
                        f"{q.dtype} {tuple(q.shape)}, k_q "
                        f"{tuple(k_q.shape)}")
    b, kh, g, d = q.shape
    s = k_q.shape[1]
    want = {"q": (q, q.dtype, (b, kh, g, d)),
            "k_q": (k_q, torch.int8, (b, s, kh, d)),
            "v_q": (v_q, torch.int8, (b, s, kh, d)),
            "k_scale": (k_scale, torch.float32, (b, kh, d)),
            "v_scale": (v_scale, torch.float32, (b, kh, d)),
            "cache_pos": (cache_pos, torch.int32, (b,))}
    for name, (t, dtype, shape) in want.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"decode_attention_q kernel: {name} is on "
                             f"{t.device}, q on {q.device} (CUDA only)")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"decode_attention_q kernel: {name} must be "
                            f"{dtype} {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention_q kernel: {name} must be "
                             "contiguous")
    out = torch.empty_like(q)
    if b == 0 or kh == 0:
        return out
    lib = build.load()
    if not lib.lrk_decode_attention_q_fits(s, g, d):
        raise ValueError(f"decode_attention_q kernel: S={s}, G={g}, D={d} "
                         "outside what it takes (S >= 1, D a multiple of "
                         "16 up to 256, G <= 16, G*D <= 1024)")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lrk_decode_attention_q(
            DTYPES[q.dtype], q.data_ptr(), k_q.data_ptr(),
            k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
            cache_pos.data_ptr(), out.data_ptr(), b, s, kh, g, d,
            float(softcap), stream)
    build.check(lib, rc, "decode_attention_q")
    launches += 1
    return out
