"""Plain PyTorch versions of the hand-written kernels.

They repeat the reference's rounding points exactly (every product
accumulates in f32, intermediates round to ``x.dtype`` between products,
the output rounds to ``x.dtype``; a quantized factor is dequantized to
``x.dtype`` before its product): the CPU path runs them, and the card
holds each kernel against them on the same inputs.  Operands are cast
to f32 before each product — for bf16 inputs that is the f32
accumulation of exact bf16 products the reference asks for.
"""
from __future__ import annotations

import math

import torch


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def lowrank_matmul_ref(x: torch.Tensor, w0: torch.Tensor,
                       w1: torch.Tensor) -> torch.Tensor:
    """y = (x @ w0) @ w1 through the rank bottleneck. x (M,C) -> (M,S)."""
    h = torch.matmul(_f32(x), _f32(w0))
    y = torch.matmul(_f32(h.to(x.dtype)), _f32(w1))
    return y.to(x.dtype)


def branched_matmul_ref(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """y = sum_n ((x @ u_n) @ xc_n) @ v_n  (paper Eq. 17).

    x (M,C); u (N,C,r1); xc (N,r1,r2); v (N,r2,S) -> (M,S).
    """
    h = torch.einsum("mc,ncr->nmr", _f32(x), _f32(u)).to(x.dtype)
    h = torch.einsum("nmr,nrs->nms", _f32(h), _f32(xc)).to(x.dtype)
    y = torch.einsum("nms,nso->mo", _f32(h), _f32(v))
    return y.to(x.dtype)


def _dq(q: torch.Tensor, scale: torch.Tensor,
        dtype: torch.dtype) -> torch.Tensor:
    """A quantized factor dequantized to the activation dtype, as the
    quantized kernels stage it: ``(q.f32 * scale)`` rounded to ``dtype``."""
    return (_f32(q) * scale).to(dtype)


def lowrank_matmul_q_ref(x: torch.Tensor, w0_q: torch.Tensor,
                         w0_scale: torch.Tensor, w1_q: torch.Tensor,
                         w1_scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ dq(w0)) @ dq(w1).  w0_q (C,R) + w0_scale (1,R); w1_q
    (R,S) + w1_scale (1,S); int8 or fp8 values, f32 scales."""
    return lowrank_matmul_ref(x, _dq(w0_q, w0_scale, x.dtype),
                              _dq(w1_q, w1_scale, x.dtype))


def branched_matmul_q_ref(x: torch.Tensor, u_q: torch.Tensor,
                          u_scale: torch.Tensor, xc_q: torch.Tensor,
                          xc_scale: torch.Tensor, v_q: torch.Tensor,
                          v_scale: torch.Tensor) -> torch.Tensor:
    """y = sum_n ((x @ dq(u_n)) @ dq(xc_n)) @ dq(v_n); per-branch
    per-output-channel scales (N,1,r1), (N,1,r2), (N,1,S)."""
    return branched_matmul_ref(x, _dq(u_q, u_scale, x.dtype),
                               _dq(xc_q, xc_scale, x.dtype),
                               _dq(v_q, v_scale, x.dtype))


def decode_attention_q_ref(q: torch.Tensor, k_q: torch.Tensor,
                           k_scale: torch.Tensor, v_q: torch.Tensor,
                           v_scale: torch.Tensor, cache_pos: torch.Tensor,
                           *, softcap: float = 0.0) -> torch.Tensor:
    """One query row per slot vs an int8 KV pool, dequantize then attend.

    q (B, 1, H, D); k_q/v_q (B, S, KH, D) int8; k/v_scale (B, KH, D)
    f32; cache_pos (B,) -> (B, 1, H, D) in q.dtype.  H rows group as
    (KH, G).  f32 softmax over positions ``<= cache_pos`` (masked with
    -1e30, so a slot with no valid position averages all of them, as
    the reference does)."""
    b, sq, h, d = q.shape
    skv, kh = k_q.shape[1], k_q.shape[2]
    k = _f32(k_q) * k_scale[:, None]
    v = _f32(v_q) * v_scale[:, None]
    qg = _f32(q).reshape(b, sq, kh, h // kh, d)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) / math.sqrt(d)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = cache_pos.to(device=q.device, dtype=torch.long)
    valid = torch.arange(skv, device=q.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return o.reshape(b, sq, h, d).to(q.dtype)
