"""Plain PyTorch versions of the hand-written kernels.

They repeat the reference's rounding points exactly (every product
accumulates in f32, intermediates round to ``x.dtype`` between products,
the output rounds to ``x.dtype``; a quantized factor is dequantized to
``x.dtype`` before its product, a 2:4-packed one expanded first): the
CPU path runs them, and the card holds each kernel against them on the
same inputs.  Operands are cast
to f32 before each product — for bf16 inputs that is the f32
accumulation of exact bf16 products the reference asks for.  The
activation-quantized chains (``*_qa``) multiply int8 by int8 exactly
(:func:`_int_dot`) and fold their scales in the reference's order; the
paged attentions gather the blocks through the tables first.
"""
from __future__ import annotations

import math

import torch

from repro_torch.quant.sparse import expand_sparse


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


def lowrank_matmul_sq_ref(x: torch.Tensor, w0_sp: torch.Tensor,
                          w0_idx: torch.Tensor, w0_scale: torch.Tensor,
                          w1_sp: torch.Tensor, w1_idx: torch.Tensor,
                          w1_scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ ds(w0)) @ ds(w1): each factor expanded from its 2:4 pack
    (``w0_sp (2,C/4,R)`` + ``w0_idx (2,C/4,1)`` + ``w0_scale (1,R)``;
    ``w1`` likewise over R) and dequantized to ``x.dtype``, as the sparse
    kernel expands on the chip, then the plain chain."""
    return lowrank_matmul_ref(x, expand_sparse(w0_sp, w0_idx, w0_scale,
                                               x.dtype),
                              expand_sparse(w1_sp, w1_idx, w1_scale,
                                            x.dtype))


def branched_matmul_sq_ref(x: torch.Tensor, u_sp: torch.Tensor,
                           u_idx: torch.Tensor, u_scale: torch.Tensor,
                           xc_q: torch.Tensor, xc_scale: torch.Tensor,
                           v_sp: torch.Tensor, v_idx: torch.Tensor,
                           v_scale: torch.Tensor) -> torch.Tensor:
    """y = sum_n ((x @ ds(u_n)) @ dq(xc_n)) @ ds(v_n): ``u`` and ``v``
    expanded from their per-branch 2:4 packs (``u_sp (N,2,C/4,r1)``,
    ``v_sp (N,2,r2/4,S)``), the dense core dequantized, all to
    ``x.dtype``, then the plain branched chain."""
    return branched_matmul_ref(x, expand_sparse(u_sp, u_idx, u_scale,
                                                x.dtype),
                               _dq(xc_q, xc_scale, x.dtype),
                               expand_sparse(v_sp, v_idx, v_scale, x.dtype))


INT8_QMAX = 127.0


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (per-token) symmetric absmax int8 quantization, as the
    reference's ``lowrank_matmul_qa.quantize_rows``: x (M, K) any float
    -> (int8 (M, K), f32 scales (M, 1)).  An all-zero row gets scale 0
    and a safe divisor of 1, so it stays exactly zero.  Round half to
    even; clipped to +-127 (never -128)."""
    xf = _f32(x)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can miss the quotient by an ulp
    scale = amax / torch.full_like(amax, INT8_QMAX)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.round(xf / safe).clamp(-INT8_QMAX, INT8_QMAX)
    return q.to(torch.int8), scale


def _int_dot(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """Exact ``a_q @ b_q`` of two int8 matrices, returned in f32 (the
    int32 sum rounded to nearest, as ``int32.astype(float32)``).  On the
    CPU the product runs in int32 (``int8 @ int8`` would wrap in int8);
    CUDA has no int32 matmul, so it runs in float64 there, exact while
    every partial sum stays below 2**53."""
    wide = torch.int32 if a_q.device.type == "cpu" else torch.float64
    return torch.matmul(a_q.to(wide), b_q.to(wide)).to(torch.float32)


def lowrank_matmul_qa_ref(x: torch.Tensor, w0_q: torch.Tensor,
                          w0_scale: torch.Tensor, w1_q: torch.Tensor,
                          w1_scale: torch.Tensor) -> torch.Tensor:
    """Activation-quantized chain, step for step as the reference's
    oracle: int8 rows of x, an exact int8 x int8 dot folded by
    ``x_scale * w0_scale``, the rank intermediate requantized per row,
    a second int8 dot folded by ``h_scale * w1_scale``.  x (M,C) f32/bf16;
    w0_q (C,R) + w0_scale (1,R); w1_q (R,S) + w1_scale (1,S) int8 ->
    (M,S) in x.dtype."""
    xq, xs = quantize_rows(x)
    h = _int_dot(xq, w0_q) * xs * w0_scale
    hq, hs = quantize_rows(h)
    y = _int_dot(hq, w1_q) * hs * w1_scale
    return y.to(x.dtype)


def branched_matmul_qa_ref(x: torch.Tensor, u_q: torch.Tensor,
                           u_scale: torch.Tensor, xc_q: torch.Tensor,
                           xc_scale: torch.Tensor, v_q: torch.Tensor,
                           v_scale: torch.Tensor) -> torch.Tensor:
    """The branched chain with int8 activations: x quantized once, each
    branch's three int8 x int8 dots folded by their row x channel scale
    products with per-row requantization between them, the f32 branch
    contributions summed in branch order."""
    xq, xs = quantize_rows(x)
    y = torch.zeros((x.shape[0], v_q.shape[-1]), dtype=torch.float32,
                    device=x.device)
    for i in range(u_q.shape[0]):
        h1q, h1s = quantize_rows(_int_dot(xq, u_q[i]) * xs * u_scale[i])
        h2q, h2s = quantize_rows(_int_dot(h1q, xc_q[i]) * h1s * xc_scale[i])
        y = y + _int_dot(h2q, v_q[i]) * h2s * v_scale[i]
    return y.to(x.dtype)


def _gather_blocks(pool: torch.Tensor, block_tables: torch.Tensor
                   ) -> torch.Tensor:
    """Each stream's logical ``(S, KH, D)`` view of a paged pool
    ``(NB+1, bs, KH, D)`` through its table row: ``(B, nblk*bs, KH, D)``
    (a copy; the paged kernels read the blocks where they lie)."""
    b, nblk = block_tables.shape
    g = pool[block_tables.to(device=pool.device, dtype=torch.long)]
    return g.reshape(b, nblk * pool.shape[1], *pool.shape[2:])


def decode_attention_paged_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, block_tables: torch.Tensor,
                               cache_pos: torch.Tensor, *,
                               softcap: float = 0.0) -> torch.Tensor:
    """Gather-then-attend over a full-width paged pool: q (B, 1, H, D);
    k/v (NB+1, bs, KH, D), block NB the dummy; block_tables (B, nblk)
    int32; cache_pos (B,) -> (B, 1, H, D).  After the gather it is the
    slot pool's decode attention op for op, so a paged stream decodes
    exactly as a slot stream does."""
    from repro_torch.layers.cache import gqa_decode_attention
    kk = _gather_blocks(k, block_tables)
    vv = _gather_blocks(v, block_tables)
    pos = cache_pos.to(device=q.device, dtype=torch.long)
    valid = (torch.arange(kk.shape[1], device=q.device)[None, :]
             <= pos[:, None])
    return gqa_decode_attention(q, kk, vv, valid, softcap)


def decode_attention_paged_q_ref(q: torch.Tensor, k_q: torch.Tensor,
                                 k_scale: torch.Tensor, v_q: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 cache_pos: torch.Tensor, *,
                                 softcap: float = 0.0) -> torch.Tensor:
    """Dequantize-gather-attend over an int8 paged pool: k_q/v_q
    (NB+1, bs, KH, D) int8 with one scale row per physical block,
    k/v_scale (NB+1, KH, D) f32; then the f32 softmax of
    :func:`decode_attention_q_ref` over positions ``<= cache_pos``."""
    b, sq, h, d = q.shape
    kk = _gather_blocks(_f32(k_q) * k_scale[:, None], block_tables)
    vv = _gather_blocks(_f32(v_q) * v_scale[:, None], block_tables)
    kh = kk.shape[2]
    qg = _f32(q).reshape(b, sq, kh, h // kh, d)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, kk) / math.sqrt(d)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = cache_pos.to(device=q.device, dtype=torch.long)
    valid = (torch.arange(kk.shape[1], device=q.device)[None, :]
             <= pos[:, None])
    s = torch.where(valid[:, None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, vv)
    return o.reshape(b, sq, h, d).to(q.dtype)


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


def decode_attention_latent_q_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                                  ckv_q: torch.Tensor,
                                  ckv_scale: torch.Tensor,
                                  krope_q: torch.Tensor,
                                  krope_scale: torch.Tensor,
                                  cache_pos: torch.Tensor, *,
                                  scale: float) -> torch.Tensor:
    """MLA's absorbed decode over an int8 latent pool, dequantize then
    attend.

    q_lat (B, 1, H, L); q_rope (B, 1, H, R); ckv_q (B, S, L) / krope_q
    (B, S, R) int8; ckv/krope_scale (B, L)/(B, R) f32; cache_pos (B,) ->
    context latents (B, 1, H, L) in q_lat.dtype.  f32 softmax over
    positions ``<= cache_pos`` (masked with -1e30, so a slot with no
    valid position averages all of them, as the reference does)."""
    cc = _f32(ckv_q) * ckv_scale[:, None]
    cr = _f32(krope_q) * krope_scale[:, None]
    s = (torch.einsum("bqhl,bsl->bhqs", _f32(q_lat), cc)
         + torch.einsum("bqhr,bsr->bhqs", _f32(q_rope), cr)) * scale
    pos = cache_pos.to(device=q_lat.device, dtype=torch.long)
    valid = torch.arange(cc.shape[1], device=q_lat.device)[None, :] \
        <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bsl->bqhl", p, cc).to(q_lat.dtype)
