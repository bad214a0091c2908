"""Attention: RoPE and GQA for prefill, chunked prefill and decode.

Plain torch (``einsum`` / ``softmax``), as the reference uses plain jnp
for prefill and full-width decode; decode over an int8 pool goes through
the plan to the ``decode_attention_q`` kernel.  Logits are f32,
masked with ``-1e30``; probabilities round to the value dtype before
the context product.  Prefill attention runs over query chunks of
``Q_CHUNK`` rows so the logits never exceed ``q_chunk x kv_len`` per
head.

Cache layout and every write belong to the layer's
:class:`repro_torch.layers.cache.CachePlan`; this module owns the
projections, RoPE and the prefill softmax.
"""
from __future__ import annotations

import math

import torch

from repro_torch.layers.cache import CachePlan, plan_from_cache
from repro_torch.layers.param import (EMBED, QKV, ParamBuilder, apply_linear,
                                      init_linear)

Q_CHUNK = 1024


def rope_sincos(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) -> sin/cos (..., dim/2) in f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE in f32.  x (..., S, n_heads, dim); sin/cos
    (..., S, dim/2)."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    s = sin[..., None, :].to(torch.float32)
    c = cos[..., None, :].to(torch.float32)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0, softcap: float = 0.0,
                      q_chunk: int = Q_CHUNK,
                      scale: float | None = None) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Skv,KH,hd) -> (B,Sq,H,hd).

    ``q_offset`` is the absolute position of q[0] for causal masking.
    """
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kh, g, hd)
    kf = k.to(torch.float32)
    kpos = torch.arange(skv, device=q.device)
    outs = []
    for c0 in range(0, sq, q_chunk):
        qc = qg[:, c0:c0 + q_chunk]
        s = torch.einsum("bqkgh,bskh->bkgqs", qc.to(torch.float32),
                         kf) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        if causal:
            qpos = int(q_offset) + c0 + torch.arange(qc.shape[1],
                                                     device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask[None, None, None], s, -1e30)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
        outs.append(o.reshape(b, qc.shape[1], h, hd))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def init_attention(pb: ParamBuilder, name: str, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int) -> None:
    sub = pb.child(name)
    init_linear(sub, "q", d_model, num_heads * head_dim, EMBED, QKV)
    init_linear(sub, "k", d_model, num_kv_heads * head_dim, EMBED, QKV)
    init_linear(sub, "v", d_model, num_kv_heads * head_dim, EMBED, QKV)
    init_linear(sub, "o", num_heads * head_dim, d_model, QKV, EMBED)


def apply_attention(p: dict, x: torch.Tensor, *, num_heads: int,
                    num_kv_heads: int, head_dim: int, rope_theta: float,
                    positions: torch.Tensor, causal: bool = True,
                    cache: dict | None = None,
                    cache_pos: torch.Tensor | None = None,
                    prompt_len: int | None = None,
                    start_pos: int | None = None,
                    plan: CachePlan | None = None,
                    softcap: float = 0.0
                    ) -> tuple[torch.Tensor, dict | None]:
    """Self-attention.  Returns (output, cache).

    * no cache: causal attention over x.
    * prefill: cache given — fills cache[0:S], causal.
    * prefill chunk: ``start_pos`` given — x holds prompt positions
      ``[start_pos, start_pos + Sq)``; K/V land at the offset and
      attention runs over the whole pool with absolute causal masking
      (``positions`` carry the absolute offsets).
    * decode: ``cache_pos`` (B,) given, Sq = 1 — writes K/V at
      ``cache_pos`` and attends over the pool.
    """
    b, sq, _ = x.shape
    q = apply_linear(p["q"], x).reshape(b, sq, num_heads, head_dim)
    k = apply_linear(p["k"], x).reshape(b, sq, num_kv_heads, head_dim)
    v = apply_linear(p["v"], x).reshape(b, sq, num_kv_heads, head_dim)
    sin, cos = rope_sincos(positions, head_dim, rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    if cache is None:
        o = chunked_attention(q, k, v, causal=causal, softcap=softcap)
    else:
        if plan is None:
            plan = plan_from_cache(cache, x.dtype)
        if cache_pos is not None:        # decode
            if sq != 1:
                raise ValueError(f"decode takes one token, got {sq}")
            cache = plan.write_decode(cache, {"k": k[:, 0], "v": v[:, 0]},
                                      cache_pos)
            o = plan.attend_decode(q, cache, cache_pos, softcap=softcap)
        elif start_pos is not None:      # prefill chunk at an offset
            cache, view = plan.write_chunk(cache, {"k": k, "v": v},
                                           start_pos, prompt_len)
            o = chunked_attention(q, view["k"], view["v"], causal=causal,
                                  q_offset=start_pos, softcap=softcap)
        else:                            # whole prefill
            cache = plan.write_prefill(cache, {"k": k, "v": v}, prompt_len)
            o = chunked_attention(q, k, v, causal=causal, softcap=softcap)
    o = o.reshape(b, sq, num_heads * head_dim)
    return apply_linear(p["o"], o), cache
