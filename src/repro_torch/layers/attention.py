"""Attention: RoPE, GQA and MLA (DeepSeek-V2) for prefill, chunked
prefill and decode, the merged attention of paper §2.3 (no cache), and
the VLM's gated cross attention over image K/V.

Plain torch (``einsum`` / ``softmax``), as the reference uses plain jnp
for prefill and full-width slot decode; decode over an int8 or a paged
pool goes through the plan to the ``decode_attention_q`` /
``decode_attention_paged[_q]`` kernels, and MLA's absorbed decode over
an int8 latent pool to ``decode_attention_latent_q``.  Logits are f32,
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

from repro_torch.layers import cache as cache_mod
from repro_torch.layers.cache import CachePlan, plan_from_cache
from repro_torch.layers.norm import init_rms_norm, rms_norm
from repro_torch.layers.param import (EMBED, HEADS, QKV, RANK,
                                      ParamBuilder, apply_linear,
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
                    softcap: float = 0.0, act_quantize: bool = False
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

    ``act_quantize`` runs the projections int8 x int8 on int8 plans.
    """
    b, sq, _ = x.shape
    aq = dict(act_quantize=act_quantize)
    q = apply_linear(p["q"], x, **aq).reshape(b, sq, num_heads, head_dim)
    k = apply_linear(p["k"], x, **aq).reshape(b, sq, num_kv_heads, head_dim)
    v = apply_linear(p["v"], x, **aq).reshape(b, sq, num_kv_heads, head_dim)
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
    return apply_linear(p["o"], o, **aq), cache


# ---------------------------------------------------------------------------
# Merged attention (paper §2.3 on a transformer: core/merging.py)
# ---------------------------------------------------------------------------

def init_merged_attention(pb: ParamBuilder, name: str, d_model: int,
                          num_heads: int, head_dim: int, qk_rank: int,
                          vo_rank: int) -> None:
    """The joint factorization of the weight products W_q W_k^T and
    W_v W_o: logits (x A_q)(x A_k)^T with A_q (d, H, qk_rank) and a key
    latent A_k (d, qk_rank) shared by the heads; context attn . (x B_v)
    and out ctx . B_o through a vo_rank bottleneck.  Four matmuls, as
    q/k/v/o, with params shrunk by rank/d.  (``head_dim`` is the
    reference's argument, unused there too.)"""
    sub = pb.child(name)
    sub.param("aq", (d_model, num_heads, qk_rank), (EMBED, HEADS, RANK))
    sub.param("ak", (d_model, qk_rank), (EMBED, RANK))
    sub.param("bv", (d_model, vo_rank), (EMBED, RANK))
    sub.param("bo", (vo_rank, num_heads, d_model), (RANK, HEADS, EMBED))


def apply_merged_attention(p: dict, x: torch.Tensor, *,
                           positions: torch.Tensor, causal: bool = True,
                           softcap: float = 0.0) -> torch.Tensor:
    """Self-attention through the merged factors, plain torch, no cache
    (as in the reference): RoPE (theta 1e4) over the rank dims of the
    queries and the shared key latent, one latent KV head."""
    b, s, _ = x.shape
    h = p["aq"].shape[1]
    r = p["aq"].shape[2]
    q = torch.einsum("bsd,dhr->bshr", x, p["aq"])     # (B,S,H,r)
    k = torch.einsum("bsd,dr->bsr", x, p["ak"])       # shared latent keys
    sin, cos = rope_sincos(positions, r, 1e4)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k[:, :, None, :], sin, cos)
    vlat = torch.einsum("bsd,dr->bsr", x, p["bv"])    # (B,S,vo_rank)
    o = chunked_attention(q, k, vlat[:, :, None, :], causal=causal,
                          softcap=softcap, scale=1.0 / math.sqrt(r))
    out = torch.einsum("bshr,rhd->bsd", o.reshape(b, s, h, -1), p["bo"])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): the paper's merged low-rank attention
# ---------------------------------------------------------------------------

def init_mla(pb: ParamBuilder, name: str, cfg) -> None:
    sub = pb.child(name)
    d, h = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora_rank:
        init_linear(sub, "q_a", d, cfg.q_lora_rank, EMBED, RANK)
        init_rms_norm(sub, "q_norm", cfg.q_lora_rank)
        init_linear(sub, "q_b", cfg.q_lora_rank, h * qk, RANK, QKV)
    else:
        init_linear(sub, "q_b", d, h * qk, EMBED, QKV)
    init_linear(sub, "kv_a", d, cfg.kv_lora_rank + cfg.qk_rope_dim, EMBED,
                RANK)
    init_rms_norm(sub, "kv_norm", cfg.kv_lora_rank)
    init_linear(sub, "kv_b", cfg.kv_lora_rank,
                h * (cfg.qk_nope_dim + cfg.v_head_dim), RANK, QKV)
    init_linear(sub, "o", h * cfg.v_head_dim, d, QKV, EMBED)


def mla_cache_spec(batch: int, seq_len: int, cfg, dtype: torch.dtype,
                   quantize: str | None = None
                   ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of one MLA layer's latent cache."""
    return cache_mod.mla_plan(cfg.kv_lora_rank, cfg.qk_rope_dim, dtype,
                              quantize).leaves(batch, seq_len)


def init_mla_cache(batch: int, seq_len: int, cfg, dtype: torch.dtype,
                   quantize: str | None = None,
                   device: str | torch.device = "cuda") -> dict:
    return cache_mod.mla_plan(cfg.kv_lora_rank, cfg.qk_rope_dim, dtype,
                              quantize).init(batch, seq_len, device)


def _mla_qkr(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor,
             act_quantize: bool):
    """Queries (nope and rotated rope parts), the normalised latent and
    the rotated shared rope key of ``x (B, S, d)``."""
    b, sq, _ = x.shape
    aq = dict(act_quantize=act_quantize)
    if cfg.q_lora_rank:
        qa = rms_norm(p["q_norm"], apply_linear(p["q_a"], x, **aq),
                      cfg.norm_eps)
        q = apply_linear(p["q_b"], qa, **aq)
    else:
        q = apply_linear(p["q_b"], x, **aq)
    q = q.reshape(b, sq, cfg.num_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    sin, cos = rope_sincos(positions, cfg.qk_rope_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    kva = apply_linear(p["kv_a"], x, **aq)
    ckv = rms_norm(p["kv_norm"], kva[..., :cfg.kv_lora_rank], cfg.norm_eps)
    k_rope = apply_rope(kva[..., cfg.kv_lora_rank:][:, :, None, :], sin,
                        cos)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def apply_mla(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              causal: bool = True, cache: dict | None = None,
              cache_pos: torch.Tensor | None = None,
              prompt_len: int | None = None, start_pos: int | None = None,
              plan: CachePlan | None = None, softcap: float = 0.0,
              act_quantize: bool = False
              ) -> tuple[torch.Tensor, dict | None]:
    """Multi-head latent attention.  Returns (output, cache).

    * decode (``cache_pos`` (B,) given, Sq = 1): the absorbed form —
      ``kv_b``'s K half folds into the query, its V half into the output,
      and attention runs against the cached latents alone (the plan's
      :meth:`~repro_torch.layers.cache.CachePlan.attend_decode_latent`);
    * prefill (a cache given): the latents fill ``cache[0:S]`` and K/V
      expand from them through ``kv_b``;
    * prefill chunk (``start_pos`` given): the chunk's latents land at the
      offset and K/V re-expand from the whole cached latent prefix
      (unwritten positions are zero latents, hidden by the absolute causal
      mask); rows at positions ``>= prompt_len`` are zeroed at the write.
    """
    b, sq, _ = x.shape
    h, nope, rope_d = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    vd = cfg.v_head_dim
    q_nope, q_rope, ckv, k_rope = _mla_qkr(p, x, cfg, positions,
                                           act_quantize)
    scale = 1.0 / math.sqrt(nope + rope_d)
    if cache is not None and plan is None:
        plan = plan_from_cache(cache, x.dtype)
    if cache is not None and cache_pos is not None:      # absorbed decode
        if sq != 1:
            raise ValueError(f"decode takes one token, got {sq}")
        cache = plan.write_decode(
            cache, {"ckv": ckv[:, 0], "krope": k_rope[:, 0]}, cache_pos)
        wkv = _kv_b_matrix(p["kv_b"], cfg, x.dtype)      # (r, H, nope+vd)
        q_lat = torch.einsum("bqhn,lhn->bqhl", q_nope, wkv[..., :nope])
        ctx = plan.attend_decode_latent(q_lat, q_rope, cache, cache_pos,
                                        scale=scale)
        o = torch.einsum("bqhl,lhv->bqhv", ctx, wkv[..., nope:])
    else:
        if cache is not None and start_pos is not None:  # prefill chunk
            cache, view = plan.write_chunk(
                cache, {"ckv": ckv, "krope": k_rope}, start_pos, prompt_len)
            src_ckv, src_rope, q_off = view["ckv"], view["krope"], start_pos
        else:
            if cache is not None:                        # whole prefill
                cache = plan.write_prefill(
                    cache, {"ckv": ckv, "krope": k_rope}, prompt_len)
            src_ckv, src_rope, q_off = ckv, k_rope, 0
        skv = src_ckv.shape[1]
        kv = apply_linear(p["kv_b"], src_ckv.to(x.dtype),
                          act_quantize=act_quantize).reshape(b, skv, h,
                                                             nope + vd)
        k = torch.cat([kv[..., :nope],
                       src_rope.to(x.dtype)[:, :, None, :].expand(
                           b, skv, h, rope_d)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        # v padded to the qk width for the shared attention, then sliced
        o = chunked_attention(q, k, _pad_last(kv[..., nope:],
                                              nope + rope_d - vd),
                              causal=causal, q_offset=q_off,
                              softcap=softcap, scale=scale)[..., :vd]
    out = apply_linear(p["o"], o.reshape(b, sq, h * vd),
                       act_quantize=act_quantize)
    return out, cache


def _kv_b_matrix(p: dict, cfg, dtype: torch.dtype) -> torch.Tensor:
    """kv_b as a dense ``(r, H, nope + v)`` tensor, recomposed from its
    factors when surgery decomposed it (``mla_kvb`` targeted)."""
    from repro_torch.layers.plan import KIND_DENSE, KIND_LOWRANK, build_plan
    plan = build_plan(p)
    if plan.kind == KIND_DENSE:
        w = plan.value(p, "w", dtype)
    elif plan.kind == KIND_LOWRANK:
        w = plan.value(p, "w0", dtype) @ plan.value(p, "w1", dtype)
    else:
        w = torch.einsum("ncr,nrs,nso->co", plan.value(p, "u", dtype),
                         plan.value(p, "xc", dtype),
                         plan.value(p, "v", dtype))
    return w.reshape(cfg.kv_lora_rank, cfg.num_heads,
                     cfg.qk_nope_dim + cfg.v_head_dim)


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the last axis of ``x`` by ``n`` (nothing for n <= 0)."""
    if n <= 0:
        return x
    return torch.nn.functional.pad(x, (0, n))


# ---------------------------------------------------------------------------
# Cross attention (VLM): queries from text, K/V from image embeddings
# ---------------------------------------------------------------------------

def init_cross_attention(pb: ParamBuilder, name: str, d_model: int,
                         num_heads: int, num_kv_heads: int, head_dim: int,
                         kv_dim: int) -> None:
    """q / k / v / o and the scalar ``gate``, zero at init (a fresh
    cross layer adds nothing until trained, as in llama-3.2-vision)."""
    sub = pb.child(name)
    init_linear(sub, "q", d_model, num_heads * head_dim, EMBED, QKV)
    init_linear(sub, "k", kv_dim, num_kv_heads * head_dim, EMBED, QKV)
    init_linear(sub, "v", kv_dim, num_kv_heads * head_dim, EMBED, QKV)
    init_linear(sub, "o", num_heads * head_dim, d_model, QKV, EMBED)
    sub.param("gate", (), (), init="zeros")


def cross_attn_kv(p: dict, kv_feats: torch.Tensor, *, num_kv_heads: int,
                  head_dim: int, act_quantize: bool = False) -> dict:
    """Cross-attention K/V ``(B, T, KH, D)`` from image features ``(B, T,
    kv_dim)``: computed once at prefill (image tokens never change during
    decode)."""
    b, t, _ = kv_feats.shape
    aq = dict(act_quantize=act_quantize)
    k = apply_linear(p["k"], kv_feats, **aq).reshape(b, t, num_kv_heads,
                                                    head_dim)
    v = apply_linear(p["v"], kv_feats, **aq).reshape(b, t, num_kv_heads,
                                                    head_dim)
    return {"k": k, "v": v}


def apply_cross_attention(p: dict, x: torch.Tensor,
                          kv_feats: torch.Tensor | None = None, *,
                          num_heads: int, num_kv_heads: int, head_dim: int,
                          kv: dict | None = None,
                          act_quantize: bool = False) -> torch.Tensor:
    """Non-causal attention of ``x``'s queries over the image K/V (``kv``,
    or computed from ``kv_feats``), no RoPE, scaled by ``tanh(gate)``
    (f32, rounded to x's dtype)."""
    b, sq, _ = x.shape
    if kv is None:
        kv = cross_attn_kv(p, kv_feats, num_kv_heads=num_kv_heads,
                           head_dim=head_dim, act_quantize=act_quantize)
    q = apply_linear(p["q"], x, act_quantize=act_quantize).reshape(
        b, sq, num_heads, head_dim)
    o = chunked_attention(q, kv["k"], kv["v"], causal=False)
    o = apply_linear(p["o"], o.reshape(b, sq, num_heads * head_dim),
                     act_quantize=act_quantize)
    return torch.tanh(p["gate"].to(torch.float32)).to(x.dtype) * o
