"""The dense pre-norm decoder block on the LRD-transparent layers, with
GQA or MLA attention.

``init_block(pb, cfg)`` builds a single layer's params (the model stacks
layers along a leading axis); ``apply_block`` runs one layer's params,
choosing MLA where the params hold an ``mla`` subtree.  The MoE,
cross-attention and SSM blocks of the reference come with ROADMAP item
A13.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.layers import attention as attn
from repro_torch.layers import cache as cache_mod
from repro_torch.layers.mlp import apply_mlp, init_mlp
from repro_torch.layers.norm import init_rms_norm, rms_norm
from repro_torch.layers.param import ParamBuilder


class BlockOpts(NamedTuple):
    """The reference's block options that the port reads:
    ``freeze_factors``, the forward half of the §2.2 freeze (the model
    detaches the frozen factors, ``core/freezing.py``).  The reference's
    ``use_pallas`` has no counterpart (the device decides), and
    ``act_quantize`` is a keyword of the serve calls."""
    freeze_factors: bool = False


def init_block(pb: ParamBuilder, cfg) -> None:
    if cfg.moe_num_experts:
        raise NotImplementedError("MoE blocks come with ROADMAP item A13")
    init_rms_norm(pb, "attn_norm", cfg.d_model)
    if cfg.mla:
        attn.init_mla(pb, "mla", cfg)
    else:
        attn.init_attention(pb, "attn", cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim)
    init_rms_norm(pb, "mlp_norm", cfg.d_model)
    init_mlp(pb, "mlp", cfg.d_model, cfg.d_ff, cfg.act)


def apply_block(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                cache: dict | None = None,
                cache_pos: torch.Tensor | None = None,
                prompt_len: int | None = None, start_pos: int | None = None,
                cache_plan=None, act_quantize: bool = False
                ) -> tuple[torch.Tensor, dict | None]:
    """Pre-norm block.  Returns ``(x', cache)``; ``start_pos`` marks a
    chunked prefill (K/V land at the offset in the existing cache);
    ``act_quantize`` runs every int8 linear int8 x int8 (prefill
    segments)."""
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    if "mla" in p:
        a, cache = attn.apply_mla(
            p["mla"], h, cfg, positions=positions, causal=True, cache=cache,
            cache_pos=cache_pos, prompt_len=prompt_len, start_pos=start_pos,
            plan=cache_plan, softcap=cfg.attn_logit_softcap,
            act_quantize=act_quantize)
    else:
        a, cache = attn.apply_attention(
            p["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, positions=positions, causal=True,
            cache=cache, cache_pos=cache_pos, prompt_len=prompt_len,
            start_pos=start_pos, plan=cache_plan,
            softcap=cfg.attn_logit_softcap, act_quantize=act_quantize)
    x = x + a
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, act_quantize=act_quantize), cache


def block_cache_spec(cfg, batch: int, seq_len: int, dtype: torch.dtype,
                     kv_quantize: str | None = None, paged=None
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of one layer's cache, from its plan:
    gqa_f32 | gqa_int8 | mla_latent | mla_latent_int8 | gqa_paged_*
    (where a ``paged`` geometry makes ``batch`` / ``seq_len`` mean
    physical blocks + 1 / block size)."""
    return cache_mod.build_cache_plan(cfg, dtype, kv_quantize,
                                      paged).leaves(batch, seq_len)
