"""The dense pre-norm decoder block on the LRD-transparent layers.

``init_block(pb, cfg)`` builds a single layer's params (the model stacks
layers along a leading axis); ``apply_block`` runs one layer's params.
The MoE, MLA, cross-attention and SSM blocks of the reference come with
ROADMAP items A10 and A13.
"""
from __future__ import annotations

import torch

from repro_torch.layers import attention as attn
from repro_torch.layers.mlp import apply_mlp, init_mlp
from repro_torch.layers.norm import init_rms_norm, rms_norm
from repro_torch.layers.param import ParamBuilder


def init_block(pb: ParamBuilder, cfg) -> None:
    if cfg.mla or cfg.moe_num_experts:
        raise NotImplementedError(
            "MLA / MoE blocks come with ROADMAP items A10 and A13")
    init_rms_norm(pb, "attn_norm", cfg.d_model)
    attn.init_attention(pb, "attn", cfg.d_model, cfg.num_heads,
                        cfg.num_kv_heads, cfg.resolved_head_dim)
    init_rms_norm(pb, "mlp_norm", cfg.d_model)
    init_mlp(pb, "mlp", cfg.d_model, cfg.d_ff, cfg.act)


def apply_block(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                cache: dict | None = None,
                cache_pos: torch.Tensor | None = None,
                prompt_len: int | None = None, start_pos: int | None = None,
                cache_plan=None) -> tuple[torch.Tensor, dict | None]:
    """Pre-norm block.  Returns ``(x', cache)``; ``start_pos`` marks a
    chunked prefill (K/V land at the offset in the existing cache)."""
    h = rms_norm(p["attn_norm"], x, cfg.norm_eps)
    a, cache = attn.apply_attention(
        p["attn"], h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta, positions=positions, causal=True,
        cache=cache, cache_pos=cache_pos, prompt_len=prompt_len,
        start_pos=start_pos, plan=cache_plan,
        softcap=cfg.attn_logit_softcap)
    x = x + a
    h = rms_norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h), cache
