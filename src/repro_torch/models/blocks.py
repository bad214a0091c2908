"""The pre-norm decoder block on the LRD-transparent layers: GQA or MLA
attention, a dense FFN or an MoE one; and the mamba2 (SSM) block.

``init_block(pb, cfg, moe=...)`` builds a single layer's params (the model
stacks layers along a leading axis); ``apply_block`` runs one layer's
params, choosing MLA where the params hold an ``mla`` subtree, the merged
attention of paper §2.3 (no cache) where they hold a ``merged`` one, and
the MoE FFN where they hold a ``moe`` one.  ``init_ssm_block`` /
``apply_ssm_block`` are the SSM family's layer (and the hybrid's, beside
its shared attention block); ``init_cross_block`` / ``apply_cross_block``
the VLM's gated cross-attention layer over image K/V.  The encoder's
blocks take layer norms and bidirectional attention, every other
family's RMS norms and causal attention.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.layers import attention as attn
from repro_torch.layers import cache as cache_mod
from repro_torch.layers import ssm as ssm_mod
from repro_torch.layers.mlp import apply_mlp, init_mlp
from repro_torch.layers.moe import apply_moe, init_moe
from repro_torch.layers.norm import (init_layer_norm, init_rms_norm,
                                     layer_norm, rms_norm)
from repro_torch.layers.param import ParamBuilder
from repro_torch.parallel.placement import gather_tree
from repro_torch.tree import tree_map


class BlockOpts(NamedTuple):
    """The reference's block options that the port reads:
    ``freeze_factors``, the forward half of the §2.2 freeze (the model
    detaches the frozen factors, ``core/freezing.py``).  The reference's
    ``use_pallas`` has no counterpart (the device decides), and
    ``act_quantize`` is a keyword of the serve calls."""
    freeze_factors: bool = False


def _norm_fns(cfg):
    """(init, apply) of the block norms: layer norm for the encoder, RMS
    norm otherwise."""
    if cfg.family == "encoder":
        return init_layer_norm, layer_norm
    return init_rms_norm, rms_norm


def init_block(pb: ParamBuilder, cfg, *, moe: bool = False) -> None:
    init_norm, _ = _norm_fns(cfg)
    init_norm(pb, "attn_norm", cfg.d_model)
    if cfg.mla:
        attn.init_mla(pb, "mla", cfg)
    else:
        attn.init_attention(pb, "attn", cfg.d_model, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim)
    init_norm(pb, "mlp_norm", cfg.d_model)
    if moe:
        init_moe(pb, "moe", cfg.d_model, cfg.resolved_moe_d_ff,
                 cfg.moe_num_experts, cfg.moe_num_shared, cfg.act)
    else:
        init_mlp(pb, "mlp", cfg.d_model, cfg.d_ff, cfg.act)


def apply_block(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                cache: dict | None = None,
                cache_pos: torch.Tensor | None = None,
                prompt_len: int | None = None, start_pos: int | None = None,
                cache_plan=None, act_quantize: bool = False
                ) -> tuple[torch.Tensor, dict | None, torch.Tensor | None]:
    """Pre-norm block.  Returns ``(x', cache, aux_loss)``: the MoE
    load-balance loss, ``None`` for a dense FFN (no device op for a loss
    that is 0); ``start_pos`` marks a chunked prefill (K/V land at the
    offset in the existing cache); ``act_quantize`` runs every int8
    linear int8 x int8 (prefill segments).  The encoder's attention is
    bidirectional."""
    p = gather_tree(p)   # a placed layer's leaves, whole (at use)
    _, norm = _norm_fns(cfg)
    causal = not cfg.is_encoder
    h = norm(p["attn_norm"], x, cfg.norm_eps)
    if "mla" in p:
        a, cache = attn.apply_mla(
            p["mla"], h, cfg, positions=positions, causal=causal,
            cache=cache, cache_pos=cache_pos, prompt_len=prompt_len,
            start_pos=start_pos, plan=cache_plan,
            softcap=cfg.attn_logit_softcap, act_quantize=act_quantize)
    elif "merged" in p:
        a = attn.apply_merged_attention(p["merged"], h, positions=positions,
                                        causal=causal,
                                        softcap=cfg.attn_logit_softcap)
        cache = None
    else:
        a, cache = attn.apply_attention(
            p["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, positions=positions, causal=causal,
            cache=cache, cache_pos=cache_pos, prompt_len=prompt_len,
            start_pos=start_pos, plan=cache_plan,
            softcap=cfg.attn_logit_softcap, act_quantize=act_quantize)
    x = x + a
    h = norm(p["mlp_norm"], x, cfg.norm_eps)
    if "moe" in p:
        f, aux = apply_moe(p["moe"], h, top_k=cfg.moe_top_k,
                           capacity_factor=cfg.moe_capacity_factor,
                           act=cfg.act,
                           dispatch_groups=cfg.moe_dispatch_groups,
                           act_quantize=act_quantize)
    else:
        f, aux = apply_mlp(p["mlp"], h, cfg.act,
                           act_quantize=act_quantize), None
    return x + f, cache, aux


def block_cache_spec(cfg, batch: int, seq_len: int, dtype: torch.dtype,
                     kv_quantize: str | None = None, paged=None
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of one layer's cache, from its plan:
    gqa_f32 | gqa_int8 | mla_latent | mla_latent_int8 | gqa_paged_*
    (where a ``paged`` geometry makes ``batch`` / ``seq_len`` mean
    physical blocks + 1 / block size)."""
    return cache_mod.build_cache_plan(cfg, dtype, kv_quantize,
                                      paged).leaves(batch, seq_len)


# ---------------------------------------------------------------------------
# Cross-attention block (VLM): gated cross attention + MLP
# ---------------------------------------------------------------------------

def init_cross_block(pb: ParamBuilder, cfg) -> None:
    init_norm, _ = _norm_fns(cfg)
    init_norm(pb, "norm", cfg.d_model)
    attn.init_cross_attention(pb, "cross_attn", cfg.d_model, cfg.num_heads,
                              cfg.num_kv_heads, cfg.resolved_head_dim,
                              cfg.vision_d_model or cfg.d_model)
    init_norm(pb, "mlp_norm", cfg.d_model)
    init_mlp(pb, "mlp", cfg.d_model, cfg.d_ff, cfg.act)


def cross_block_kv(p: dict, image_feats: torch.Tensor, cfg, *,
                   act_quantize: bool = False) -> dict:
    """One cross block's image K/V ``{"k", "v"}`` ``(B, T, KH, D)``."""
    p = gather_tree(p)   # a placed layer's leaves, whole (at use)
    return attn.cross_attn_kv(p["cross_attn"], image_feats,
                              num_kv_heads=cfg.num_kv_heads,
                              head_dim=cfg.resolved_head_dim,
                              act_quantize=act_quantize)


def cross_kv_all(cross_stacked: dict, image_feats: torch.Tensor, cfg, *,
                 act_quantize: bool = False) -> dict:
    """The image K/V of every stacked cross block: ``{"k", "v"}``
    ``(n_super, B, T, KH, D)``."""
    n = cross_stacked["cross_attn"]["gate"].shape[0]
    kvs = [cross_block_kv(tree_map(lambda t: t[i], cross_stacked),
                          image_feats, cfg, act_quantize=act_quantize)
           for i in range(n)]
    return {k: torch.stack([kv[k] for kv in kvs]) for k in ("k", "v")}


def apply_cross_block(p: dict, x: torch.Tensor, cfg, *,
                      image_feats: torch.Tensor | None = None,
                      kv: dict | None = None,
                      act_quantize: bool = False) -> torch.Tensor:
    """Pre-norm gated cross attention over the image K/V (``kv``, or
    computed from ``image_feats``), then the MLP."""
    p = gather_tree(p)   # a placed layer's leaves, whole (at use)
    _, norm = _norm_fns(cfg)
    h = norm(p["norm"], x, cfg.norm_eps)
    x = x + attn.apply_cross_attention(
        p["cross_attn"], h, image_feats, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        kv=kv, act_quantize=act_quantize)
    h = norm(p["mlp_norm"], x, cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h, cfg.act, act_quantize=act_quantize)


# ---------------------------------------------------------------------------
# SSM (mamba2) block
# ---------------------------------------------------------------------------

def init_ssm_block(pb: ParamBuilder, cfg) -> None:
    init_rms_norm(pb, "norm", cfg.d_model)
    ssm_mod.init_ssm(pb, "ssm", ssm_mod.dims_from_config(cfg))


def apply_ssm_block(p: dict, x: torch.Tensor, cfg, *,
                    state: dict | None = None, decode: bool = False,
                    act_quantize: bool = False
                    ) -> tuple[torch.Tensor, dict | None]:
    """Pre-norm mamba2 layer.  Returns ``(x', state)``: with ``decode``
    one step advances ``state`` in place, else the full-sequence SSD
    writes its final state into ``state`` (when given)."""
    p = gather_tree(p)   # a placed layer's leaves, whole (at use)
    dims = ssm_mod.dims_from_config(cfg)
    h = rms_norm(p["norm"], x, cfg.norm_eps)
    if decode:
        y, state = ssm_mod.apply_ssm_decode(
            p["ssm"], h, dims, state, act_quantize=act_quantize,
            norm_eps=cfg.norm_eps)
    else:
        y, state = ssm_mod.apply_ssm(
            p["ssm"], h, dims, state=state, act_quantize=act_quantize,
            norm_eps=cfg.norm_eps)
    return x + y, state
