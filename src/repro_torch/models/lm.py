"""LM trunk for the dense family: init, embed, trunk, logits, prefill,
chunked prefill and decode.

Per-layer params are stacked along a leading ``layers`` axis, as in the
reference; where the reference scans the stack with ``lax.scan``, the
port runs a Python loop over the layer axis, each layer seeing 2-D / 3-D
factor views that go straight to the kernels.  The KV cache is stacked
the same way (``{"blocks": {"k", "v"}}``, ``(L, B, S, KH, D)``, or the
int8 family's ``k_q``/``k_scale``/``v_q``/``v_scale``) and is written in
place.  The other families (MoE, VLM, SSM, hybrid, encoder)
come with ROADMAP item A13.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import cache as cache_mod
from repro_torch.layers.norm import init_rms_norm, rms_norm
from repro_torch.layers.param import (EMBED, LAYERS, VOCAB, ParamBuilder,
                                      apply_linear, init_linear)
from repro_torch.layers.plan import matmul_f32
from repro_torch.models import blocks as B

PyTree = Any


def layer_slice(tree: PyTree, i: int) -> PyTree:
    """Index the leading layer axis of every leaf (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list[PyTree]) -> PyTree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stack_axes(axes: PyTree) -> PyTree:
    if isinstance(axes, dict):
        return {k: _stack_axes(v) for k, v in axes.items()}
    return (LAYERS, *axes)


class LMModel:
    """init / embed / trunk / logits / prefill / decode for one dense
    architecture, on one device."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} comes with ROADMAP item A13")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.padded_vocab = ((-cfg.vocab_size) % 128 + cfg.vocab_size
                             if cfg.pad_vocab else cfg.vocab_size)

    # -- init ---------------------------------------------------------------

    def init(self, generator: torch.Generator) -> tuple[PyTree, PyTree]:
        """Random params from ``generator`` (which must live on this
        model's device) and their logical-axes tree."""
        cfg = self.cfg
        pb = ParamBuilder(generator, self.dtype, self.device)
        pb.child("embed").param("w", (self.padded_vocab, cfg.d_model),
                                (VOCAB, EMBED), init="embed", scale=0.02)
        layers, layer_axes = [], None
        for _ in range(cfg.num_layers):
            lb = ParamBuilder(generator, self.dtype, self.device)
            B.init_block(lb, cfg)
            layers.append(lb.params)
            layer_axes = lb.axes
        pb.attach("blocks", _stack(layers), _stack_axes(layer_axes))
        del layers
        init_rms_norm(pb, "final_norm", cfg.d_model)
        if not cfg.tie_embeddings:
            init_linear(pb, "unembed", cfg.d_model, self.padded_vocab,
                        EMBED, VOCAB)
        return pb.params, pb.axes

    # -- embedding / head ---------------------------------------------------

    def embed(self, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"]["w"][tokens].to(self.dtype)

    def logits(self, params: PyTree, x: torch.Tensor) -> torch.Tensor:
        """f32 logits over the padded vocab; padded columns masked."""
        cfg = self.cfg
        h = rms_norm(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            out = matmul_f32(h, params["embed"]["w"].t())
        else:
            out = apply_linear(params["unembed"], h).to(torch.float32)
        if self.padded_vocab != cfg.vocab_size:
            keep = torch.arange(self.padded_vocab,
                                device=out.device) < cfg.vocab_size
            out = torch.where(keep, out, -1e30)
        return out

    # -- trunk ----------------------------------------------------------------

    def trunk(self, params: PyTree, x: torch.Tensor, *,
              positions: torch.Tensor, cache: PyTree | None = None,
              cache_pos: torch.Tensor | None = None,
              prompt_len: int | None = None, start_pos: int | None = None,
              cache_plan=None) -> tuple[torch.Tensor, PyTree | None]:
        """Run every layer.  Returns ``(x, cache)``; the cache is written
        in place."""
        for i in range(self.cfg.num_layers):
            c_l = None if cache is None else layer_slice(cache["blocks"], i)
            x, _ = B.apply_block(layer_slice(params["blocks"], i), x,
                                 self.cfg, positions=positions, cache=c_l,
                                 cache_pos=cache_pos, prompt_len=prompt_len,
                                 start_pos=start_pos, cache_plan=cache_plan)
        return x, cache

    # -- caches ---------------------------------------------------------------

    def cache_plan(self, kv_quantize: str | None = None
                   ) -> cache_mod.CachePlan:
        return cache_mod.build_cache_plan(self.cfg, self.dtype, kv_quantize)

    def cache_plans(self, kv_quantize: str | None = None
                    ) -> list[cache_mod.CachePlan]:
        return [self.cache_plan(kv_quantize)] * self.cfg.num_layers

    def init_cache(self, batch: int, seq_len: int,
                   kv_quantize: str | None = None) -> PyTree:
        """Zero cache of every layer, stacked ``(L, ...)`` per leaf of
        the plan (int8 values and f32 scale rows for ``"int8"``)."""
        leaves = self.cache_plan(kv_quantize).leaves(batch, seq_len)
        return {"blocks": {n: torch.zeros((self.cfg.num_layers, *shape),
                                          dtype=dt, device=self.device)
                           for n, (shape, dt) in leaves.items()}}

    # -- prefill / decode -----------------------------------------------------

    def prefill(self, params: PyTree, batch: dict, cache: PyTree, *,
                last_pos: int | None = None, cache_plan=None
                ) -> tuple[torch.Tensor, PyTree]:
        """Fill the cache with a whole prompt; returns (logits at the
        last real position (B, 1, V), cache).  ``last_pos`` is the index
        of the final real token of a right-padded prompt."""
        tokens = batch["tokens"]
        x = self.embed(params, tokens)
        bsz, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None, :].expand(bsz, s)
        prompt_len = None if last_pos is None else int(last_pos) + 1
        x, cache = self.trunk(params, x, positions=positions, cache=cache,
                              prompt_len=prompt_len, cache_plan=cache_plan)
        lp = s - 1 if last_pos is None else int(last_pos)
        return self.logits(params, x[:, lp:lp + 1]), cache

    def prefill_chunk(self, params: PyTree, batch: dict, cache: PyTree, *,
                      start_pos: int, prompt_len: int, cache_plan=None
                      ) -> tuple[torch.Tensor, PyTree]:
        """Continue a prefill one chunk at a time: ``batch["tokens"]``
        (1, C) holds prompt positions ``[start_pos, start_pos + C)``,
        possibly right-padded; ``prompt_len`` is the chunk's real end.
        Returns logits (1, 1, V) at the last real row of the chunk."""
        tokens = batch["tokens"]
        x = self.embed(params, tokens)
        bsz, c = x.shape[:2]
        positions = (int(start_pos)
                     + torch.arange(c, device=x.device))[None, :].expand(bsz,
                                                                         c)
        x, cache = self.trunk(params, x, positions=positions, cache=cache,
                              prompt_len=prompt_len, start_pos=start_pos,
                              cache_plan=cache_plan)
        lp = min(max(int(prompt_len) - 1 - int(start_pos), 0), c - 1)
        return self.logits(params, x[:, lp:lp + 1]), cache

    def decode_step(self, params: PyTree, tokens: torch.Tensor,
                    positions: torch.Tensor, cache: PyTree, *,
                    cache_plan=None) -> tuple[torch.Tensor, PyTree]:
        """One token per sequence.  tokens (B, 1); positions (B,)."""
        x = self.embed(params, tokens)
        x, cache = self.trunk(params, x, positions=positions[:, None],
                              cache=cache, cache_pos=positions,
                              cache_plan=cache_plan)
        return self.logits(params, x), cache
