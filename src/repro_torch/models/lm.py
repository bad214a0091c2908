"""LM trunk for the dense family (GQA or MLA attention): init, embed,
trunk, logits, the training forward and loss, prefill, chunked prefill
and decode.

Per-layer params are stacked along a leading ``layers`` axis, as in the
reference; where the reference scans the stack with ``lax.scan``, the
port runs a Python loop over the layer axis, each layer seeing 2-D / 3-D
factor views that go straight to the kernels.  The KV cache is stacked
the same way (``{"blocks": {"k", "v"}}``, ``(L, B, S, KH, D)``, the
int8 family's ``k_q``/``k_scale``/``v_q``/``v_scale``, a paged pool's
blocks and ``block_tables``, or an MLA stack's latents ``ckv``/``krope``
``(L, B, S, r)`` and their int8 pairs) and is written in place.  Still
left for ROADMAP item A13: the MoE family (DeepSeek-V2 with its experts,
the reference's unstacked first dense block), VLM, SSM, hybrid and
encoder.

Training (:meth:`LMModel.loss`) runs the trunk without a cache over
per-layer views from ``unbind`` (one stacked gradient per leaf in
backward), each block optionally checkpointed (``remat``): ``"full"``
recomputes the whole block in backward, ``"dots"`` keeps the outputs of
the plain matrix products (``aten.mm`` / ``addmm``: the reference's
``dots_with_no_batch_dims_saveable``) and of the two chain kernels, and
recomputes the rest.  The cross-entropy runs over sequence chunks whose
logits are recomputed in backward, never kept.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.layers import cache as cache_mod
from repro_torch.layers.norm import init_rms_norm, rms_norm
from repro_torch.layers.param import (EMBED, LAYERS, VOCAB, ParamBuilder,
                                      apply_linear, init_linear)
from repro_torch.layers.plan import matmul_f32
from repro_torch.models import blocks as B

PyTree = Any
CE_CHUNK_SEQ = 512      # logits computed per seq-chunk to bound activation


def layer_slice(tree: PyTree, i: int) -> PyTree:
    """Index the leading layer axis of every leaf (views, no copy)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list[PyTree]) -> PyTree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unbind(tree: PyTree, n: int) -> list[PyTree]:
    """The ``n`` layer trees of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the plain matrix products' and the chain kernels' outputs,
    recompute everything else."""
    from repro_torch.kernels.autograd import KERNEL_OPS
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              *KERNEL_OPS):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` checkpointed by the ``remat`` policy ("none" | "dots" |
    "full")."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat {remat!r}")


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

    def logits(self, params: PyTree, x: torch.Tensor, *,
               act_quantize: bool = False) -> torch.Tensor:
        """f32 logits over the padded vocab; padded columns masked."""
        cfg = self.cfg
        h = rms_norm(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            out = matmul_f32(h, params["embed"]["w"].t())
        else:
            out = apply_linear(params["unembed"], h,
                               act_quantize=act_quantize).to(torch.float32)
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
              cache_plan=None, act_quantize: bool = False,
              remat: str = "none") -> tuple[torch.Tensor, PyTree | None]:
        """Run every layer.  Returns ``(x, cache)``; the cache is written
        in place.  ``act_quantize`` runs every int8 linear int8 x int8
        (prefill segments only).  Without a cache (training) each block
        runs under the ``remat`` policy."""
        if cache is None:
            block = _remat(lambda h, p_l: B.apply_block(
                p_l, h, self.cfg, positions=positions,
                act_quantize=act_quantize)[0], remat)
            for p_l in _unbind(params["blocks"], self.cfg.num_layers):
                x = block(x, p_l)
            return x, None
        for i in range(self.cfg.num_layers):
            c_l = None if cache is None else layer_slice(cache["blocks"], i)
            x, _ = B.apply_block(layer_slice(params["blocks"], i), x,
                                 self.cfg, positions=positions, cache=c_l,
                                 cache_pos=cache_pos, prompt_len=prompt_len,
                                 start_pos=start_pos, cache_plan=cache_plan,
                                 act_quantize=act_quantize)
        return x, cache

    # -- training -------------------------------------------------------------

    def forward(self, params: PyTree, batch: dict, *,
                opts: B.BlockOpts = B.BlockOpts(), remat: str = "none"
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward (training).  Returns the pre-head
        activations (B, S, D) and the auxiliary loss (0 for the dense
        family); :meth:`loss` applies the head in chunks.  With
        ``opts.freeze_factors`` the frozen factors are detached first."""
        if opts.freeze_factors:
            from repro_torch.core.freezing import stop_frozen_factors
            params = stop_frozen_factors(params)
        x = self.embed(params, batch["tokens"])
        bsz, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None, :].expand(bsz, s)
        x, _ = self.trunk(params, x, positions=positions, remat=remat)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params: PyTree, batch: dict, *,
             opts: B.BlockOpts = B.BlockOpts(), remat: str = "none"
             ) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy over ``batch["tokens"]`` (B, S) (the
        last position has no label), plus 0.01 x the auxiliary loss.
        Returns ``(total, {"ce", "aux", "tokens"})``."""
        x, aux = self.forward(params, batch, opts=opts, remat=remat)
        tok = batch["tokens"].long()
        labels = torch.cat([tok[:, 1:], torch.zeros_like(tok[:, :1])], 1)
        valid = torch.cat([torch.ones_like(tok[:, 1:], dtype=torch.bool),
                           torch.zeros_like(tok[:, :1], dtype=torch.bool)], 1)
        ce, n_tok = self._chunked_ce(params, x, labels, valid)
        loss = ce / torch.clamp(n_tok, min=1.0)
        return loss + 0.01 * aux, {"ce": loss, "aux": aux, "tokens": n_tok}

    def _chunked_ce(self, params: PyTree, x: torch.Tensor,
                    labels: torch.Tensor, valid: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Summed cross-entropy and valid-token count over sequence
        chunks of at most ``CE_CHUNK_SEQ`` (never the whole (B, S, V)
        logits); each chunk's logits are recomputed in backward."""
        s = x.shape[1]
        chunk = min(CE_CHUNK_SEQ, s)
        n = s // chunk if s % chunk == 0 else 1
        chunk = s // n

        def body(xc, lc, vc):
            logits = self.logits(params, xc)             # (B, chunk, V) f32
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, lc[..., None])[..., 0]
            ce = torch.where(vc, logz - gold, 0.0)
            return ce.sum(), vc.sum().to(torch.float32)

        ce = n_tok = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            c, t = ckpt.checkpoint(body, x[:, sl], labels[:, sl],
                                   valid[:, sl], use_reentrant=False)
            ce, n_tok = ce + c, n_tok + t
        return ce, n_tok

    # -- caches ---------------------------------------------------------------

    def cache_plan(self, kv_quantize: str | None = None,
                   paged: cache_mod.PagedGeometry | None = None
                   ) -> cache_mod.CachePlan:
        return cache_mod.build_cache_plan(self.cfg, self.dtype, kv_quantize,
                                          paged)

    def cache_plans(self, kv_quantize: str | None = None,
                    paged: cache_mod.PagedGeometry | None = None
                    ) -> list[cache_mod.CachePlan]:
        return [self.cache_plan(kv_quantize, paged)] * self.cfg.num_layers

    def init_cache(self, batch: int, seq_len: int,
                   kv_quantize: str | None = None,
                   paged: cache_mod.PagedGeometry | None = None) -> PyTree:
        """A fresh cache of every layer, stacked ``(L, ...)`` per leaf of
        the plan (int8 values and f32 scale rows for ``"int8"``; for a
        ``paged`` geometry, ``batch`` physical blocks of ``seq_len``
        positions plus block tables pointing at the dummy)."""
        plan = self.cache_plan(kv_quantize, paged)
        return {"blocks": {
            n: torch.full((self.cfg.num_layers, *shape), plan.fill_value(n),
                          dtype=dt, device=self.device)
            for n, (shape, dt) in plan.leaves(batch, seq_len).items()}}

    # -- prefill / decode -----------------------------------------------------

    def prefill(self, params: PyTree, batch: dict, cache: PyTree, *,
                last_pos: int | None = None, cache_plan=None,
                act_quantize: bool = False) -> tuple[torch.Tensor, PyTree]:
        """Fill the cache with a whole prompt; returns (logits at the
        last real position (B, 1, V), cache).  ``last_pos`` is the index
        of the final real token of a right-padded prompt."""
        tokens = batch["tokens"]
        x = self.embed(params, tokens)
        bsz, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None, :].expand(bsz, s)
        prompt_len = None if last_pos is None else int(last_pos) + 1
        x, cache = self.trunk(params, x, positions=positions, cache=cache,
                              prompt_len=prompt_len, cache_plan=cache_plan,
                              act_quantize=act_quantize)
        lp = s - 1 if last_pos is None else int(last_pos)
        return self.logits(params, x[:, lp:lp + 1],
                           act_quantize=act_quantize), cache

    def prefill_chunk(self, params: PyTree, batch: dict, cache: PyTree, *,
                      start_pos: int, prompt_len: int, cache_plan=None,
                      act_quantize: bool = False
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
                              cache_plan=cache_plan,
                              act_quantize=act_quantize)
        lp = min(max(int(prompt_len) - 1 - int(start_pos), 0), c - 1)
        return self.logits(params, x[:, lp:lp + 1],
                           act_quantize=act_quantize), cache

    def decode_step(self, params: PyTree, tokens: torch.Tensor,
                    positions: torch.Tensor, cache: PyTree, *,
                    cache_plan=None) -> tuple[torch.Tensor, PyTree]:
        """One token per sequence.  tokens (B, 1); positions (B,)."""
        x = self.embed(params, tokens)
        x, cache = self.trunk(params, x, positions=positions[:, None],
                              cache=cache, cache_pos=positions,
                              cache_plan=cache_plan)
        return self.logits(params, x), cache
