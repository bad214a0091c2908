"""LM trunk for the dense, MoE, SSM, hybrid, VLM and encoder families:
init, embed, trunk, logits, the training forward and loss, prefill,
chunked prefill (attention-cached families) and decode.

* dense:  one stack of L blocks (GQA or MLA attention).
* moe:    an optional unstacked first block with the dense FFN
          (``moe_first_dense``, DeepSeek-V2's), then a stack of MoE blocks.
* ssm:    one stack of L mamba2 blocks (mamba2).
* hybrid: the mamba2 stack with one *shared* attention + MLP block
          (``shared_attn``, unstacked) applied after every
          ``hybrid_attn_every`` SSM layers, each application with its own
          KV entry; the ``num_layers % hybrid_attn_every`` trailing SSM
          layers run last (zamba2).
* vlm:    ``n_super`` super blocks, each ``cross_attn_every - 1`` self
          blocks (one stack of ``n_super * n_self_per`` under
          ``"blocks"``) followed by one gated cross-attention block over
          the image K/V (a stack of ``n_super`` under ``"cross"``)
          (llama-3.2-vision).  The image embeddings arrive precomputed
          (``batch["image_embeds"]``); a prefill writes every cross
          block's image K/V into the cache and decode reads it there.
* encoder: one stack of L blocks with layer norms and bidirectional
          attention over precomputed frame embeddings (``batch["frames"]``,
          through ``frontend_proj`` where ``frontend_dim != d_model``),
          no token embedding, no cache and no decode step (hubert).

Per-layer params are stacked along a leading ``layers`` axis, as in the
reference; where the reference scans the stack with ``lax.scan``, the
port runs a Python loop over the layer axis, each layer seeing 2-D / 3-D
factor views that go straight to the kernels.  The KV cache is stacked
the same way (``{"blocks": {"k", "v"}}``, ``(L, B, S, KH, D)``, the
int8 family's ``k_q``/``k_scale``/``v_q``/``v_scale``, a paged pool's
blocks and ``block_tables``, or an MLA stack's latents ``ckv``/``krope``
``(L, B, S, r)`` and their int8 pairs), with the unstacked first block's
leaves under ``"first"`` (no ``L`` axis), and is written in place.  The
recurrent families' cache is ``{"blocks": {"ssm", "conv_x", "conv_bc"}}``
(``(L, B, nh, hd, N)``, ``(L, B, K-1, d_inner)``, ``(L, B, K-1, 2N)``,
in the model dtype), plus the hybrid's ``"shared"`` KV entry with an
``n_groups`` lead.  The VLM's cache is ``{"self": ..., "cross_kv": {"k",
"v"}}``: the self blocks' KV entry with an ``(n_super, n_self_per)`` lead
and the image K/V ``(n_super, B, T_img, KH, D)``, in the model dtype
whatever the pool (an int8 pool quantizes ``"self"`` only, as the
reference's does).

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
from repro_torch.layers import ssm as ssm_mod
from repro_torch.layers.norm import (init_layer_norm, init_rms_norm,
                                     layer_norm, rms_norm)
from repro_torch.layers.param import (EMBED, LAYERS, VOCAB, ParamBuilder,
                                      apply_linear, init_linear)
from repro_torch.layers.plan import matmul_f32
from repro_torch.models import blocks as B
from repro_torch.parallel.placement import gather_outside

PyTree = Any
CE_CHUNK_SEQ = 512      # logits computed per seq-chunk to bound activation
#: the layer stacks of a tree: a placed tree's are gathered a layer at a
#: time by the block functions, every other leaf at the entry points
STACKS = ("blocks", "cross")


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


#: the families :class:`LMModel` serves
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encoder")
#: the families whose layers carry recurrent state
RECURRENT = ("ssm", "hybrid")


def missing_family(family: str) -> NotImplementedError:
    """The refusal of the family :class:`LMModel` does not serve: the
    ResNets are :class:`repro_torch.models.resnet.ResNetModel`'s."""
    return NotImplementedError(
        f"family {family!r} is served by models/resnet.py's ResNetModel "
        "(models.api.get_model), not by LMModel")


class LMModel:
    """init / embed / trunk / logits / prefill / decode for one dense,
    MoE, SSM, hybrid, VLM or encoder architecture, on one device."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.family not in FAMILIES:
            raise missing_family(cfg.family)
        self.cfg = cfg
        #: the VLM's super blocks, each ``n_self_per`` self blocks and one
        #: cross block (0 for every other family)
        self.n_super = self.n_self_per = 0
        if cfg.family == "vlm":
            every = cfg.cross_attn_every
            if every <= 1 or cfg.num_layers % every:
                raise ValueError(
                    f"vlm: num_layers {cfg.num_layers} must be a multiple "
                    f"of cross_attn_every {every} > 1")
            self.n_super = cfg.num_layers // every
            self.n_self_per = every - 1
        #: unstacked first blocks (dense FFN) and the stacked rest (the
        #: VLM's self blocks only)
        self.n_first = cfg.moe_first_dense if cfg.family == "moe" else 0
        self.n_stack = (self.n_super * self.n_self_per if self.n_super
                        else cfg.num_layers - self.n_first)
        #: the hybrid's groups of ``hybrid_attn_every`` SSM layers, each
        #: followed by the shared block (0 for every other family)
        self.n_groups = (cfg.num_layers // cfg.hybrid_attn_every
                         if cfg.family == "hybrid" else 0)
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
        if cfg.family != "encoder":
            pb.child("embed").param("w", (self.padded_vocab, cfg.d_model),
                                    (VOCAB, EMBED), init="embed", scale=0.02)
        elif cfg.frontend_dim and cfg.frontend_dim != cfg.d_model:
            init_linear(pb, "frontend_proj", cfg.frontend_dim, cfg.d_model,
                        EMBED, EMBED)
        moe = cfg.family == "moe"
        if self.n_first:
            if self.n_first != 1:
                raise ValueError(
                    f"moe_first_dense={self.n_first}: the reference builds "
                    "one unstacked first block")
            first = ParamBuilder(generator, self.dtype, self.device)
            B.init_block(first, cfg, moe=False)
            pb.attach("first", first.params, first.axes)
        recurrent = cfg.family in RECURRENT
        layers, layer_axes = [], None
        for _ in range(self.n_stack):
            lb = ParamBuilder(generator, self.dtype, self.device)
            if recurrent:
                B.init_ssm_block(lb, cfg)
            else:
                B.init_block(lb, cfg, moe=moe)
            layers.append(lb.params)
            layer_axes = lb.axes
        pb.attach("blocks", _stack(layers), _stack_axes(layer_axes))
        del layers
        if self.n_super:
            crosses = []
            for _ in range(self.n_super):
                cb = ParamBuilder(generator, self.dtype, self.device)
                B.init_cross_block(cb, cfg)
                crosses.append(cb.params)
            pb.attach("cross", _stack(crosses), _stack_axes(cb.axes))
        if cfg.family == "hybrid":
            shared = ParamBuilder(generator, self.dtype, self.device)
            B.init_block(shared, cfg, moe=False)
            pb.attach("shared_attn", shared.params, shared.axes)
        (init_layer_norm if cfg.family == "encoder"
         else init_rms_norm)(pb, "final_norm", cfg.d_model)
        if not cfg.tie_embeddings:
            init_linear(pb, "unembed", cfg.d_model, self.padded_vocab,
                        EMBED, VOCAB)
        return pb.params, pb.axes

    # -- embedding / head ---------------------------------------------------

    def embed(self, params: PyTree, batch: dict) -> torch.Tensor:
        """The trunk's input (B, S, D): ``batch["tokens"]``' embedding
        rows, or the encoder's ``batch["frames"]`` (through
        ``frontend_proj`` where the tree has one)."""
        if self.cfg.family == "encoder":
            x = batch["frames"].to(self.dtype)
            if "frontend_proj" in params:
                x = apply_linear(params["frontend_proj"], x)
            return x
        return params["embed"]["w"][batch["tokens"]].to(self.dtype)

    def logits(self, params: PyTree, x: torch.Tensor, *,
               act_quantize: bool = False) -> torch.Tensor:
        """f32 logits over the padded vocab; padded columns masked."""
        params = gather_outside(params, STACKS)
        cfg = self.cfg
        norm = layer_norm if cfg.family == "encoder" else rms_norm
        h = norm(params["final_norm"], x, cfg.norm_eps)
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
              remat: str = "none", image_embeds: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, PyTree | None, torch.Tensor]:
        """Run every layer: the unstacked first block (if any), then the
        stack (the recurrent families: :meth:`_recurrent_trunk`; the VLM:
        :meth:`_vlm_trunk`, over ``image_embeds``).
        Returns ``(x, cache, aux)``, ``aux`` the summed MoE load-balance
        loss (``None`` without an MoE layer); the cache is written in
        place.  ``act_quantize`` runs every int8 linear int8 x int8
        (prefill segments only).  Without a cache (training) each block
        runs under the ``remat`` policy."""
        if self.cfg.family in RECURRENT:
            return self._recurrent_trunk(
                params, x, positions=positions, cache=cache,
                cache_pos=cache_pos, prompt_len=prompt_len,
                start_pos=start_pos, cache_plan=cache_plan,
                act_quantize=act_quantize, remat=remat)
        if self.n_super:
            return self._vlm_trunk(
                params, x, positions=positions, cache=cache,
                cache_pos=cache_pos, prompt_len=prompt_len,
                start_pos=start_pos, cache_plan=cache_plan,
                act_quantize=act_quantize, remat=remat,
                image_embeds=image_embeds)
        aux = None

        def add(a):
            return aux if a is None else a if aux is None else aux + a
        layers = ([] if "first" not in params
                  else [(params["first"], None if cache is None
                         else cache["first"])])
        if cache is None:
            layers += [(p_l, None)
                       for p_l in _unbind(params["blocks"], self.n_stack)]
            block = _remat(lambda h, p_l: B.apply_block(
                p_l, h, self.cfg, positions=positions,
                act_quantize=act_quantize)[::2], remat)
            for p_l, _ in layers:
                x, a = block(x, p_l)
                aux = add(a)
            return x, None, aux
        layers += [(layer_slice(params["blocks"], i),
                    layer_slice(cache["blocks"], i))
                   for i in range(self.n_stack)]
        for p_l, c_l in layers:
            x, _, a = B.apply_block(p_l, x, self.cfg, positions=positions,
                                    cache=c_l, cache_pos=cache_pos,
                                    prompt_len=prompt_len,
                                    start_pos=start_pos,
                                    cache_plan=cache_plan,
                                    act_quantize=act_quantize)
            aux = add(a)
        return x, cache, aux

    def _recurrent_trunk(self, params: PyTree, x: torch.Tensor, *,
                         positions: torch.Tensor, cache: PyTree | None,
                         cache_pos: torch.Tensor | None,
                         prompt_len: int | None, start_pos: int | None,
                         cache_plan, act_quantize: bool, remat: str
                         ) -> tuple[torch.Tensor, PyTree | None, None]:
        """The SSM stack, or the hybrid's: ``n_groups`` groups of
        ``hybrid_attn_every`` SSM layers, each followed by the shared
        block over that group's own KV entry, then the trailing SSM
        layers (``num_layers % hybrid_attn_every``).  A prefill writes every layer's final state (and the
        shared block's K/V) into the cache, a decode step advances them;
        recurrent state advances through every token it sees, so prompts
        prefill whole (no chunk offset)."""
        cfg = self.cfg
        if start_pos is not None:
            raise ValueError(f"family {cfg.family!r} prefills whole prompts "
                             "(its recurrent state has no chunk offset)")
        decode = cache_pos is not None
        if cache is None:
            per_layer = _unbind(params["blocks"], cfg.num_layers)
            ssm_step = _remat(lambda h, p_l: B.apply_ssm_block(
                p_l, h, cfg, act_quantize=act_quantize)[0], remat)
            shared_step = _remat(lambda h, p_s: B.apply_block(
                p_s, h, cfg, positions=positions,
                act_quantize=act_quantize)[0], remat)

        def ssm(i: int, h: torch.Tensor) -> torch.Tensor:
            if cache is None:
                return ssm_step(h, per_layer[i])
            return B.apply_ssm_block(
                layer_slice(params["blocks"], i), h, cfg,
                state=layer_slice(cache["blocks"], i), decode=decode,
                act_quantize=act_quantize)[0]

        def shared(g: int, h: torch.Tensor) -> torch.Tensor:
            if cache is None:
                return shared_step(h, params["shared_attn"])
            return B.apply_block(
                params["shared_attn"], h, cfg, positions=positions,
                cache=layer_slice(cache["shared"], g), cache_pos=cache_pos,
                prompt_len=prompt_len, cache_plan=cache_plan,
                act_quantize=act_quantize)[0]

        i = 0
        for g in range(self.n_groups):
            for _ in range(cfg.hybrid_attn_every):
                x = ssm(i, x)
                i += 1
            x = shared(g, x)
        for i in range(i, cfg.num_layers):
            x = ssm(i, x)
        return x, cache, None

    def _vlm_trunk(self, params: PyTree, x: torch.Tensor, *,
                   positions: torch.Tensor, cache: PyTree | None,
                   cache_pos: torch.Tensor | None, prompt_len: int | None,
                   start_pos: int | None, cache_plan, act_quantize: bool,
                   remat: str, image_embeds: torch.Tensor | None
                   ) -> tuple[torch.Tensor, PyTree | None, None]:
        """The VLM's super blocks: ``n_self_per`` self blocks, then the
        cross block over the image K/V.  Without a cache (training) each
        cross block computes its K/V from ``image_embeds``; a prefill
        (or prefill chunk) writes every cross block's K/V into
        ``cache["cross_kv"]`` first, and decode reads it there."""
        cfg = self.cfg
        ns, npr = self.n_super, self.n_self_per
        aq = dict(act_quantize=act_quantize)
        if cache is None:
            img = image_embeds.to(self.dtype)
            selfs = _unbind(params["blocks"], self.n_stack)
            block = _remat(lambda h, p_l: B.apply_block(
                p_l, h, cfg, positions=positions, **aq)[0], remat)
            cross = _remat(lambda h, p_c: B.apply_cross_block(
                p_c, h, cfg, image_feats=img, **aq), remat)
            for s, p_c in enumerate(_unbind(params["cross"], ns)):
                for j in range(npr):
                    x = block(x, selfs[s * npr + j])
                x = cross(x, p_c)
            return x, None, None
        if cache_pos is None:
            kv = B.cross_kv_all(params["cross"], image_embeds.to(self.dtype),
                                cfg, **aq)
            for k in ("k", "v"):
                cache["cross_kv"][k].copy_(kv[k])
            del kv
        for s in range(ns):
            for j in range(npr):
                x = B.apply_block(
                    layer_slice(params["blocks"], s * npr + j), x, cfg,
                    positions=positions,
                    cache=layer_slice(layer_slice(cache["self"], s), j),
                    cache_pos=cache_pos, prompt_len=prompt_len,
                    start_pos=start_pos, cache_plan=cache_plan, **aq)[0]
            x = B.apply_cross_block(
                layer_slice(params["cross"], s), x, cfg,
                kv=layer_slice(cache["cross_kv"], s), **aq)
        return x, cache, None

    # -- training -------------------------------------------------------------

    def forward(self, params: PyTree, batch: dict, *,
                opts: B.BlockOpts = B.BlockOpts(), remat: str = "none"
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward (training).  Returns the pre-head
        activations (B, S, D) and the summed MoE load-balance loss (0 for
        the dense family); :meth:`loss` applies the head in chunks.  With
        ``opts.freeze_factors`` the frozen factors are detached first.
        ``batch``: ``tokens`` (B, S), plus the VLM's ``image_embeds``
        (B, T_img, vision_d_model or d_model); the encoder's ``frames``
        (B, S, frontend_dim or d_model)."""
        params = gather_outside(params, STACKS)
        if opts.freeze_factors:
            from repro_torch.core.freezing import stop_frozen_factors
            params = stop_frozen_factors(params)
        x = self.embed(params, batch)
        bsz, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None, :].expand(bsz, s)
        x, _, aux = self.trunk(params, x, positions=positions, remat=remat,
                               image_embeds=batch.get("image_embeds"))
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux

    def loss(self, params: PyTree, batch: dict, *,
             opts: B.BlockOpts = B.BlockOpts(), remat: str = "none"
             ) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy over ``batch["tokens"]`` (B, S) (the
        last position has no label), or the encoder's cross-entropy
        against ``batch["labels"]`` (B, S) at every position, plus 0.01 x
        the auxiliary loss.  Returns ``(total, {"ce", "aux", "tokens"})``."""
        params = gather_outside(params, STACKS)
        x, aux = self.forward(params, batch, opts=opts, remat=remat)
        if self.cfg.family == "encoder":
            labels = batch["labels"].long()
            valid = torch.ones_like(labels, dtype=torch.bool)
        else:
            tok = batch["tokens"].long()
            labels = torch.cat([tok[:, 1:], torch.zeros_like(tok[:, :1])],
                               1)
            valid = torch.cat(
                [torch.ones_like(tok[:, 1:], dtype=torch.bool),
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
        """One plan per cached attention layer (the hybrid's shared block
        once per group, the VLM's self blocks; none for the SSM stack,
        whose recurrent state is no per-token KV stream, nor for the
        encoder)."""
        f = self.cfg.family
        n = (self.n_groups if f == "hybrid" else 0
             if f in ("ssm", "encoder") else self.n_stack + self.n_first)
        return [self.cache_plan(kv_quantize, paged)] * n

    def state_leaves(self, batch: int
                     ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """``{name: (shape, dtype)}`` of one layer's recurrent state (none
        for the attention families)."""
        if self.cfg.family not in RECURRENT:
            return {}
        return ssm_mod.ssm_state_spec(
            batch, ssm_mod.dims_from_config(self.cfg), self.dtype)

    def init_cache(self, batch: int, seq_len: int,
                   kv_quantize: str | None = None,
                   paged: cache_mod.PagedGeometry | None = None) -> PyTree:
        """A fresh cache of every layer, per leaf of the plan: stacked
        ``(L, ...)`` under ``"blocks"``, and the unstacked first block's
        under ``"first"`` (int8 values and f32 scale rows for ``"int8"``;
        for a ``paged`` geometry, ``batch`` physical blocks of ``seq_len``
        positions plus block tables pointing at the dummy).  The recurrent
        families' ``"blocks"`` hold zero states (:meth:`state_leaves`),
        and the hybrid's ``"shared"`` one KV entry per group.  The VLM's
        ``"self"`` holds its self blocks' entries ``(n_super, n_self_per,
        ...)`` and ``"cross_kv"`` the image K/V ``(n_super, batch, T_img,
        KH, D)`` in the model dtype (slot pools only); the encoder has no
        cache."""
        f = self.cfg.family
        if f == "encoder":
            raise ValueError("encoder-only model has no KV cache")
        if f == "vlm" and paged is not None:
            raise ValueError("the VLM has no paged pool (its admission is "
                             "blocking, the paged pool's continuous)")
        plan = self.cache_plan(kv_quantize, paged)

        def entry(*lead: int) -> dict:
            return {n: torch.full((*lead, *shape), plan.fill_value(n),
                                  dtype=dt, device=self.device)
                    for n, (shape, dt) in plan.leaves(batch,
                                                      seq_len).items()}
        if self.cfg.family in RECURRENT:
            out = {"blocks": {
                n: torch.zeros((self.cfg.num_layers, *shape), dtype=dt,
                               device=self.device)
                for n, (shape, dt) in self.state_leaves(batch).items()}}
            if self.n_groups:
                out["shared"] = entry(self.n_groups)
            return out
        if self.n_super:
            cfg = self.cfg
            shape = (self.n_super, batch, cfg.num_image_tokens,
                     cfg.num_kv_heads, cfg.resolved_head_dim)
            return {"self": entry(self.n_super, self.n_self_per),
                    "cross_kv": {k: torch.zeros(shape, dtype=self.dtype,
                                                device=self.device)
                                 for k in ("k", "v")}}
        out = {"blocks": entry(self.n_stack)}
        if self.n_first:
            out["first"] = entry()
        return out

    # -- prefill / decode -----------------------------------------------------

    def prefill(self, params: PyTree, batch: dict, cache: PyTree, *,
                last_pos: int | None = None, cache_plan=None,
                act_quantize: bool = False) -> tuple[torch.Tensor, PyTree]:
        """Fill the cache with a whole prompt; returns (logits at the
        last real position (B, 1, V), cache).  ``last_pos`` is the index
        of the final real token of a right-padded prompt; a VLM's
        ``batch`` carries its ``image_embeds``."""
        params = gather_outside(params, STACKS)
        x = self.embed(params, batch)
        bsz, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None, :].expand(bsz, s)
        prompt_len = None if last_pos is None else int(last_pos) + 1
        x, cache, _ = self.trunk(params, x, positions=positions,
                                 cache=cache, prompt_len=prompt_len,
                                 cache_plan=cache_plan,
                                 act_quantize=act_quantize,
                                 image_embeds=batch.get("image_embeds"))
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
        params = gather_outside(params, STACKS)
        x = self.embed(params, batch)
        bsz, c = x.shape[:2]
        positions = (int(start_pos)
                     + torch.arange(c, device=x.device))[None, :].expand(bsz,
                                                                         c)
        x, cache, _ = self.trunk(params, x, positions=positions,
                                 cache=cache, prompt_len=prompt_len,
                                 start_pos=start_pos, cache_plan=cache_plan,
                                 act_quantize=act_quantize,
                                 image_embeds=batch.get("image_embeds"))
        lp = min(max(int(prompt_len) - 1 - int(start_pos), 0), c - 1)
        return self.logits(params, x[:, lp:lp + 1],
                           act_quantize=act_quantize), cache

    def decode_step(self, params: PyTree, tokens: torch.Tensor,
                    positions: torch.Tensor, cache: PyTree, *,
                    cache_plan=None) -> tuple[torch.Tensor, PyTree]:
        """One token per sequence.  tokens (B, 1); positions (B,).  The
        encoder has none."""
        params = gather_outside(params, STACKS)
        if self.cfg.family == "encoder":
            raise ValueError("encoder-only model has no decode step")
        x = self.embed(params, {"tokens": tokens})
        x, cache, _ = self.trunk(params, x, positions=positions[:, None],
                                 cache=cache, cache_pos=positions,
                                 cache_plan=cache_plan)
        return self.logits(params, x), cache
