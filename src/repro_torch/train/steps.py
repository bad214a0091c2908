"""The train / prefill / decode / forward step functions.

* :func:`make_train_step` — loss -> gradients (``grad_accum``
  micro-batches, the remat policy) -> optional EF-PowerSGD -> masked
  AdamW.  Gradients come from ``torch.autograd.grad`` over the leaves
  that require grad; a factor the freeze policy detached gets ``None``.
* :func:`make_prefill_step` / :func:`make_decode_step` /
  :func:`make_forward_step` — the serving pair and the encoder-style
  forward, without autograd.

The reference's multi-pod path (EF-PowerSGD inside a ``shard_map`` over
the ``pod`` axis, ``repro/train/steps.py:95-110``) comes with ROADMAP
item A14: a ``mesh`` raises.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.freezing import trainable_mask
from repro_torch.models.blocks import BlockOpts
from repro_torch.train import compression as comp
from repro_torch.train import optim
from repro_torch.tree import map_with_path, paths, tree_map

PyTree = Any


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "meshes and multi-pod gradient sync come with ROADMAP item A14")


def block_opts(run: RunConfig) -> BlockOpts:
    return BlockOpts(freeze_factors=run.lrd.freeze and run.lrd.enabled)


def make_loss_fn(model, run: RunConfig) -> Callable:
    opts = block_opts(run)
    remat = run.parallel.remat

    def loss_fn(params, batch):
        return model.loss(params, batch, opts=opts, remat=remat)
    return loss_fn


def value_and_grad(loss_fn: Callable, params: PyTree, batch: dict
                   ) -> tuple[torch.Tensor, dict, PyTree]:
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch)``: grads in
    ``params``' layout, ``None`` at every leaf that does not require grad
    or that the forward detached."""
    wrt = [(p, t) for p, t in paths(params) if t.requires_grad]
    loss, metrics = loss_fn(params, batch)
    gs = torch.autograd.grad(loss, [t for _, t in wrt], allow_unused=True)
    got = {p: g for (p, _), g in zip(wrt, gs)}
    grads = map_with_path(lambda p, _: got.get(p), params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _microbatch(batch: dict, n: int, i: int) -> dict:
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
            for k, v in batch.items()}


def _add_f32(total, g):
    """``total + g`` in f32, ``None`` counting as zero."""
    if g is None:
        return total
    return g.to(torch.float32) if total is None else total + g


def make_train_step(model, run: RunConfig, opt_cfg: optim.OptimConfig,
                    mesh=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters are updated in place.  ``opt_state`` carries {"adam": ...,
    "ef": ...} when compression is on."""
    _no_mesh(mesh)
    loss_fn = make_loss_fn(model, run)
    accum = max(1, run.parallel.grad_accum)
    use_comp = run.parallel.grad_compression_rank > 0
    comp_cfg = comp.CompressionConfig(rank=run.parallel.grad_compression_rank)

    def grads_of(params, batch):
        if accum == 1:
            return value_and_grad(loss_fn, params, batch)
        gsum = tree_map(lambda _: None, params)
        lsum = 0.0
        for i in range(accum):
            loss, _, g = value_and_grad(loss_fn, params,
                                        _microbatch(batch, accum, i))
            gsum, lsum = tree_map(_add_f32, gsum, g), lsum + loss
        return lsum / accum, {}, tree_map(
            lambda g: None if g is None else g / accum, gsum)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grads_of(params, batch)
        if use_comp:
            grads, ef, _ = comp.compress_decompress(
                grads, opt_state["ef"], comp_cfg, lambda t: t)
            opt_state = dict(opt_state, ef=ef)
        mask = trainable_mask(params, enabled=run.lrd.freeze
                              and run.lrd.enabled)
        params, adam, om = optim.adamw_update(grads, opt_state["adam"],
                                              params, opt_cfg, mask)
        return params, dict(opt_state, adam=adam), dict(metrics, loss=loss,
                                                        **om)
    return train_step


def init_opt_state(model, run: RunConfig, params: PyTree,
                   opt_cfg: optim.OptimConfig,
                   generator: torch.Generator | None = None) -> dict:
    """AdamW state (no moments for the frozen leaves) and, with
    compression, the EF-PowerSGD state (warm-start Qs from ``generator``,
    default seed 17 on the params' device)."""
    mask = trainable_mask(params, enabled=run.lrd.freeze and run.lrd.enabled)
    state = {"adam": optim.adamw_init(params, mask)}
    if run.parallel.grad_compression_rank > 0:
        if generator is None:
            device = state["adam"]["step"].device
            generator = torch.Generator(device=device).manual_seed(17)
        state["ef"] = comp.init_state(
            params, comp.CompressionConfig(
                rank=run.parallel.grad_compression_rank), generator)
    return state


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(model, run: RunConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(model, run: RunConfig) -> Callable:
    @torch.no_grad()
    def decode_step(params, tokens, positions, cache):
        return model.decode_step(params, tokens, positions, cache)
    return decode_step


def make_forward_step(model, run: RunConfig) -> Callable:
    """Full forward returning per-position logits."""
    @torch.no_grad()
    def forward_step(params, batch):
        x, _ = model.forward(params, batch)
        return model.logits(params, x)
    return forward_step
