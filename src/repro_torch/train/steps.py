"""The train / prefill / decode / forward step functions.

* :func:`make_train_step` — loss -> gradients (``grad_accum``
  micro-batches, the remat policy) -> optional EF-PowerSGD -> masked
  AdamW.  Gradients come from ``torch.autograd.grad`` over the leaves
  that require grad; a factor the freeze policy detached gets ``None``.
  With a mesh the parameters are a placed tree
  (``parallel/placement.py``): every rank holds its shards, the model
  gathers each block's leaves at use, the batch splits over ``(pod,
  data)`` and the gradients come back as shards averaged over ``data``.
  Over ``pod`` they are synced by EF-PowerSGD when
  ``grad_compression_rank > 0`` (the reference's ``shard_map`` manual
  over ``pod``, ``repro/train/steps.py:95-110``: ``compress_decompress``
  with the mean over the pod ranks as its ``reduce_fn``), else by a
  plain mean.
* :func:`make_prefill_step` / :func:`make_decode_step` /
  :func:`make_forward_step` — the serving pair and the encoder-style
  forward, without autograd.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core.freezing import trainable_mask
from repro_torch.models.blocks import BlockOpts
from repro_torch.parallel import placement
from repro_torch.parallel.sharding import mesh_shape
from repro_torch.train import compression as comp
from repro_torch.train import optim
from repro_torch.tree import map_with_path, paths, tree_map

PyTree = Any


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


def _compress_placed(grads: PyTree, state: PyTree, params: PyTree,
                     cfg: comp.CompressionConfig,
                     reduce_fn: Callable) -> tuple[PyTree, PyTree]:
    """``compress_decompress`` of each leaf's whole gradient and error
    buffer, gathered from the shards (laid out as ``params``), a leaf at
    a time; returns this rank's shards of the synced gradients and of the
    new error buffers."""
    def leaf(g, st, p):
        if g is None or "q" not in st:
            return comp.compress_decompress(g, st, cfg, reduce_fn)[:2]

        def whole(t):
            return placement.whole(placement.like(t, p))
        g2, st2, _ = comp.compress_decompress(
            whole(g), {"err": whole(st["err"]), "q": st["q"]}, cfg,
            reduce_fn)
        return (placement.shard_of(g2, p.spec, p.mesh),
                {"err": placement.shard_of(st2["err"], p.spec, p.mesh),
                 "q": st2["q"]})
    out = tree_map(leaf, grads, state, params)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def make_synced_grads(model, run: RunConfig, mesh=None) -> Callable:
    """``(params, opt_state, batch) -> (loss, metrics, grads, ef)``: a
    step's gradients, synced as :func:`make_train_step` syncs them, and
    the new EF-PowerSGD state (``None`` without compression)."""
    loss_fn = make_loss_fn(model, run)
    accum = max(1, run.parallel.grad_accum)
    use_comp = run.parallel.grad_compression_rank > 0
    comp_cfg = comp.CompressionConfig(rank=run.parallel.grad_compression_rank)
    pod = mesh is not None and "pod" in mesh_shape(mesh)

    def grads_of(fn, params, batch):
        if accum == 1:
            return value_and_grad(fn, params, batch)
        gsum = tree_map(lambda _: None, params)
        lsum = 0.0
        for i in range(accum):
            loss, _, g = value_and_grad(fn, params,
                                        _microbatch(batch, accum, i))
            gsum, lsum = tree_map(_add_f32, gsum, g), lsum + loss
        return lsum / accum, {}, tree_map(
            lambda g: None if g is None else g / accum, gsum)

    def synced_grads(params, opt_state, batch):
        if mesh is None:
            loss, metrics, grads = grads_of(loss_fn, params, batch)
            if not use_comp:
                return loss, metrics, grads, None
            grads, ef, _ = comp.compress_decompress(
                grads, opt_state["ef"], comp_cfg, lambda t: t)
            return loss, metrics, grads, ef
        loss, metrics, grads = grads_of(
            lambda t, b: loss_fn(placement.like(t, params), b),
            placement.shards(params), placement.local_rows(batch, mesh))
        loss = placement.mean_over(torch.as_tensor(loss), mesh,
                                   placement.BATCH_AXES)
        def reduce_fn(t):
            return placement.mean_over(t, mesh, ("pod",)) if pod else t
        ef = None
        if use_comp:
            grads, ef = _compress_placed(grads, opt_state["ef"], params,
                                         comp_cfg, reduce_fn)
        elif pod:
            grads = tree_map(lambda g: None if g is None else reduce_fn(g),
                             grads)
        return loss, metrics, grads, ef
    return synced_grads


def make_train_step(model, run: RunConfig, opt_cfg: optim.OptimConfig,
                    mesh=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters are updated in place.  ``opt_state`` carries {"adam": ...,
    "ef": ...} when compression is on.  With a ``mesh`` (a
    ``DeviceMesh`` over ``pod`` / ``data`` / ``model``) ``params`` is a
    placed tree, ``batch`` the global batch (the same on every rank) and
    ``opt_state`` :func:`init_opt_state`'s of that tree: the moments and
    the error buffers are shards laid out as their parameters, and the
    clip's global norm sums the shards over the mesh."""
    synced_grads = make_synced_grads(model, run, mesh)

    def train_step(params, opt_state, batch):
        loss, metrics, grads, ef = synced_grads(params, opt_state, batch)
        if ef is not None:
            opt_state = dict(opt_state, ef=ef)
        tensors = params if mesh is None else placement.shards(params)
        mask = trainable_mask(tensors, enabled=run.lrd.freeze
                              and run.lrd.enabled)
        gnorm = (None if mesh is None
                 else placement.global_norm(grads, params))
        _, adam, om = optim.adamw_update(grads, opt_state["adam"], tensors,
                                         opt_cfg, mask, gnorm=gnorm)
        return params, dict(opt_state, adam=adam), dict(metrics, loss=loss,
                                                        **om)
    return train_step


def init_opt_state(model, run: RunConfig, params: PyTree,
                   opt_cfg: optim.OptimConfig,
                   generator: torch.Generator | None = None) -> dict:
    """AdamW state (no moments for the frozen leaves) and, with
    compression, the EF-PowerSGD state (warm-start Qs from ``generator``,
    default seed 17 on the params' device).  Of a placed tree: the
    moments and the error buffers as shards of their parameters, each Q
    (the whole gradient's last dim by the rank) whole on every rank."""
    placed = placement.is_placed(params)
    tensors = placement.shards(params) if placed else params
    mask = trainable_mask(tensors, enabled=run.lrd.freeze and run.lrd.enabled)
    state = {"adam": optim.adamw_init(tensors, mask)}
    if run.parallel.grad_compression_rank > 0:
        if generator is None:
            device = state["adam"]["step"].device
            generator = torch.Generator(device=device).manual_seed(17)
        cfg = comp.CompressionConfig(rank=run.parallel.grad_compression_rank)
        if not placed:
            state["ef"] = comp.init_state(params, cfg, generator)
        else:
            def leaf(p):
                st = comp.init_state(p, cfg, generator)  # whole shapes
                if "q" in st:
                    st["err"] = placement.shard_of(st["err"], p.spec,
                                                   p.mesh)
                return st
            state["ef"] = tree_map(leaf, params)
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
