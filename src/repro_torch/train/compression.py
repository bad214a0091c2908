"""PowerSGD-style low-rank gradient compression with error feedback.

A gradient matrix ``G (C, S)`` is factorized per sync as ``P (C, r) @
Q (S, r)^T`` with one power iteration warm-started from the previous Q;
only P and Q would cross the slow link.  The compression residual is fed
back into the next step's gradient (error feedback).  Tensors that are
not 2-D+ or too small to win pass uncompressed.

The reference runs this inside a ``shard_map`` over the ``pod`` mesh
axis; the port trains on one device, so ``reduce_fn`` is the identity
there (multi-pod sync comes with ROADMAP item A14).  A ``None``
gradient leaf (a factor the forward detached) passes through as
``None`` with its state unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.tree import leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    rank: int = 4
    min_dim: int = 64          # don't compress tensors smaller than this
    power_iters: int = 1


def _compressible(shape: tuple[int, ...], cfg: CompressionConfig) -> bool:
    if len(shape) < 2:
        return False
    c = math.prod(shape[:-1])
    s = shape[-1]
    if min(c, s) < cfg.min_dim:
        return False
    return cfg.rank * (c + s) < c * s       # compression actually wins


def init_state(grads: PyTree, cfg: CompressionConfig,
               generator: torch.Generator) -> PyTree:
    """Per leaf of ``grads`` (any tree of tensors of the gradients'
    shapes): an error-feedback buffer and, where compressible, a
    warm-start Q drawn from ``generator``."""
    def leaf(g):
        if not _compressible(tuple(g.shape), cfg):
            return {"err": torch.zeros((0,), dtype=torch.float32,
                                       device=g.device)}
        return {"err": torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device),
                "q": torch.randn((g.shape[-1], cfg.rank), generator=generator,
                                 device=generator.device).to(g.device)}
    return tree_map(leaf, grads)


def compress_decompress(grads: PyTree, state: PyTree, cfg: CompressionConfig,
                        reduce_fn: Callable[[torch.Tensor], torch.Tensor]
                        ) -> tuple[PyTree, PyTree, dict]:
    """EF-PowerSGD round: returns ``(synced_grads, new_state, stats)``.
    ``reduce_fn`` is the mean-reduction across the sync group, applied to
    P and Q of a compressed tensor and to an uncompressed gradient."""
    def leaf(g, st):
        """(synced gradient, new state, bytes raw, bytes sent)."""
        if g is None:
            return None, st, 0, 0
        if "q" not in st:
            return reduce_fn(g), st, g.numel() * 4, g.numel() * 4
        gf = g.to(torch.float32).reshape(-1, g.shape[-1])    # (C, S)
        gf = gf + st["err"].reshape(gf.shape)                 # error feedback
        q = st["q"]
        for _ in range(cfg.power_iters):
            p = reduce_fn(gf @ q)                             # (C, r)
            p, _ = torch.linalg.qr(p)                         # orthonormal
            q = reduce_fn(gf.t() @ p)                         # (S, r)
        ghat = p @ q.t()
        return (ghat.reshape(g.shape).to(g.dtype),
                {"err": (gf - ghat).reshape(g.shape), "q": q},
                g.numel() * 4, (p.numel() + q.numel()) * 4)

    out = tree_map(leaf, grads, state)
    parts = leaves(out)
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out),
            {"bytes_raw": sum(t[2] for t in parts),
             "bytes_sent": sum(t[3] for t in parts)})
