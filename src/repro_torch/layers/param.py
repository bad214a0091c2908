"""Parameter construction + the linear-op dispatch seam.

Params are plain nested dicts of tensors in the reference's layout
(``(d_in, d_out)`` weights).  :class:`ParamBuilder` builds two parallel
trees: ``params`` (the tensors) and ``axes`` (tuples of logical axis
names; surgery reads the leading ``layers`` axis from them).  Random
values come from an explicit ``torch.Generator``.

LRD surgery replaces a dense leaf ``{"w": W}`` with ``{"w0", "w1"}`` (SVD
pair) or ``{"u", "xc", "v"}`` (branched); :func:`apply_linear` dispatches
on the keys present, so model code never changes when a layer is
decomposed.
"""
from __future__ import annotations

import math
from typing import Any

import torch

PyTree = Any

# Logical axis names (the reference's names).
LAYERS = "layers"
EMBED = "embed"
FFN = "ffn"
QKV = "qkv"
VOCAB = "vocab"
EXPERTS = "experts"
RANK = "rank"
BRANCH = "branch"
CONV = "conv"


class ParamBuilder:
    """Builds ``(params, axes)`` trees drawing from one generator."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device: str | torch.device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self.params: dict = {}
        self.axes: dict = {}

    def param(self, name: str, shape: tuple[int, ...], axes: tuple,
              init: str = "normal", scale: float | None = None,
              dtype: torch.dtype | None = None) -> None:
        assert len(shape) == len(axes), (name, shape, axes)
        dtype = dtype or self.dtype
        if init in ("normal", "embed"):
            if init == "normal":
                fan_in = shape[0] if len(shape) >= 2 else shape[-1]
                std = scale if scale is not None else \
                    1.0 / math.sqrt(max(fan_in, 1))
            else:
                std = scale if scale is not None else 1.0
            v = torch.randn(shape, generator=self.generator,
                            dtype=torch.float32, device=self.device) * std
        elif init == "zeros":
            v = torch.zeros(shape, dtype=torch.float32, device=self.device)
        elif init == "ones":
            v = torch.ones(shape, dtype=torch.float32, device=self.device)
        else:
            raise ValueError(f"unknown init {init}")
        self.params[name] = v.to(dtype)
        self.axes[name] = tuple(axes)

    def child(self, name: str) -> "ParamBuilder":
        sub = ParamBuilder(self.generator, self.dtype, self.device)
        self.params[name] = sub.params
        self.axes[name] = sub.axes
        return sub

    def attach(self, name: str, params: PyTree, axes: PyTree) -> None:
        self.params[name] = params
        self.axes[name] = axes


def init_linear(pb: ParamBuilder, name: str, d_in: int, d_out: int,
                axes_in, axes_out, scale: float | None = None) -> None:
    """A dense linear op; LRD surgery may later rewrite the subtree."""
    pb.child(name).param("w", (d_in, d_out), (axes_in, axes_out),
                         scale=scale)


def apply_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Apply a (possibly decomposed) linear op to ``x`` (..., d_in)."""
    from repro_torch.layers.plan import build_plan
    return build_plan(p).execute(p, x)


def linear_flops(p: dict, n_tokens: int) -> float:
    """Forward matmul FLOPs for ``n_tokens`` rows through this op."""
    from repro_torch.layers.plan import build_plan
    return build_plan(p).flops_per_token * n_tokens
