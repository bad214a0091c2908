"""RMSNorm, LayerNorm (the encoder's) and mamba2's gated RMSNorm, with
f32 internals."""
from __future__ import annotations

import torch

from repro_torch.layers.param import EMBED, ParamBuilder


def init_rms_norm(pb: ParamBuilder, name: str, dim: int) -> None:
    pb.child(name).param("scale", (dim,), (EMBED,), init="ones")


def rms_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def init_layer_norm(pb: ParamBuilder, name: str, dim: int) -> None:
    sub = pb.child(name)
    sub.param("scale", (dim,), (EMBED,), init="ones")
    sub.param("bias", (dim,), (EMBED,), init="zeros")


def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def gated_rms_norm(p: dict, x: torch.Tensor, gate: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's RMSNormGated: normalize(x * silu(gate))."""
    xf = x.to(torch.float32) * torch.nn.functional.silu(
        gate.to(torch.float32))
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)
