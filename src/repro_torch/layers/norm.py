"""RMSNorm with f32 internals."""
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
