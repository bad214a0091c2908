"""Feed-forward blocks (SwiGLU / GELU) over the linear-op dispatch seam."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.param import (EMBED, FFN, ParamBuilder, apply_linear,
                                      init_linear)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu``: its default is the tanh
    approximation, not the exact erf form."""
    return F.gelu(x, approximate="tanh")


def init_mlp(pb: ParamBuilder, name: str, d_model: int, d_ff: int,
             act: str = "swiglu") -> None:
    sub = pb.child(name)
    init_linear(sub, "up", d_model, d_ff, EMBED, FFN)
    if act == "swiglu":
        init_linear(sub, "gate", d_model, d_ff, EMBED, FFN)
    init_linear(sub, "down", d_ff, d_model, FFN, EMBED)


def ffn_hidden(up: torch.Tensor, gate: torch.Tensor | None, act: str,
               dtype: torch.dtype) -> torch.Tensor:
    """The hidden activation of an FFN in f32, rounded to ``dtype``:
    ``silu(gate) * up`` for SwiGLU, ``gelu(up)`` for GELU."""
    if act == "swiglu":
        return F.silu(gate.to(torch.float32)).to(dtype) * up
    if act == "gelu":
        return gelu(up.to(torch.float32)).to(dtype)
    raise ValueError(f"unknown act {act}")


def apply_mlp(p: dict, x: torch.Tensor, act: str = "swiglu", *,
              act_quantize: bool = False) -> torch.Tensor:
    up = apply_linear(p["up"], x, act_quantize=act_quantize)
    gate = (apply_linear(p["gate"], x, act_quantize=act_quantize)
            if act == "swiglu" else None)
    h = ffn_hidden(up, gate, act, x.dtype)
    return apply_linear(p["down"], h, act_quantize=act_quantize)
