"""SwiGLU feed-forward block over the linear-op dispatch seam."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.param import (EMBED, FFN, ParamBuilder, apply_linear,
                                      init_linear)


def init_mlp(pb: ParamBuilder, name: str, d_model: int, d_ff: int,
             act: str = "swiglu") -> None:
    if act != "swiglu":
        raise NotImplementedError(
            f"act {act!r}: the port serves SwiGLU stacks; other families "
            "come with ROADMAP item A13")
    sub = pb.child(name)
    init_linear(sub, "up", d_model, d_ff, EMBED, FFN)
    init_linear(sub, "gate", d_model, d_ff, EMBED, FFN)
    init_linear(sub, "down", d_ff, d_model, FFN, EMBED)


def apply_mlp(p: dict, x: torch.Tensor, *,
              act_quantize: bool = False) -> torch.Tensor:
    up = apply_linear(p["up"], x, act_quantize=act_quantize)
    gate = apply_linear(p["gate"], x, act_quantize=act_quantize)
    h = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    return apply_linear(p["down"], h, act_quantize=act_quantize)
