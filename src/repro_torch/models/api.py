"""Model construction + random inputs for one (architecture x shape) cell."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def get_model(cfg: ModelConfig, device: str | torch.device = "cuda"):
    from repro_torch.models.lm import LMModel
    return LMModel(cfg, device)


def synth_inputs(cfg: ModelConfig, shape: ShapeConfig,
                 generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random inputs of one cell, drawn from ``generator`` on its device
    (the reference's ``input_specs`` / ``synth_inputs`` for the dense,
    MoE, SSM and hybrid families): ``tokens`` (B, S) int32 for a train or prefill cell;
    ``tokens`` (B, 1) and ``positions`` (B,) for a decode cell."""
    from repro_torch.models.lm import FAMILIES, missing_family
    if cfg.family not in FAMILIES:
        raise missing_family(cfg.family)
    b, s = shape.global_batch, shape.seq_len
    dev = generator.device
    if shape.kind == "decode":
        return {"tokens": torch.randint(0, cfg.vocab_size, (b, 1),
                                        generator=generator, device=dev,
                                        dtype=torch.int32),
                "positions": torch.randint(0, s - 1, (b,),
                                           generator=generator, device=dev,
                                           dtype=torch.int32)}
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                    generator=generator, device=dev,
                                    dtype=torch.int32)}
