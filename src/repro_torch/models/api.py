"""Model construction + random inputs for one (architecture x shape) cell."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def get_model(cfg: ModelConfig, device: str | torch.device = "cuda"):
    if cfg.family == "resnet":
        from repro_torch.models.resnet import ResNetModel
        return ResNetModel(cfg, device)
    from repro_torch.models.lm import LMModel
    return LMModel(cfg, device)


def synth_inputs(cfg: ModelConfig, shape: ShapeConfig,
                 generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random inputs of one cell, drawn from ``generator`` on its device
    (the reference's ``input_specs`` / ``synth_inputs`` for the dense,
    MoE, SSM, hybrid and ResNet families): ``tokens`` (B, S) int32 for a
    train or prefill cell; ``tokens`` (B, 1) and ``positions`` (B,) for a
    decode cell; ``images`` (B, img, img, 3) in the model dtype and
    ``labels`` (B,) int32 below ``num_classes`` for a ResNet."""
    from repro_torch.models.lm import FAMILIES, missing_family
    b, s = shape.global_batch, shape.seq_len
    dev = generator.device
    if cfg.family == "resnet":
        images = torch.randn((b, cfg.img_size, cfg.img_size, 3),
                             generator=generator, device=dev) * 0.2
        return {"images": images.to(getattr(torch, cfg.dtype)),
                "labels": torch.randint(0, cfg.num_classes, (b,),
                                        generator=generator, device=dev,
                                        dtype=torch.int32)}
    if cfg.family not in FAMILIES:
        raise missing_family(cfg.family)
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
