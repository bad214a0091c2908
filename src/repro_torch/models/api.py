"""Model construction."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def get_model(cfg: ModelConfig, device: str | torch.device = "cuda"):
    if cfg.family == "resnet":
        raise NotImplementedError("ResNet comes with ROADMAP item A13")
    from repro_torch.models.lm import LMModel
    return LMModel(cfg, device)
