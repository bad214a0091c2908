"""Model construction, input specs and random inputs for one
(architecture x shape) cell.

``input_specs(cfg, shape)`` gives the ``(shape, dtype)`` of every step
input of a cell without allocating anything: the dry run
(``launch/dryrun.py``) makes fake tensors of them.  Modality frontends
are stubs, as in the reference: the encoder takes precomputed frame
embeddings, the VLM precomputed patch embeddings.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def get_model(cfg: ModelConfig, device: str | torch.device = "cuda"):
    if cfg.family == "resnet":
        from repro_torch.models.resnet import ResNetModel
        return ResNetModel(cfg, device)
    from repro_torch.models.lm import LMModel
    return LMModel(cfg, device)


class TensorSpec(NamedTuple):
    """The shape and dtype of one step input (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                with_labels: bool = True) -> dict[str, TensorSpec]:
    """:class:`TensorSpec` of one (arch x shape) cell's step inputs: the
    names, shapes and dtypes of the reference's ``input_specs``."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    i32 = torch.int32
    if cfg.family == "resnet":
        out = {"images": TensorSpec((b, cfg.img_size, cfg.img_size, 3), dt)}
        if with_labels:
            out["labels"] = TensorSpec((b,), i32)
        return out
    if shape.kind == "decode":
        return {"tokens": TensorSpec((b, 1), i32),
                "positions": TensorSpec((b,), i32)}
    if cfg.family == "encoder":
        out = {"frames": TensorSpec((b, s, cfg.frontend_dim or cfg.d_model),
                                    dt)}
        if with_labels:
            out["labels"] = TensorSpec((b, s), i32)
        return out
    out = {"tokens": TensorSpec((b, s), i32)}
    if cfg.family == "vlm":
        out["image_embeds"] = TensorSpec(
            (b, cfg.num_image_tokens, cfg.vision_d_model or cfg.d_model), dt)
    return out


def synth_inputs(cfg: ModelConfig, shape: ShapeConfig,
                 generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Random inputs of one cell, drawn from ``generator`` on its device
    (the reference's ``input_specs`` / ``synth_inputs``): ``tokens`` (B,
    S) int32 for a train or prefill cell, plus the VLM's ``image_embeds``
    (B, num_image_tokens, vision_d_model or d_model); the encoder's
    ``frames`` (B, S, frontend_dim or d_model) and ``labels`` (B, S)
    int32; ``tokens`` (B, 1) and ``positions`` (B,) for a decode cell;
    ``images`` (B, img, img, 3) and ``labels`` (B,) int32 below
    ``num_classes`` for a ResNet.  Float inputs are normal at std 0.2 in
    the model dtype (the stub frontends' precomputed embeddings)."""
    from repro_torch.models.lm import FAMILIES, missing_family
    b, s = shape.global_batch, shape.seq_len
    dev = generator.device
    dt = getattr(torch, cfg.dtype)

    def normal(*dims: int) -> torch.Tensor:
        return (torch.randn(dims, generator=generator, device=dev)
                * 0.2).to(dt)

    def ints(hi: int, *dims: int) -> torch.Tensor:
        return torch.randint(0, hi, dims, generator=generator, device=dev,
                             dtype=torch.int32)
    if cfg.family == "resnet":
        return {"images": normal(b, cfg.img_size, cfg.img_size, 3),
                "labels": ints(cfg.num_classes, b)}
    if cfg.family not in FAMILIES:
        raise missing_family(cfg.family)
    if shape.kind == "decode":
        return {"tokens": ints(cfg.vocab_size, b, 1),
                "positions": ints(s - 1, b)}
    if cfg.family == "encoder":
        return {"frames": normal(b, s, cfg.frontend_dim or cfg.d_model),
                "labels": ints(cfg.vocab_size, b, s)}
    out = {"tokens": ints(cfg.vocab_size, b, s)}
    if cfg.family == "vlm":
        out["image_embeds"] = normal(b, cfg.num_image_tokens,
                                     cfg.vision_d_model or cfg.d_model)
    return out
