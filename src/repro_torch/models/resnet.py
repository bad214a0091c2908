"""Bottleneck ResNet-50/101/152 — the paper's own benchmark architectures.

Built on the same ``(params, axes)`` trees and the conv / linear seams
(:func:`repro_torch.layers.conv.apply_conv`, ``apply_linear``), so the
LRD surgery (SVD on the 1x1 convs and the fc, Tucker-2 on the 3x3 convs)
applies unchanged: the model Tables 1 and 3-6 of the paper are measured
on.  The tree is the reference's key for key (HWIO conv weights, NHWC
activations), so :func:`repro_torch.bridge.to_torch` carries a reference
tree across as it is.

Norms are per-channel scale / bias ("frozen-stats batch norm"): the
paper fine-tunes from a pre-trained model, where folding the running
statistics into scale and bias is standard; it also keeps
:func:`merge_bottleneck` exact.  The fc is a linear: an SVD pair runs the
B1 chain kernel (f32 cluster kernel), an int8 one B3.  The convolutions
are cuDNN's (``layers/conv.py``).

:func:`merge_bottleneck` is the paper's Fig. 3 layer merging: after the
3x3 conv is Tucker-decomposed, its U factor goes into the preceding 1x1
conv and its V factor into the following one, which restores the
original layer count.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FAMILY_RESNET, ModelConfig
from repro_torch.core import merging
from repro_torch.layers.conv import (apply_conv, init_conv, nchw, nhwc,
                                     same_pads)
from repro_torch.layers.param import (EMBED, VOCAB, ParamBuilder,
                                      apply_linear, init_linear)

PyTree = Any


def _stage_widths(cfg: ModelConfig) -> list[tuple[int, int, int]]:
    """(mid, out, stride) of each stage."""
    w = cfg.resnet_width
    return [(w * 2**i, w * 2**i * 4, 1 if i == 0 else 2)
            for i in range(len(cfg.resnet_stage_blocks))]


def analytic_param_count(cfg: ModelConfig) -> int:
    total = 3 * cfg.resnet_width * 49 + cfg.resnet_width * 2   # stem + norm
    c_in = cfg.resnet_width
    for (mid, out, _), n in zip(_stage_widths(cfg), cfg.resnet_stage_blocks):
        for b in range(n):
            total += c_in * mid + mid * mid * 9 + mid * out
            total += 2 * (mid + mid + out)
            if b == 0:
                total += c_in * out + 2 * out
            c_in = out
    total += c_in * cfg.num_classes + cfg.num_classes
    return total


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max pool of NHWC ``x`` with XLA's ``SAME`` padding by
    -inf (the reference's ``reduce_window``): the extra row and column of
    an even side go at the bottom and right, which ``max_pool2d``'s own
    symmetric padding cannot say."""
    (t, b), (l, r) = (same_pads(int(x.shape[1]), 3, 2),
                      same_pads(int(x.shape[2]), 3, 2))
    xc = F.pad(nchw(x), (l, r, t, b), value=float("-inf"))
    return nhwc(F.max_pool2d(xc, 3, 2))


class ResNetModel:
    """init / forward / loss of one bottleneck ResNet on one device."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.family != FAMILY_RESNET:
            raise ValueError(f"ResNetModel takes the resnet family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = getattr(torch, cfg.dtype)

    # -- init ----------------------------------------------------------------

    def init(self, generator: torch.Generator) -> tuple[PyTree, PyTree]:
        cfg = self.cfg
        pb = ParamBuilder(generator, self.dtype, self.device)
        init_conv(pb, "stem", 3, cfg.resnet_width, 7)
        self._init_norm(pb, "stem_norm", cfg.resnet_width)
        c_in = cfg.resnet_width
        for si, ((mid, out, _), n) in enumerate(
                zip(_stage_widths(cfg), cfg.resnet_stage_blocks)):
            stage = pb.child(f"stage{si}")
            for bi in range(n):
                blk = stage.child(f"block{bi}")
                init_conv(blk, "conv1", c_in, mid, 1)
                self._init_norm(blk, "norm1", mid)
                init_conv(blk, "conv2", mid, mid, 3)
                self._init_norm(blk, "norm2", mid)
                init_conv(blk, "conv3", mid, out, 1)
                self._init_norm(blk, "norm3", out)
                if bi == 0:
                    init_conv(blk, "downsample", c_in, out, 1)
                    self._init_norm(blk, "ds_norm", out)
                c_in = out
        init_linear(pb, "fc", c_in, cfg.num_classes, EMBED, VOCAB)
        pb.param("fc_bias", (cfg.num_classes,), (VOCAB,), init="zeros")
        return pb.params, pb.axes

    @staticmethod
    def _init_norm(pb: ParamBuilder, name: str, dim: int) -> None:
        sub = pb.child(name)
        sub.param("scale", (dim,), (EMBED,), init="ones")
        sub.param("bias", (dim,), (EMBED,), init="zeros")

    @staticmethod
    def _norm(p: dict, x: torch.Tensor) -> torch.Tensor:
        return x * p["scale"] + p["bias"]

    # -- forward -------------------------------------------------------------

    def forward(self, params: PyTree, images: torch.Tensor, *,
                freeze_factors: bool = False) -> torch.Tensor:
        """Logits (B, num_classes) in f32 of NHWC ``images``.
        ``freeze_factors``: the forward half of the §2.2 freeze (the
        teacher-derived factors detached)."""
        if freeze_factors:
            from repro_torch.core.freezing import stop_frozen_factors
            params = stop_frozen_factors(params)
        x = apply_conv(params["stem"], images, stride=2, name="stem")
        x = _max_pool_same(torch.relu(self._norm(params["stem_norm"], x)))
        for si, ((_, _, stride), n) in enumerate(
                zip(_stage_widths(self.cfg), self.cfg.resnet_stage_blocks)):
            stage = params[f"stage{si}"]
            for bi in range(n):
                blk = stage[f"block{bi}"]
                at = f"stage{si}/block{bi}/"
                s = stride if bi == 0 else 1
                h = apply_conv(blk["conv1"], x, name=at + "conv1")
                h = torch.relu(self._norm(blk["norm1"], h))
                h = apply_conv(blk["conv2"], h, stride=s, name=at + "conv2")
                h = torch.relu(self._norm(blk["norm2"], h))
                h = apply_conv(blk["conv3"], h, name=at + "conv3")
                h = self._norm(blk["norm3"], h)
                if "downsample" in blk:
                    x = apply_conv(blk["downsample"], x, stride=s,
                                   name=at + "downsample")
                    x = self._norm(blk["ds_norm"], x)
                x = torch.relu(x + h)
        x = x.mean(dim=(1, 2))
        logits = apply_linear(params["fc"], x)
        return logits.to(torch.float32) + params["fc_bias"]

    def loss(self, params: PyTree, batch: dict, *, opts=None,
             remat: str = "none") -> tuple[torch.Tensor, dict]:
        """Mean cross-entropy and accuracy of ``batch`` (``images``,
        ``labels``), as :meth:`LMModel.loss` takes its arguments:
        ``opts`` (``models.blocks.BlockOpts``) carries the §2.2 freeze;
        the ResNets have no remat."""
        if remat != "none":
            raise ValueError(f"remat {remat!r}: the ResNets run without "
                             "activation checkpointing")
        logits = self.forward(params, batch["images"], freeze_factors=(
            opts is not None and opts.freeze_factors))
        labels = batch["labels"].long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, None])[:, 0]
        loss = (logz - gold).mean()
        acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        return loss, {"ce": loss, "acc": acc}

    @staticmethod
    def layer_count(params: PyTree) -> int:
        """Weighted-layer count as the paper counts it (convs + fc)."""
        count = 0

        def visit(p):
            nonlocal count
            if isinstance(p, dict):
                keys = set(p)
                if "w" in keys and p["w"].ndim >= 2:
                    count += 1
                elif "tucker_u" in keys:
                    count += 3
                elif "core" in keys and "u" in keys:
                    count += 3
                elif "w0" in keys:
                    count += 2
                elif "u" in keys and "xc" in keys:
                    count += 3
                else:
                    for v in p.values():
                        visit(v)
        visit(params)
        return count


def merge_bottleneck(params: PyTree) -> PyTree:
    """Paper §2.3 / Fig. 3: absorb the Tucker 1x1 factors into the
    neighbouring 1x1 convs of every bottleneck, restoring the original
    layer count.

    Expects conv2 subtrees decomposed as ``{"tucker_u", "core",
    "tucker_v"}`` and dense conv1 / conv3.  Returns a new tree (untouched
    leaves shared) where

        conv1' = conv1 @ U,  conv2' = core,  conv3' = V @ conv3,

    and norm1 / norm2, which now act in the R1 / R2 bases, are reset to
    identity scale and zero bias, as the reference resets them."""
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in params.items()}
    for sk, stage in out.items():
        if not (isinstance(stage, dict) and sk.startswith("stage")):
            continue
        for bk, blk in list(stage.items()):
            if not (isinstance(blk, dict) and "conv2" in blk):
                continue
            c2 = blk["conv2"]
            if "tucker_u" not in c2:
                continue
            if "w" not in blk["conv1"] or "w" not in blk["conv3"]:
                raise ValueError(f"{sk}/{bk}: merging needs dense 1x1 "
                                 "neighbours of conv2")
            core = c2["core"]
            r1, r2 = int(core.shape[-2]), int(core.shape[-1])
            like = dict(dtype=core.dtype, device=core.device)
            stage[bk] = dict(
                blk,
                conv1={"w": merging.merge_conv1x1_into_u(
                    blk["conv1"]["w"], c2["tucker_u"])},
                conv3={"w": merging.merge_v_into_conv1x1(
                    c2["tucker_v"], blk["conv3"]["w"])},
                norm1={"scale": torch.ones(r1, **like),
                       "bias": torch.zeros(r1, **like)},
                norm2={"scale": torch.ones(r2, **like),
                       "bias": torch.zeros(r2, **like)},
                conv2={"w": core})
    return out
