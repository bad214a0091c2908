"""Conv ops with LRD dispatch (dense | 1x1 SVD pair | Tucker-2 | branched
Tucker).

Weights are HWIO ``(k, k, C, S)`` and activations NHWC, as in the
reference.  The LRD surgery rewrites a conv subtree to the Tucker triple
(paper Fig. 1b) or its branched form (Fig. 4), and a 1x1 conv to an SVD
pair; :func:`apply_conv` dispatches on the keys present
(:func:`repro_torch.layers.plan.classify`), so the ResNet code does not
change when a layer is decomposed — the seam ``apply_linear`` is for the
linears.

Every convolution is ``torch.nn.functional.conv2d`` (cuDNN on the card),
as the reference's are ``lax.conv_general_dilated`` outside any Pallas
kernel.  The NHWC activation goes in as its NCHW view (a channels-last
tensor, so no activation is copied) and comes back as the NHWC view of
the channels-last output.  The HWIO weight is permuted to OIHW on each
call; cuDNN copies it into its own layout, about 100 MB over a ResNet-50
forward.  ``SAME`` padding is XLA's: at stride 2 on an even side the
extra row and column go at the bottom and right, which conv2d's
symmetric ``padding`` cannot say, so such a side is padded with
``F.pad`` first.  The branched core runs as a grouped convolution
(``groups=N``), the paper's Fig. 4 equivalence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.param import CONV, EMBED, FFN, ParamBuilder


def init_conv(pb: ParamBuilder, name: str, c_in: int, c_out: int, k: int,
              scale: float | None = None) -> None:
    pb.child(name).param("w", (k, k, c_in, c_out), (CONV, CONV, EMBED, FFN),
                         scale=scale if scale is not None
                         else (c_in * k * k) ** -0.5)


def same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding (before, after) of one side of ``n``."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC tensor (no copy)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """The NHWC view of an NCHW tensor (no copy for a channels-last one)."""
    return x.permute(0, 2, 3, 1)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, groups: int = 1,
          padding: str = "SAME") -> torch.Tensor:
    """NHWC ``x`` through HWIO ``w``; ``padding`` "SAME" or "VALID"."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    xc = nchw(x)
    pad = 0
    if padding == "SAME":
        (t, b), (l, r) = (same_pads(int(x.shape[1]), kh, stride),
                          same_pads(int(x.shape[2]), kw, stride))
        if t == b and l == r:
            pad = (t, l)
        else:
            xc = F.pad(xc, (l, r, t, b))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, padding=pad,
                 groups=groups)
    return nhwc(y)


def _pointwise(x: torch.Tensor, w: torch.Tensor, stride: int = 1
               ) -> torch.Tensor:
    """A 1x1 conv by the (C, S) matrix ``w``."""
    return _conv(x, w[None, None], stride, padding="VALID")


def apply_conv(p: dict, x: torch.Tensor, *, stride: int = 1,
               padding: str = "SAME", name: str = "conv") -> torch.Tensor:
    """NHWC conv through a (possibly decomposed) weight subtree.

    The plan classifies the subtree (quantized or not) and hands back
    each factor, dequantized to ``x.dtype`` (A6's quantized conv
    cores).  The §2.2 freeze is the caller's
    (:func:`repro_torch.core.freezing.stop_frozen_factors`).  A branched
    ``{u, xc, v}`` subtree (a branched 1x1 conv) raises ``ValueError``
    naming ``name``: the reference's ``apply_conv`` reads a ``core`` such
    a subtree does not have (ROADMAP §C)."""
    from repro_torch.layers import plan as lplan
    plan = lplan.build_plan(p)

    def get(factor: str) -> torch.Tensor:
        return plan.value(p, factor, x.dtype)

    if plan.kind == lplan.KIND_DENSE:
        return _conv(x, get("w"), stride, padding=padding)
    if plan.kind == lplan.KIND_LOWRANK:            # 1x1 conv = SVD pair
        return _pointwise(_pointwise(x, get("w0"), stride), get("w1"))
    if plan.kind == lplan.KIND_TUCKER_CONV:        # Tucker-2 triple
        h = _pointwise(x, get("tucker_u"))
        h = _conv(h, get("core"), stride, padding=padding)
        return _pointwise(h, get("tucker_v"))
    if plan.kind == lplan.KIND_BRANCHED:
        raise ValueError(
            f"{name}: a branched {{u, xc, v}} conv subtree (a branched 1x1 "
            "conv) has no conv path; the reference's apply_conv reads a "
            "'core' it does not have (KeyError).  Decompose 1x1 convs "
            "unbranched, or target only the k x k convs")
    # Branched Tucker: u (N, C, r1), core (N, k, k, r1, r2), v (N, r2, S).
    u, core, v = get("u"), get("core"), get("v")
    n, c, r1 = u.shape
    r2, s = v.shape[-2], v.shape[-1]
    # 1) every branch's projection at once: (C, N*r1), branch-major
    h = _pointwise(x, u.movedim(0, 1).reshape(c, n * r1))
    # 2) the block-diagonal core as a grouped conv: HWIO (k, k, r1, N*r2),
    #    the groups contiguous on the output axis, as conv2d takes them
    h = _conv(h, torch.cat(list(core), dim=-1), stride, groups=n,
              padding=padding)
    # 3) the branches summed by one (N*r2, S) 1x1 conv
    return _pointwise(h, v.reshape(n * r2, s))


def conv_out_channels(p: dict) -> int:
    from repro_torch.layers.plan import build_plan
    return build_plan(p).d_out
