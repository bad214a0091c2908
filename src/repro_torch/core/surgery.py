"""Whole-model LRD surgery — applies the paper's technique to a param tree.

``decompose_model(params, axes, lrd)`` walks the ``(params, axes)`` trees
built by :class:`repro_torch.layers.param.ParamBuilder`, labels every
linear subtree ``{"w": ...}`` by its path, picks a rank per
:mod:`repro_torch.core.rank_selection` (``rank_mode="search"``: the
paper's Algorithm 1 on the H100 cost model, at ``m_tokens`` rows) and
rewrites the subtree:

    {"w": (.., C, S)} -> {"w0": (.., C, R), "w1": (.., R, S)}     SVD pair
                      -> {"u": (.., N, C, r), "xc": (.., N, r, r),
                          "v": (.., N, r, S)}                     branched
                      -> unchanged                     (skip / ORG)

Stacked-layer weights (leading ``layers`` axis) and MoE expert banks
(leading ``experts`` axis, after the layers') decompose batched, so every
layer of a stack and every expert of a bank share one rank.

Conv weights (the ResNets, axes ``(conv, conv, ., .)``): a 1x1 conv is
an FC layer (paper Fig. 1a), labelled ``conv1x1`` and decomposed as one
on its ``(C, S)`` matrix; a k x k conv goes through Tucker-2
(:mod:`repro_torch.core.tucker`), ranks from paper Eq. 7 (``ratio``),
snapped (``aligned``) or searched by Algorithm 1 on the ``"tucker"``
cost-model timer (``search``):

    {"w": (k, k, C, S)} -> {"tucker_u": (C, R1), "core": (k, k, R1, R2),
                            "tucker_v": (R2, S)}
    or branched          -> {"u": (N, C, r1), "core": (N, k, k, r1, r2),
                             "v": (N, r2, S)}

The decisions go into a :class:`SurgeryReport`, field for field the
reference's.  :func:`sparsify_model` then 2:4-packs the factors (the
third compression axis).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import LRDConfig
from repro_torch.core import cost_model as cm
from repro_torch.core import rank_selection as rs
from repro_torch.core.branching import (branch_svd, branch_tucker,
                                        quantize_ranks)
from repro_torch.core.svd import decompose_auto
from repro_torch.core.tucker import ratio_ranks, tucker2_decompose
from repro_torch.layers.param import (BRANCH, CONV, EXPERTS, LAYERS, RANK,
                                      linear_flops)

PyTree = Any

_LABELS: dict[tuple[str, str], str] = {
    ("attn", "q"): "attn_q", ("attn", "k"): "attn_k",
    ("attn", "v"): "attn_v", ("attn", "o"): "attn_o",
    ("cross_attn", "q"): "attn_q", ("cross_attn", "k"): "attn_k",
    ("cross_attn", "v"): "attn_v", ("cross_attn", "o"): "attn_o",
    ("mla", "o"): "attn_o",
    ("mla", "q_a"): "mla_qa", ("mla", "q_b"): "mla_qb",
    ("mla", "kv_a"): "mla_kva", ("mla", "kv_b"): "mla_kvb",
    ("mlp", "up"): "ffn_up", ("mlp", "gate"): "ffn_gate",
    ("mlp", "down"): "ffn_down",
    ("shared", "up"): "ffn_up", ("shared", "gate"): "ffn_gate",
    ("shared", "down"): "ffn_down",
    ("experts", "up"): "moe_up", ("experts", "gate"): "moe_gate",
    ("experts", "down"): "moe_down",
    ("ssm", "in_proj"): "ssm_in", ("ssm", "out_proj"): "ssm_out",
}


def classify_path(path: tuple[str, ...]) -> str:
    """Target label for a linear subtree at ``path``."""
    if not path:
        return "unknown"
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if (parent, leaf) in _LABELS:
        return _LABELS[(parent, leaf)]
    if leaf.startswith("conv") or leaf == "downsample":
        return "conv"
    return leaf


@dataclasses.dataclass
class LayerDecision:
    path: str
    label: str
    kind: str                  # "svd" | "branched" | "tucker" |
                               # "branched_tucker" | "org" | "skip"
    shape: tuple[int, ...]
    rank: int | tuple[int, int] | None
    params_before: int
    params_after: int
    flops_before: float        # per input row / output pixel (forward)
    flops_after: float
    reason: str = ""


@dataclasses.dataclass
class SurgeryReport:
    decisions: list[LayerDecision] = dataclasses.field(default_factory=list)

    @property
    def params_before(self) -> int:
        return sum(d.params_before for d in self.decisions)

    @property
    def params_after(self) -> int:
        return sum(d.params_after for d in self.decisions)

    @property
    def decomposed(self) -> list[LayerDecision]:
        return [d for d in self.decisions if d.kind not in ("org", "skip")]

    def summary(self) -> dict:
        fb = sum(d.flops_before for d in self.decisions)
        fa = sum(d.flops_after for d in self.decisions)
        return {
            "layers_seen": len(self.decisions),
            "layers_decomposed": len(self.decomposed),
            "params_before": self.params_before,
            "params_after": self.params_after,
            "param_ratio": self.params_after / max(1, self.params_before),
            "flops_ratio": fa / max(1e-30, fb),
        }


def _is_linear_node(node: Any) -> bool:
    return (isinstance(node, dict) and set(node) == {"w"}
            and isinstance(node["w"], torch.Tensor))


def _batch_dims(ax: tuple) -> int:
    n = 0
    for a in ax:
        if a not in (LAYERS, EXPERTS):
            break
        n += 1
    return n


def _is_conv(ax: tuple) -> bool:
    core = ax[_batch_dims(ax):]
    return len(core) == 4 and core[0] == CONV and core[1] == CONV


def _decompose_linear(w: torch.Tensor, ax: tuple, lrd: LRDConfig,
                      m_tokens: int, cache: dict
                      ) -> tuple[dict | None, dict | None, str, Any]:
    """Returns (new_params, new_axes, kind, rank) or (None, None,
    "skip"/"org", reason)."""
    nb = _batch_dims(ax)
    c, s = int(w.shape[-2]), int(w.shape[-1])
    if min(c, s) < lrd.min_dim:
        return None, None, "skip", f"min_dim({min(c, s)}<{lrd.min_dim})"
    if (c, s) not in cache:
        cache[(c, s)] = rs.select_rank(
            c, s, compression=lrd.compression, mode=lrd.rank_mode,
            align=lrd.rank_align, rank_min_frac=lrd.rank_min_frac,
            m_tokens=m_tokens)
    rank = cache[(c, s)]
    if rank == rs.ORG:
        return None, None, "org", "algorithm1: dense layer faster"
    batch_ax = ax[:nb]
    in_ax, out_ax = ax[-2], ax[-1]
    n = lrd.branches
    if n > 1 and rank // n >= max(lrd.rank_align, 1):
        f = branch_svd(w, rank, n)
        params = {"u": f.u, "xc": f.xc, "v": f.v}
        axes = {"u": (*batch_ax, BRANCH, in_ax, RANK),
                "xc": (*batch_ax, BRANCH, RANK, RANK),
                "v": (*batch_ax, BRANCH, RANK, out_ax)}
        return params, axes, "branched", quantize_ranks(rank, rank, n)[0]
    f = decompose_auto(w, rank)
    params = {"w0": f.w0.contiguous(), "w1": f.w1.contiguous()}
    axes = {"w0": (*batch_ax, in_ax, RANK), "w1": (*batch_ax, RANK, out_ax)}
    return params, axes, "svd", rank


def _decompose_conv(w: torch.Tensor, ax: tuple, lrd: LRDConfig,
                    m_tokens: int
                    ) -> tuple[dict | None, dict | None, str, Any]:
    """A k x k conv's Tucker-2 (or branched Tucker) rewrite, as
    :func:`_decompose_linear` returns a linear's.  ``search`` runs
    Algorithm 1 on the cost model at an output of ``m_tokens`` pixels
    (H100 by default), with r2 following r1 at the ratio S / C."""
    kh, _, c, s = (int(d) for d in w.shape)
    if min(c, s) < lrd.min_dim // 4:     # convs are smaller than FC layers
        return None, None, "skip", f"min_dim({min(c, s)})"
    r1, r2 = ratio_ranks(c, s, kh, lrd.compression)
    if lrd.rank_mode == "aligned":
        r1 = rs.align_rank(r1, min(lrd.rank_align, max(8, c // 2)))
        r2 = rs.align_rank(r2, min(lrd.rank_align, max(8, s // 2)))
    elif lrd.rank_mode == "search":
        beta = s / c
        timer = cm.make_model_timer(m_tokens, c, s, kind="tucker", k=kh,
                                    beta=beta)
        t_dense = cm.conv_time(int(m_tokens ** 0.5) or 1, c, s, kh)
        dec = rs.algorithm1(timer, t_dense, r1,
                            max(1, int(r1 * lrd.rank_min_frac)),
                            step=1 if r1 <= 512 else 8)
        if dec.rank == rs.ORG:
            return None, None, "org", "algorithm1: dense conv faster"
        r1 = dec.rank
        r2 = max(1, int(round(beta * r1)))
    n = lrd.branches
    if n > 1 and min(r1, r2) // n >= 8:
        f = branch_tucker(w, r1, r2, n)
        params = {"u": f.u, "core": f.core, "v": f.v}
        axes = {"u": (BRANCH, ax[-2], RANK),
                "core": (BRANCH, CONV, CONV, RANK, RANK),
                "v": (BRANCH, RANK, ax[-1])}
        return params, axes, "branched_tucker", quantize_ranks(r1, r2, n)
    f = tucker2_decompose(w, r1, r2)
    params = {"tucker_u": f.u, "core": f.core, "tucker_v": f.v}
    axes = {"tucker_u": (ax[-2], RANK), "core": (CONV, CONV, RANK, RANK),
            "tucker_v": (RANK, ax[-1])}
    return params, axes, "tucker", (r1, r2)


def _count(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return int(tree.numel())


def _fwd_flops(params: dict, conv: bool = False) -> float:
    """Forward FLOPs per row (linear, on the innermost (unstacked) factor
    dims) or per output pixel (a k x k conv: a dense one counts its
    window here, a Tucker one through its plan's chain)."""
    if conv:
        if "w" in params:
            kh, kw, c, s = params["w"].shape[-4:]
            return 2.0 * kh * kw * c * s
        return linear_flops(params, 1)

    def inner(k: str, v: torch.Tensor) -> torch.Tensor:
        nd = 3 if k in ("u", "xc", "v") else 2
        return v[(0,) * (v.ndim - nd)] if v.ndim > nd else v
    return linear_flops({k: inner(k, v) for k, v in params.items()}, 1)


def decompose_model(params: PyTree, axes: PyTree, lrd: LRDConfig, *,
                    m_tokens: int = 4096
                    ) -> tuple[PyTree, PyTree, SurgeryReport]:
    """Apply LRD to every targeted linear and conv subtree.  Returns
    rewritten copies of both trees (untouched leaves are shared, not
    copied) plus the decision report.  ``m_tokens``: the rows (a conv's
    output pixels) Algorithm 1's cost model times each candidate rank at
    (``rank_mode="search"``)."""
    report = SurgeryReport()
    if not lrd.enabled:
        return params, axes, report
    targets = set(lrd.targets)
    rank_cache: dict = {}

    def walk(p: Any, a: Any, path: tuple[str, ...]) -> tuple[Any, Any]:
        if _is_linear_node(p):
            label = classify_path(path)
            w, ax = p["w"], a["w"]
            conv = _is_conv(ax)
            conv1x1 = conv and int(w.shape[0]) == 1 and int(w.shape[1]) == 1
            if conv1x1:
                # 1x1 convs are FC layers (paper Fig. 1a): SVD, not Tucker
                label, conv = "conv1x1", False
            pstr = "/".join(path)
            before_params, before_flops = _count(p), _fwd_flops(p, conv)
            if label not in targets:
                report.decisions.append(LayerDecision(
                    pstr, label, "skip", tuple(w.shape), None,
                    before_params, before_params, before_flops, before_flops,
                    "label not targeted"))
                return p, a
            if conv:
                np_, na, kind, rank = _decompose_conv(w, ax, lrd, m_tokens)
            elif conv1x1:
                np_, na, kind, rank = _decompose_linear(
                    w.reshape(w.shape[-2], w.shape[-1]), ax[-2:], lrd,
                    m_tokens, rank_cache)
            else:
                np_, na, kind, rank = _decompose_linear(w, ax, lrd, m_tokens,
                                                        rank_cache)
            if np_ is None:
                report.decisions.append(LayerDecision(
                    pstr, label, kind, tuple(w.shape), None,
                    before_params, before_params, before_flops, before_flops,
                    str(rank)))
                return p, a
            report.decisions.append(LayerDecision(
                pstr, label, kind, tuple(w.shape), rank,
                before_params, _count(np_), before_flops,
                _fwd_flops(np_, conv)))
            return np_, na
        if isinstance(p, dict):
            new_p, new_a = {}, {}
            for k in p:
                new_p[k], new_a[k] = walk(p[k], a[k], (*path, k))
            return new_p, new_a
        return p, a

    new_params, new_axes = walk(params, axes, ())
    return new_params, new_axes, report


def sparsify_model(params: PyTree, axes: PyTree, lrd: LRDConfig, *,
                   mode: str | None = None) -> tuple[PyTree, PyTree]:
    """Magnitude-based 2:4 sparsification of the decomposed factors, after
    :func:`decompose_model`: every ``lrd.sparse_targets`` factor whose
    input dim is a multiple of 4 becomes the packed ``k_sp``/``k_idx``
    (+ ``k_scale``) triple of :mod:`repro_torch.quant.sparse`.  ``mode``
    defaults to ``lrd.quantize``: with a quant mode the kept values pack
    straight to the narrow dtype, else they keep the source dtype.
    Returns rewritten ``(params, axes)``; a no-op at ``sparsify="none"``.
    """
    if lrd.sparsify == "none":
        return params, axes
    from repro_torch.quant.sparse import sparsify_tree
    quant = lrd.quantize if mode is None else mode
    return sparsify_tree(params, pattern=lrd.sparsify, mode=quant,
                         targets=lrd.sparse_targets, axes=axes)
