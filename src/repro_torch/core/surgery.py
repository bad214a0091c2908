"""Whole-model LRD surgery — applies the paper's technique to a param tree.

``decompose_model(params, axes, lrd)`` walks the ``(params, axes)`` trees
built by :class:`repro_torch.layers.param.ParamBuilder`, labels every
linear subtree ``{"w": ...}`` by its path, picks a rank per
:mod:`repro_torch.core.rank_selection` and rewrites the subtree:

    {"w": (.., C, S)} -> {"w0": (.., C, R), "w1": (.., R, S)}     SVD pair
                      -> {"u": (.., N, C, r), "xc": (.., N, r, r),
                          "v": (.., N, r, S)}                     branched
                      -> unchanged                     (skip / ORG)

Stacked-layer weights (leading ``layers`` axis) decompose batched, so
every layer of a stack shares one rank.  The decisions go into a
:class:`SurgeryReport`, field for field the reference's.  Convolution
weights (Tucker-2) come with ROADMAP item A13.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import LRDConfig
from repro_torch.core import rank_selection as rs
from repro_torch.core.branching import branch_svd, quantize_ranks
from repro_torch.core.svd import decompose_auto
from repro_torch.layers.param import (BRANCH, CONV, EXPERTS, LAYERS, RANK,
                                      linear_flops)

PyTree = Any

_LABELS: dict[tuple[str, str], str] = {
    ("attn", "q"): "attn_q", ("attn", "k"): "attn_k",
    ("attn", "v"): "attn_v", ("attn", "o"): "attn_o",
    ("mlp", "up"): "ffn_up", ("mlp", "gate"): "ffn_gate",
    ("mlp", "down"): "ffn_down",
}


def classify_path(path: tuple[str, ...]) -> str:
    """Target label for a linear subtree at ``path``."""
    if not path:
        return "unknown"
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if (parent, leaf) in _LABELS:
        return _LABELS[(parent, leaf)]
    return leaf


@dataclasses.dataclass
class LayerDecision:
    path: str
    label: str
    kind: str                  # "svd" | "branched" | "org" | "skip"
    shape: tuple[int, ...]
    rank: int | None
    params_before: int
    params_after: int
    flops_before: float        # per input row (forward)
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


def _decompose_linear(w: torch.Tensor, ax: tuple, lrd: LRDConfig,
                      cache: dict) -> tuple[dict | None, dict | None, str,
                                            Any]:
    """Returns (new_params, new_axes, kind, rank) or (None, None,
    "skip"/"org", reason)."""
    nb = _batch_dims(ax)
    c, s = int(w.shape[-2]), int(w.shape[-1])
    if min(c, s) < lrd.min_dim:
        return None, None, "skip", f"min_dim({min(c, s)}<{lrd.min_dim})"
    if (c, s) not in cache:
        cache[(c, s)] = rs.select_rank(c, s, compression=lrd.compression,
                                       mode=lrd.rank_mode,
                                       align=lrd.rank_align)
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


def _count(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return int(tree.numel())


def _fwd_flops(params: dict) -> float:
    """Forward FLOPs per row, on the innermost (unstacked) factor dims."""
    def inner(k: str, v: torch.Tensor) -> torch.Tensor:
        nd = 3 if k in ("u", "xc", "v") else 2
        return v[(0,) * (v.ndim - nd)] if v.ndim > nd else v
    return linear_flops({k: inner(k, v) for k, v in params.items()}, 1)


def decompose_model(params: PyTree, axes: PyTree, lrd: LRDConfig
                    ) -> tuple[PyTree, PyTree, SurgeryReport]:
    """Apply LRD to every targeted linear subtree.  Returns rewritten
    copies of both trees (untouched leaves are shared, not copied) plus
    the decision report."""
    report = SurgeryReport()
    if not lrd.enabled:
        return params, axes, report
    targets = set(lrd.targets)
    rank_cache: dict = {}

    def walk(p: Any, a: Any, path: tuple[str, ...]) -> tuple[Any, Any]:
        if _is_linear_node(p):
            label = classify_path(path)
            w, ax = p["w"], a["w"]
            core = ax[_batch_dims(ax):]
            if len(core) == 4 and core[0] == CONV:
                raise NotImplementedError(
                    "conv weights (Tucker-2) come with ROADMAP item A13")
            pstr = "/".join(path)
            before_params, before_flops = _count(p), _fwd_flops(p)
            if label not in targets:
                report.decisions.append(LayerDecision(
                    pstr, label, "skip", tuple(w.shape), None,
                    before_params, before_params, before_flops, before_flops,
                    "label not targeted"))
                return p, a
            np_, na, kind, rank = _decompose_linear(w, ax, lrd, rank_cache)
            if np_ is None:
                report.decisions.append(LayerDecision(
                    pstr, label, kind, tuple(w.shape), None,
                    before_params, before_params, before_flops, before_flops,
                    str(rank)))
                return p, a
            report.decisions.append(LayerDecision(
                pstr, label, kind, tuple(w.shape), rank,
                before_params, _count(np_), before_flops, _fwd_flops(np_)))
            return np_, na
        if isinstance(p, dict):
            new_p, new_a = {}, {}
            for k in p:
                new_p[k], new_a[k] = walk(p[k], a[k], (*path, k))
            return new_p, new_a
        return p, a

    new_params, new_axes = walk(params, axes, ())
    return new_params, new_axes, report
