"""LinearPlan — the execution-plan seam for every linear flavour.

Decomposition shrinks parameters but deepens the chain: a dense
``y = x W`` becomes ``y = (x W0) W1`` (paper Eq. 5) or the branched
block-diagonal form of Eq. 17, ``y = sum_j ((x @ u_j) @ xc_j) @ v_j``.
A :class:`LinearPlan` classifies a linear subtree once from its keys
(``dense | lowrank | branched``), records its factors as
:class:`FactorSpec` metadata, answers the accounting questions
(``weight_bytes``, ``flops_per_token``, ``matmul_chain``) and executes
it: every decomposed linear goes through
:mod:`repro_torch.kernels.ops`, which launches the CUDA kernel for a
CUDA activation and runs the kernel's plain version for a CPU one.

Quantized (``*_q``/``*_scale``) and 2:4-packed (``*_sp``/``*_idx``)
trees and the Tucker conv kinds are not part of this slice; they raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

PyTree = Any

KIND_DENSE = "dense"
KIND_LOWRANK = "lowrank"
KIND_BRANCHED = "branched"

_KIND_FACTORS: dict[str, tuple[str, ...]] = {
    KIND_DENSE: ("w",),
    KIND_LOWRANK: ("w0", "w1"),
    KIND_BRANCHED: ("u", "xc", "v"),
}

_QUANT_SUFFIX, _SP_SUFFIX = "_q", "_sp"


@dataclasses.dataclass(frozen=True)
class FactorSpec:
    """One factor of a (possibly decomposed) linear.  Metadata only."""

    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    @property
    def bytes(self) -> int:
        """Device-memory bytes of this factor."""
        return self.size * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class LinearPlan:
    """How one linear subtree executes: kind, factors, kernel decision."""

    kind: str
    factors: tuple[FactorSpec, ...]

    @property
    def branches(self) -> int:
        return self.factors[0].shape[-3] if self.kind == KIND_BRANCHED else 1

    # -- accounting ---------------------------------------------------------

    @property
    def param_count(self) -> int:
        return sum(f.size for f in self.factors)

    @property
    def weight_bytes(self) -> int:
        """Device-memory bytes the weight stream moves per full pass (the
        decode roofline's memory term)."""
        return sum(f.bytes for f in self.factors)

    def matmul_chain(self) -> list[tuple[int, int, int]]:
        """The chain as ``(mult, k, n)`` triples — ``mult`` repetitions of
        an ``(M, k) @ (k, n)`` product."""
        s = {f.name: f.shape for f in self.factors}
        if self.kind == KIND_DENSE:
            return [(1, s["w"][-2], s["w"][-1])]
        if self.kind == KIND_LOWRANK:
            c, r = s["w0"][-2], s["w0"][-1]
            return [(1, c, r), (1, r, s["w1"][-1])]
        n = self.branches
        c, r1 = s["u"][-2], s["u"][-1]
        r2 = s["xc"][-1]
        return [(n, c, r1), (n, r1, r2), (n, r2, s["v"][-1])]

    @property
    def flops_per_token(self) -> float:
        """Forward matmul FLOPs per input row."""
        return sum(2.0 * mult * k * n for mult, k, n in self.matmul_chain())

    # -- kernel dispatch ----------------------------------------------------

    def kernel_for(self, x_shape: tuple[int, ...]) -> str | None:
        """The fused kernel that executes this plan for an activation of
        ``x_shape``: ``"lowrank"`` for a 2-D SVD pair, ``"branched"`` for
        3-D branch factors, None for a dense linear.  Stacked factors (a
        leading layer axis) never reach a kernel: the model slices the
        layer axis first."""
        if self.kind == KIND_DENSE or len(x_shape) < 2:
            return None
        want_ndim = 2 if self.kind == KIND_LOWRANK else 3
        if any(len(f.shape) != want_ndim for f in self.factors):
            raise ValueError(
                f"{self.kind} factors {[f.shape for f in self.factors]} "
                "carry a leading stack axis; slice it before executing")
        return self.kind

    # -- execution ----------------------------------------------------------

    def execute(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """Apply this plan's linear op to ``x`` (..., d_in)."""
        from repro_torch.kernels import ops
        kernel = self.kernel_for(tuple(x.shape))
        if kernel is None:
            return matmul_f32(x, p["w"]).to(x.dtype)
        if kernel == KIND_LOWRANK:
            return ops.lowrank_matmul(x, p["w0"], p["w1"])
        return ops.branched_matmul(x, p["u"], p["xc"], p["v"])


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in f32 (the reference's
    ``preferred_element_type=float32``); bf16 operands are widened first,
    which keeps every product exact."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


# ---------------------------------------------------------------------------
# Plan construction (cached — built once per distinct subtree geometry)
# ---------------------------------------------------------------------------

def classify(p: dict) -> str:
    """Kind of a linear subtree from the keys present."""
    for key in p:
        if key.endswith(_QUANT_SUFFIX) or key.endswith(_SP_SUFFIX):
            raise NotImplementedError(
                f"quantized / 2:4-packed linear keys ({sorted(p)}) come "
                "with ROADMAP items A6 (weight quantization) and A11 "
                "(2:4 sparsity)")
    if "w" in p:
        return KIND_DENSE
    if "tucker_u" in p or "core" in p:
        raise NotImplementedError(
            "Tucker conv subtrees come with ROADMAP item A13 (ResNet)")
    if "xc" in p:
        return KIND_BRANCHED
    if "w0" in p:
        return KIND_LOWRANK
    raise ValueError(f"not a linear param subtree: {sorted(p)}")


def is_linear_subtree(node: Any) -> bool:
    """Does this dict node hold the factors of one linear op?"""
    return isinstance(node, dict) and any(
        isinstance(node.get(k), torch.Tensor) for k in ("w", "w0", "xc", "u"))


_PLAN_CACHE: dict[tuple, LinearPlan] = {}


def build_plan(p: dict) -> LinearPlan:
    """The plan for one linear subtree, cached on its geometry."""
    key = tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in p.items()))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        kind = classify(p)
        plan = LinearPlan(kind, tuple(
            FactorSpec(name, tuple(int(d) for d in p[name].shape),
                       p[name].dtype)
            for name in _KIND_FACTORS[kind]))
        _PLAN_CACHE[key] = plan
    return plan


def build_plan_tree(params: PyTree) -> PyTree:
    """Map every linear subtree of a param tree to its plan (other
    subtrees recurse; non-linear leaves map to ``None``)."""
    if is_linear_subtree(params):
        return build_plan(params)
    if isinstance(params, dict):
        return {k: build_plan_tree(v) for k, v in params.items()}
    return None


def plan_leaves(plan_tree: PyTree) -> list[LinearPlan]:
    if isinstance(plan_tree, LinearPlan):
        return [plan_tree]
    if isinstance(plan_tree, dict):
        return [p for v in plan_tree.values() for p in plan_leaves(v)]
    return []


def tree_summary(plan_tree: PyTree) -> dict:
    """Aggregate accounting over a :func:`build_plan_tree` result."""
    plans = plan_leaves(plan_tree)
    return {
        "linears": len(plans),
        "by_kind": {k: sum(1 for p in plans if p.kind == k)
                    for k in sorted({p.kind for p in plans})},
        "param_count": sum(p.param_count for p in plans),
        "weight_bytes": sum(p.weight_bytes for p in plans),
    }
