"""LinearPlan — the execution-plan seam for every linear flavour.

Decomposition shrinks parameters but deepens the chain: a dense
``y = x W`` becomes ``y = (x W0) W1`` (paper Eq. 5) or the branched
block-diagonal form of Eq. 17, ``y = sum_j ((x @ u_j) @ xc_j) @ v_j``.
A :class:`LinearPlan` classifies a linear subtree once from its keys
(``dense | lowrank | branched``, quantized ``k_q``/``k_scale`` trees
classifying as their plain originals), records its factors as
:class:`FactorSpec` metadata, answers the accounting questions
(``weight_bytes``, ``quant_bytes``, ``flops_per_token``,
``matmul_chain``) and executes it: every decomposed linear goes through
:mod:`repro_torch.kernels.ops`, which launches the CUDA kernel for a
CUDA activation and runs the kernel's plain version for a CPU one.  A
fully quantized plan runs the quantized kernel (``lowrank_q`` /
``branched_q``); a mixed one (partial ``quant_targets``) dequantizes to
``x.dtype`` and runs the plain chain's kernel, as the reference runs it
through its dequantizing jnp path.

2:4-packed (``*_sp``/``*_idx``) trees and the Tucker conv kinds are not
part of this slice; they raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
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

_QUANT_SUFFIX, _SCALE_SUFFIX, _SP_SUFFIX = "_q", "_scale", "_sp"


@dataclasses.dataclass(frozen=True)
class FactorSpec:
    """One factor of a (possibly decomposed, possibly quantized) linear.
    Metadata only; ``dtype`` is the stored value dtype (int8 / e4m3 when
    quantized)."""

    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    quantized: bool = False        # stored as name_q / name_scale
    scale_shape: tuple[int, ...] | None = None

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    @property
    def bytes(self) -> int:
        """Device-memory bytes of this factor, f32 scales included."""
        n = self.size * self.dtype.itemsize
        if self.quantized:
            n += int(math.prod(self.scale_shape)) * 4
        return n


@dataclasses.dataclass(frozen=True)
class LinearPlan:
    """How one linear subtree executes: kind, factors, kernel decision."""

    kind: str
    factors: tuple[FactorSpec, ...]

    @property
    def branches(self) -> int:
        return self.factors[0].shape[-3] if self.kind == KIND_BRANCHED else 1

    @property
    def quantized(self) -> bool:
        """Any factor stored quantized."""
        return any(f.quantized for f in self.factors)

    @property
    def fully_quantized(self) -> bool:
        """Every factor quantized — the quantized kernels need all."""
        return all(f.quantized for f in self.factors)

    # -- accounting ---------------------------------------------------------

    @property
    def param_count(self) -> int:
        return sum(f.size for f in self.factors)

    @property
    def quant_bytes(self) -> int:
        """Bytes of quantized storage (narrow values + scales)."""
        return sum(f.bytes for f in self.factors if f.quantized)

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
        3-D branch factors (``"lowrank_q"`` / ``"branched_q"`` when every
        factor is quantized), None for a dense linear.  Stacked factors
        (a leading layer axis) never reach a kernel: the model slices the
        layer axis first."""
        if self.kind == KIND_DENSE or len(x_shape) < 2:
            return None
        want_ndim = 2 if self.kind == KIND_LOWRANK else 3
        if any(len(f.shape) != want_ndim for f in self.factors):
            raise ValueError(
                f"{self.kind} factors {[f.shape for f in self.factors]} "
                "carry a leading stack axis; slice it before executing")
        return self.kind + "_q" if self.fully_quantized else self.kind

    def value(self, p: dict, name: str, dtype: torch.dtype) -> torch.Tensor:
        """Factor ``name`` of tree ``p``; a quantized pair is dequantized
        to ``dtype``."""
        if name in p:
            return p[name]
        q, scale = p[name + _QUANT_SUFFIX], p[name + _SCALE_SUFFIX]
        return (q.to(torch.float32) * scale).to(dtype)

    # -- execution ----------------------------------------------------------

    def execute(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """Apply this plan's linear op to ``x`` (..., d_in)."""
        from repro_torch.kernels import ops
        kernel = self.kernel_for(tuple(x.shape))
        if kernel == "lowrank_q":
            return ops.lowrank_matmul_q(x, p["w0_q"], p["w0_scale"],
                                        p["w1_q"], p["w1_scale"])
        if kernel == "branched_q":
            return ops.branched_matmul_q(x, p["u_q"], p["u_scale"],
                                         p["xc_q"], p["xc_scale"],
                                         p["v_q"], p["v_scale"])
        w = [self.value(p, name, x.dtype) for name in _KIND_FACTORS[self.kind]]
        if kernel is None:
            return matmul_f32(x, w[0]).to(x.dtype)
        if kernel == KIND_LOWRANK:
            return ops.lowrank_matmul(x, *w)
        return ops.branched_matmul(x, *w)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in f32 (the reference's
    ``preferred_element_type=float32``); bf16 operands are widened first,
    which keeps every product exact."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


# ---------------------------------------------------------------------------
# Plan construction (cached — built once per distinct subtree geometry)
# ---------------------------------------------------------------------------

def _has(p: dict, key: str) -> bool:
    return key in p or key + _QUANT_SUFFIX in p


def classify(p: dict) -> str:
    """Kind of a linear subtree from the keys present (a quantized
    ``k_q``/``k_scale`` tree classifies as its plain original)."""
    if any(key.endswith(_SP_SUFFIX) for key in p):
        raise NotImplementedError(
            f"2:4-packed linear keys ({sorted(p)}) come with ROADMAP item "
            "A11 (2:4 sparsity)")
    if _has(p, "w"):
        return KIND_DENSE
    if _has(p, "tucker_u") or _has(p, "core"):
        raise NotImplementedError(
            "Tucker conv subtrees come with ROADMAP item A13 (ResNet)")
    if _has(p, "xc"):
        return KIND_BRANCHED
    if _has(p, "w0"):
        return KIND_LOWRANK
    raise ValueError(f"not a linear param subtree: {sorted(p)}")


def is_linear_subtree(node: Any) -> bool:
    """Does this dict node hold the factors of one linear op?"""
    return isinstance(node, dict) and any(
        isinstance(node.get(k + sfx), torch.Tensor)
        for k in ("w", "w0", "xc", "u") for sfx in ("", _QUANT_SUFFIX))


def _spec(p: dict, name: str) -> FactorSpec:
    if name in p:
        v = p[name]
        return FactorSpec(name, tuple(int(d) for d in v.shape), v.dtype)
    q, scale = p[name + _QUANT_SUFFIX], p[name + _SCALE_SUFFIX]
    return FactorSpec(name, tuple(int(d) for d in q.shape), q.dtype, True,
                      tuple(int(d) for d in scale.shape))


_PLAN_CACHE: dict[tuple, LinearPlan] = {}


def build_plan(p: dict) -> LinearPlan:
    """The plan for one linear subtree, cached on its geometry."""
    key = tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in p.items()))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        kind = classify(p)
        plan = LinearPlan(kind, tuple(_spec(p, name)
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
        "quantized": sum(1 for p in plans if p.quantized),
        "param_count": sum(p.param_count for p in plans),
        "weight_bytes": sum(p.weight_bytes for p in plans),
        "quant_bytes": sum(p.quant_bytes for p in plans),
    }
