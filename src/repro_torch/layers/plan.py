"""LinearPlan — the execution-plan seam for every linear flavour.

Decomposition shrinks parameters but deepens the chain: a dense
``y = x W`` becomes ``y = (x W0) W1`` (paper Eq. 5) or the branched
block-diagonal form of Eq. 17, ``y = sum_j ((x @ u_j) @ xc_j) @ v_j``.
A :class:`LinearPlan` classifies a linear subtree once from its keys
(``dense | lowrank | branched``; quantized ``k_q``/``k_scale`` and
2:4-packed ``k_sp``/``k_idx`` trees classify as their plain originals),
records its factors as :class:`FactorSpec` metadata, answers the
accounting questions (``weight_bytes``, ``quant_bytes``,
``flops_per_token``, ``matmul_chain``) and executes it: every decomposed
linear goes through :mod:`repro_torch.kernels.ops`, which launches the
CUDA kernel for a CUDA activation and runs the kernel's plain version
for a CPU one.  A fully quantized plan runs the quantized kernel
(``lowrank_q`` / ``branched_q``), or, on prefill segments with
activation quantization and int8 factors, the int8 x int8 kernel
(``lowrank_qa`` / ``branched_qa``).  A 2:4 plan in the canonical compound
layout (every packed factor quantized; for branched, ``u`` and ``v``
packed and ``xc`` quantized dense) runs the sparse kernel
(``lowrank_sq`` / ``branched_sq``).  Any other mixed plan (partial
``quant_targets`` or ``sparse_targets``, or an unquantized 2:4 pack)
expands and dequantizes to ``x.dtype`` and runs the plain chain's
kernel, as the reference runs it through its jnp path.

The Tucker-2 conv triple (paper Fig. 1b) and its branched form (Fig. 4)
classify the same way, as ``tucker_conv`` (``tucker_u`` / ``core`` /
``tucker_v``) and ``branched_tucker_conv`` (``u`` / ``core`` / ``v``).
They have spatial weights, so they execute through
:func:`repro_torch.layers.conv.apply_conv` (``torch.nn.functional.
conv2d``, as the reference runs them through ``lax.conv_general_dilated``
outside any Pallas kernel); :meth:`LinearPlan.execute` raises on them and
:meth:`LinearPlan.kernel_for` names no kernel.
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
KIND_TUCKER_CONV = "tucker_conv"
KIND_BRANCHED_TUCKER_CONV = "branched_tucker_conv"

#: kinds :meth:`LinearPlan.execute` runs
LINEAR_KINDS = (KIND_DENSE, KIND_LOWRANK, KIND_BRANCHED)
#: kinds only :func:`repro_torch.layers.conv.apply_conv` runs (spatial
#: weights)
CONV_KINDS = (KIND_TUCKER_CONV, KIND_BRANCHED_TUCKER_CONV)

#: factor names per kind, in chain order
_KIND_FACTORS: dict[str, tuple[str, ...]] = {
    KIND_DENSE: ("w",),
    KIND_LOWRANK: ("w0", "w1"),
    KIND_BRANCHED: ("u", "xc", "v"),
    KIND_TUCKER_CONV: ("tucker_u", "core", "tucker_v"),
    KIND_BRANCHED_TUCKER_CONV: ("u", "core", "v"),
}

_QUANT_SUFFIX, _SCALE_SUFFIX = "_q", "_scale"
_SP_SUFFIX, _IDX_SUFFIX = "_sp", "_idx"


@dataclasses.dataclass(frozen=True)
class FactorSpec:
    """One factor of a (possibly decomposed, quantized or 2:4-packed)
    linear.  Metadata only; ``shape`` is the logical dense shape and
    ``dtype`` the stored value dtype (int8 / e4m3 when quantized)."""

    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    quantized: bool = False        # f32 name_scale beside the values
    scale_shape: tuple[int, ...] | None = None
    sparsity: str | None = None    # "2:4" when stored name_sp / name_idx
    idx_shape: tuple[int, ...] | None = None

    @property
    def density(self) -> float:
        """Kept fraction of the logical values (1.0 when dense)."""
        if self.sparsity is None:
            return 1.0
        keep, group = (int(t) for t in self.sparsity.split(":"))
        return keep / group

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))

    @property
    def stored_size(self) -> int:
        """Values actually stored (the 2:4 packing keeps half)."""
        return int(round(self.size * self.density))

    @property
    def bytes(self) -> int:
        """Device-memory bytes of this factor: the stored values, one
        int8 index per kept row of a 2:4 pack, the f32 scales."""
        n = self.stored_size * self.dtype.itemsize
        if self.idx_shape is not None:
            n += int(math.prod(self.idx_shape))
        if self.quantized:
            n += int(math.prod(self.scale_shape)) * 4
        return n


@dataclasses.dataclass(frozen=True)
class LinearPlan:
    """How one linear subtree executes: kind, factors, kernel decision."""

    kind: str
    factors: tuple[FactorSpec, ...]

    @property
    def d_in(self) -> int:
        return self.factors[0].shape[-2]

    @property
    def d_out(self) -> int:
        return self.factors[-1].shape[-1]

    @property
    def branches(self) -> int:
        if self.kind in (KIND_BRANCHED, KIND_BRANCHED_TUCKER_CONV):
            return self.factors[0].shape[-3]
        return 1

    @property
    def quantized(self) -> bool:
        """Any factor stored quantized."""
        return any(f.quantized for f in self.factors)

    @property
    def fully_quantized(self) -> bool:
        """Every factor quantized — the quantized kernels need all."""
        return all(f.quantized for f in self.factors)

    @property
    def sparse(self) -> bool:
        """Any factor stored 2:4-packed."""
        return any(f.sparsity is not None for f in self.factors)

    # -- accounting ---------------------------------------------------------

    @property
    def param_count(self) -> int:
        """Stored values (the kept ones of a 2:4 factor); scales and
        indices are bookkeeping, not parameters."""
        return sum(f.stored_size for f in self.factors)

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
        an ``(M, k) @ (k, n)`` product (per output pixel for a Tucker
        conv kind: ``k`` counts the core's window).  A dense plan counts
        one ``(C, S)`` product: its weight carries no axes that would
        tell a spatial conv from a stacked bank, so the surgery counts a
        dense conv's window itself."""
        s = {f.name: f.shape for f in self.factors}
        if self.kind == KIND_DENSE:
            return [(1, s["w"][-2], s["w"][-1])]
        if self.kind == KIND_LOWRANK:
            c, r = s["w0"][-2], s["w0"][-1]
            return [(1, c, r), (1, r, s["w1"][-1])]
        if self.kind == KIND_BRANCHED:
            n = self.branches
            c, r1 = s["u"][-2], s["u"][-1]
            r2 = s["xc"][-1]
            return [(n, c, r1), (n, r1, r2), (n, r2, s["v"][-1])]
        if self.kind == KIND_TUCKER_CONV:
            c, r1 = s["tucker_u"][-2], s["tucker_u"][-1]
            kh, kw, _, r2 = s["core"][-4:]
            return [(1, c, r1), (1, kh * kw * r1, r2),
                    (1, r2, s["tucker_v"][-1])]
        n = self.branches                             # branched Tucker
        c, r1 = s["u"][-2], s["u"][-1]
        kh, kw, _, r2 = s["core"][-4:]
        return [(n, c, r1), (n, kh * kw * r1, r2), (n, r2, s["v"][-1])]

    def chain_factors(self) -> tuple[FactorSpec, ...]:
        """The weight operand of each product of :meth:`matmul_chain`
        (the factors are built in chain order)."""
        return self.factors

    def chain_density(self) -> tuple[float, ...]:
        """Kept fraction of each product's weight, aligned with
        :meth:`matmul_chain`."""
        return tuple(f.density for f in self.chain_factors())

    @property
    def flops_per_token(self) -> float:
        """Forward matmul FLOPs per input row, scaled by the kept fraction
        of 2:4 factors."""
        return sum(2.0 * mult * k * n * d
                   for (mult, k, n), d in zip(self.matmul_chain(),
                                              self.chain_density()))

    # -- kernel dispatch ----------------------------------------------------

    def kernel_for(self, x_shape: tuple[int, ...],
                   act_quantize: bool = False) -> str | None:
        """The fused kernel that executes this plan for an activation of
        ``x_shape``: ``"lowrank"`` for a 2-D SVD pair, ``"branched"`` for
        3-D branch factors (``"lowrank_q"`` / ``"branched_q"`` when every
        factor is quantized), None for a dense linear.  A 2:4 plan is
        decided first, as in the reference (``repro/layers/plan.py:
        341-363``): ``"lowrank_sq"`` / ``"branched_sq"`` for the canonical
        compound layout (every factor of an SVD pair packed and
        quantized; branched ``u`` and ``v`` packed and quantized, ``xc``
        quantized dense), the plain chain's kernel on expanded factors
        for any other, never a qa kernel.  ``act_quantize`` (prefill
        segments only) asks for the int8 x int8 kernels ``"lowrank_qa"``
        / ``"branched_qa"``, which take fully int8 plans only: fp8 plans
        keep the weight-only kernels, and a mixed plan runs the
        dequantized plain chain, as in the reference
        (``repro/layers/plan.py:370-381``).  Stacked factors (a leading
        layer axis) never reach a kernel: the model slices the layer
        axis first.  A conv kind names no kernel (its convolutions run in
        ``apply_conv``)."""
        if self.kind in (KIND_DENSE, *CONV_KINDS) or len(x_shape) < 2:
            return None
        want_ndim = 2 if self.kind == KIND_LOWRANK else 3
        if any(len(f.shape) != want_ndim for f in self.factors):
            raise ValueError(
                f"{self.kind} factors {[f.shape for f in self.factors]} "
                "carry a leading stack axis; slice it before executing")
        if self.sparse:
            packed = [f.sparsity is not None and f.quantized
                      for f in self.factors]
            if self.kind == KIND_LOWRANK:
                return "lowrank_sq" if all(packed) else self.kind
            xc = self.factors[1]
            canonical = (packed[0] and packed[2] and xc.quantized
                         and xc.sparsity is None)
            return "branched_sq" if canonical else self.kind
        if not self.fully_quantized:
            return self.kind
        if act_quantize and all(f.dtype == torch.int8
                                for f in self.factors):
            return self.kind + "_qa"
        return self.kind + "_q"

    def value(self, p: dict, name: str, dtype: torch.dtype) -> torch.Tensor:
        """Factor ``name`` of tree ``p``; a quantized pair is dequantized
        to ``dtype``, a 2:4 pack expanded (and dequantized) to it."""
        if name in p:
            return p[name]
        if name + _SP_SUFFIX in p:
            from repro_torch.quant.sparse import expand_sparse
            return expand_sparse(p[name + _SP_SUFFIX], p[name + _IDX_SUFFIX],
                                 p.get(name + _SCALE_SUFFIX), dtype)
        q, scale = p[name + _QUANT_SUFFIX], p[name + _SCALE_SUFFIX]
        return (q.to(torch.float32) * scale).to(dtype)

    # -- execution ----------------------------------------------------------

    def execute(self, p: dict, x: torch.Tensor, *,
                act_quantize: bool = False) -> torch.Tensor:
        """Apply this plan's linear op to ``x`` (..., d_in);
        ``act_quantize`` as in :meth:`kernel_for`.  A conv kind raises:
        it runs through :func:`repro_torch.layers.conv.apply_conv`."""
        from repro_torch.kernels import ops
        if self.kind not in LINEAR_KINDS:
            raise ValueError(
                f"kind {self.kind!r} is a conv plan; use apply_conv")
        kernel = self.kernel_for(tuple(x.shape), act_quantize)
        if kernel == "lowrank_qa":
            return ops.lowrank_matmul_qa(x, p["w0_q"], p["w0_scale"],
                                         p["w1_q"], p["w1_scale"])
        if kernel == "branched_qa":
            return ops.branched_matmul_qa(x, p["u_q"], p["u_scale"],
                                          p["xc_q"], p["xc_scale"],
                                          p["v_q"], p["v_scale"])
        if kernel == "lowrank_sq":
            return ops.lowrank_matmul_sq(
                x, p["w0_sp"], p["w0_idx"], p["w0_scale"], p["w1_sp"],
                p["w1_idx"], p["w1_scale"])
        if kernel == "branched_sq":
            return ops.branched_matmul_sq(
                x, p["u_sp"], p["u_idx"], p["u_scale"], p["xc_q"],
                p["xc_scale"], p["v_sp"], p["v_idx"], p["v_scale"])
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
    return any(key + sfx in p for sfx in ("", _QUANT_SUFFIX, _SP_SUFFIX))


def classify(p: dict) -> str:
    """Kind of a linear / conv subtree from the keys present (quantized
    ``k_q``/``k_scale`` and 2:4-packed ``k_sp``/``k_idx`` trees classify
    as their plain originals)."""
    if _has(p, "w"):
        return KIND_DENSE
    if _has(p, "tucker_u"):
        return KIND_TUCKER_CONV
    if _has(p, "xc"):
        return KIND_BRANCHED
    if _has(p, "core"):
        return KIND_BRANCHED_TUCKER_CONV
    if _has(p, "w0"):
        return KIND_LOWRANK
    raise ValueError(f"not a linear param subtree: {sorted(p)}")


def is_linear_subtree(node: Any) -> bool:
    """Does this dict node hold the factors of one linear / conv op?"""
    return isinstance(node, dict) and any(
        isinstance(node.get(k + sfx), torch.Tensor)
        for k in ("w", "w0", "xc", "tucker_u", "core", "u")
        for sfx in ("", _QUANT_SUFFIX, _SP_SUFFIX))


def _spec(p: dict, name: str) -> FactorSpec:
    if name in p:
        v = p[name]
        return FactorSpec(name, tuple(int(d) for d in v.shape), v.dtype)
    if name + _SP_SUFFIX in p:
        # slot-major (..., 2, G, S) values: the logical shape has 4G rows
        sp, idx = p[name + _SP_SUFFIX], p[name + _IDX_SUFFIX]
        scale = p.get(name + _SCALE_SUFFIX)
        return FactorSpec(
            name, (*(int(d) for d in sp.shape[:-3]), 4 * int(sp.shape[-2]),
                   int(sp.shape[-1])), sp.dtype, scale is not None,
            None if scale is None else tuple(int(d) for d in scale.shape),
            "2:4", tuple(int(d) for d in idx.shape))
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
        "sparse": sum(1 for p in plans if p.sparse),
        "param_count": sum(p.param_count for p in plans),
        "weight_bytes": sum(p.weight_bytes for p in plans),
        "quant_bytes": sum(p.quant_bytes for p in plans),
    }
