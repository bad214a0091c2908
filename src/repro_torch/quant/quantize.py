"""Per-channel symmetric quantization of decomposed factor matrices.

The port's copy of the reference's weight quantization (same modes,
rounding, key rewrite and accounting): a quantized factor ``k`` is
rewritten in place as the key pair ``k_q`` (narrow values) + ``k_scale``
(f32 per-output-channel scales), e.g.

    {"w0": (C, R), "w1": (R, S)}
      -> {"w0_q": int8 (C, R), "w0_scale": f32 (1, R),
          "w1_q": int8 (R, S), "w1_scale": f32 (1, S)}

so :func:`repro_torch.layers.param.apply_linear` dispatches on the keys
present and model code never changes.  Scales are per output channel:
the absmax reduction runs over the input (second-to-last) axis only.
Symmetric, no zero point: ``w ~= q * scale`` with ``q`` in
``[-127, 127]`` (int8, round half to even) or e4m3 values in
``[-448, 448]`` (fp8, ``torch.float8_e4m3fn``).  On the same f32 input
both modes give the reference's values bit for bit.
"""
from __future__ import annotations

from typing import Any, Iterable

import torch

PyTree = Any

MODE_INT8 = "int8"
MODE_FP8 = "fp8"
MODES = (MODE_INT8, MODE_FP8)

#: keys the LRD surgery can produce (SVD pair, branched, Tucker-2)
FACTOR_KEYS = ("w0", "w1", "u", "xc", "v", "tucker_u", "core", "tucker_v")

QUANT_SUFFIX = "_q"
SCALE_SUFFIX = "_scale"
# 2:4 structured-sparsity pair (repro_torch.quant.sparse): ``k_sp`` packed
# values (slot-major ``(..., 2, C/4, S)``) + ``k_idx`` int8 within-group
# row positions ``(..., 2, C/4, 1)``.  Defined here so the axes alignment
# below covers sparse trees without a circular import.
SP_SUFFIX = "_sp"
IDX_SUFFIX = "_idx"

INT8_QMAX = 127.0          # symmetric narrow range [-127, 127]
FP8_MAX = 448.0            # e4m3 max finite


def quantize_array(w: torch.Tensor, mode: str = MODE_INT8, *,
                   axis: int = -2) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``w`` per channel along ``axis`` -> ``(q, scale)``.

    ``scale`` keeps ``w``'s shape with ``axis`` collapsed to 1, so
    ``q.float() * scale`` broadcasts back to ``w``.  All-zero channels
    get scale 0 (they dequantize to exact zeros).
    """
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r} (want one of {MODES})")
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = amax / (INT8_QMAX if mode == MODE_INT8 else FP8_MAX)
    safe = torch.where(scale > 0, scale, 1.0)
    scaled = wf / safe
    if mode == MODE_INT8:
        q = torch.clamp(torch.round(scaled), -INT8_QMAX, INT8_QMAX)
        return q.to(torch.int8), scale
    return scaled.to(torch.float8_e4m3fn), scale


def dequantize_array(q: torch.Tensor, scale: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_array` (up to rounding error)."""
    return (q.to(torch.float32) * scale).to(dtype)


def is_quantized(node: Any) -> bool:
    """Does this (linear) subtree hold quantized factors?"""
    return isinstance(node, dict) and any(
        k.endswith(QUANT_SUFFIX) for k in node)


def dequantize_subtree(node: dict,
                       dtype: torch.dtype = torch.bfloat16) -> dict:
    """Restore one subtree's ``k_q``/``k_scale`` pairs to plain ``k``."""
    out = {}
    for k, v in node.items():
        if k.endswith(QUANT_SUFFIX):
            base = k[: -len(QUANT_SUFFIX)]
            out[base] = dequantize_array(v, node[base + SCALE_SUFFIX], dtype)
        elif not k.endswith(SCALE_SUFFIX):
            out[k] = v
    return out


def scale_axes(axes: tuple) -> tuple:
    """Logical axes of a ``k_scale`` leaf given factor ``k``'s axes: the
    reduced input axis becomes unsharded (None), the rest stay."""
    if len(axes) < 2:
        raise ValueError(f"factor axes must be 2D+: {axes}")
    return (*axes[:-2], None, axes[-1])


def sparse_value_axes(axes: tuple) -> tuple:
    """Logical axes of a ``k_sp`` leaf given factor ``k``'s axes: the
    slot-major packing ``(..., 2, C/4, S)`` inserts an unsharded keep-slot
    axis before the (grouped) input axis; input and output axes keep their
    names."""
    if len(axes) < 2:
        raise ValueError(f"factor axes must be 2D+: {axes}")
    return (*axes[:-2], None, axes[-2], axes[-1])


def sparse_index_axes(axes: tuple) -> tuple:
    """Logical axes of a ``k_idx`` leaf ``(..., 2, C/4, 1)``: keep-slot
    and the collapsed output axis unsharded, the input axis as the
    value's."""
    if len(axes) < 2:
        raise ValueError(f"factor axes must be 2D+: {axes}")
    return (*axes[:-2], None, axes[-2], None)


def align_quantized_axes(params_node: dict, axes_node: dict) -> dict:
    """Axes dict aligned with a (possibly quantized or 2:4-packed) params
    dict: a missing ``k_q`` entry inherits ``k``'s axes, a missing
    ``k_scale`` gets :func:`scale_axes` of them, ``k_sp`` / ``k_idx``
    get :func:`sparse_value_axes` / :func:`sparse_index_axes`."""
    out = {}
    for k in params_node:
        if k in axes_node:
            out[k] = axes_node[k]
            continue
        for suffix, fn in ((QUANT_SUFFIX, lambda a: a),
                           (SCALE_SUFFIX, scale_axes),
                           (SP_SUFFIX, sparse_value_axes),
                           (IDX_SUFFIX, sparse_index_axes)):
            base = k[: -len(suffix)]
            if k.endswith(suffix) and base in axes_node:
                out[k] = fn(axes_node[base])
                break
        else:
            raise KeyError(
                f"cannot resolve logical axes for param key {k!r} "
                f"(axes node has {sorted(axes_node)})")
    return out


def refuse_expert_bank(path: tuple[str, ...], what: str) -> None:
    """Raise where a pass would rewrite a factor of an MoE expert bank
    (``path`` runs through ``"experts"``): the routed expert products run
    dense, SVD-pair or branched banks only, as the reference's
    ``_expert_matmul`` does, which reads ``w0`` / ``u`` and so cannot run
    a quantized or packed bank."""
    if "experts" in path:
        raise ValueError(
            f"{what} of the MoE expert bank at {'/'.join(path)}: the "
            "routed expert products have no quantized or 2:4 path (nor "
            "has the reference's _expert_matmul); serve an MoE tree with "
            "decomposed experts in its own dtype, or leave the experts "
            "dense")


def quantize_tree(params: PyTree, mode: str = MODE_INT8, *,
                  targets: Iterable[str] = FACTOR_KEYS,
                  axes: PyTree | None = None) -> PyTree:
    """Quantize every targeted factor leaf of a param tree.

    Only 2-D+ tensor leaves whose key is in ``targets`` are rewritten
    (norms, embeddings and dense ``w`` layers pass through); subtrees
    that already hold quantized factors are left alone, so the transform
    is idempotent.  With ``axes`` (the matching logical-axes tree) the
    rewrite applies to both trees and ``(qparams, qaxes)`` is returned.
    A targeted factor of an MoE expert bank raises ``ValueError``
    (:func:`refuse_expert_bank`); a dense expert bank's ``w`` is not a
    factor key and passes through.
    """
    targets = set(targets)

    def walk(node: Any, ax: Any, path: tuple = ()) -> tuple[Any, Any]:
        if not isinstance(node, dict):
            return node, ax
        if is_quantized(node):
            return dict(node), (align_quantized_axes(node, ax)
                                if isinstance(ax, dict) else ax)
        out, a_out = {}, {}
        for k, v in node.items():
            if isinstance(ax, dict):
                if k not in ax:
                    raise KeyError(
                        f"axes tree missing entry for param key {k!r} "
                        f"(axes node has {sorted(ax)})")
                a_k = ax[k]
            else:
                a_k = None
            if (k in targets and isinstance(v, torch.Tensor)
                    and v.ndim >= 2):
                refuse_expert_bank((*path, k), f"quantize={mode!r}")
                out[k + QUANT_SUFFIX], out[k + SCALE_SUFFIX] = \
                    quantize_array(v, mode)
                if isinstance(ax, dict):
                    a_out[k + QUANT_SUFFIX] = a_k
                    a_out[k + SCALE_SUFFIX] = scale_axes(a_k)
            else:
                out[k], a_out[k] = walk(v, a_k, (*path, k))
        return out, a_out

    qparams, qaxes = walk(params, axes)
    return qparams if axes is None else (qparams, qaxes)


def dequantize_tree(params: PyTree,
                    dtype: torch.dtype = torch.bfloat16) -> PyTree:
    """Inverse tree transform: restore plain factor keys everywhere."""
    if not isinstance(params, dict):
        return params
    if is_quantized(params):
        return dequantize_subtree(params, dtype)
    return {k: dequantize_tree(v, dtype) for k, v in params.items()}


def tree_bytes(params: PyTree) -> int:
    """Total bytes of every tensor leaf (what device memory holds and a
    full pass streams)."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0


def relative_error(w: torch.Tensor, mode: str = MODE_INT8, *,
                   axis: int = -2) -> float:
    """``||w - dq(q(w))|| / ||w||`` — the round-trip quantization error."""
    q, scale = quantize_array(w, mode, axis=axis)
    wf = w.to(torch.float32)
    num = float(torch.linalg.vector_norm(
        wf - dequantize_array(q, scale, torch.float32)))
    return num / max(float(torch.linalg.vector_norm(wf)), 1e-30)
