"""2:4 semi-structured sparsity of decomposed factor matrices.

The port's copy of the reference's third compression axis (same packing,
mask, rounding and key rewrite): a magnitude-based 2:4 prune of the
factor matrices that composes with rank reduction and with per-channel
quantization.  A sparsified factor ``k (..., C, S)`` is rewritten in
place as the key triple

    k_sp    — packed kept values, slot-major ``(..., 2, C/4, S)``
              (int8 / e4m3 when composed with quantization, else ``k``'s
              dtype)
    k_idx   — int8 within-group row positions ``(..., 2, C/4, 1)``,
              values in ``{0..3}``, ascending per group
    k_scale — f32 per-output-channel scales ``(..., 1, S)`` (only when
              quantized; the convention of ``quantize_tree``)

The mask is shared across the output axis: in every group of 4 input
rows the 2 rows with the largest L1 norm over the output channels are
kept for all columns, so the metadata is one int8 position per kept row
(``C/2`` bytes per factor) rather than 2 bits per value.  Slot-major
packing makes slot ``i`` of a factor one contiguous ``(C/4, S)`` tile;
the sparse kernels (``kernels/lowrank_matmul_sq``,
``kernels/branched_matmul_sq``) expand it row by row on the chip.  On
the same input the packing is the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Iterable

import torch

from repro_torch.quant.quantize import (IDX_SUFFIX, MODE_INT8, SCALE_SUFFIX,
                                        SP_SUFFIX, is_quantized,
                                        quantize_array, refuse_expert_bank,
                                        scale_axes, sparse_index_axes,
                                        sparse_value_axes)

PyTree = Any

PATTERN_24 = "2:4"
PATTERNS = (PATTERN_24,)

#: factor keys the 2:4 pass targets by default: the SVD pair and the
#: branched outer factors.  The branched core ``xc`` is excluded (it is
#: small, and the branched sparse kernel keeps it a plain int8 tile).
SPARSE_KEYS = ("w0", "w1", "u", "v")


def pattern_nm(pattern: str) -> tuple[int, int]:
    """``"2:4" -> (2, 4)`` — kept rows per group, group size."""
    if pattern not in PATTERNS:
        raise ValueError(
            f"unknown sparsity pattern {pattern!r} (want one of {PATTERNS})")
    keep, group = (int(t) for t in pattern.split(":"))
    return keep, group


def sparsify_array(w: torch.Tensor, pattern: str = PATTERN_24,
                   mode: str = MODE_INT8
                   ) -> tuple[torch.Tensor, torch.Tensor,
                              torch.Tensor | None]:
    """Magnitude-prune ``w (..., C, S)`` to 2:4 along the input axis.

    Returns ``(sp, idx, scale)``: packed values ``(..., 2, C/4, S)``, int8
    ascending within-group positions ``(..., 2, C/4, 1)``, and f32
    per-output-channel scales ``(..., 1, S)`` when ``mode`` is a quant
    mode (``sp`` is then int8 / e4m3); ``mode="none"`` keeps ``sp`` in
    ``w``'s dtype and returns ``scale=None``.  A row's magnitude is its
    f32 L1 norm over the output channels; the stable sort keeps the lower
    row of a tie, as the reference does.  Requires ``C % 4 == 0``.
    """
    keep, group = pattern_nm(pattern)
    *lead, c, s = w.shape
    if c % group:
        raise ValueError(f"input dim {c} not divisible by {group} "
                         f"for {pattern} sparsity: {tuple(w.shape)}")
    g = c // group
    wg = w.to(torch.float32).reshape(*lead, g, group, s)
    score = wg.abs().sum(dim=-1)                          # (..., G, 4)
    top = torch.argsort(-score, dim=-1, stable=True)[..., :keep]
    idx = torch.sort(top, dim=-1).values                  # (..., G, 2)
    sp = torch.take_along_dim(wg, idx[..., None], dim=-2)  # (..., G, 2, S)
    sp = sp.movedim(-2, -3)                               # (..., 2, G, S)
    idx = idx.transpose(-1, -2)[..., None].to(torch.int8).contiguous()
    if mode == "none":
        return sp.to(w.dtype).contiguous(), idx, None
    # one f32 scale per column over all kept rows of both slots
    q, scale = quantize_array(sp.reshape(*lead, keep * g, s), mode)
    return q.reshape(*lead, keep, g, s), idx, scale


def expand_sparse(sp: torch.Tensor, idx: torch.Tensor,
                  scale: torch.Tensor | None = None,
                  dtype: torch.dtype | None = None) -> torch.Tensor:
    """Inverse scatter ``(..., 2, C/4, S) -> (..., C, S)``: pruned rows
    come back as exact zeros; with ``scale`` the f32 values are
    dequantized and rounded to ``dtype`` (default bf16), as the sparse
    kernels expand on the chip; without, ``dtype`` defaults to ``sp``'s."""
    *lead, keep, g, s = sp.shape
    group = 4 * idx.shape[-1]
    pos = torch.arange(group, device=sp.device, dtype=torch.int32)
    hit = idx.to(torch.int32) == pos                      # (..., 2, G, 4)
    vals = sp.to(torch.float32)
    dense = torch.zeros((*lead, g, group, s), dtype=torch.float32,
                        device=sp.device)
    for i in range(keep):
        dense = dense + torch.where(hit[..., i, :, :, None],
                                    vals[..., i, :, None, :], 0.0)
    dense = dense.reshape(*lead, g * group, s)
    if scale is not None:
        return (dense * scale).to(dtype or torch.bfloat16)
    return dense.to(dtype or sp.dtype)


def is_sparse(node: Any) -> bool:
    """Does this (linear) subtree hold 2:4-packed factors?"""
    return isinstance(node, dict) and any(
        k.endswith(SP_SUFFIX) for k in node)


def desparsify_subtree(node: dict,
                       dtype: torch.dtype = torch.bfloat16) -> dict:
    """Restore one subtree's ``k_sp``/``k_idx``(/``k_scale``) triples to
    plain dense ``k`` (pruned rows as zeros)."""
    out = {}
    for k, v in node.items():
        if k.endswith(SP_SUFFIX):
            base = k[: -len(SP_SUFFIX)]
            out[base] = expand_sparse(v, node[base + IDX_SUFFIX],
                                      node.get(base + SCALE_SUFFIX), dtype)
        elif k.endswith(IDX_SUFFIX) or (
                k.endswith(SCALE_SUFFIX)
                and k[: -len(SCALE_SUFFIX)] + SP_SUFFIX in node):
            continue
        else:
            out[k] = v
    return out


def sparsify_tree(params: PyTree, pattern: str = PATTERN_24,
                  mode: str = MODE_INT8, *,
                  targets: Iterable[str] = SPARSE_KEYS,
                  axes: PyTree | None = None) -> PyTree:
    """Sparsify (and, with a quant ``mode``, quantize) every targeted
    factor leaf: 2-D+ tensors whose key is in ``targets`` and whose input
    dim is a multiple of the group size.  Other leaves pass through (a
    later ``quantize_tree`` picks up the plain factors).  Subtrees already
    sparse or quantized are left alone, so the pass is idempotent and
    runs before ``quantize_tree`` in the engine's load pipeline.  With
    ``axes`` (the matching logical-axes tree) both trees are rewritten
    and ``(sparams, saxes)`` is returned.  A targeted factor of an MoE
    expert bank raises ``ValueError`` (``refuse_expert_bank``)."""
    _, group = pattern_nm(pattern)
    targets = set(targets)

    def walk(node: Any, ax: Any, path: tuple = ()) -> tuple[Any, Any]:
        if not isinstance(node, dict):
            return node, ax
        if is_sparse(node) or is_quantized(node):
            return dict(node), (dict(ax) if isinstance(ax, dict) else ax)
        out, a_out = {}, {}
        for k, v in node.items():
            a_k = ax[k] if isinstance(ax, dict) else None
            if (k in targets and isinstance(v, torch.Tensor) and v.ndim >= 2
                    and v.shape[-2] % group == 0 and v.shape[-2] >= group):
                refuse_expert_bank((*path, k), f"sparsify={pattern!r}")
                sp, idx, scale = sparsify_array(v, pattern, mode)
                out[k + SP_SUFFIX] = sp
                out[k + IDX_SUFFIX] = idx
                if scale is not None:
                    out[k + SCALE_SUFFIX] = scale
                if isinstance(ax, dict):
                    a_out[k + SP_SUFFIX] = sparse_value_axes(a_k)
                    a_out[k + IDX_SUFFIX] = sparse_index_axes(a_k)
                    if scale is not None:
                        a_out[k + SCALE_SUFFIX] = scale_axes(a_k)
            else:
                out[k], a_out[k] = walk(v, a_k, (*path, k))
        return out, a_out

    sparams, saxes = walk(params, axes)
    return sparams if axes is None else (sparams, saxes)


def desparsify_tree(params: PyTree,
                    dtype: torch.dtype = torch.bfloat16) -> PyTree:
    """Inverse tree transform: restore plain (zero-padded) factor keys."""
    if not isinstance(params, dict):
        return params
    if is_sparse(params):
        return desparsify_subtree(params, dtype)
    return {k: desparsify_tree(v, dtype) for k, v in params.items()}


def relative_error_sparse(w: torch.Tensor, pattern: str = PATTERN_24,
                          mode: str = MODE_INT8) -> float:
    """``||w - expand(sparsify(w))|| / ||w||`` — the prune (+ quant)
    round-trip error."""
    sp, idx, scale = sparsify_array(w, pattern, mode)
    wf = w.to(torch.float32)
    num = float(torch.linalg.vector_norm(
        wf - expand_sparse(sp, idx, scale, torch.float32)))
    return num / max(float(torch.linalg.vector_norm(wf)), 1e-30)
