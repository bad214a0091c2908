"""Runtime KV-cache quantization: per-(slot, head, channel) int8 K/V.

The port's copy of the reference's int8 KV pool.  Layout (the
``k_q``/``k_scale`` pair convention of the weight side):

    {"k":  (B, S, KH, D)}
      -> {"k_q": int8 (B, S, KH, D), "k_scale": f32 (B, KH, D)}

One f32 scale per head_dim channel of each slot's K (or V) stream: the
absmax reduction runs over the sequence axis, so the decode kernel folds
K scales into the query row and V scales into the output.  The scale is
a running max; when a new token enlarges it, the slot's int8 history is
requantized at the larger scale (``round(q * old / new)``).

Writes are in place (the reference returns updated copies), like every
cache write of the port.  Where the reference skips the O(S) history
requant behind ``lax.cond`` unless some channel grew, the port runs it
on the device every time: reading a flag back to the host in every layer
of every step would stall the stream, and the requant is bit-exact where
no scale grew (the ratio is exactly 1 and ``round(q * 1.0) == q``).

The primitives are rank-polymorphic over the tail, as the reference's
are: GQA pools ``(B, S, KH, D)`` with ``(B, KH, D)`` scales and MLA
latent pools ``(B, S, r)`` with per-(slot, channel) ``(B, r)`` scales
alike, or stacked ``(L, B, S, ...)`` caches through
:func:`quantize_kv_tree`.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.quant.quantize import INT8_QMAX

PyTree = Any

#: runtime KV quantization modes
KV_MODES = ("int8",)

#: overflow ceiling of the running-max scales: a NaN/Inf activation must
#: corrupt only its own cache row, never the scale that the requant pass
#: multiplies into the slot's whole history.
KV_SCALE_MAX = 1e30


def check_mode(mode: str) -> None:
    if mode not in KV_MODES:
        raise ValueError(
            f"unknown kv quant mode {mode!r} (want one of {KV_MODES})")


def _finite_scale(candidate: torch.Tensor) -> torch.Tensor:
    """A non-finite absmax contributes nothing (0, so the running max
    keeps its old value); finite candidates cap at KV_SCALE_MAX."""
    return torch.where(torch.isfinite(candidate), candidate,
                       0.0).clamp_(max=KV_SCALE_MAX)


def _safe(scale: torch.Tensor) -> torch.Tensor:
    return torch.where(scale > 0, scale, 1.0)


def quantize_kv(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize ``x`` with a given (broadcastable) scale -> int8.
    Non-finite inputs land as 0."""
    q = torch.round(x.to(torch.float32) / _safe(scale))
    q = torch.where(torch.isfinite(q), q.clamp(-INT8_QMAX, INT8_QMAX), 0.0)
    return q.to(torch.int8)


def kv_scales(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Per-(slot, head, channel) scales: absmax over the sequence
    ``axis`` / 127, overflow-guarded."""
    return _finite_scale(x.to(torch.float32).abs().amax(dim=axis)
                         / INT8_QMAX)


def quantize_kv_prefill(x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, KH, D)`` -> ``(q int8 (B, S, KH, D), scale f32
    (B, KH, D))``, the absmax reduced over the prompt's sequence axis."""
    scale = kv_scales(x, axis=1)
    return quantize_kv(x, scale[:, None]), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q (B, S, KH, D) * scale (B, KH, D)`` -> ``(B, S, KH, D)``."""
    return (q.to(torch.float32) * scale[:, None]).to(dtype)


def _requant_(cache_q: torch.Tensor, scale: torch.Tensor,
              scale_new: torch.Tensor) -> None:
    """Rescale the int8 history in place from ``scale`` to the running
    max ``scale_new`` (B, KH, D); bit-exact where the scale did not
    grow."""
    ratio = torch.where(scale_new > 0, scale / _safe(scale_new), 1.0)
    h = cache_q.to(torch.float32).mul_(ratio[:, None])
    cache_q.copy_(h.round_().clamp_(-INT8_QMAX, INT8_QMAX))


def kv_write_chunk(cache_q: torch.Tensor, scale: torch.Tensor,
                   new: torch.Tensor, start: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Insert a prefill chunk's K (or V) into an int8 pool, in place.

    ``cache_q (B, S, KH, D)`` int8; ``scale (B, KH, D)`` f32;
    ``new (B, C, KH, D)``; ``start`` the chunk's sequence offset,
    clamped so the chunk fits (``dynamic_update_slice`` semantics).
    One absmax over the whole chunk updates the running max, the history
    is requantized once, and the chunk lands in one slice write.
    """
    newf = new.to(torch.float32)
    scale_new = torch.maximum(
        scale, _finite_scale(newf.abs().amax(dim=1) / INT8_QMAX))
    _requant_(cache_q, scale, scale_new)
    s_max, c = cache_q.shape[1], new.shape[1]
    if c > s_max:
        raise ValueError(f"{c} positions do not fit a cache of {s_max}")
    start = min(max(int(start), 0), s_max - c)
    cache_q[:, start:start + c] = quantize_kv(newf, scale_new[:, None])
    scale.copy_(scale_new)
    return cache_q, scale


def kv_write_token(cache_q: torch.Tensor, scale: torch.Tensor,
                   new: torch.Tensor, pos: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Insert one decoded token's K (or V) into an int8 pool, in place.

    ``cache_q (B, S, *tail)`` int8 (``tail`` ``(KH, D)`` or ``(r,)``);
    ``scale (B, *tail)`` f32; ``new (B, *tail)``; ``pos (B,)`` per-slot
    write positions.  The
    scale grows to ``max(scale, |new| / 127)`` for EVERY slot, idle ones
    included, and the history is requantized where it grew.  A negative
    position wraps once (JAX indexing); a position still outside
    ``[0, S)`` drops its row, as a JAX scatter drops an out-of-bounds
    update — its scale has grown all the same.  No host sync.
    """
    newf = new.to(torch.float32)
    scale_new = torch.maximum(scale, _finite_scale(newf.abs() / INT8_QMAX))
    _requant_(cache_q, scale, scale_new)
    q_new = quantize_kv(newf, scale_new)
    s_max = cache_q.shape[1]
    p = pos.to(device=cache_q.device, dtype=torch.long)
    p = torch.where(p < 0, p + s_max, p)
    valid = (p >= 0) & (p < s_max)
    pc = p.clamp(0, s_max - 1)
    rows = torch.arange(cache_q.shape[0], device=cache_q.device)
    cur = cache_q[rows, pc]
    cache_q[rows, pc] = torch.where(
        valid.reshape(-1, *([1] * (q_new.ndim - 1))), q_new, cur)
    scale.copy_(scale_new)
    return cache_q, scale


def quantize_kv_tree(cache: PyTree, prompt_len: int | None = None
                     ) -> PyTree:
    """Quantize a full-precision cache into the int8 pool layout (a new
    tree).  Every GQA dict ``{"k", "v"}`` (leaves ``(..., S, KH, D)``,
    sequence axis -3) and every MLA latent dict ``{"ckv", "krope"}``
    (leaves ``(..., S, r)``, sequence axis -2) becomes its ``*_q`` /
    ``*_scale`` pairs, per-layer or stacked ``(L, B, S, ...)`` alike.
    Positions ``>= prompt_len`` (the right-padded prefill tail) are
    masked out of the values and of the absmax, so the result equals the
    quantize-on-insert whole-prefill path.  A VLM's image K/V
    (``"cross_kv"``) stays in the model dtype, unmasked: it is no
    per-token stream, as in the reference's int8 pool."""
    def one(x: torch.Tensor, seq_axis: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
        xf = x.to(torch.float32)
        if prompt_len is not None:
            keep = (torch.arange(x.shape[seq_axis], device=x.device)
                    < int(prompt_len)).reshape(-1, *([1] * (-seq_axis - 1)))
            xf = torch.where(keep, xf, 0.0)
        scale = kv_scales(xf, axis=seq_axis)
        return quantize_kv(xf, scale.unsqueeze(seq_axis)), scale

    if isinstance(cache, dict):
        for names, seq_axis in ((("k", "v"), -3), (("ckv", "krope"), -2)):
            if set(cache) == set(names):
                out = {}
                for name in names:
                    out[name + "_q"], out[name + "_scale"] = one(
                        cache[name], seq_axis)
                return out
        return {k: v if k == "cross_kv" else quantize_kv_tree(v, prompt_len)
                for k, v in cache.items()}
    return cache


def kv_bytes_per_step(slots: int, seq_len: int, num_kv_heads: int,
                      head_dim: int, *, quantize: str | None = None,
                      dtype_bytes: int = 4) -> int:
    """Bytes one layer's K+V pool streams per decode step: every slot's
    full cache (masked, not skipped), at 1 byte per value plus the f32
    scale rows for int8."""
    n = slots * seq_len * num_kv_heads * head_dim
    if quantize in (None, "none"):
        return 2 * n * dtype_bytes
    check_mode(quantize)
    return 2 * n + 2 * slots * num_kv_heads * head_dim * 4
