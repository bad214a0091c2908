"""CachePlan for the full-width GQA slot pool (family ``gqa_f32``).

One plan per attention layer declares the cache leaves (``k``/``v``,
``(B, S, KH, D)`` in the model dtype — "f32" names full width, bf16
included), their byte accounting, the three write executors and the
cache-coupled decode attention.  The int8, MLA and paged families of the
reference come with ROADMAP items A7, A10 and A9.

The port writes caches IN PLACE (the reference returns updated copies):
a decode step would otherwise copy the whole pool.  Every writer returns
the dict it was given.  Two reference semantics are reproduced by hand
because torch raises or truncates where JAX does not:

* a prefill / chunk write whose window would run past the sequence end
  has its start clamped so the update fits
  (``lax.dynamic_update_slice_in_dim``);
* a decode write at a position outside ``[0, S)`` is dropped (a JAX
  scatter drops out-of-bounds updates; idle slots decode too, and the
  engine relies on positions past the pool being harmless).
"""
from __future__ import annotations

import dataclasses
import math

import torch

FAMILY_GQA = "gqa_f32"

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class CachePlan:
    """How one attention layer's K/V cache is laid out, costed and
    executed."""

    num_kv_heads: int
    head_dim: int
    dtype: torch.dtype
    family: str = FAMILY_GQA

    @property
    def leaf_names(self) -> tuple[str, ...]:
        return ("k", "v")

    def shape(self, batch: int, seq_len: int) -> tuple[int, ...]:
        return (batch, seq_len, self.num_kv_heads, self.head_dim)

    def init(self, batch: int, seq_len: int,
             device: str | torch.device = "cuda") -> dict:
        return {n: torch.zeros(self.shape(batch, seq_len), dtype=self.dtype,
                               device=device)
                for n in self.leaf_names}

    # -- accounting ---------------------------------------------------------

    @property
    def bytes_per_token(self) -> int:
        """Per-position cache bytes of ONE stream, this layer."""
        return 2 * self.num_kv_heads * self.head_dim * self.dtype.itemsize

    def bytes_per_step(self, slots: int, seq_len: int) -> int:
        """Bytes the pool streams per decode step (every slot's full
        ``seq_len`` is read: masked, not skipped)."""
        return slots * seq_len * self.bytes_per_token

    # -- write executors ----------------------------------------------------
    # ``new`` holds the layer's values {"k", "v"}: (B, S, KH, D), or
    # (B, KH, D) for a decode write.

    @staticmethod
    def _write_at(cache: dict, new: dict, start: int) -> dict:
        for key, x in new.items():
            s_max, sq = cache[key].shape[1], x.shape[1]
            if sq > s_max:
                raise ValueError(f"{sq} positions do not fit a cache of "
                                 f"{s_max}")
            start = min(max(int(start), 0), s_max - sq)   # clamp to fit
            cache[key][:, start:start + sq] = x.to(cache[key].dtype)
        return cache

    def write_prefill(self, cache: dict, new: dict,
                      prompt_len: int | None = None) -> dict:
        """Whole-prompt write at position 0.  (``prompt_len`` only
        matters to quantized families; full-width pools keep the pad
        rows, which causality hides and insert masks.)"""
        del prompt_len
        return self._write_at(cache, new, 0)

    def write_chunk(self, cache: dict, new: dict, start_pos: int,
                    prompt_len: int | None = None) -> tuple[dict, dict]:
        """Chunk write at sequence offset ``start_pos``; rows at absolute
        positions ``>= prompt_len`` (bucket padding) are zeroed first.
        Returns ``(cache, view)`` — for a full-width pool the attend view
        is the written pool itself."""
        if prompt_len is not None:
            masked = {}
            for key, x in new.items():
                pos = int(start_pos) + torch.arange(x.shape[1],
                                                    device=x.device)
                keep = (pos < int(prompt_len)).reshape(1, -1, 1, 1)
                masked[key] = torch.where(keep, x, torch.zeros_like(x))
            new = masked
        cache = self._write_at(cache, new, start_pos)
        return cache, cache

    def write_decode(self, cache: dict, new: dict,
                     cache_pos: torch.Tensor) -> dict:
        """One-token write at per-slot positions ``cache_pos`` (B,);
        positions outside the pool are dropped.  No host sync: dropped
        rows rewrite the value already stored at a clamped position."""
        for key, x in new.items():
            pool = cache[key]
            s_max = pool.shape[1]
            pos = cache_pos.to(device=pool.device, dtype=torch.long)
            pos = torch.where(pos < 0, pos + s_max, pos)  # JAX index wrap
            valid = (pos >= 0) & (pos < s_max)
            pc = pos.clamp(0, s_max - 1)
            rows = torch.arange(pool.shape[0], device=pool.device)
            cur = pool[rows, pc]
            pool[rows, pc] = torch.where(valid.reshape(-1, 1, 1),
                                         x.to(pool.dtype), cur)
        return cache

    # -- decode attention ---------------------------------------------------

    def attend_decode(self, q: torch.Tensor, cache: dict,
                      cache_pos: torch.Tensor, *,
                      softcap: float = 0.0) -> torch.Tensor:
        """One query row vs the whole pool.  q (B, 1, H, D) ->
        (B, 1, H, D); positions ``> cache_pos`` are masked."""
        skv = cache["k"].shape[1]
        pos = cache_pos.to(device=q.device, dtype=torch.long)
        valid = (torch.arange(skv, device=q.device)[None, :]
                 <= pos[:, None])
        return gqa_decode_attention(q, cache["k"], cache["v"], valid,
                                    softcap)


def gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor, softcap: float
                         ) -> torch.Tensor:
    """Full-width GQA decode attention: q (B, 1, H, D) vs k/v
    (B, S, KH, D), slot validity (B, S) masked into the f32 logits."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                     k.to(torch.float32)) * (1.0 / math.sqrt(hd))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid[:, None, None, None, :], s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return o.reshape(b, sq, h, hd)


def gqa_plan(num_kv_heads: int, head_dim: int, dtype: torch.dtype,
             quantize: str | None = None) -> CachePlan:
    """The plan for one GQA attention layer's K/V cache."""
    if quantize not in (None, "none"):
        raise NotImplementedError(
            "int8 KV pools come with ROADMAP item A7 (int8 KV cache)")
    return CachePlan(num_kv_heads, head_dim, dtype)


def build_cache_plan(cfg, dtype: torch.dtype,
                     kv_quantize: str | None = None) -> CachePlan:
    if cfg.mla:
        raise NotImplementedError("MLA latent caches come with ROADMAP "
                                  "item A10 (MLA)")
    return gqa_plan(cfg.num_kv_heads, cfg.resolved_head_dim, dtype,
                    kv_quantize)
