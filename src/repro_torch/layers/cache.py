"""CachePlan for the GQA slot pool: full width (``gqa_f32``) or int8
(``gqa_int8``).

One plan per attention layer declares the cache leaves, their byte
accounting, the three write executors and the cache-coupled decode
attention:

* ``gqa_f32`` — ``k``/``v`` ``(B, S, KH, D)`` in the model dtype ("f32"
  names full width, bf16 included);
* ``gqa_int8`` — ``k_q``/``v_q`` ``(B, S, KH, D)`` int8 plus
  ``k_scale``/``v_scale`` ``(B, KH, D)`` f32 per-(slot, head, channel)
  scales (:mod:`repro_torch.quant.kv`); decode attention runs the
  ``decode_attention_q`` kernel on the int8 pool.

The MLA and paged families of the reference come with ROADMAP items A10
and A9.

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

from repro_torch.quant import kv as kvq

FAMILY_GQA = "gqa_f32"
FAMILY_GQA_INT8 = "gqa_int8"

#: leaves with a sequence axis (``(B, S, KH, D)``); the scale rows
#: ``(B, KH, D)`` have none
SEQ_LEAVES = ("k", "v", "k_q", "v_q")

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
    def quantized(self) -> bool:
        return self.family == FAMILY_GQA_INT8

    def leaves(self, batch: int, seq_len: int
               ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """``{name: (shape, dtype)}`` of one layer's cache leaves."""
        value = (batch, seq_len, self.num_kv_heads, self.head_dim)
        if not self.quantized:
            return {n: (value, self.dtype) for n in ("k", "v")}
        row = (batch, self.num_kv_heads, self.head_dim)
        return {"k_q": (value, torch.int8), "k_scale": (row, torch.float32),
                "v_q": (value, torch.int8), "v_scale": (row, torch.float32)}

    def init(self, batch: int, seq_len: int,
             device: str | torch.device = "cuda") -> dict:
        """Zero cache (zero scales dequantize to zeros)."""
        return {n: torch.zeros(shape, dtype=dt, device=device)
                for n, (shape, dt) in self.leaves(batch, seq_len).items()}

    # -- accounting ---------------------------------------------------------

    @property
    def bytes_per_token(self) -> int:
        """Per-position cache bytes of ONE stream, this layer."""
        itemsize = 1 if self.quantized else self.dtype.itemsize
        return 2 * self.num_kv_heads * self.head_dim * itemsize

    @property
    def bytes_per_slot(self) -> int:
        """Per-slot constant bytes (the f32 scale rows), this layer."""
        return 2 * self.num_kv_heads * self.head_dim * 4 \
            if self.quantized else 0

    def bytes_per_step(self, slots: int, seq_len: int) -> int:
        """Bytes the pool streams per decode step (every slot's full
        ``seq_len`` is read: masked, not skipped)."""
        return slots * (seq_len * self.bytes_per_token + self.bytes_per_slot)

    # -- write executors ----------------------------------------------------
    # ``new`` holds the layer's full-precision values under their logical
    # names {"k", "v"}: (B, S, KH, D), or (B, KH, D) for a decode write.

    @staticmethod
    def _mask_new(new: dict, start_pos: int, prompt_len: int | None
                  ) -> dict:
        """Zero rows at absolute positions ``>= prompt_len`` (bucket-pad
        tail) so they neither land garbage in the pool nor inflate the
        int8 running-max scales."""
        if prompt_len is None:
            return new
        masked = {}
        for key, x in new.items():
            pos = int(start_pos) + torch.arange(x.shape[1], device=x.device)
            keep = (pos < int(prompt_len)).reshape(1, -1, 1, 1)
            masked[key] = torch.where(keep, x, torch.zeros_like(x))
        return masked

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
        """Whole-prompt write at position 0.  Full-width pools keep the
        pad rows (causality hides them and insert masks them); int8 pools
        quantize on insert, with one-shot scales over the real prompt
        (``prompt_len`` masks the pad tail out first)."""
        if not self.quantized:
            return self._write_at(cache, new, 0)
        for key, x in self._mask_new(new, 0, prompt_len).items():
            q, scale = kvq.quantize_kv_prefill(x)
            self._write_at(cache, {key + "_q": q}, 0)
            cache[key + "_scale"].copy_(scale)
        return cache

    def write_chunk(self, cache: dict, new: dict, start_pos: int,
                    prompt_len: int | None = None) -> tuple[dict, dict]:
        """Chunk write at sequence offset ``start_pos``; rows at absolute
        positions ``>= prompt_len`` (bucket padding) are zeroed first.
        Returns ``(cache, view)``: the full-precision whole-pool attend
        view under the logical names — the written pool itself for a
        full-width pool, the dequantized pool for int8 (serve stages
        chunked prompts at full width instead, for exactness)."""
        new = self._mask_new(new, start_pos, prompt_len)
        if not self.quantized:
            cache = self._write_at(cache, new, start_pos)
            return cache, cache
        view = {}
        for key, x in new.items():
            q, scale = kvq.kv_write_chunk(cache[key + "_q"],
                                          cache[key + "_scale"], x,
                                          start_pos)
            view[key] = kvq.dequantize_kv(q, scale, x.dtype)
        return cache, view

    def write_decode(self, cache: dict, new: dict,
                     cache_pos: torch.Tensor) -> dict:
        """One-token write at per-slot positions ``cache_pos`` (B,);
        positions outside the pool are dropped.  No host sync: dropped
        rows rewrite the value already stored at a clamped position.
        Int8 pools take the running-max scale update
        (:func:`repro_torch.quant.kv.kv_write_token`)."""
        if self.quantized:
            for key, x in new.items():
                kvq.kv_write_token(cache[key + "_q"], cache[key + "_scale"],
                                   x, cache_pos)
            return cache
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
        (B, 1, H, D); positions ``> cache_pos`` are masked.  Int8 pools
        go through :func:`repro_torch.kernels.ops.decode_attention_q`
        (the kernel on the card, its plain version on the CPU)."""
        if self.quantized:
            from repro_torch.kernels import ops
            return ops.decode_attention_q(
                q, cache["k_q"], cache["k_scale"], cache["v_q"],
                cache["v_scale"], cache_pos, softcap=softcap)
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
    """The plan for one GQA attention layer's K/V cache (``quantize``
    None / "none" or "int8")."""
    if quantize in (None, "none"):
        return CachePlan(num_kv_heads, head_dim, dtype)
    kvq.check_mode(quantize)
    return CachePlan(num_kv_heads, head_dim, dtype, FAMILY_GQA_INT8)


def build_cache_plan(cfg, dtype: torch.dtype,
                     kv_quantize: str | None = None) -> CachePlan:
    if cfg.mla:
        raise NotImplementedError("MLA latent caches come with ROADMAP "
                                  "item A10 (MLA)")
    return gqa_plan(cfg.num_kv_heads, cfg.resolved_head_dim, dtype,
                    kv_quantize)


def plan_from_cache(cache: dict, dtype: torch.dtype = torch.float32
                    ) -> CachePlan:
    """Classify a per-layer GQA cache dict into its plan, for callers
    that thread none.  Geometry comes from the leaf shapes; ``dtype`` is
    only read for the int8 family (full-width leaves carry theirs)."""
    if "k_q" in cache:
        kh, hd = cache["k_q"].shape[-2:]
        return gqa_plan(kh, hd, dtype, "int8")
    if "k" in cache:
        kh, hd = cache["k"].shape[-2:]
        return gqa_plan(kh, hd, cache["k"].dtype)
    raise ValueError(f"not a GQA KV cache dict: {sorted(cache)}")
