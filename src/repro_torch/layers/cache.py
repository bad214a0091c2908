"""CachePlan for the KV pools: GQA (slot or paged, full width or int8)
and the MLA latent pools.

One plan per attention layer declares the cache leaves, their byte
accounting, the three write executors and the cache-coupled decode
attention:

* ``gqa_f32`` — ``k``/``v`` ``(B, S, KH, D)`` in the model dtype ("f32"
  names full width, bf16 included);
* ``gqa_int8`` — ``k_q``/``v_q`` ``(B, S, KH, D)`` int8 plus
  ``k_scale``/``v_scale`` ``(B, KH, D)`` f32 per-(slot, head, channel)
  scales (:mod:`repro_torch.quant.kv`); decode attention runs the
  ``decode_attention_q`` kernel on the int8 pool;
* ``gqa_paged_f32`` / ``gqa_paged_int8`` — the paged pool
  (:class:`PagedGeometry`): value leaves ``(NB+1, bs, KH, D)`` whose
  batch axis indexes physical blocks (block ``NB`` is the dummy that idle
  table entries point at), int8 scale rows ``(NB+1, KH, D)`` — one per
  block, so a shared prefix block travels with its own scales — and a
  ``block_tables`` leaf ``(slots, blocks_per_slot)`` int32.  Decode
  attention runs the ``decode_attention_paged[_q]`` kernels through the
  tables; prompts never write the paged pool directly (serve stages
  them in a contiguous stream cache, and the pool manager scatters whole
  blocks, :mod:`repro_torch.serve.pool`);
* ``mla_latent`` — MLA's latents ``ckv`` ``(B, S, r)`` and ``krope``
  ``(B, S, rope)`` in the model dtype; decode attends in the absorbed
  form in plain torch, as the reference does in plain jnp;
* ``mla_latent_int8`` — ``ckv_q``/``krope_q`` int8 plus per-(slot,
  channel) f32 scales ``(B, r)`` / ``(B, rope)`` (no head axis: every
  head shares the one latent stream); decode attention runs the
  ``decode_attention_latent_q`` kernel.  There is no paged MLA pool, as
  in the reference.

A plan is its family plus the tail shape of each logical leaf (``k``,
``v`` or ``ckv``, ``krope``): every leaf, byte count and write derives
from those, whatever the rank of the tail.

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
FAMILY_MLA = "mla_latent"
FAMILY_MLA_INT8 = "mla_latent_int8"
FAMILY_GQA_PAGED = "gqa_paged_f32"
FAMILY_GQA_PAGED_INT8 = "gqa_paged_int8"

#: sequence-axis position (from the right) of every per-position cache
#: leaf, by key: K/V pools are ``(..., S, KH, D)``, latents ``(..., S,
#: r)``.  Scale rows have no sequence axis.
SEQ_AXIS: dict[str, int] = {
    "k": -3, "v": -3, "k_q": -3, "v_q": -3,
    "ckv": -2, "krope": -2, "ckv_q": -2, "krope_q": -2,
}

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class PagedGeometry:
    """Static geometry of a paged KV pool: value leaves are laid out
    ``(num_blocks + 1, block_size, ...)``, physical block ``num_blocks``
    being the dummy that idle table entries point at, and each slot's row
    of ``block_tables (slots, blocks_per_slot)`` maps its logical blocks
    to physical ones."""

    block_size: int       #: tokens per KV block
    num_blocks: int       #: usable blocks (the leaves hold one more)
    slots: int            #: concurrent streams (block-table rows)
    blocks_per_slot: int  #: max_seq // block_size (table row width)

    @property
    def dummy_block(self) -> int:
        return self.num_blocks

    @property
    def max_seq(self) -> int:
        return self.block_size * self.blocks_per_slot


@dataclasses.dataclass(frozen=True)
class CachePlan:
    """How one attention layer's cache is laid out, costed and
    executed."""

    family: str
    #: ``(logical leaf, tail shape)`` pairs: the dims after (batch, seq)
    #: of ``k``/``v`` ``(KH, D)`` or of ``ckv``/``krope`` ``(r,)``
    tails: tuple[tuple[str, tuple[int, ...]], ...]
    dtype: torch.dtype
    #: paged families carry their block geometry; slot families None
    paged: PagedGeometry | None = None

    @property
    def quantized(self) -> bool:
        return self.family in (FAMILY_GQA_INT8, FAMILY_MLA_INT8,
                               FAMILY_GQA_PAGED_INT8)

    @property
    def mla(self) -> bool:
        return self.family in (FAMILY_MLA, FAMILY_MLA_INT8)

    def leaves(self, batch: int, seq_len: int
               ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
        """``{name: (shape, dtype)}`` of one layer's cache leaves (for a
        paged plan, ``batch`` = physical blocks + 1 and ``seq_len`` = the
        block size)."""
        out = {}
        for name, tail in self.tails:
            value = (batch, seq_len, *tail)
            if not self.quantized:
                out[name] = (value, self.dtype)
            else:
                out[name + "_q"] = (value, torch.int8)
                out[name + "_scale"] = ((batch, *tail), torch.float32)
        if self.paged is not None:
            out["block_tables"] = ((self.paged.slots,
                                    self.paged.blocks_per_slot), torch.int32)
        return out

    def fill_value(self, name: str) -> int:
        """A fresh leaf's value: block tables point at the dummy block
        (an unallocated stream never aliases live data), all else 0
        (zero scales dequantize to zeros)."""
        return self.paged.dummy_block if name == "block_tables" else 0

    def init(self, batch: int, seq_len: int,
             device: str | torch.device = "cuda") -> dict:
        """A fresh cache of one layer."""
        return {n: torch.full(shape, self.fill_value(n), dtype=dt,
                              device=device)
                for n, (shape, dt) in self.leaves(batch, seq_len).items()}

    # -- accounting ---------------------------------------------------------

    @property
    def _values_per_position(self) -> int:
        return sum(math.prod(tail) for _, tail in self.tails)

    @property
    def bytes_per_token(self) -> int:
        """Per-position cache bytes of ONE stream, this layer."""
        itemsize = 1 if self.quantized else self.dtype.itemsize
        return self._values_per_position * itemsize

    @property
    def bytes_per_slot(self) -> int:
        """Per-slot constant bytes (the f32 scale rows), this layer; for
        a paged plan, per physical block."""
        return self._values_per_position * 4 if self.quantized else 0

    @property
    def bytes_per_block(self) -> int:
        """KV bytes of one physical block of a paged plan: ``block_size``
        positions plus the block's scale rows."""
        if self.paged is None:
            raise ValueError(f"{self.family} is not a paged family")
        return (self.paged.block_size * self.bytes_per_token
                + self.bytes_per_slot)

    def bytes_per_step(self, slots: int, seq_len: int) -> int:
        """Bytes the pool streams per decode step, as the reference
        counts them: every slot's full ``seq_len`` (masked, not skipped);
        a paged pool one block per table entry plus the entries."""
        if self.paged is not None:
            nblk = seq_len // self.paged.block_size
            return slots * nblk * (self.bytes_per_block + 4)
        return slots * (seq_len * self.bytes_per_token + self.bytes_per_slot)

    # -- write executors ----------------------------------------------------
    # ``new`` holds the layer's full-precision values under their logical
    # names: {"k", "v"} (B, S, KH, D) or {"ckv", "krope"} (B, S, r); a
    # decode write's values carry no S axis.

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
            keep = (pos < int(prompt_len)).reshape(
                1, -1, *([1] * (x.ndim - 2)))
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

    def _no_paged_writes(self, what: str) -> None:
        if self.paged is not None:
            raise ValueError(
                f"paged pools take no {what} writes: serve stages prompts "
                "in a contiguous stream cache and the pool manager "
                "scatters whole blocks at insert")

    def write_prefill(self, cache: dict, new: dict,
                      prompt_len: int | None = None) -> dict:
        """Whole-prompt write at position 0.  Full-width pools keep the
        pad rows (causality hides them and insert masks them); int8 pools
        quantize on insert, with one-shot scales over the real prompt
        (``prompt_len`` masks the pad tail out first)."""
        self._no_paged_writes("prefill")
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
        self._no_paged_writes("chunk")
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
        if self.paged is not None:
            return self._write_decode_paged(cache, new, cache_pos)
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
            pool[rows, pc] = torch.where(
                valid.reshape(-1, *([1] * (x.ndim - 1))), x.to(pool.dtype),
                cur)
        return cache

    def _write_decode_paged(self, cache: dict, new: dict,
                            cache_pos: torch.Tensor) -> dict:
        """One-token write through the block tables: block
        ``tables[slot, pos // bs]``, row ``pos % bs``.  A position past
        the table lands in the dummy block (the slot pool drops it), as
        does an idle slot's write (its row points at the dummy).  Int8
        takes the running-max scale update on the ONE gathered block
        (:func:`repro_torch.quant.kv.kv_write_token` on a copy), then
        scatters block and scale row back — a shared prefix block is
        never the target, decode always lands past the shared prefix.
        No host sync."""
        geom = self.paged
        bt = cache["block_tables"]
        pos = cache_pos.to(device=bt.device, dtype=torch.long)
        slots = torch.arange(pos.shape[0], device=bt.device)
        blk = torch.clamp(torch.div(pos, geom.block_size,
                                    rounding_mode="floor"),
                          max=geom.blocks_per_slot - 1)
        phys = torch.where(pos < geom.max_seq, bt[slots, blk].long(),
                           geom.dummy_block)
        row = torch.remainder(pos, geom.block_size)
        if not self.quantized:
            for key, x in new.items():
                cache[key][phys, row] = x.to(cache[key].dtype)
            return cache
        for key, x in new.items():
            values, scales = cache[key + "_q"], cache[key + "_scale"]
            blocks, rows = values[phys], scales[phys]
            kvq.kv_write_token(blocks, rows, x, row)
            values[phys] = blocks
            scales[phys] = rows
        return cache

    # -- decode attention ---------------------------------------------------

    def attend_decode(self, q: torch.Tensor, cache: dict,
                      cache_pos: torch.Tensor, *,
                      softcap: float = 0.0) -> torch.Tensor:
        """One query row vs the whole pool.  q (B, 1, H, D) ->
        (B, 1, H, D); positions ``> cache_pos`` are masked.  Int8 and
        paged pools go through :mod:`repro_torch.kernels.ops`
        (``decode_attention_q`` / ``decode_attention_paged[_q]``: the
        kernel on the card, its plain version on the CPU)."""
        from repro_torch.kernels import ops
        if self.mla:
            raise ValueError("latent families attend via "
                             "attend_decode_latent")
        if self.paged is not None:
            bt = cache["block_tables"]
            if not self.quantized:
                return ops.decode_attention_paged(
                    q, cache["k"], cache["v"], bt, cache_pos,
                    softcap=softcap)
            return ops.decode_attention_paged_q(
                q, cache["k_q"], cache["k_scale"], cache["v_q"],
                cache["v_scale"], bt, cache_pos, softcap=softcap)
        if self.quantized:
            return ops.decode_attention_q(
                q, cache["k_q"], cache["k_scale"], cache["v_q"],
                cache["v_scale"], cache_pos, softcap=softcap)
        skv = cache["k"].shape[1]
        pos = cache_pos.to(device=q.device, dtype=torch.long)
        valid = (torch.arange(skv, device=q.device)[None, :]
                 <= pos[:, None])
        return gqa_decode_attention(q, cache["k"], cache["v"], valid,
                                    softcap)


    def attend_decode_latent(self, q_lat: torch.Tensor,
                             q_rope: torch.Tensor, cache: dict,
                             cache_pos: torch.Tensor, *,
                             scale: float) -> torch.Tensor:
        """MLA's absorbed decode: latent-space queries against the latent
        pool, per-head K/V never materialised.  q_lat (B, 1, H, r);
        q_rope (B, 1, H, rope) -> context latents (B, 1, H, r).  The int8
        pool goes through :func:`repro_torch.kernels.ops.
        decode_attention_latent_q` (the kernel on the card, its plain
        version on the CPU); the full-width pool attends in plain torch,
        as the reference does in jnp: f32 logits, probabilities rounded to
        the query dtype before the context product."""
        if not self.mla:
            raise ValueError("GQA families attend via attend_decode")
        if self.quantized:
            from repro_torch.kernels import ops
            return ops.decode_attention_latent_q(
                q_lat, q_rope, cache["ckv_q"], cache["ckv_scale"],
                cache["krope_q"], cache["krope_scale"], cache_pos,
                scale=scale)
        cc, cr = cache["ckv"], cache["krope"]
        s = (torch.einsum("bqhl,bsl->bhqs", q_lat.to(torch.float32),
                          cc.to(torch.float32))
             + torch.einsum("bqhr,bsr->bhqs", q_rope.to(torch.float32),
                            cr.to(torch.float32))) * scale
        pos = cache_pos.to(device=q_lat.device, dtype=torch.long)
        valid = (torch.arange(cc.shape[1], device=q_lat.device)[None, :]
                 <= pos[:, None])
        s = torch.where(valid[:, None, None, :], s, _NEG_INF)
        attn = torch.softmax(s, dim=-1).to(q_lat.dtype)
        return torch.einsum("bhqs,bsl->bqhl", attn, cc.to(q_lat.dtype))


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


def _family_plan(family: str, quant_family: str,
                 tails: tuple[tuple[str, tuple[int, ...]], ...],
                 dtype: torch.dtype, quantize: str | None,
                 paged: PagedGeometry | None = None) -> CachePlan:
    if quantize in (None, "none"):
        return CachePlan(family, tails, dtype, paged)
    kvq.check_mode(quantize)
    return CachePlan(quant_family, tails, dtype, paged)


def gqa_plan(num_kv_heads: int, head_dim: int, dtype: torch.dtype,
             quantize: str | None = None) -> CachePlan:
    """The plan for one GQA attention layer's K/V cache (``quantize``
    None / "none" or "int8")."""
    tail = (num_kv_heads, head_dim)
    return _family_plan(FAMILY_GQA, FAMILY_GQA_INT8,
                        (("k", tail), ("v", tail)), dtype, quantize)


def gqa_paged_plan(num_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   quantize: str | None = None, *,
                   geometry: PagedGeometry) -> CachePlan:
    """The plan for one GQA layer's paged K/V pool (``quantize`` None /
    "none" or "int8")."""
    tail = (num_kv_heads, head_dim)
    return _family_plan(FAMILY_GQA_PAGED, FAMILY_GQA_PAGED_INT8,
                        (("k", tail), ("v", tail)), dtype, quantize,
                        geometry)


def mla_plan(kv_lora_rank: int, qk_rope_dim: int, dtype: torch.dtype,
             quantize: str | None = None) -> CachePlan:
    """The plan for one MLA layer's latent cache (``quantize`` None /
    "none" or "int8").  The latent is the rank-compressed K/V factor;
    the int8 family compresses it again with per-(slot, channel)
    scales."""
    return _family_plan(FAMILY_MLA, FAMILY_MLA_INT8,
                        (("ckv", (kv_lora_rank,)),
                         ("krope", (qk_rope_dim,))), dtype, quantize)


def build_cache_plan(cfg, dtype: torch.dtype,
                     kv_quantize: str | None = None,
                     paged: PagedGeometry | None = None) -> CachePlan:
    """The per-attention-layer plan of a model config: ``cfg.mla``
    selects the latent families, a ``paged`` geometry the paged GQA
    families (there is no paged latent pool, as in the reference)."""
    if paged is not None:
        if cfg.mla:
            raise ValueError("paged KV pools serve the GQA families only "
                             "(no paged MLA latent cache)")
        return gqa_paged_plan(cfg.num_kv_heads, cfg.resolved_head_dim,
                              dtype, kv_quantize, geometry=paged)
    if cfg.mla:
        return mla_plan(cfg.kv_lora_rank, cfg.qk_rope_dim, dtype,
                        kv_quantize)
    return gqa_plan(cfg.num_kv_heads, cfg.resolved_head_dim, dtype,
                    kv_quantize)


def plan_from_cache(cache: dict, dtype: torch.dtype = torch.float32
                    ) -> CachePlan:
    """Classify a per-layer cache dict into its plan, for callers that
    thread none.  Geometry comes from the leaf shapes; ``dtype`` is only
    read for the int8 families (full-width leaves carry theirs)."""
    if "block_tables" in cache:
        val = cache.get("k", cache.get("k_q"))
        nb1, bs, kh, hd = val.shape[-4:]
        slots, bpslot = cache["block_tables"].shape[-2:]
        geom = PagedGeometry(bs, nb1 - 1, slots, bpslot)
        if "k_q" in cache:
            return gqa_paged_plan(kh, hd, dtype, "int8", geometry=geom)
        return gqa_paged_plan(kh, hd, cache["k"].dtype, geometry=geom)
    if "ckv_q" in cache:
        return mla_plan(cache["ckv_q"].shape[-1],
                        cache["krope_q"].shape[-1], dtype, "int8")
    if "ckv" in cache:
        return mla_plan(cache["ckv"].shape[-1], cache["krope"].shape[-1],
                        cache["ckv"].dtype)
    if "k_q" in cache:
        kh, hd = cache["k_q"].shape[-2:]
        return gqa_plan(kh, hd, dtype, "int8")
    if "k" in cache:
        kh, hd = cache["k"].shape[-2:]
        return gqa_plan(kh, hd, cache["k"].dtype)
    raise ValueError(f"not a KV cache dict: {sorted(cache)}")
