"""KV pool managers: slot / block and KV-byte accounting over the serve
cache pool.

:class:`KVPoolManager` — the slot pool, the model's stacked cache
``(L, slots, S_max, KH, D)`` (or MLA latents ``(L, slots, S_max, r)``),
one batch slot per in-flight stream, in the full-width ``gqa_f32`` /
``mla_latent`` or the int8 ``gqa_int8`` / ``mla_latent_int8`` family
(``kv_quantize="int8"``: int8 values plus ``(L, slots, KH, D)`` or
``(L, slots, r)`` f32 scale rows), or the recurrent families' state
``(L, slots, ...)`` (no sequence axis, no per-token bytes; the hybrid's
shared attention KV beside it), or the VLM's self-block entries beside
its image K/V ``cross_kv`` ``(n_super, slots, T_img, KH, D)`` (model
dtype in either family, read by every decode step, no sequence mask).
:class:`PagedKVPoolManager` — the paged pool, fixed-size physical
blocks behind per-slot block tables with radix prefix sharing
(``gqa_paged_f32`` / ``gqa_paged_int8``, :mod:`repro_torch.serve.paging`;
no MLA).

A manager owns the state side of the serve stack: the cache tensors and
per-slot write positions, slot allocation with admission tickets
(preemption evicts the youngest stream first), byte accounting derived
from the model's cache plans, and the insert that lands a finished
batch=1 staging cache in the pool — quantizing a full-precision
chunked-prefill staging cache into an int8 pool on the way.  Both take
the same ``allocate(..., tokens=)`` / ``can_admit(..., tokens=)`` /
``grow(..., token=)`` / ``release(..., publish=)`` surface; the slot pool
ignores the prompt tokens and the publishing, which only the paged
pool's prefix registry needs.  Both carry the fault points of
:mod:`repro_torch.serve.faults` (``pool_alloc``, the paged
``radix_match``, ``block_scale`` on int8 pools) and an invariant oracle,
``check_integrity()``, that the engine runs after every step under
``debug=True``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.layers.cache import SEQ_AXIS, PagedGeometry
from repro_torch.quant.kv import kv_scales, quantize_kv, quantize_kv_tree
from repro_torch.serve import paging
from repro_torch.serve.faults import NULL_INJECTOR
from repro_torch.serve.paging import PoolExhausted

PyTree = Any

#: the VLM cache's image K/V entry (no per-token stream: never masked,
#: never quantized, not in the per-token byte accounting)
CROSS_KV = "cross_kv"


class IntegrityError(AssertionError):
    """A pool invariant does not hold (slot state, tickets, refcounts vs
    block tables, the free / cold / referenced partition, byte
    accounting); raised by ``check_integrity()``."""


def _at(lead: int, *index) -> tuple:
    """The index of ``index`` past ``lead`` leading (layer) axes."""
    return (slice(None),) * lead + index


def _leaf_names(cache: PyTree) -> dict[str, set[str]]:
    return {top: set(entry) for top, entry in cache.items()}


def _corrupt_scale(cache: PyTree, index: int) -> None:
    """The ``block_scale`` fault: set row ``index`` (a slot of the slot
    pool, a physical block of the paged one) of the first ``*_scale``
    leaf in sorted tree order to ``+inf`` on every layer, as the
    reference's ``_corrupt_scale_leaf`` does.  The dequantized KV goes
    non-finite and the stream's next logits trip the watchdog."""
    for top in sorted(cache):
        names = sorted(n for n in cache[top] if n.endswith("_scale"))
        if names:
            leaf = cache[top][names[0]]
            ax = leaf.ndim - (3 if names[0] in ("k_scale", "v_scale")
                              else 2)
            leaf[_at(ax, index)] = float("inf")
            return


class KVPoolManager:
    """Slot/byte owner for one engine's KV pool."""

    def __init__(self, model, slots: int, max_seq: int, *,
                 kv_quantize: str | None = None,
                 byte_budget: int | None = None):
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.kv_quantize = kv_quantize
        self.byte_budget = byte_budget
        #: fault source (inert unless the engine threads its injector in)
        self.faults = NULL_INJECTOR
        self.cache = model.init_cache(slots, max_seq, kv_quantize)
        self.positions = np.zeros((slots,), np.int32)   # next write pos
        self.lengths = np.zeros((slots,), np.int64)     # logical KV tokens
        self.tickets = np.full((slots,), -1, np.int64)  # admission age
        self._next_ticket = 0
        #: one CachePlan per attention layer — the source of all bytes
        self.plans = model.cache_plans(kv_quantize)
        #: rank of one layer's leaf, by name (KV leaves and recurrent
        #: state): a cache entry's leaves carry the layer axis where they
        #: have one more ("blocks", the hybrid's "shared" group axis), none
        #: where they have not (an unstacked "first" block)
        self._rank = {n: len(shape) for n, (shape, _) in
                      {**model.cache_plan(kv_quantize).leaves(
                          slots, max_seq),
                       **model.state_leaves(slots)}.items()}
        #: per-position KV bytes of ONE stream across all layers
        self.bytes_per_token = sum(p.bytes_per_token for p in self.plans)
        #: bytes the whole pool streams per decode step: the plans' and
        #: a VLM's image K/V (a per-image constant stream outside the
        #: per-token plans, read every step too)
        self.kv_bytes_per_step = sum(p.bytes_per_step(slots, max_seq)
                                     for p in self.plans) + sum(
            t.numel() * t.element_size()
            for t in self.cache.get(CROSS_KV, {}).values())

    # -- slot bookkeeping ---------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots) if self.tickets[i] < 0]

    def occupied_slots(self) -> list[int]:
        return [i for i in range(self.slots) if self.tickets[i] >= 0]

    def allocate(self, slot: int, length: int,
                 tokens: list[int] | None = None) -> int:
        """Reserve ``slot`` for a stream of ``length`` prompt tokens (the
        whole prompt's bytes are reserved up front).  Returns the leading
        prompt tokens whose KV is already pooled: always 0 here (the
        paged pool prefix-matches ``tokens``)."""
        del tokens
        if self.tickets[slot] >= 0:
            raise ValueError(f"slot {slot} is occupied")
        if self.faults.fire("pool_alloc"):
            raise PoolExhausted("injected: pool_alloc (slot pool)")
        self.tickets[slot] = self._next_ticket
        self._next_ticket += 1
        self.lengths[slot] = length
        self.positions[slot] = 0
        return 0

    def grow(self, slot: int, n: int = 1, token: int | None = None) -> None:
        """Account ``n`` decoded tokens of KV growth for ``slot``
        (``token``, the id whose KV just landed, matters to the paged
        pool's prefix registry only)."""
        del token
        self.positions[slot] += n
        self.lengths[slot] += n

    def release(self, slot: int, publish: bool = True) -> None:
        """Free ``slot`` (``publish`` is the paged pool's; the slot pool
        shares nothing)."""
        del publish
        self.tickets[slot] = -1
        self.lengths[slot] = 0
        self.positions[slot] = 0

    # -- invariants ---------------------------------------------------------

    def check_integrity(self) -> bool:
        """Cross-check the slot pool's invariants (raises
        :class:`IntegrityError`, else returns True): free slots hold no
        state, occupied ones a position and length in ``[0, max_seq]``,
        tickets are unique, ``used_bytes`` equals the occupied slots'
        recomputation."""
        errs: list[str] = []
        occ = self.occupied_slots()
        for s in range(self.slots):
            if self.tickets[s] < 0:
                if self.lengths[s] or self.positions[s]:
                    errs.append(
                        f"free slot {s} holds state "
                        f"(len={self.lengths[s]}, pos={self.positions[s]})")
                continue
            for what, v in (("position", self.positions[s]),
                            ("length", self.lengths[s])):
                if not 0 <= v <= self.max_seq:
                    errs.append(f"slot {s} {what} {v} out of "
                                f"[0, {self.max_seq}]")
        tickets = [int(self.tickets[s]) for s in occ]
        if len(set(tickets)) != len(tickets):
            errs.append(f"duplicate admission tickets: {tickets}")
        recomputed = int(sum(int(self.lengths[s]) for s in occ)
                         * self.bytes_per_token)
        if recomputed != self.used_bytes():
            errs.append(f"used_bytes {self.used_bytes()} != occupied-slot "
                        f"recomputation {recomputed}")
        if errs:
            raise IntegrityError("; ".join(errs))
        return True

    # -- byte budget --------------------------------------------------------

    def used_bytes(self) -> int:
        return int(self.lengths.sum() * self.bytes_per_token)

    def capacity_bytes(self) -> int:
        """Bytes the pool can hold: the byte budget when one is set, else
        every slot full (the router's pressure denominator; 0 for a pool
        without per-token bytes, where the router counts streams)."""
        physical = self.slots * self.max_seq * self.bytes_per_token
        if self.byte_budget is not None:
            return min(self.byte_budget, physical) if physical else \
                self.byte_budget
        return physical

    def prefix_affinity(self, tokens: list[int] | None) -> int:
        """Leading prompt tokens whose KV this pool holds: always 0 (the
        slot layout shares nothing; the router's routing signal)."""
        del tokens
        return 0

    def can_admit(self, prompt_len: int,
                  tokens: list[int] | None = None) -> bool:
        """Does a ``prompt_len``-token stream fit the byte budget?  An
        empty pool always admits (one over-budget prompt must not
        deadlock the queue)."""
        del tokens
        if self.byte_budget is None or not self.occupied_slots():
            return True
        projected = self.used_bytes() + prompt_len * self.bytes_per_token
        return projected <= self.byte_budget

    def pressure_victims(self) -> list[int]:
        """Slots to preempt, youngest first, until the pool is back under
        its byte budget; at least one stream always survives."""
        if self.byte_budget is None:
            return []
        occ = sorted(self.occupied_slots(), key=lambda s: self.tickets[s])
        victims: list[int] = []
        used = self.used_bytes()
        while used > self.byte_budget and len(occ) > 1:
            s = occ.pop()
            victims.append(s)
            used -= int(self.lengths[s] * self.bytes_per_token)
        return victims

    # -- slot scatter -------------------------------------------------------

    def insert(self, cache1: PyTree, slot: int, length: int) -> None:
        """Land a batch=1 staging cache in pool slot ``slot``, every entry
        of the cache tree (the stack's ``(L, ...)`` leaves, an unstacked
        first block's, the hybrid's per-group KV).  Positions ``>=
        length`` (bucket padding) are zeroed on the way in; recurrent
        state has no sequence axis and replaces the slot's whole state.  A full-width staging cache
        entering an int8 pool (chunked prefill) is quantized first, with
        one-shot scales over the real prompt; a cache already in the
        pool's family (blocking prefill) lands as it is.  A VLM's image
        K/V (``cross_kv``, lead ``n_super``) lands whole, unmasked."""
        if _leaf_names(cache1) != _leaf_names(self.cache):
            cache1 = quantize_kv_tree(cache1, length)
        for top, entry in self.cache.items():
            for name, pool_leaf in entry.items():
                lead = (1 if top == CROSS_KV
                        else pool_leaf.ndim - self._rank[name])
                one = cache1[top][name][_at(lead, 0)]   # (*L, S, *tail)
                if name in SEQ_AXIS and top != CROSS_KV:
                    ax = SEQ_AXIS[name]
                    keep = (torch.arange(one.shape[ax], device=one.device)
                            < length).reshape(-1, *([1] * (-ax - 1)))
                    one = torch.where(keep, one, torch.zeros_like(one))
                pool_leaf[_at(lead, slot)] = one
        self.positions[slot] = length
        self.lengths[slot] = length
        if self.kv_quantize and self.faults.fire("block_scale"):
            _corrupt_scale(self.cache, slot)


class PagedKVPoolManager:
    """The block-granular pool: the :class:`KVPoolManager` surface backed
    by a :class:`repro_torch.serve.paging.BlockPool`, per-slot block
    tables and a radix prefix cache (the reference's
    ``repro/serve/pool.py::PagedKVPoolManager``).

    Device state is the paged cache: value leaves ``(L, NB+1, bs, KH,
    D)`` (physical block ``NB`` the dummy) plus ``block_tables (L, slots,
    blocks_per_slot)`` int32.  Host state is the refcounted block pool,
    each slot's table and token list (exactly the tokens whose KV is
    pooled: the prompt at insert, one more per decode step) and the
    positions / lengths / tickets arrays.

    * :meth:`allocate` radix-matches the prompt (capped at ``length - 1``
      tokens, so at least one token is prefilled for its logits),
      retains the matched blocks read-only and allocates fresh ones
      past the match;
    * the engine gathers the matched prefix into the stream's staging
      cache (:meth:`gather_prefix`) and chunk-prefills the rest;
    * :meth:`insert` adopts blocks a concurrent identical prompt has
      registered since admission (ours are released), registers the
      stream's remaining full prompt blocks first-writer-wins, then
      scatters the staged KV into the blocks the stream owns — an int8
      pool quantizes each block with its own scale row on the way;
    * :meth:`release` publishes the stream's full blocks, generated ones
      included (a preempted stream resumes on its own blocks), and drops
      its references: registered blocks go cold, the rest free.

    ``used_bytes`` counts referenced blocks: a shared prefix counts once.
    """

    def __init__(self, model, slots: int, max_seq: int, *,
                 kv_quantize: str | None = None,
                 byte_budget: int | None = None,
                 block_size: int = paging.DEFAULT_BLOCK_SIZE,
                 num_blocks: int | None = None):
        if max_seq % block_size:
            raise ValueError(
                f"max_seq {max_seq} must be a multiple of the KV block "
                f"size {block_size}")
        bpslot = max_seq // block_size
        if num_blocks is None:
            num_blocks = slots * bpslot
        if num_blocks < bpslot:
            raise ValueError(
                f"num_blocks {num_blocks} cannot cover one full stream "
                f"({bpslot} blocks)")
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.kv_quantize = kv_quantize
        self.byte_budget = byte_budget
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.blocks_per_slot = bpslot
        self.geometry = PagedGeometry(block_size, num_blocks, slots, bpslot)
        self.cache = model.init_cache(num_blocks + 1, block_size,
                                      kv_quantize, paged=self.geometry)
        self.positions = np.zeros((slots,), np.int32)   # next write pos
        self.lengths = np.zeros((slots,), np.int64)     # logical KV tokens
        self.tickets = np.full((slots,), -1, np.int64)  # admission age
        self._next_ticket = 0
        self.faults = NULL_INJECTOR
        self.blocks = paging.BlockPool(num_blocks, block_size)
        self.tables: list[list[int]] = [[] for _ in range(slots)]
        self.tokens: list[list[int]] = [[] for _ in range(slots)]
        #: leading radix-adopted blocks per slot (read-only shares)
        self._shared: list[int] = [0] * slots
        #: fresh blocks replaced by a concurrent twin's at insert
        self.adoptions = 0
        self.plans = model.cache_plans(kv_quantize, paged=self.geometry)
        self.bytes_per_token = sum(p.bytes_per_token for p in self.plans)
        #: KV bytes of one physical block across all layers
        self.bytes_per_block = sum(p.bytes_per_block for p in self.plans)
        self.kv_bytes_per_step = sum(p.bytes_per_step(slots, max_seq)
                                     for p in self.plans)

    # -- slot bookkeeping ---------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots) if self.tickets[i] < 0]

    def occupied_slots(self) -> list[int]:
        return [i for i in range(self.slots) if self.tickets[i] >= 0]

    def allocate(self, slot: int, length: int,
                 tokens: list[int] | None = None) -> int:
        """Reserve ``slot`` for a ``length``-token prompt: attach to the
        radix-cached prefix (at most ``length - 1`` tokens) and allocate
        fresh blocks covering positions ``[0, length]`` (the +1 is the
        first decode write).  Returns the matched token count, which the
        engine does not prefill.  On :class:`PoolExhausted` every block
        retained or allocated so far is released first.  The device
        table row stays at the dummy until :meth:`insert`: decode writes
        a row for every non-live slot at its position, and a published
        row would route it into a shared block."""
        if self.tickets[slot] >= 0:
            raise ValueError(f"slot {slot} is occupied")
        if self.faults.fire("pool_alloc"):
            raise PoolExhausted("injected: pool_alloc (paged admission)")
        toks = [int(t) for t in tokens] if tokens is not None else []
        # an injected radix_match miss admits with no prefix reuse
        blind = bool(toks) and self.faults.fire("radix_match")
        matched = (self.blocks.match_retain(toks, max_tokens=length - 1)
                   if toks and not blind else [])
        table = list(matched)
        need = min(length // self.block_size + 1, self.blocks_per_slot)
        try:
            while len(table) < need:
                table.append(self.blocks.alloc())
        except PoolExhausted:
            for bid in table:
                self.blocks.release(bid)
            raise
        self.tickets[slot] = self._next_ticket
        self._next_ticket += 1
        self.lengths[slot] = length
        self.positions[slot] = 0
        self.tables[slot] = table
        self.tokens[slot] = toks[:length]
        self._shared[slot] = len(matched)
        return len(matched) * self.block_size

    def grow(self, slot: int, n: int = 1, token: int | None = None) -> None:
        """Account ``n`` decoded tokens for ``slot``; ``token`` (the id
        whose KV the step just wrote) extends the slot's token list so
        that release can publish generated blocks.  Allocates the next
        block when the write position crosses into it.  Atomic: the fresh
        blocks are secured before any accounting changes, so a
        :class:`PoolExhausted` leaves the slot as it was (the engine
        preempts the stream)."""
        need = min((int(self.positions[slot]) + n) // self.block_size + 1,
                   self.blocks_per_slot)
        fresh: list[int] = []
        try:
            if (len(self.tables[slot]) < need
                    and self.faults.fire("pool_alloc")):
                raise PoolExhausted("injected: pool_alloc (decode grow)")
            while len(self.tables[slot]) + len(fresh) < need:
                fresh.append(self.blocks.alloc())
        except PoolExhausted:
            for bid in fresh:
                self.blocks.release(bid)
            raise
        if token is not None:
            self.tokens[slot].append(int(token))
        self.positions[slot] += n
        self.lengths[slot] += n
        if fresh:
            self.tables[slot].extend(fresh)
            self._push_table(slot)

    def release(self, slot: int, publish: bool = True) -> None:
        """Free ``slot``: publish its full token blocks to the radix
        (prompt and generated), drop every block reference and point the
        device table row back at the dummy.  ``publish=False`` (a
        quarantined stream) registers nothing."""
        if publish and self.positions[slot] > 0:      # KV actually landed
            n_full = min(int(self.positions[slot]) // self.block_size,
                         len(self.tables[slot]))
            if n_full:
                self.blocks.register(
                    self.tokens[slot][:n_full * self.block_size],
                    self.tables[slot][:n_full])
        for bid in self.tables[slot]:
            self.blocks.release(bid)
        self.tables[slot] = []
        self.tokens[slot] = []
        self._shared[slot] = 0
        self.tickets[slot] = -1
        self.lengths[slot] = 0
        self.positions[slot] = 0
        self._push_table(slot)

    # -- invariants ---------------------------------------------------------

    def check_integrity(self) -> bool:
        """Cross-check every invariant (raises :class:`IntegrityError`,
        else returns True): each block's refcount equals the table
        entries that reference it; free, cold and referenced blocks
        partition the pool (free ones unregistered, cold ones
        registered); ``used_bytes`` equals the referenced blocks' bytes;
        free slots hold no state."""
        errs: list[str] = []
        table_refs = [0] * self.num_blocks
        for s in range(self.slots):
            if self.tickets[s] < 0:
                if (self.tables[s] or self.tokens[s] or self.lengths[s]
                        or self.positions[s] or self._shared[s]):
                    errs.append(f"free slot {s} holds state")
                continue
            if self._shared[s] > len(self.tables[s]):
                errs.append(
                    f"slot {s} shared count {self._shared[s]} exceeds "
                    f"table length {len(self.tables[s])}")
            if len(self.tokens[s]) > self.max_seq:
                errs.append(f"slot {s} token list overflows max_seq")
            for bid in self.tables[s]:
                if not 0 <= bid < self.num_blocks:
                    errs.append(f"slot {s} references bad block {bid}")
                else:
                    table_refs[bid] += 1
        if table_refs != self.blocks.ref:
            diff = [b for b in range(self.num_blocks)
                    if table_refs[b] != self.blocks.ref[b]]
            errs.append(
                f"refcount mismatch on blocks {diff[:8]}: tables say "
                f"{[table_refs[b] for b in diff[:8]]}, pool says "
                f"{[self.blocks.ref[b] for b in diff[:8]]}")
        free = set(self.blocks.free)
        cold = set(self.blocks.cold)
        referenced = {b for b in range(self.num_blocks)
                      if self.blocks.ref[b] > 0}
        if len(free) != len(self.blocks.free):
            errs.append("duplicate entries on the free list")
        if free & cold:
            errs.append(f"free/cold overlap: {sorted(free & cold)[:8]}")
        if (free | cold | referenced) != set(range(self.num_blocks)) \
                or (free & referenced) or (cold & referenced):
            errs.append("free/cold/referenced do not partition the pool")
        for b in free:
            if b in self.blocks.radix:
                errs.append(f"free block {b} still radix-registered")
        for b in cold:
            if b not in self.blocks.radix:
                errs.append(f"cold block {b} not radix-registered")
        recomputed = len(referenced) * self.bytes_per_block
        if recomputed != self.used_bytes():
            errs.append(
                f"used_bytes {self.used_bytes()} != referenced-block "
                f"recomputation {recomputed}")
        if errs:
            raise IntegrityError("; ".join(errs))
        return True

    # -- byte budget --------------------------------------------------------

    def used_bytes(self) -> int:
        """Bytes of referenced blocks; a shared prefix counts once."""
        return int(self.blocks.used_blocks() * self.bytes_per_block)

    def capacity_bytes(self) -> int:
        """Bytes the pool can hold: the byte budget when one is set, else
        the whole physical block pool."""
        physical = self.num_blocks * self.bytes_per_block
        if self.byte_budget is not None:
            return min(self.byte_budget, physical) if physical else \
                self.byte_budget
        return physical

    def prefix_affinity(self, tokens: list[int] | None) -> int:
        """Leading prompt tokens whose KV this pool holds: the radix peek
        (no references taken), in tokens; the router lands shared-prompt
        traffic where its blocks are."""
        if not tokens:
            return 0
        matched = self.blocks.match_peek([int(t) for t in tokens],
                                         max_tokens=len(tokens) - 1)
        return len(matched) * self.block_size

    def can_admit(self, prompt_len: int,
                  tokens: list[int] | None = None) -> bool:
        """Admission in blocks: the fresh blocks the prompt needs (radix
        hits subtract) plus the matched blocks that are cold now (they
        leave the recyclable set and enter ``used_bytes`` when
        :meth:`allocate` warms them) must fit the physical pool and the
        byte budget.  An empty pool always admits budget-wise."""
        need = min(prompt_len // self.block_size + 1, self.blocks_per_slot)
        matched_cold = 0
        if tokens is not None:
            matched = self.blocks.match_peek(
                [int(t) for t in tokens], max_tokens=prompt_len - 1)
            need -= len(matched)
            matched_cold = sum(1 for b in matched if self.blocks.ref[b] == 0)
        if need + matched_cold > self.blocks.free_capacity():
            return False
        if self.byte_budget is None or not self.occupied_slots():
            return True
        projected = self.used_bytes() + \
            (need + matched_cold) * self.bytes_per_block
        return projected <= self.byte_budget

    def pressure_victims(self) -> list[int]:
        """Slots to preempt, youngest ticket first: until the referenced
        bytes are under the byte budget, then until the pool can cover
        every surviving stream's next block allocation.  Refcounts are
        simulated across the victim set, so a block two victims share
        counts as freed once both are gone.  At least one stream always
        survives."""
        occ = sorted(self.occupied_slots(), key=lambda s: self.tickets[s])
        victims: list[int] = []
        ref = list(self.blocks.ref)

        def pop_frees(s):     # blocks that reach ref 0 when s releases
            n = 0
            for b in self.tables[s]:
                ref[b] -= 1
                if ref[b] == 0:
                    n += 1
            return n

        freed = 0
        if self.byte_budget is not None and self.bytes_per_block:
            used = self.used_bytes()
            while used > self.byte_budget and len(occ) > 1:
                s = occ.pop()
                n = pop_frees(s)
                freed += n
                used -= n * self.bytes_per_block
                victims.append(s)

        def needs_block(s):   # next grow crosses into an unallocated block
            nxt = int(self.positions[s]) + 1
            need = min(nxt // self.block_size + 1, self.blocks_per_slot)
            return self.positions[s] > 0 and need > len(self.tables[s])

        cap = self.blocks.free_capacity() + freed
        while len(occ) > 1 and cap < sum(map(needs_block, occ)):
            s = occ.pop()
            cap += pop_frees(s)
            victims.append(s)
        return victims

    # -- device gather / scatter --------------------------------------------

    def _ids_row(self, table: list[int]) -> torch.Tensor:
        row = np.full((self.blocks_per_slot,), self.geometry.dummy_block,
                      np.int64)
        row[:len(table)] = table
        return torch.as_tensor(row, device=self.model.device)

    def _entries(self, cache: PyTree):
        """``(name, entry, lead)`` of every top-level entry of a cache
        tree: ``lead`` the layer axes in front of its leaves (1 for the
        stack, 0 for an unstacked first block), read off the pool's
        block tables ``(*L, slots, blocks_per_slot)``."""
        for top, entry in cache.items():
            yield top, entry, self.cache[top]["block_tables"].ndim - 2

    @torch.inference_mode()
    def _push_table(self, slot: int) -> None:
        """Write ``slot``'s block-table row on every layer (the pool's
        tensors are inference tensors: a release outside a step, as
        ``cancel`` or a router's evacuation, writes here too)."""
        row = self._ids_row(self.tables[slot]).to(torch.int32)
        for _, entry, lead in self._entries(self.cache):
            entry["block_tables"][_at(lead, slot)] = row

    def gather_prefix(self, staging: PyTree, slot: int,
                      upto: int) -> PyTree:
        """Copy ``slot``'s first ``upto`` pooled positions (the
        radix-matched prefix) into a batch=1 full-precision staging cache
        (``(L, 1, S, KH, D)`` leaves, ``(1, S, KH, D)`` for an unstacked
        entry), in place; int8 blocks are dequantized."""
        ids = self._ids_row(self.tables[slot])
        for top, entry, lead in self._entries(staging):
            pool = self.cache[top]
            for name, leaf in entry.items():
                if name in pool:
                    g = pool[name][_at(lead, ids)]
                else:
                    g = (pool[name + "_q"][_at(lead, ids)].to(torch.float32)
                         * pool[name + "_scale"][_at(lead, ids)]
                         .unsqueeze(lead + 1))
                g = g.reshape(*g.shape[:lead], -1, *g.shape[-2:])
                leaf[_at(lead, 0, slice(None, upto))] = \
                    g[_at(lead, slice(None, upto))].to(leaf.dtype)
        return staging

    def insert(self, cache1: PyTree, slot: int, length: int) -> None:
        """Land a finished full-precision staging cache in the stream's
        blocks.  Adoption first: full prompt blocks another stream has
        registered since admission replace ours (retain theirs, release
        our fresh one), so N concurrent identical prompts store the
        prefix once.  Then the remaining full blocks are registered
        first-writer-wins and the staged KV is scattered into the blocks
        the stream owns — adopted entries aim at the dummy, so a shared
        block is never written.  Rows ``>= length`` are zeroed; an int8
        pool quantizes each block with one absmax scale row."""
        toks = self.tokens[slot]
        table = self.tables[slot]
        n_full = min(length // self.block_size, len(table))
        path = self.blocks.match_peek(toks[:n_full * self.block_size])
        for i in range(len(path)):
            if table[i] != path[i]:
                self.blocks.retain(path[i])
                self.blocks.release(table[i])   # fresh, never written
                table[i] = path[i]
                self.adoptions += 1
        self._shared[slot] = max(self._shared[slot], len(path))
        if n_full > len(path):
            self.blocks.register(toks[:n_full * self.block_size],
                                 table[:n_full])
        ids = self._ids_row(table)
        ids[:self._shared[slot]] = self.geometry.dummy_block
        bs = self.block_size
        keep = (torch.arange(self.max_seq, device=ids.device)
                < length).reshape(self.blocks_per_slot, bs, 1, 1)
        for top, entry, lead in self._entries(self.cache):
            for name in ("k", "v"):
                x = cache1[top][name][_at(lead, 0)]        # (*L, S, KH, D)
                xb = x.reshape(*x.shape[:lead], self.blocks_per_slot, bs,
                               *x.shape[-2:])
                xb = torch.where(keep, xb, torch.zeros_like(xb))
                if name in entry:
                    entry[name][_at(lead, ids)] = xb.to(entry[name].dtype)
                    continue
                scale = kv_scales(xb, axis=-3)         # (*L, nblk, KH, D)
                entry[name + "_q"][_at(lead, ids)] = quantize_kv(
                    xb, scale.unsqueeze(-3))
                entry[name + "_scale"][_at(lead, ids)] = scale
        self.positions[slot] = length
        self.lengths[slot] = length
        self._push_table(slot)
        if self.kv_quantize and table and self.faults.fire("block_scale"):
            # the first block this stream owns (not a radix share): the
            # watchdog quarantines this stream, not its prefix twins
            _corrupt_scale(self.cache,
                           table[min(self._shared[slot], len(table) - 1)])

    # -- stats ----------------------------------------------------------------

    def physical_blocks_in_use(self) -> int:
        return self.blocks.used_blocks()

    def prefix_stats(self) -> dict:
        st = self.blocks.stats
        return {"prefix_queries": st.prefix_queries,
                "prefix_block_hits": st.prefix_block_hits,
                "adopted_blocks": self.adoptions,
                "evictions": st.evictions}
