"""KVPoolManager: slot + KV-byte accounting over the serve cache pool.

The pool is the model's stacked cache ``(L, slots, S_max, KH, D)`` — one
batch slot per in-flight stream — in the full-width ``gqa_f32`` family.
This manager owns the state side of the serve stack: the cache tensors
and per-slot write positions, slot allocation with admission tickets
(preemption evicts the youngest stream first), byte accounting derived
from the model's cache plans, and the slot scatter that lands a finished
batch=1 staging cache in its slot.  The paged pool and int8 pools come
with ROADMAP items A9 and A7.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

PyTree = Any


class KVPoolManager:
    """Slot/byte owner for one engine's KV pool."""

    def __init__(self, model, slots: int, max_seq: int, *,
                 byte_budget: int | None = None):
        self.model = model
        self.slots = slots
        self.max_seq = max_seq
        self.byte_budget = byte_budget
        self.cache = model.init_cache(slots, max_seq)
        self.positions = np.zeros((slots,), np.int32)   # next write pos
        self.lengths = np.zeros((slots,), np.int64)     # logical KV tokens
        self.tickets = np.full((slots,), -1, np.int64)  # admission age
        self._next_ticket = 0
        #: one CachePlan per attention layer — the source of all bytes
        self.plans = model.cache_plans()
        #: per-position KV bytes of ONE stream across all layers
        self.bytes_per_token = sum(p.bytes_per_token for p in self.plans)
        #: bytes the whole pool streams per decode step
        self.kv_bytes_per_step = sum(p.bytes_per_step(slots, max_seq)
                                     for p in self.plans)

    # -- slot bookkeeping ---------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots) if self.tickets[i] < 0]

    def occupied_slots(self) -> list[int]:
        return [i for i in range(self.slots) if self.tickets[i] >= 0]

    def allocate(self, slot: int, length: int) -> None:
        """Reserve ``slot`` for a stream of ``length`` prompt tokens (the
        whole prompt's bytes are reserved up front)."""
        if self.tickets[slot] >= 0:
            raise ValueError(f"slot {slot} is occupied")
        self.tickets[slot] = self._next_ticket
        self._next_ticket += 1
        self.lengths[slot] = length
        self.positions[slot] = 0

    def grow(self, slot: int, n: int = 1) -> None:
        """Account ``n`` decoded tokens of KV growth for ``slot``."""
        self.positions[slot] += n
        self.lengths[slot] += n

    def release(self, slot: int) -> None:
        self.tickets[slot] = -1
        self.lengths[slot] = 0
        self.positions[slot] = 0

    # -- byte budget --------------------------------------------------------

    def used_bytes(self) -> int:
        return int(self.lengths.sum() * self.bytes_per_token)

    def can_admit(self, prompt_len: int) -> bool:
        """Does a ``prompt_len``-token stream fit the byte budget?  An
        empty pool always admits (one over-budget prompt must not
        deadlock the queue)."""
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
        """Land a batch=1 staging cache in pool slot ``slot``.  Positions
        ``>= length`` (bucket padding) are zeroed on the way in."""
        for name, pool_leaf in self.cache["blocks"].items():
            one = cache1["blocks"][name][:, 0]          # (L, S, KH, D)
            keep = (torch.arange(one.shape[1], device=one.device)
                    < length).reshape(1, -1, 1, 1)
            pool_leaf[:, slot] = torch.where(keep, one,
                                             torch.zeros_like(one))
        self.positions[slot] = length
        self.lengths[slot] = length
