"""ModelRunner: the serve stack's single compute seam.

Owns the params and exposes ONE entry — :meth:`step` ``(tokens,
positions, seg_kind, ...)`` — so the scheduler and engine never touch
the model API directly.  Segment kinds:

* ``"decode"``:        tokens ``(slots, 1)``, positions ``(slots,)`` —
                       one token for every slot against the shared pool;
* ``"prefill_chunk"``: tokens ``(1, C)`` at offset ``start_pos`` against a
                       batch=1 staging cache (continuous admission);
* ``"prefill"``:       tokens ``(1, S)`` whole-prompt prefill (blocking
                       admission); a ``batch`` given beside the tokens
                       (the VLM's, with its ``image_embeds``) goes to the
                       model unchanged.

Each segment runs with its cache's plan: the pool plan (the
``kv_quantize`` family, slot or paged) for decode and blocking prefill,
the full-precision stream plan for chunked-prefill staging caches —
chunk attention runs over the exact K/V prefix and the pool quantizes
once at insert, so chunked greedy streams equal whole-prefill ones.
``act_quantize="int8"`` runs the prefill and chunk segments' int8 plans
int8 x int8; decode keeps full-width activations.

Every step runs under ``torch.inference_mode()``.  :meth:`sample` is the
batched sampler with the numerical watchdog beside it
(:func:`repro_torch.serve.guard.sample_and_flag`); tokens and flags come
to the host in one transfer.  The runner carries the ``nan_logits`` and
``slow_step`` fault points (:mod:`repro_torch.serve.faults`), applied
after the model's call.
"""
from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from repro_torch.serve.faults import NULL_INJECTOR
from repro_torch.serve.guard import sample_and_flag

PyTree = Any

SEG_KINDS = ("decode", "prefill_chunk", "prefill")


class ModelRunner:
    def __init__(self, model, params: PyTree, *, max_seq: int,
                 kv_quantize: str | None = None,
                 act_quantize: str | None = None, paged=None,
                 faults=None):
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.device = model.device
        #: plan of the shared pool (slot, or paged given a PagedGeometry)
        #: and of blocking-admission staging
        self.pool_plan = model.cache_plan(kv_quantize, paged)
        #: plan of a full-precision chunked-prefill staging cache
        self.stream_plan = model.cache_plan(None)
        #: int8 activations on prefill and chunk segments only: decode's
        #: M = batch rows stay at full width, as in the reference
        #: (``repro/serve/runner.py:74-79``)
        self.prefill_act_quantize = act_quantize == "int8"
        #: fault source of the ``nan_logits`` / ``slow_step`` points
        self.faults = faults if faults is not None else NULL_INJECTOR

    def new_stream_cache(self, kv_quantize: str | None = None) -> PyTree:
        """A fresh batch=1 cache for one stream (full precision unless
        ``kv_quantize`` asks for the pool's int8 family)."""
        return self.model.init_cache(1, self.max_seq, kv_quantize)

    @torch.inference_mode()
    def step(self, tokens: torch.Tensor, positions: torch.Tensor | None,
             seg_kind: str, *, cache: PyTree, start_pos: int | None = None,
             prompt_len: int | None = None, last_pos: int | None = None,
             batch: dict | None = None) -> tuple[torch.Tensor, PyTree]:
        """Run one segment.  Returns ``(logits, cache)``.  ``batch``
        (prefill segments) carries the model inputs beside ``tokens``."""
        if batch is None:
            batch = {"tokens": tokens}
        m, p = self.model, self.params
        aq = self.prefill_act_quantize
        if seg_kind == "decode":
            out = m.decode_step(p, tokens, positions, cache,
                                cache_plan=self.pool_plan)
        elif seg_kind == "prefill_chunk":
            out = m.prefill_chunk(p, batch, cache,
                                  start_pos=start_pos, prompt_len=prompt_len,
                                  cache_plan=self.stream_plan,
                                  act_quantize=aq)
        elif seg_kind == "prefill":
            out = m.prefill(p, batch, cache, last_pos=last_pos,
                            cache_plan=self.pool_plan, act_quantize=aq)
        else:
            raise ValueError(
                f"unknown seg_kind {seg_kind!r} (want one of {SEG_KINDS})")
        if self.faults.active:
            out = self._inject(out, seg_kind)
        return out

    def _inject(self, out: tuple[torch.Tensor, PyTree],
                seg_kind: str) -> tuple[torch.Tensor, PyTree]:
        """The post-call fault points: ``slow_step`` sleeps on the host
        (the card runs on meanwhile; the step's host time, which ends in
        a sync, grows); ``nan_logits`` poisons the logits the model just
        produced, one slot row on decode or the whole segment on prefill.
        A ``seg`` param limits which segment kinds are consulted, so
        schedule indices count matching calls only."""
        if self.faults.fire("slow_step"):
            time.sleep(float(self.faults.param("slow_step", "seconds",
                                               0.05)))
        seg = self.faults.param("nan_logits", "seg", None)
        if seg is not None and seg_kind != seg:
            return out
        if self.faults.fire("nan_logits"):
            logits, cache = out
            logits = logits.clone()
            if seg_kind == "decode":
                logits[int(self.faults.param("nan_logits", "slot", 0))] = \
                    float("nan")
            else:
                logits.fill_(float("nan"))
            out = (logits, cache)
        return out

    @torch.inference_mode()
    def sample(self, logits: torch.Tensor, temps: np.ndarray,
               generator: torch.Generator) -> tuple[np.ndarray, np.ndarray]:
        """Batched greedy/temperature sampling with the watchdog;
        host-side ``(tokens, bad)`` arrays, brought over in one copy."""
        t = torch.as_tensor(temps, dtype=torch.float32, device=logits.device)
        toks, bad = sample_and_flag(logits.to(torch.float32), t, generator)
        host = torch.stack((toks, bad.to(toks.dtype))).cpu().numpy()
        return host[0], host[1].astype(bool)
