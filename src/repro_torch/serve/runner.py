"""ModelRunner: the serve stack's single compute seam.

Owns the params and exposes ONE entry — :meth:`step` ``(tokens,
positions, seg_kind, ...)`` — so the scheduler and engine never touch
the model API directly.  Segment kinds:

* ``"decode"``:        tokens ``(slots, 1)``, positions ``(slots,)`` —
                       one token for every slot against the shared pool;
* ``"prefill_chunk"``: tokens ``(1, C)`` at offset ``start_pos`` against a
                       batch=1 staging cache (continuous admission);
* ``"prefill"``:       tokens ``(1, S)`` whole-prompt prefill (blocking
                       admission).

Each segment runs with its cache's plan: the pool plan (the
``kv_quantize`` family) for decode and blocking prefill, the
full-precision stream plan for chunked-prefill staging caches — chunk
attention runs over the exact K/V prefix and the pool quantizes once at
slot insert, so chunked greedy streams equal whole-prefill ones.

Every step runs under ``torch.inference_mode()``.  :meth:`sample` is the
batched sampler with the numerical watchdog fused in (the reference's
``guard.sample_and_flag``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

PyTree = Any

SEG_KINDS = ("decode", "prefill_chunk", "prefill")


def sample_and_flag(logits: torch.Tensor, temps: torch.Tensor,
                    generator: torch.Generator
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``logits (rows, V)``, ``temps (rows,)`` -> ``(tokens (rows,),
    bad (rows,) bool)``.  Greedy rows (``temps == 0``) take the argmax
    (first maximum on ties); temperature rows draw by the Gumbel-max
    trick from ``generator``.  A row with any non-finite logit is flagged
    and sampled from zeroed logits."""
    bad = ~torch.isfinite(logits).all(dim=-1)
    clean = torch.where(bad[:, None], torch.zeros_like(logits), logits)
    greedy = torch.argmax(clean, dim=-1)
    safe = torch.where(temps > 0, temps, torch.ones_like(temps))
    u = torch.rand(clean.shape, generator=generator, device=clean.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    sampled = torch.argmax(clean / safe[:, None] + gumbel, dim=-1)
    return torch.where(temps > 0, sampled, greedy), bad


class ModelRunner:
    def __init__(self, model, params: PyTree, *, max_seq: int,
                 kv_quantize: str | None = None):
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.device = model.device
        #: plan of the shared pool and of blocking-admission staging
        self.pool_plan = model.cache_plan(kv_quantize)
        #: plan of a full-precision chunked-prefill staging cache
        self.stream_plan = model.cache_plan(None)

    def new_stream_cache(self, kv_quantize: str | None = None) -> PyTree:
        """A fresh batch=1 cache for one stream (full precision unless
        ``kv_quantize`` asks for the pool's int8 family)."""
        return self.model.init_cache(1, self.max_seq, kv_quantize)

    @torch.inference_mode()
    def step(self, tokens: torch.Tensor, positions: torch.Tensor | None,
             seg_kind: str, *, cache: PyTree, start_pos: int | None = None,
             prompt_len: int | None = None, last_pos: int | None = None
             ) -> tuple[torch.Tensor, PyTree]:
        """Run one segment.  Returns ``(logits, cache)``."""
        m, p = self.model, self.params
        if seg_kind == "decode":
            return m.decode_step(p, tokens, positions, cache,
                                 cache_plan=self.pool_plan)
        if seg_kind == "prefill_chunk":
            return m.prefill_chunk(p, {"tokens": tokens}, cache,
                                   start_pos=start_pos,
                                   prompt_len=prompt_len,
                                   cache_plan=self.stream_plan)
        if seg_kind == "prefill":
            return m.prefill(p, {"tokens": tokens}, cache,
                             last_pos=last_pos, cache_plan=self.pool_plan)
        raise ValueError(
            f"unknown seg_kind {seg_kind!r} (want one of {SEG_KINDS})")

    @torch.inference_mode()
    def sample(self, logits: torch.Tensor, temps: np.ndarray,
               generator: torch.Generator) -> tuple[np.ndarray, np.ndarray]:
        """Batched greedy/temperature sampling with the watchdog;
        host-side ``(tokens, bad)`` arrays."""
        t = torch.as_tensor(temps, dtype=torch.float32, device=logits.device)
        toks, bad = sample_and_flag(logits.to(torch.float32), t, generator)
        return toks.cpu().numpy(), bad.cpu().numpy()
