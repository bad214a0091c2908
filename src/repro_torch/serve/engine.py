"""Batched serving engine: continuous batching over a fixed slot pool.

``ServeEngine`` is a thin façade over three seams:

* :class:`repro_torch.serve.scheduler.Scheduler` — request lifecycle and
  the per-step token budget: decode first (every live stream decodes one
  token per step), then chunked-prefill segments with the leftover
  budget, so a long prompt never stalls live streams;
* :class:`repro_torch.serve.pool.KVPoolManager` — the ``gqa_f32`` slot
  pool, slot allocation, byte accounting, byte-budget admission and
  youngest-first preemption;
* :class:`repro_torch.serve.runner.ModelRunner` — params and the one
  ``step(tokens, positions, seg_kind)`` entry, plus the sampler.

Continuous (chunked) admission is the default for the dense family; a
prompt stages in a full-width batch=1 cache while it is chunk-prefilled
and lands in its slot in one scatter, so chunked greedy streams equal
whole-prefill ("blocking" admission) streams.  Prefill token arrays are
padded to power-of-two length buckets (the reference compiles once per
bucket; the port keeps the same shapes so both see the same padding).

Sampling is greedy or temperature (Gumbel-max on a seeded
``torch.Generator``); a stream whose logits go non-finite is quarantined
(terminated ``failed``) without disturbing its neighbours.  Deadlines,
cancellation, fault injection, load shedding, weight / KV quantization
and the paged pool come with ROADMAP items A6-A9 and A12.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.layers import plan as lplan
from repro_torch.models.api import get_model
from repro_torch.serve.metrics import latency_summary
from repro_torch.serve.pool import KVPoolManager
from repro_torch.serve.runner import ModelRunner
from repro_torch.serve.scheduler import (PREFILL_BUCKET_MIN, PrefillStream,
                                         Request, Scheduler)

__all__ = ["ServeEngine", "Request", "PREFILL_BUCKET_MIN"]

PyTree = Any

DEFAULT_PREFILL_CHUNK = 64
STATS_WINDOW = 4096

#: LRDConfig fields whose non-default values this slice does not serve,
#: with the ROADMAP item that brings each
_UNSERVED = {"quantize": "A6", "kv_quantize": "A7", "act_quantize": "A8",
             "sparsify": "A11"}


def _param_device(params: PyTree) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class ServeEngine:
    #: families whose prefill padding is inert (causal attention never
    #: lets a real token see a pad token)
    _BUCKET_FAMILIES = ("dense",)

    def __init__(self, run: RunConfig, params: PyTree, *, slots: int = 4,
                 max_seq: int = 512, seed: int = 0,
                 admission: str = "continuous",
                 prefill_chunk: int | None = None,
                 kv_byte_budget: int | None = None,
                 device: str | torch.device = "cuda"):
        """``params`` must already live on ``device`` (the card by
        default; tests pass ``"cpu"``).  ``admission`` is "continuous"
        (default: token-budget chunked prefill) or "blocking" (one whole
        prefill per admit).  ``kv_byte_budget`` gates admission and
        triggers youngest-first preemption; None = never preempt."""
        for field, item in _UNSERVED.items():
            if getattr(run.lrd, field) != "none":
                raise NotImplementedError(
                    f"LRDConfig.{field}={getattr(run.lrd, field)!r} comes "
                    f"with ROADMAP item {item}")
        if run.lrd.kv_layout != "slot":
            raise NotImplementedError("the paged KV pool comes with "
                                      "ROADMAP item A9")
        self.device = torch.device(device)
        if _param_device(params).type != self.device.type:
            raise ValueError(f"params live on {_param_device(params)}, "
                             f"engine on {self.device}")
        self.run = run
        self.model = get_model(run.model, self.device)
        if not run.model.has_decode:
            raise ValueError("serving needs a decoder")
        self.params = params
        self.plans = lplan.build_plan_tree(params)
        self.plan_summary = lplan.tree_summary(self.plans)
        self.slots = slots
        self.max_seq = max_seq
        if admission not in ("continuous", "blocking"):
            raise ValueError(f"admission {admission!r} (want 'continuous' "
                             "or 'blocking')")
        self.admission = admission
        chunk = prefill_chunk or run.lrd.prefill_chunk \
            or DEFAULT_PREFILL_CHUNK
        self.prefill_chunk = max(1, min(chunk, max_seq))
        self.step_token_budget = (run.lrd.step_token_budget
                                  or slots + self.prefill_chunk)
        with torch.inference_mode():
            self.pool = KVPoolManager(self.model, slots, max_seq,
                                      byte_budget=kv_byte_budget)
        self.plan_summary["kv_bytes_per_step"] = self.pool.kv_bytes_per_step
        self.plan_summary["kv_cache_family"] = self.pool.plans[0].family
        self.runner = ModelRunner(self.model, params, max_seq=max_seq)
        self.scheduler = Scheduler(slots, prefill_chunk=self.prefill_chunk,
                                   step_token_budget=self.step_token_budget)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.quarantined = 0
        self.stats: deque[dict] = deque(maxlen=STATS_WINDOW)

    @property
    def finished(self) -> list[Request]:
        return self.scheduler.finished

    # -- helpers --------------------------------------------------------------

    def add_request(self, req: Request) -> None:
        if len(req.prompt) > self.max_seq - 1:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens does not fit "
                f"max_seq={self.max_seq} (need <= {self.max_seq - 1} "
                "to leave room for decode)")
        if req.submit_time is None:
            req.submit_time = time.perf_counter()
        self.scheduler.submit(req)

    def _bucket_len(self, n: int) -> int:
        """Power-of-2 prefill length bucket."""
        if self.run.model.family not in self._BUCKET_FAMILIES:
            return n
        return min(max(PREFILL_BUCKET_MIN, 1 << (n - 1).bit_length()),
                   self.max_seq)

    def _tokens(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=torch.long, device=self.device)

    def _sync(self) -> None:
        """Wait for the device so host-clock stats time the work, not
        its enqueue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _append_token(self, req: Request, tok: int, now: float) -> None:
        req.output.append(tok)
        req.token_times.append(now)
        if req.first_token_time is None:
            req.first_token_time = now

    def _maybe_finish(self, slot: int) -> bool:
        req = self.scheduler.active[slot]
        tok = req.output[-1]
        ended = req.eos_id is not None and tok == req.eos_id
        full = (len(req.output) >= req.max_new_tokens
                or self.pool.positions[slot] >= self.max_seq - 1)
        if ended or full:
            self.scheduler.finish(slot)
            self.pool.release(slot)
            return True
        return False

    def _quarantine(self, slot: int) -> None:
        self.scheduler.quarantine(slot)
        self.pool.release(slot)
        self.quarantined += 1

    def _sample_first(self, streams: list[PrefillStream],
                      rows: list[torch.Tensor]) -> int:
        """Sample every completed prefill's first token in one call."""
        temps = np.array([max(ps.req.temperature, 0.0) for ps in streams],
                         np.float32)
        toks, bad = self.runner.sample(torch.stack(rows), temps,
                                       self.generator)
        now = time.perf_counter()
        first = 0
        for ps, tok, flagged in zip(streams, toks, bad):
            if flagged:
                self._quarantine(ps.slot)
                continue
            self._append_token(ps.req, int(tok), now)
            first += 1
            self._maybe_finish(ps.slot)
        return first

    # -- admission ------------------------------------------------------------

    def _admit_blocking(self) -> tuple[int, int]:
        """One whole prefill per admitted request.  Returns (first tokens
        sampled, prompt tokens prefilled)."""
        started = self.scheduler.admit(self.pool)
        if not started:
            return 0, 0
        rows, pf_toks = [], 0
        for ps in started:
            n = len(ps.tokens)
            padded = np.zeros((1, self._bucket_len(n)), np.int64)
            padded[0, :n] = ps.tokens
            cache1 = self.runner.new_stream_cache()
            logits, cache1 = self.runner.step(
                self._tokens(padded), None, "prefill", cache=cache1,
                last_pos=n - 1)
            self.pool.insert(cache1, ps.slot, n)
            self.scheduler.activate(ps)
            pf_toks += n
            rows.append(logits[0, -1])
        return self._sample_first(started, rows), pf_toks

    def _prefill_chunks(self, n_live: int) -> tuple[int, int]:
        """Spend the step's leftover token budget on prefill chunks.
        Returns (prompt tokens prefilled, first tokens sampled)."""
        plan = self.scheduler.chunk_plan(n_live)
        if not plan:
            return 0, 0
        completed: list[PrefillStream] = []
        pf_toks = 0
        for ps, c in plan:
            if ps.cache is None:
                ps.cache = self.runner.new_stream_cache()
            b = self._bucket_len(c)
            if ps.written + b > self.max_seq:   # keep the offset write
                b = self.max_seq - ps.written   # inside the slot
            padded = np.zeros((1, b), np.int64)
            padded[0, :c] = ps.tokens[ps.written:ps.written + c]
            eff_len = min(len(ps.tokens), ps.written + c)
            logits, ps.cache = self.runner.step(
                self._tokens(padded), None, "prefill_chunk", cache=ps.cache,
                start_pos=ps.written, prompt_len=eff_len)
            ps.written += c
            pf_toks += c
            ps.last_logits = logits[0, 0]
            if ps.remaining == 0:
                completed.append(ps)
        first = 0
        if completed:
            for ps in completed:
                self.pool.insert(ps.cache, ps.slot, len(ps.tokens))
                self.scheduler.activate(ps)
                ps.cache = None
            first = self._sample_first(completed,
                                       [ps.last_logits for ps in completed])
        self._sync()
        return pf_toks, first

    # -- main loop --------------------------------------------------------------

    def _decode_live(self, live: list[int]) -> int:
        pool = self.pool
        tokens = np.zeros((self.slots, 1), np.int64)
        temps = np.zeros((self.slots,), np.float32)
        for i in live:
            tokens[i, 0] = self.scheduler.active[i].output[-1]
            temps[i] = max(self.scheduler.active[i].temperature, 0.0)
        logits, pool.cache = self.runner.step(
            self._tokens(tokens), self._tokens(pool.positions), "decode",
            cache=pool.cache)
        toks, bad = self.runner.sample(logits[:, 0], temps, self.generator)
        now = time.perf_counter()
        produced = 0
        for i in live:
            if bad[i]:
                self._quarantine(i)
                continue
            self._append_token(self.scheduler.active[i], int(toks[i]), now)
            pool.grow(i)
            produced += 1
            self._maybe_finish(i)
        return produced

    def step(self) -> int:
        """One scheduler step: preempt under KV pressure, admit, decode
        every live stream, then spend leftover budget on prefill chunks.
        Returns tokens produced (decode + first tokens)."""
        with torch.inference_mode():
            return self._step()

    def _step(self) -> int:
        sched, pool = self.scheduler, self.pool
        victims = pool.pressure_victims()
        for slot in victims:
            sched.preempt(slot)
            pool.release(slot)
        admit_s = prefill_s = 0.0
        if self.admission == "blocking":
            t0 = time.perf_counter()
            first, pf_toks = self._admit_blocking()
            admit_s = time.perf_counter() - t0
            live = sched.live_slots()
            t0 = time.perf_counter()
            produced = self._decode_live(live) if live else 0
            decode_s = time.perf_counter() - t0
        else:
            sched.admit(pool)
            live = sched.live_slots()
            t0 = time.perf_counter()
            produced = self._decode_live(live) if live else 0
            decode_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pf_toks, first = self._prefill_chunks(len(live))
            prefill_s = time.perf_counter() - t0
        if live or pf_toks or first:
            self.stats.append({"live": len(live), "tokens": produced,
                               "seconds": decode_s,
                               "prefill_tokens": pf_toks,
                               "prefill_seconds": prefill_s,
                               "first_tokens": first,
                               "admit_seconds": admit_s,
                               "preempted": len(victims)})
        return produced + first

    def run_until_done(self, max_steps: int = 10_000) -> list[Request]:
        """Drive the engine until queue and slots drain; returns the
        requests that reached a terminal status during this call."""
        start = len(self.finished)
        for _ in range(max_steps):
            if not self.scheduler.busy():
                break
            self.step()
        else:
            if self.scheduler.busy():
                raise RuntimeError(
                    f"run_until_done: {max_steps} steps exhausted with work "
                    "in flight")
        return self.finished[start:]

    def throughput(self) -> dict:
        """Aggregate serving stats over the stats window (host clock,
        device synchronised by the sampler's host copy)."""
        stats = list(self.stats)
        status_counts: dict[str, int] = {}
        for r in self.finished:
            status_counts[r.status] = status_counts.get(r.status, 0) + 1
        ttfts = [r.ttft for r in self.finished if r.ttft is not None]
        itls = [b - a for r in self.finished
                for a, b in zip(r.token_times, r.token_times[1:])]
        decode_steps = [s["seconds"] for s in stats if s["live"]]
        out = {"tokens_per_s": 0.0, "steps": len(stats), "mean_batch": 0.0,
               "decode_seconds": 0.0, "prefill_seconds": 0.0,
               "prefill_tokens": 0,
               "decode_step_ms_mean": (1e3 * sum(decode_steps)
                                       / len(decode_steps)
                                       if decode_steps else 0.0),
               "preemptions": self.scheduler.preemptions,
               "admit_failures": self.scheduler.admit_failures,
               "quarantined": self.quarantined,
               "status_counts": status_counts,
               "ttft_mean_s": (sum(ttfts) / len(ttfts)) if ttfts else 0.0,
               "latency": latency_summary(itls, ttfts,
                                          requests=len(self.finished))}
        if stats:
            dec = sum(s["tokens"] for s in stats)
            first = sum(s["first_tokens"] for s in stats)
            dec_s = sum(s["seconds"] for s in stats)
            pf_s = sum(s["prefill_seconds"] + s["admit_seconds"]
                       for s in stats)
            out["tokens_per_s"] = (dec + first) / max(dec_s + pf_s, 1e-9)
            out["mean_batch"] = dec / len(stats)
            out["decode_seconds"] = dec_s
            out["prefill_seconds"] = pf_s
            out["prefill_tokens"] = sum(s["prefill_tokens"] for s in stats)
        return out
