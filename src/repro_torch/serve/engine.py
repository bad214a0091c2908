"""Batched serving engine: continuous batching over a fixed slot pool.

``ServeEngine`` is a thin façade over three seams:

* :class:`repro_torch.serve.scheduler.Scheduler` — request lifecycle and
  the per-step token budget: decode first (every live stream decodes one
  token per step), then chunked-prefill segments with the leftover
  budget, so a long prompt never stalls live streams;
* :class:`repro_torch.serve.pool.KVPoolManager` — the slot pool
  (``gqa_f32``, or ``gqa_int8`` with ``kv_quantize="int8"``; an MLA
  stack's latents in ``mla_latent`` / ``mla_latent_int8``), or with
  ``kv_layout="paged"`` :class:`~repro_torch.serve.pool.PagedKVPoolManager`
  — fixed-size KV blocks behind block tables with radix prefix sharing
  (``gqa_paged_f32`` / ``gqa_paged_int8``); slot allocation, byte
  accounting, byte-budget admission and youngest-first preemption;
* :class:`repro_torch.serve.runner.ModelRunner` — params and the one
  ``step(tokens, positions, seg_kind)`` entry, plus the sampler.

Continuous (chunked) admission is the default for the dense family, MLA
stacks included (the MoE family admits blocking: per-chunk expert
capacity would route other tokens than the whole prompt's; so do the
recurrent families and the VLM, whose blocking prefill computes the
image K/V from zero image embeddings, as the reference's engine does); a
prompt stages in a full-width batch=1 cache while it is chunk-prefilled
and lands in its slot in one scatter (quantizing into an int8 pool), so
chunked greedy streams equal whole-prefill ("blocking" admission)
streams.  ``quantize="int8"`` / ``"fp8"`` quantizes the decomposed
factors at load (:mod:`repro_torch.quant.quantize`), and every fully
quantized linear then runs the quantized kernels; ``act_quantize="int8"``
(with int8 factors) runs the prefill and chunk segments int8 x int8;
``sparsify="2:4"`` packs the factors 2:4 first
(:mod:`repro_torch.quant.sparse`), and with int8 / fp8 factors every
packed linear runs the sparse kernels.
Prefill token arrays are padded to power-of-two length buckets (the
reference compiles once per bucket; the port keeps the same shapes so
both see the same padding).  On a paged pool a prompt whose leading
blocks are cached in the radix starts with their KV gathered into its
staging cache and prefills only the rest.

Sampling is greedy or temperature (Gumbel-max on a seeded
``torch.Generator``).

Hardening, as in the reference (``repro/serve/engine.py``):

* lifecycle — per-request ``deadline_s`` / ``max_queue_s`` expiry,
  :meth:`ServeEngine.cancel` from every state, a preemption-retry budget
  ending in ``dropped``, and one of
  :data:`repro_torch.serve.scheduler.STATUSES` on every request that
  leaves the engine;
* quarantine — a stream whose logits go non-finite terminates
  ``failed`` (its blocks are not published) without disturbing its
  neighbours (:mod:`repro_torch.serve.guard`);
* degradation — a :class:`~repro_torch.serve.scheduler.LoadShedder`
  watches preemption, admission-failure and the router's SLO pressure
  and, past its watermark, shrinks the step budget and pauses admission;
* watchdogs — the no-progress guard of :meth:`run_until_done`, a
  per-step :class:`~repro_torch.train.fault_tolerance.StragglerDetector`
  (host time of steps that each end in a device sync) and, under
  ``debug=True``, the pool's ``check_integrity()`` after every step;
* chaos — a :class:`~repro_torch.serve.faults.FaultInjector` threads its
  points through the pool, the runner and, for the length of each
  ``step()``, the kernels' entry points (``kernel_gate`` raises
  :class:`~repro_torch.kernels.ops.KernelRejected`; nothing falls back).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops as kops
from repro_torch.layers import plan as lplan
from repro_torch.models.api import get_model
from repro_torch.parallel import placement
from repro_torch.quant.quantize import MODES as QUANT_MODES
from repro_torch.quant.quantize import quantize_tree
from repro_torch.quant.sparse import sparsify_tree
from repro_torch.serve import paging
from repro_torch.serve.faults import NULL_INJECTOR, FaultInjector
from repro_torch.serve.metrics import latency_summary
from repro_torch.serve.paging import PoolExhausted
from repro_torch.serve.pool import KVPoolManager, PagedKVPoolManager
from repro_torch.serve.runner import ModelRunner
from repro_torch.serve.scheduler import (PREFILL_BUCKET_MIN, PRIORITIES,
                                         DegradationPolicy, LoadShedder,
                                         PrefillStream, Request, Scheduler)
from repro_torch.train.fault_tolerance import StragglerDetector

__all__ = ["ServeEngine", "Request", "FaultInjector", "PREFILL_BUCKET_MIN"]

PyTree = Any

DEFAULT_PREFILL_CHUNK = 64
#: steps of stats kept (a ring: a long-running engine's host memory stays
#: bounded)
STATS_WINDOW = 4096
#: consecutive zero-progress steps before :meth:`ServeEngine.run_until_done`
#: fails the survivors
DEFAULT_STALL_STEPS = 64


def _param_device(params: PyTree) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class ServeEngine:
    #: families whose prefill padding is inert (causal attention never
    #: lets a real token see a pad token; the VLM's cross attention reads
    #: the image only); MoE capacity routing lets pads displace real
    #: tokens and recurrent state advances through them, so the MoE, SSM
    #: and hybrid families prefill unpadded
    _BUCKET_FAMILIES = ("dense", "vlm")
    #: families served with chunked continuous admission: a chunk's
    #: per-chunk expert capacity differs from the whole prompt's,
    #: recurrent state has no chunk offset and the VLM precomputes its
    #: image K/V at a whole prefill, so the MoE, SSM, hybrid and VLM
    #: families keep blocking whole-prompt admission
    _CHUNK_FAMILIES = ("dense",)

    def __init__(self, run: RunConfig, params: PyTree, *, slots: int = 4,
                 max_seq: int = 512, seed: int = 0,
                 admission: str | None = None,
                 prefill_chunk: int | None = None,
                 kv_byte_budget: int | None = None,
                 quantize: str | None = None,
                 sparsify: str | None = None,
                 kv_quantize: str | None = None,
                 act_quantize: str | None = None,
                 kv_layout: str | None = None,
                 kv_block_size: int | None = None,
                 kv_num_blocks: int | None = None,
                 step_token_budget: int | None = None,
                 stats_window: int = STATS_WINDOW,
                 debug: bool = False,
                 faults: FaultInjector | None = None,
                 degradation: DegradationPolicy | bool = True,
                 stall_steps: int = DEFAULT_STALL_STEPS,
                 priority_aware: bool = True,
                 batch_share: float = 1.0,
                 device: str | torch.device = "cuda"):
        """``params`` must already live on ``device`` (the card by
        default; only an explicit ``"cpu"`` serves on the CPU).  A tree
        placed on a mesh (``parallel/placement.py::place``, already
        quantized or packed) serves as it is: every rank runs the same
        engine on its shards, each block gathering its leaves at use.
        ``admission`` is "continuous" (token-budget chunked prefill; the
        default for the dense family) or "blocking" (one whole prefill per
        admit; the default, and the only choice, for the MoE, SSM, hybrid
        and VLM families).  An encoder config is refused (no decode
        step).
        ``kv_byte_budget`` gates admission and triggers youngest-first
        preemption; None = never preempt.  ``quantize`` ("none" | "int8" |
        "fp8") quantizes the ``run.lrd.quant_targets`` factors at load;
        ``sparsify`` ("none" | "2:4") packs the ``run.lrd.sparse_targets``
        factors 2:4 before that (in the quantized dtype when ``quantize``
        is set); ``kv_quantize`` ("none" | "int8") stores the KV pool in
        int8; ``act_quantize`` ("none" | "int8", needs
        ``quantize="int8"``) quantizes prefill activations per token so
        the int8 plans run int8 x int8 (decode keeps full-width
        activations).  ``kv_layout`` ("slot" | "paged") selects the pool;
        "paged" needs continuous admission, ``kv_block_size`` (default
        16) must divide ``max_seq``, and ``kv_num_blocks`` sizes the
        block pool (default the slot pool's capacity, ``slots * max_seq
        / kv_block_size``).  ``prefill_chunk`` / ``step_token_budget``
        default to ``run.lrd`` (0 there: 64 and ``slots +
        prefill_chunk``), as do the others.

        ``debug=True`` runs the pool's ``check_integrity()`` after every
        step.  ``faults`` threads a
        :class:`~repro_torch.serve.faults.FaultInjector` through the pool,
        the runner and the kernels' entry points (inert by default).
        ``degradation`` is a :class:`~repro_torch.serve.scheduler.
        DegradationPolicy` (True: the defaults; False / None: off) of the
        load shedder; ``stall_steps`` the no-progress horizon of
        :meth:`run_until_done`; ``stats_window`` the length of the stats
        and per-class latency rings.  ``priority_aware`` / ``batch_share``
        configure the scheduler's priority classes."""
        self.device = torch.device(device)
        if _param_device(params).type != self.device.type:
            raise ValueError(f"params live on {_param_device(params)}, "
                             f"engine on {self.device}")
        self.run = run
        self.model = get_model(run.model, self.device)
        if not run.model.has_decode:
            raise ValueError("serving needs a decoder (encoder-only: no "
                             "decode step)")
        if quantize is None:
            quantize = run.lrd.quantize
        if quantize not in ("none", *QUANT_MODES):
            raise ValueError(f"quantize {quantize!r} (want 'none' or one "
                             f"of {QUANT_MODES})")
        if sparsify is None:
            sparsify = run.lrd.sparsify
        placed = placement.is_placed(params)
        if placed and (sparsify != "none" or quantize != "none"):
            raise ValueError("quantize or sparsify a tree before placing "
                             "it (make_param_shardings resolves the "
                             "rewritten leaves)")
        if sparsify != "none":
            # before quantize_tree: the pass prunes and packs (in the
            # quantized dtype), and quantize_tree then skips the packed
            # factors and quantizes the rest (xc, indivisible layers)
            params = sparsify_tree(params, sparsify, mode=quantize,
                                   targets=run.lrd.sparse_targets)
        if quantize != "none":
            params = quantize_tree(params, quantize,
                                   targets=run.lrd.quant_targets)
        self.quantize, self.sparsify = quantize, sparsify
        if kv_quantize is None:
            kv_quantize = run.lrd.kv_quantize
        self.kv_quantize = None if kv_quantize == "none" else kv_quantize
        if act_quantize is None:
            act_quantize = run.lrd.act_quantize
        self.act_quantize = None if act_quantize == "none" else act_quantize
        if self.act_quantize and self.act_quantize != "int8":
            raise ValueError(
                f"act_quantize {act_quantize!r} (want 'int8' or 'none')")
        if self.act_quantize and quantize != "int8":
            raise ValueError(
                "act_quantize='int8' needs quantize='int8' — the qa "
                "kernels run int8 x int8 against fully-int8 factor plans")
        self.params = params
        self.plans = lplan.build_plan_tree(
            placement.meta_view(params) if placed else params)
        self.plan_summary = lplan.tree_summary(self.plans)
        self.slots = slots
        self.max_seq = max_seq
        chunked = run.model.family in self._CHUNK_FAMILIES
        if admission is None:
            admission = "continuous" if chunked else "blocking"
        elif admission not in ("continuous", "blocking"):
            raise ValueError(f"admission {admission!r} (want 'continuous' "
                             "or 'blocking')")
        elif admission == "continuous" and not chunked:
            raise ValueError(
                f"family {run.model.family!r} does not support chunked "
                "admission; use admission='blocking'")
        self.admission = admission
        chunk = prefill_chunk or run.lrd.prefill_chunk \
            or DEFAULT_PREFILL_CHUNK
        self.prefill_chunk = max(1, min(chunk, max_seq))
        self.step_token_budget = (step_token_budget
                                  or run.lrd.step_token_budget
                                  or slots + self.prefill_chunk)
        if kv_layout is None:
            kv_layout = run.lrd.kv_layout or "slot"
        if kv_layout not in ("slot", "paged"):
            raise ValueError(
                f"kv_layout {kv_layout!r} (want 'slot' or 'paged')")
        self.kv_layout = kv_layout
        with torch.inference_mode():
            if kv_layout == "paged":
                if admission != "continuous":
                    raise ValueError(
                        "kv_layout='paged' needs continuous admission "
                        "(the radix prefix gather stages into the "
                        "chunked prefill path)")
                self.pool = PagedKVPoolManager(
                    self.model, slots, max_seq,
                    kv_quantize=self.kv_quantize,
                    byte_budget=kv_byte_budget,
                    block_size=(kv_block_size or run.lrd.kv_block_size
                                or paging.DEFAULT_BLOCK_SIZE),
                    num_blocks=kv_num_blocks)
            else:
                self.pool = KVPoolManager(self.model, slots, max_seq,
                                          kv_quantize=self.kv_quantize,
                                          byte_budget=kv_byte_budget)
        self.plan_summary["kv_bytes_per_step"] = self.pool.kv_bytes_per_step
        self.plan_summary["kv_layout"] = kv_layout
        if self.pool.plans:
            self.plan_summary["kv_cache_family"] = self.pool.plans[0].family
        self.debug = debug
        self.faults = faults if faults is not None else NULL_INJECTOR
        self.pool.faults = self.faults
        self.runner = ModelRunner(self.model, params, max_seq=max_seq,
                                  kv_quantize=self.kv_quantize,
                                  act_quantize=self.act_quantize,
                                  paged=getattr(self.pool, "geometry", None),
                                  faults=self.faults)
        self.scheduler = Scheduler(slots, prefill_chunk=self.prefill_chunk,
                                   step_token_budget=self.step_token_budget,
                                   priority_aware=priority_aware,
                                   batch_share=batch_share)
        if degradation is True:
            degradation = DegradationPolicy()
        self.shedder = (LoadShedder(degradation, self.step_token_budget)
                        if degradation else None)
        self.stragglers = StragglerDetector()
        self.stall_steps = max(1, stall_steps)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.quarantined = 0
        self.deadline_expired = 0
        self._step_idx = 0
        self.stats: deque[dict] = deque(maxlen=stats_window)
        # per-class latency rings (seconds).  ITL samples are service
        # time: this engine's cumulative step seconds between a stream's
        # tokens, so replicas sharing a device are not charged for each
        # other; TTFT is wall clock (queue wait is real latency).
        self.class_itl: dict[str, deque] = {
            p: deque(maxlen=stats_window) for p in PRIORITIES}
        self.class_ttft: dict[str, deque] = {
            p: deque(maxlen=stats_window) for p in PRIORITIES}
        #: set by the router's SLO tracker to trip the load shedder one
        #: step early; consumed and cleared by :meth:`step`
        self.slo_pressure = False
        #: cumulative service seconds (admit + decode + prefill time of
        #: every step), the clock of the class ITL rings
        self.service_s = 0.0
        self._step_token_reqs: list[Request] = []

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
        # the ITL sample is taken at the end of the step, against
        # service_s (the step's length is not known yet)
        self._step_token_reqs.append(req)
        req.output.append(tok)
        req.token_times.append(now)
        if req.first_token_time is None:
            req.first_token_time = now
            if req.submit_time is not None:
                self.class_ttft[req.priority].append(now - req.submit_time)

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
        """Terminate the stream in ``slot`` as ``failed``; its blocks are
        not published (a poisoned cache must never seed later prompts)."""
        self.scheduler.quarantine(slot)
        self.pool.release(slot, publish=False)
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
            cache1 = self.runner.new_stream_cache(self.kv_quantize)
            batch = {"tokens": self._tokens(padded)}
            if self.run.model.family == "vlm":
                # the reference engine's stub image: zero embeddings
                batch["image_embeds"] = torch.zeros(
                    (1, self.run.model.num_image_tokens,
                     self.run.model.d_model), dtype=self.model.dtype,
                    device=self.device)
            logits, cache1 = self.runner.step(
                batch["tokens"], None, "prefill", cache=cache1,
                last_pos=n - 1, batch=batch)
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
                if ps.written:
                    # a paged prefix hit: the first `written` positions'
                    # KV is pooled already; gather it (dequantizing int8
                    # blocks) and prefill only the rest
                    ps.cache = self.pool.gather_prefix(ps.cache, ps.slot,
                                                       ps.written)
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

    # -- lifecycle: cancel / deadlines ------------------------------------------

    def cancel(self, uid: int) -> bool:
        """Cancel request ``uid`` wherever it is (waiting, preempted and
        requeued, chunk-prefilling or decoding), releasing its slot,
        blocks and copy-on-write references; it terminates
        ``cancelled``.  False when ``uid`` is unknown or terminal."""
        sched, pool = self.scheduler, self.pool
        for req in sched.waiting:
            if req.uid == uid:
                sched.waiting.remove(req)
                sched.terminal(req, "cancelled")
                return True
        for ps in sched.prefilling:
            if ps.req.uid == uid:
                sched.prefilling.remove(ps)
                sched.terminal(ps.req, "cancelled")
                # no KV landed yet: release drops exactly the references
                # admission took
                pool.release(ps.slot)
                return True
        for slot, req in enumerate(sched.active):
            if req is not None and req.uid == uid:
                sched.active[slot] = None
                sched.terminal(req, "cancelled")
                pool.release(slot)
                return True
        return False

    def _expire_deadlines(self) -> int:
        """Terminate every request whose ``deadline_s`` (anywhere) or
        ``max_queue_s`` (waiting only) has elapsed; returns the count."""
        sched, pool = self.scheduler, self.pool
        now = time.perf_counter()

        def over(req, budget):
            return (budget is not None and req.submit_time is not None
                    and now - req.submit_time > budget)

        n = 0
        for req in list(sched.waiting):
            if over(req, req.deadline_s) or over(req, req.max_queue_s):
                sched.waiting.remove(req)
                sched.terminal(req, "deadline_exceeded")
                n += 1
        for ps in list(sched.prefilling):
            if over(ps.req, ps.req.deadline_s):
                sched.prefilling.remove(ps)
                sched.terminal(ps.req, "deadline_exceeded")
                pool.release(ps.slot)
                n += 1
        for slot, req in enumerate(sched.active):
            if req is not None and over(req, req.deadline_s):
                sched.active[slot] = None
                sched.terminal(req, "deadline_exceeded")
                pool.release(slot)
                n += 1
        self.deadline_expired += n
        return n

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
            # the KV this step wrote belongs to the *input* token: the
            # paged pool's prefix registry tracks it
            try:
                pool.grow(i, token=int(tokens[i, 0]))
            except PoolExhausted:
                # no block for the next write: preempt (the stream
                # resumes by re-prefilling prompt + output; grow is
                # atomic, so the pool is as it was before the call)
                self.scheduler.preempt(i)
                pool.release(i)
                produced += 1
                continue
            produced += 1
            self._maybe_finish(i)
        return produced

    def step(self) -> int:
        """One scheduler step: expire deadlines, preempt under KV
        pressure, admit (unless the load shedder pauses it), decode every
        live stream, then spend leftover budget on prefill chunks.
        Returns tokens produced (decode + first tokens).  The engine's
        injector gates the kernels' entry points for the length of the
        step only."""
        gate = self.faults if self.faults.configured("kernel_gate") else None
        with torch.inference_mode(), kops.fault_gate(gate):
            return self._step()

    def _step(self) -> int:
        sched, pool = self.scheduler, self.pool
        self._step_idx += 1
        self._step_token_reqs.clear()
        self.stragglers.start()
        self._expire_deadlines()
        victims = pool.pressure_victims()
        for slot in victims:
            sched.preempt(slot)
            pool.release(slot)
        admit_fail0 = sched.admit_failures
        shed = False
        if self.shedder is not None:
            # degraded: the shrunk budget, and no admission while work is
            # in flight (an idle engine always admits)
            sched.step_token_budget = self.shedder.budget
            shed = self.shedder.engaged and (
                bool(sched.prefilling)
                or any(r is not None for r in sched.active))
        admit_s = prefill_s = 0.0
        if self.admission == "blocking":
            t0 = time.perf_counter()
            first, pf_toks = (0, 0) if shed else self._admit_blocking()
            admit_s = time.perf_counter() - t0
            live = sched.live_slots()
            t0 = time.perf_counter()
            produced = self._decode_live(live) if live else 0
            decode_s = time.perf_counter() - t0
        else:
            if not shed:
                sched.admit(pool)
            live = sched.live_slots()
            t0 = time.perf_counter()
            produced = self._decode_live(live) if live else 0
            decode_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pf_toks, first = self._prefill_chunks(len(live))
            prefill_s = time.perf_counter() - t0
        event = self.stragglers.stop(self._step_idx)
        if self.shedder is not None:
            self.shedder.observe(bool(victims)
                                 or sched.admit_failures > admit_fail0
                                 or self.slo_pressure)
        self.slo_pressure = False
        if live or pf_toks or first:
            self.stats.append({"live": len(live), "tokens": produced,
                               "seconds": decode_s,
                               "prefill_tokens": pf_toks,
                               "prefill_seconds": prefill_s,
                               "first_tokens": first,
                               "admit_seconds": admit_s,
                               "preempted": len(victims),
                               "admit_failures":
                                   sched.admit_failures - admit_fail0,
                               "shed": int(shed),
                               "straggler": int(event is not None)})
        # service-time ITL: each token after a stream's first samples the
        # service seconds since its previous token
        self.service_s += admit_s + decode_s + prefill_s
        key = id(self)
        for req in self._step_token_reqs:
            mark = req.service_mark
            if mark is not None and mark[0] == key:
                self.class_itl[req.priority].append(self.service_s - mark[1])
            req.service_mark = (key, self.service_s)
        self._step_token_reqs.clear()
        if self.debug:
            pool.check_integrity()
        return produced + first

    def _fail_survivors(self) -> int:
        """The no-progress watchdog fired: terminate everything queued or
        in flight as ``failed`` and reclaim its pool state unpublished."""
        sched, pool = self.scheduler, self.pool
        n = 0
        while sched.waiting:
            sched.terminal(sched.waiting.popleft(), "failed")
            n += 1
        for ps in list(sched.prefilling):
            sched.prefilling.remove(ps)
            sched.terminal(ps.req, "failed")
            pool.release(ps.slot, publish=False)
            n += 1
        for slot, req in enumerate(sched.active):
            if req is not None:
                sched.active[slot] = None
                sched.terminal(req, "failed")
                pool.release(slot, publish=False)
                n += 1
        return n

    def run_until_done(self, max_steps: int = 10_000) -> list[Request]:
        """Drive the engine until queue and slots drain; returns the
        requests that reached a terminal status during this call.
        ``stall_steps`` consecutive steps without progress (no token, no
        prefill, no terminal transition) fail the survivors and return;
        exhausting ``max_steps`` with work in flight raises."""
        sched = self.scheduler
        start = len(self.finished)
        stalled = 0
        for _ in range(max_steps):
            if not sched.busy():
                break
            fin0 = len(self.finished)
            prev = self.stats[-1] if self.stats else None
            produced = self.step()
            entry = (self.stats[-1]
                     if self.stats and self.stats[-1] is not prev else None)
            progressed = (produced > 0 or len(self.finished) > fin0
                          or bool(entry and entry["prefill_tokens"]))
            stalled = 0 if progressed else stalled + 1
            if stalled >= self.stall_steps:
                self._fail_survivors()
                break
        else:
            if sched.busy():
                raise RuntimeError(
                    f"run_until_done: {max_steps} steps exhausted with "
                    f"{len(sched.waiting)} waiting, "
                    f"{len(sched.prefilling)} prefilling, "
                    f"{len(sched.live_slots())} active requests still "
                    "in flight")
        return self.finished[start:]

    def class_stats(self, priority: str) -> dict:
        """Per-class p50 / p99 ITL and TTFT (ms) over the sample rings,
        and the class's terminal request count."""
        done = sum(1 for r in self.finished if r.priority == priority)
        return latency_summary(self.class_itl[priority],
                               self.class_ttft[priority], requests=done)

    def throughput(self) -> dict:
        """Aggregate serving stats over the stats window (host clock,
        device synchronised by the sampler's host copy).  The reference's
        key set, the same whether or not a step was recorded (the
        ``shed_*`` / ``degradation_*`` group iff the engine has a load
        shedder), plus ``decode_step_ms_mean`` and ``latency``."""
        stats = list(self.stats)
        status_counts: dict[str, int] = {}
        for r in self.finished:
            key = r.status or "finished"
            status_counts[key] = status_counts.get(key, 0) + 1
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
               "deadline_expired": self.deadline_expired,
               "status_counts": status_counts,
               "slow_steps": len(self.stragglers.events),
               "step_ewma_s": self.stragglers.ewma,
               "ttft_mean_s": (sum(ttfts) / len(ttfts)) if ttfts else 0.0,
               "per_class": {p: self.class_stats(p) for p in PRIORITIES},
               "latency": latency_summary(itls, ttfts,
                                          requests=len(self.finished))}
        if self.shedder is not None:
            out["shed_steps"] = sum(s["shed"] for s in stats)
            out["degradation_engaged"] = self.shedder.engaged
            out["degradation_engages"] = self.shedder.engage_count
            out["degradation_recoveries"] = self.shedder.recover_count
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
