"""Layer-latency cost model: the timer behind Algorithm 1.

The paper times each candidate decomposition with a GPU profiler.  The
model here is the reference's (``repro/core/cost_model.py``) formula for
formula, with the card's constants (:data:`repro_torch.analysis.hw_specs.
DEFAULT`, the H100): a dim pads to the column tile (128), so a rank of
309 costs the tensor cores what 384 costs, while 256 saves a whole tile.

``matmul_time`` models ``(M x K) @ (K x N)`` as

    t = max(compute, memory)
    compute = 2 * M' * K' * N' / peak_flops      (padded dims)
    memory  = bytes(A) + bytes(B) + bytes(C) / hbm_bw   (unpadded, streamed)

a two-term roofline per product.  The staircase of t(r) (paper Fig. 2)
comes entirely from the padding.  :func:`make_measured_timer` is the
paper's own mode: it times the real products on the card with CUDA
events.
"""
from __future__ import annotations

import functools
import time
from typing import Callable

import torch

from repro_torch.analysis.hw_specs import DEFAULT, HardwareSpec, mxu_padded


def matmul_time(m: int, k: int, n: int, *, dtype_bytes: int = 2,
                spec: HardwareSpec = DEFAULT) -> float:
    """Modelled seconds for (m,k)@(k,n) on one card."""
    mp, kp, np_ = mxu_padded(m, spec), mxu_padded(k, spec), mxu_padded(n, spec)
    compute = 2.0 * mp * kp * np_ / spec.peak_flops_bf16
    memory = dtype_bytes * (m * k + k * n + m * n) / spec.hbm_bandwidth
    return max(compute, memory)


def dense_layer_time(m: int, c: int, s: int, **kw) -> float:
    """Original FC layer: one (m,c)@(c,s)."""
    return matmul_time(m, c, s, **kw)


def lowrank_layer_time(m: int, c: int, s: int, rank: int, **kw) -> float:
    """SVD pair: (m,c)@(c,r) then (m,r)@(r,s).  Two HBM round-trips."""
    return matmul_time(m, c, rank, **kw) + matmul_time(m, rank, s, **kw)


def branched_layer_time(m: int, c: int, s: int, r1: int, r2: int,
                        branches: int, *, dtype_bytes: int = 2,
                        spec: HardwareSpec = DEFAULT) -> float:
    """Block-diagonal branched LRD (paper Eq. 17 / Fig. 4) as one fused
    kernel runs it: branches back to back (time adds) with per-branch K
    dims of r/N; HBM traffic is x once, every branch's weights and the
    output."""
    n = branches
    b1, b2 = max(1, r1 // n), max(1, r2 // n)
    mp = mxu_padded(m, spec)
    flops = n * 2.0 * mp * (mxu_padded(c, spec) * mxu_padded(b1, spec)
                            + mxu_padded(b1, spec) * mxu_padded(b2, spec)
                            + mxu_padded(b2, spec) * mxu_padded(s, spec))
    compute = flops / spec.peak_flops_bf16
    weights = n * (c * b1 + b1 * b2 + b2 * s)
    memory = dtype_bytes * (m * c + weights + m * s) / spec.hbm_bandwidth
    return max(compute, memory)


def plan_layer_time(plan, m: int, *, act_bytes: int = 2, kv_bytes: int = 0,
                    act_quantize: bool = False,
                    spec: HardwareSpec = DEFAULT) -> float:
    """Modelled seconds for one :class:`repro_torch.layers.plan.LinearPlan`
    at ``m`` tokens: the plan-driven, quant-aware form of the timers
    above.

    Compute walks the plan's matmul chain on padded dims, scaled by each
    factor's ``chain_density()`` and costed at ``spec.peak_flops`` of the
    widest operand (int8 x int8 only where every factor is plain int8 and
    ``act_quantize`` is on: :func:`plan_qa_eligible`).  Memory streams
    the activations (:func:`plan_act_stream_bytes`), the plan's
    ``weight_bytes`` and ``kv_bytes``, the KV pool bytes the layer reads
    a step (``CachePlan.bytes_per_step`` of :mod:`repro_torch.layers.cache`,
    where the reference has ``plan_kv_bytes``)."""
    mp = mxu_padded(m, spec)
    qa = plan_qa_eligible(plan, act_quantize)
    rate = spec.peak_flops(1 if qa else act_bytes)
    flops = sum(2.0 * mult * mp * mxu_padded(k, spec) * mxu_padded(n, spec)
                * density
                for (mult, k, n), density in zip(plan.matmul_chain(),
                                                 plan.chain_density()))
    compute = flops / rate
    memory = (plan_act_stream_bytes(plan, act_bytes=act_bytes,
                                    act_quantize=act_quantize) * m
              + plan.weight_bytes + kv_bytes) / spec.hbm_bandwidth
    return max(compute, memory)


def plan_qa_eligible(plan, act_quantize: bool = True) -> bool:
    """Does the whole chain run int8 x int8 with act-quant on: every
    factor quantized, dense (no 2:4 pack: sparse plans never take the qa
    kernels), with 1-byte values?  As in the reference, the test is the
    value's byte width, so it also says yes for fp8 factors, which
    :meth:`repro_torch.layers.plan.LinearPlan.kernel_for` keeps on the
    weight-only kernels (a quirk of the reference, kept)."""
    return act_quantize and all(
        f.quantized and f.sparsity is None and f.dtype.itemsize == 1
        for f in plan.chain_factors())


def plan_act_stream_bytes(plan, *, act_bytes: int = 2,
                          act_quantize: bool = False) -> float:
    """Per-token activation bytes of one linear: its input and output
    rows at ``act_bytes``, narrowed to int8 values plus one f32 scale
    per row when the chain is qa-eligible."""
    if plan_qa_eligible(plan, act_quantize):
        act_bytes = 1 + 4.0 / max(1, plan.d_in)
    return act_bytes * (plan.d_in + plan.d_out)


def conv_time(m_hw: int, c: int, s: int, k: int, *, dtype_bytes: int = 2,
              spec: HardwareSpec = DEFAULT) -> float:
    """kxk conv at output spatial size m_hw^2 == matmul with K = c*k*k."""
    return matmul_time(m_hw * m_hw, c * k * k, s,
                       dtype_bytes=dtype_bytes, spec=spec)


def tucker2_time(m_hw: int, c: int, s: int, k: int, r1: int, r2: int,
                 **kw) -> float:
    """1x1 (c->r1) + kxk core (r1->r2) + 1x1 (r2->s)."""
    m = m_hw * m_hw
    return (matmul_time(m, c, r1, **kw)
            + matmul_time(m, r1 * k * k, r2, **kw)
            + matmul_time(m, r2, s, **kw))


# ---------------------------------------------------------------------------
# Timers for Algorithm 1 (rank_selection.py): rank -> seconds for a fixed
# layer geometry, from the cost model or measured on the device.
# ---------------------------------------------------------------------------

def make_model_timer(m: int, c: int, s: int, *, kind: str = "svd",
                     k: int = 1, beta: float | None = None,
                     spec: HardwareSpec = DEFAULT) -> Callable[[int], float]:
    if kind == "svd":
        def timer(r: int) -> float:
            return lowrank_layer_time(m, c, s, r, spec=spec)
    elif kind == "tucker":
        bb = beta if beta is not None else s / c
        def timer(r: int) -> float:
            r2 = max(1, int(round(bb * r)))
            return tucker2_time(int(m ** 0.5) or 1, c, s, k, r, r2, spec=spec)
    else:
        raise ValueError(kind)
    return timer


def make_dense_time(m: int, c: int, s: int, *, kind: str = "svd", k: int = 1,
                    spec: HardwareSpec = DEFAULT) -> float:
    if kind == "svd":
        return dense_layer_time(m, c, s, spec=spec)
    return conv_time(int(m ** 0.5) or 1, c, s, k, spec=spec)


#: spin cycles queued on the card before a timed run (about 1 ms on an
#: H100): the host enqueues the run behind it, so the events time the
#: device's work and not the host's launches
SPIN_CYCLES = 2_000_000


def _seconds(fn: Callable[[], torch.Tensor], device: torch.device,
             iters: int, x: torch.Tensor, cold: bool) -> float:
    """Mean seconds of ``fn`` over ``iters`` calls after one warm-up call
    (cuBLAS picks its algorithm for the shape there): on a CUDA device
    each call between its own CUDA events, the host kept ahead; with
    ``cold`` twice the L2 is written before each call, outside its
    events, and then ``x`` is rewritten in place, so the weights stream
    from HBM and the input sits in L2, as in a layer of a served stack.
    On the CPU the host clock over all calls."""
    with torch.inference_mode():
        fn()
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters
        with torch.cuda.device(device):
            flush = (torch.empty(2 * DEFAULT.l2_bytes, dtype=torch.uint8,
                                 device=device) if cold else None)
            events = []
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(iters):
                if cold:
                    flush.zero_()
                    x.mul_(1)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in events) / 1e3 / iters


def _randn(shape: tuple[int, int], seed: int, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=dtype)


def make_measured_timer(m: int, c: int, s: int, *,
                        dtype: torch.dtype = torch.float32, iters: int = 5,
                        device: str | torch.device = "cuda", seed: int = 0,
                        cold: bool = True) -> Callable[[int], float]:
    """Timer of ``(x @ w0) @ w1`` on ``device`` at each candidate rank
    (the paper's method verbatim): mean seconds of ``iters`` calls after
    a warm-up call, by CUDA events on a CUDA device (with the host kept
    ahead, and with ``cold`` the factors out of L2 before every call:
    :func:`_seconds`), by the host clock on ``device="cpu"``.  Inputs
    come from seeded generators (``x`` from ``seed``, rank ``r``'s
    factors from ``seed + 2r + 1`` and ``seed + 2r + 2``), so t(r) does
    not depend on the order of the ranks asked; each rank is timed once
    and cached."""
    dev = torch.device(device)
    x = _randn((m, c), seed, dtype, dev)

    @functools.lru_cache(maxsize=None)
    def timer(r: int) -> float:
        w0 = _randn((c, r), seed + 2 * r + 1, dtype, dev)
        w1 = _randn((r, s), seed + 2 * r + 2, dtype, dev)
        return _seconds(lambda: (x @ w0) @ w1, dev, iters, x, cold)

    return timer


def measured_dense_time(m: int, c: int, s: int, *,
                        dtype: torch.dtype = torch.float32, iters: int = 5,
                        device: str | torch.device = "cuda", seed: int = 0,
                        cold: bool = True) -> float:
    """:func:`make_measured_timer`'s measurement of the dense layer
    ``x @ w``."""
    dev = torch.device(device)
    x = _randn((m, c), seed, dtype, dev)
    w = _randn((c, s), seed + 1, dtype, dev)
    return _seconds(lambda: x @ w, dev, iters, x, cold)
