"""Public entry points of the hand-written kernels.

Each flattens leading dims (``(..., C) -> (M, C)``) and dispatches by the
device the activation lives on: a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`; any other device goes to the CUDA kernel,
which launches or raises.  Nothing else -- no padding (the kernels mask
ragged M, C, R and S themselves) and no fit fallback.

Under autograd (grad enabled and an input that requires grad) the two
chains of the training path, ``lowrank_matmul`` and ``branched_matmul``,
run as :mod:`repro_torch.kernels.autograd`'s Functions: the same forward,
a backward of explicit products.  The other kernels are serve-only (the
quantized, 2:4 and activation-quantized chains are load-time rewrites
the reference never trains, the decode attentions read a KV pool): a
call under autograd raises.

Every entry point first consults the ``kernel_gate`` fault point of the
injector installed by :func:`fault_gate` (the serve engine installs its
own for the length of its ``step()``).  A fire raises
:class:`KernelRejected` before anything dispatches: no kernel launches
and no plain version runs in its place.  (The reference's gate makes its
fit predicate refuse at trace time and falls back to the oracle; the
port has no fallback, and its hook is per step, not module-global.)

While a :class:`repro_torch.analysis.roofline.StepCounter` is active
(:func:`set_counter`), each entry point is one fused op of the count: it
charges its kernel's cost once (``roofline.kernel_cost``), and the
counter sees none of the aten ops it runs, so a CPU tensor's plain
version and a CUDA tensor's launch count alike.  With no counter (the
default, ``None``) the entry points run as they are.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from repro_torch.kernels import autograd as kgrad
from repro_torch.kernels import branched_matmul as bk
from repro_torch.kernels import branched_matmul_q as bqk
from repro_torch.kernels import branched_matmul_qa as bak
from repro_torch.kernels import branched_matmul_sq as bsk
from repro_torch.kernels import decode_attention_latent_q as dlk
from repro_torch.kernels import decode_attention_paged as dpk
from repro_torch.kernels import decode_attention_q as dak
from repro_torch.kernels import lowrank_matmul as lk
from repro_torch.kernels import lowrank_matmul_q as lqk
from repro_torch.kernels import lowrank_matmul_qa as lak
from repro_torch.kernels import lowrank_matmul_sq as lsk
from repro_torch.kernels import ref


class KernelRejected(RuntimeError):
    """An entry point refused to dispatch: the ``kernel_gate`` fault point
    fired.  ``kernel`` names the entry point."""

    def __init__(self, kernel: str):
        super().__init__(f"{kernel}: rejected by the kernel_gate fault point")
        self.kernel = kernel


#: the injector the entry points consult (``None``: the gate is inert)
_FAULT_INJECTOR = None


def set_fault_injector(inj):
    """Install ``inj`` (a :class:`repro_torch.serve.faults.FaultInjector`,
    or ``None`` to clear) for the ``kernel_gate`` point; returns the one
    it replaces."""
    global _FAULT_INJECTOR
    prev, _FAULT_INJECTOR = _FAULT_INJECTOR, inj
    return prev


@contextlib.contextmanager
def fault_gate(inj):
    """Install ``inj`` for the block and restore the previous injector on
    exit, an exception included."""
    prev = set_fault_injector(inj)
    try:
        yield
    finally:
        set_fault_injector(prev)


#: the step counter the entry points charge (``None``: nothing counts)
_COUNTER = None


def set_counter(counter):
    """Install ``counter`` (a ``StepCounter``, or ``None`` to clear);
    returns the one it replaces."""
    global _COUNTER
    prev, _COUNTER = _COUNTER, counter
    return prev


def _counted(fn):
    """Make entry point ``fn`` one op of an active counter's count."""
    name = fn.__name__

    @functools.wraps(fn)
    def entry(*args, **kwargs):
        counter = _COUNTER
        if counter is None:
            return fn(*args, **kwargs)
        with counter.kernel(name, args):
            return fn(*args, **kwargs)
    return entry


def _gate(name: str) -> None:
    if _FAULT_INJECTOR is not None and _FAULT_INJECTOR.fire("kernel_gate"):
        raise KernelRejected(name)


def _under_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _serve_only(name: str, x: torch.Tensor) -> None:
    """Raise for a serve-only kernel called under autograd."""
    if _under_grad(x):
        raise RuntimeError(f"{name} is a serve-time kernel with no backward; "
                           "call it under torch.no_grad() / "
                           "torch.inference_mode()")


@_counted
def lowrank_matmul(x: torch.Tensor, w0: torch.Tensor,
                   w1: torch.Tensor) -> torch.Tensor:
    """y = (x @ w0) @ w1.  x (..., C); w0 (C, R); w1 (R, S) -> (..., S)."""
    _gate("lowrank_matmul")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _under_grad(x, w0, w1):
        y = kgrad.LowrankMatmul.apply(x2.contiguous(), w0, w1)
    elif x.device.type == "cpu":
        y = ref.lowrank_matmul_ref(x2, w0, w1)
    else:
        y = lk.lowrank_matmul(x2.contiguous(), w0, w1)
    return y.reshape(*lead, w1.shape[-1])


@_counted
def branched_matmul(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """y = sum_n ((x @ u_n) @ xc_n) @ v_n.  x (..., C) -> (..., S)."""
    _gate("branched_matmul")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _under_grad(x, u, xc, v):
        y = kgrad.BranchedMatmul.apply(x2.contiguous(), u, xc, v)
    elif x.device.type == "cpu":
        y = ref.branched_matmul_ref(x2, u, xc, v)
    else:
        y = bk.branched_matmul(x2.contiguous(), u, xc, v)
    return y.reshape(*lead, v.shape[-1])


@_counted
def lowrank_matmul_q(x: torch.Tensor, w0_q: torch.Tensor,
                     w0_scale: torch.Tensor, w1_q: torch.Tensor,
                     w1_scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ dq(w0)) @ dq(w1).  x (..., C); w0_q (C, R) + w0_scale
    (1, R); w1_q (R, S) + w1_scale (1, S) -> (..., S)."""
    _gate("lowrank_matmul_q")
    _serve_only("lowrank_matmul_q", x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.lowrank_matmul_q_ref(x2, w0_q, w0_scale, w1_q, w1_scale)
    else:
        y = lqk.lowrank_matmul_q(x2.contiguous(), w0_q, w0_scale, w1_q,
                                 w1_scale)
    return y.reshape(*lead, w1_q.shape[-1])


@_counted
def branched_matmul_q(x: torch.Tensor, u_q: torch.Tensor,
                      u_scale: torch.Tensor, xc_q: torch.Tensor,
                      xc_scale: torch.Tensor, v_q: torch.Tensor,
                      v_scale: torch.Tensor) -> torch.Tensor:
    """y = sum_n ((x @ dq(u_n)) @ dq(xc_n)) @ dq(v_n).  x (..., C) ->
    (..., S)."""
    _gate("branched_matmul_q")
    _serve_only("branched_matmul_q", x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.branched_matmul_q_ref(x2, u_q, u_scale, xc_q, xc_scale, v_q,
                                      v_scale)
    else:
        y = bqk.branched_matmul_q(x2.contiguous(), u_q, u_scale, xc_q,
                                  xc_scale, v_q, v_scale)
    return y.reshape(*lead, v_q.shape[-1])


@_counted
def lowrank_matmul_sq(x: torch.Tensor, w0_sp: torch.Tensor,
                      w0_idx: torch.Tensor, w0_scale: torch.Tensor,
                      w1_sp: torch.Tensor, w1_idx: torch.Tensor,
                      w1_scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ ds(w0)) @ ds(w1) on 2:4-packed quantized factors.  x (...,
    C); w0_sp (2, C/4, R) + w0_idx (2, C/4, 1) + w0_scale (1, R); w1_sp
    (2, R/4, S) + w1_idx (2, R/4, 1) + w1_scale (1, S) -> (..., S)."""
    _gate("lowrank_matmul_sq")
    _serve_only("lowrank_matmul_sq", x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.lowrank_matmul_sq_ref(x2, w0_sp, w0_idx, w0_scale, w1_sp,
                                      w1_idx, w1_scale)
    else:
        y = lsk.lowrank_matmul_sq(x2.contiguous(), w0_sp, w0_idx, w0_scale,
                                  w1_sp, w1_idx, w1_scale)
    return y.reshape(*lead, w1_sp.shape[-1])


@_counted
def branched_matmul_sq(x: torch.Tensor, u_sp: torch.Tensor,
                       u_idx: torch.Tensor, u_scale: torch.Tensor,
                       xc_q: torch.Tensor, xc_scale: torch.Tensor,
                       v_sp: torch.Tensor, v_idx: torch.Tensor,
                       v_scale: torch.Tensor) -> torch.Tensor:
    """y = sum_n ((x @ ds(u_n)) @ dq(xc_n)) @ ds(v_n): u and v 2:4-packed
    per branch, xc quantized dense.  x (..., C) -> (..., S)."""
    _gate("branched_matmul_sq")
    _serve_only("branched_matmul_sq", x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.branched_matmul_sq_ref(x2, u_sp, u_idx, u_scale, xc_q,
                                       xc_scale, v_sp, v_idx, v_scale)
    else:
        y = bsk.branched_matmul_sq(x2.contiguous(), u_sp, u_idx, u_scale,
                                   xc_q, xc_scale, v_sp, v_idx, v_scale)
    return y.reshape(*lead, v_sp.shape[-1])


@_counted
def lowrank_matmul_qa(x: torch.Tensor, w0_q: torch.Tensor,
                      w0_scale: torch.Tensor, w1_q: torch.Tensor,
                      w1_scale: torch.Tensor) -> torch.Tensor:
    """The activation-quantized chain: x (..., C) quantized per row,
    both dots int8 x int8 on int8 w0_q (C, R) / w1_q (R, S) with f32
    scales (1, R) / (1, S) -> (..., S)."""
    _gate("lowrank_matmul_qa")
    _serve_only("lowrank_matmul_qa", x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.lowrank_matmul_qa_ref(x2, w0_q, w0_scale, w1_q, w1_scale)
    else:
        y = lak.lowrank_matmul_qa(x2.contiguous(), w0_q, w0_scale, w1_q,
                                  w1_scale)
    return y.reshape(*lead, w1_q.shape[-1])


@_counted
def branched_matmul_qa(x: torch.Tensor, u_q: torch.Tensor,
                       u_scale: torch.Tensor, xc_q: torch.Tensor,
                       xc_scale: torch.Tensor, v_q: torch.Tensor,
                       v_scale: torch.Tensor) -> torch.Tensor:
    """The activation-quantized branched chain: x (..., C) quantized per
    row once, every branch dot int8 x int8 -> (..., S)."""
    _gate("branched_matmul_qa")
    _serve_only("branched_matmul_qa", x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.branched_matmul_qa_ref(x2, u_q, u_scale, xc_q, xc_scale,
                                       v_q, v_scale)
    else:
        y = bak.branched_matmul_qa(x2.contiguous(), u_q, u_scale, xc_q,
                                   xc_scale, v_q, v_scale)
    return y.reshape(*lead, v_q.shape[-1])


def _decode_rows(q: torch.Tensor, kh: int) -> torch.Tensor:
    """q (B, 1, H, D) -> (B, KH, G, D): the H query rows group as (KH, G),
    as in the reference (``repro/kernels/ops.py:407-408``)."""
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"decode attention takes one query row, got {sq}")
    return q.reshape(b, kh, h // kh, d).contiguous()


@_counted
def decode_attention_paged(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, block_tables: torch.Tensor,
                           cache_pos: torch.Tensor, *,
                           softcap: float = 0.0) -> torch.Tensor:
    """One decode step of attention over a full-width paged pool.  q (B,
    1, H, D); k/v (NB+1, bs, KH, D), block NB the dummy; block_tables
    (B, nblk) int32; cache_pos (B,) -> (B, 1, H, D)."""
    _gate("decode_attention_paged")
    _serve_only("decode_attention_paged", q)
    if q.device.type == "cpu":
        return ref.decode_attention_paged_ref(q, k, v, block_tables,
                                              cache_pos, softcap=softcap)
    o = dpk.decode_attention_paged(
        _decode_rows(q, k.shape[2]), k, v,
        block_tables.to(torch.int32).contiguous(),
        cache_pos.to(torch.int32).contiguous(), softcap=softcap)
    return o.reshape(q.shape)


@_counted
def decode_attention_paged_q(q: torch.Tensor, k_q: torch.Tensor,
                             k_scale: torch.Tensor, v_q: torch.Tensor,
                             v_scale: torch.Tensor,
                             block_tables: torch.Tensor,
                             cache_pos: torch.Tensor, *,
                             softcap: float = 0.0) -> torch.Tensor:
    """One decode step of attention over an int8 paged pool with one
    scale row per physical block, k/v_scale (NB+1, KH, D) f32."""
    _gate("decode_attention_paged_q")
    _serve_only("decode_attention_paged_q", q)
    if q.device.type == "cpu":
        return ref.decode_attention_paged_q_ref(
            q, k_q, k_scale, v_q, v_scale, block_tables, cache_pos,
            softcap=softcap)
    o = dpk.decode_attention_paged_q(
        _decode_rows(q, k_q.shape[2]), k_q, k_scale, v_q, v_scale,
        block_tables.to(torch.int32).contiguous(),
        cache_pos.to(torch.int32).contiguous(), softcap=softcap)
    return o.reshape(q.shape)


@_counted
def decode_attention_q(q: torch.Tensor, k_q: torch.Tensor,
                       k_scale: torch.Tensor, v_q: torch.Tensor,
                       v_scale: torch.Tensor, cache_pos: torch.Tensor, *,
                       softcap: float = 0.0) -> torch.Tensor:
    """One decode step of attention over an int8 KV pool.  q (B, 1, H, D);
    k_q/v_q (B, S, KH, D) int8; k/v_scale (B, KH, D) f32; cache_pos (B,)
    -> (B, 1, H, D)."""
    _gate("decode_attention_q")
    _serve_only("decode_attention_q", q)
    if q.device.type == "cpu":
        return ref.decode_attention_q_ref(q, k_q, k_scale, v_q, v_scale,
                                          cache_pos, softcap=softcap)
    o = dak.decode_attention_q(
        _decode_rows(q, k_q.shape[2]), k_q, k_scale, v_q, v_scale,
        cache_pos.to(torch.int32).contiguous(), softcap=softcap)
    return o.reshape(q.shape)


@_counted
def decode_attention_latent_q(q_lat: torch.Tensor, q_rope: torch.Tensor,
                              ckv_q: torch.Tensor, ckv_scale: torch.Tensor,
                              krope_q: torch.Tensor,
                              krope_scale: torch.Tensor,
                              cache_pos: torch.Tensor, *,
                              scale: float) -> torch.Tensor:
    """One absorbed-form MLA decode step over an int8 latent pool.  q_lat
    (B, 1, H, L); q_rope (B, 1, H, R); ckv_q (B, S, L) / krope_q (B, S,
    R) int8; ckv/krope_scale (B, L)/(B, R) f32; cache_pos (B,) ->
    context latents (B, 1, H, L).  Where the reference falls back to its
    oracle when the VMEM budget does not fit (``repro/kernels/ops.py:
    478-510``), the kernel raises."""
    _gate("decode_attention_latent_q")
    _serve_only("decode_attention_latent_q", q_lat)
    if q_lat.device.type == "cpu":
        return ref.decode_attention_latent_q_ref(
            q_lat, q_rope, ckv_q, ckv_scale, krope_q, krope_scale,
            cache_pos, scale=scale)
    if q_lat.shape[1] != 1:
        raise ValueError("decode attention takes one query row, got "
                         f"{q_lat.shape[1]}")
    o = dlk.decode_attention_latent_q(
        q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous(), ckv_q,
        ckv_scale, krope_q, krope_scale,
        cache_pos.to(torch.int32).contiguous(), scale=scale)
    return o[:, None]
