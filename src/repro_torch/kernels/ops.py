"""Public entry points of the hand-written kernels.

Each flattens leading dims (``(..., C) -> (M, C)``) and dispatches by the
device the activation lives on: a CPU tensor runs the plain version in
:mod:`repro_torch.kernels.ref`; any other device goes to the CUDA kernel,
which launches or raises.  Nothing else -- no padding (the kernels mask
ragged M, C, R and S themselves) and no fit fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import branched_matmul as bk
from repro_torch.kernels import branched_matmul_q as bqk
from repro_torch.kernels import decode_attention_q as dak
from repro_torch.kernels import lowrank_matmul as lk
from repro_torch.kernels import lowrank_matmul_q as lqk
from repro_torch.kernels import ref


def lowrank_matmul(x: torch.Tensor, w0: torch.Tensor,
                   w1: torch.Tensor) -> torch.Tensor:
    """y = (x @ w0) @ w1.  x (..., C); w0 (C, R); w1 (R, S) -> (..., S)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.lowrank_matmul_ref(x2, w0, w1)
    else:
        y = lk.lowrank_matmul(x2.contiguous(), w0, w1)
    return y.reshape(*lead, w1.shape[-1])


def branched_matmul(x: torch.Tensor, u: torch.Tensor, xc: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """y = sum_n ((x @ u_n) @ xc_n) @ v_n.  x (..., C) -> (..., S)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.branched_matmul_ref(x2, u, xc, v)
    else:
        y = bk.branched_matmul(x2.contiguous(), u, xc, v)
    return y.reshape(*lead, v.shape[-1])


def lowrank_matmul_q(x: torch.Tensor, w0_q: torch.Tensor,
                     w0_scale: torch.Tensor, w1_q: torch.Tensor,
                     w1_scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ dq(w0)) @ dq(w1).  x (..., C); w0_q (C, R) + w0_scale
    (1, R); w1_q (R, S) + w1_scale (1, S) -> (..., S)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.lowrank_matmul_q_ref(x2, w0_q, w0_scale, w1_q, w1_scale)
    else:
        y = lqk.lowrank_matmul_q(x2.contiguous(), w0_q, w0_scale, w1_q,
                                 w1_scale)
    return y.reshape(*lead, w1_q.shape[-1])


def branched_matmul_q(x: torch.Tensor, u_q: torch.Tensor,
                      u_scale: torch.Tensor, xc_q: torch.Tensor,
                      xc_scale: torch.Tensor, v_q: torch.Tensor,
                      v_scale: torch.Tensor) -> torch.Tensor:
    """y = sum_n ((x @ dq(u_n)) @ dq(xc_n)) @ dq(v_n).  x (..., C) ->
    (..., S)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = ref.branched_matmul_q_ref(x2, u_q, u_scale, xc_q, xc_scale, v_q,
                                      v_scale)
    else:
        y = bqk.branched_matmul_q(x2.contiguous(), u_q, u_scale, xc_q,
                                  xc_scale, v_q, v_scale)
    return y.reshape(*lead, v_q.shape[-1])


def decode_attention_q(q: torch.Tensor, k_q: torch.Tensor,
                       k_scale: torch.Tensor, v_q: torch.Tensor,
                       v_scale: torch.Tensor, cache_pos: torch.Tensor, *,
                       softcap: float = 0.0) -> torch.Tensor:
    """One decode step of attention over an int8 KV pool.  q (B, 1, H, D);
    k_q/v_q (B, S, KH, D) int8; k/v_scale (B, KH, D) f32; cache_pos (B,)
    -> (B, 1, H, D).  The H query rows group as (KH, G), as in the
    reference (``repro/kernels/ops.py:407-408``)."""
    if q.device.type == "cpu":
        return ref.decode_attention_q_ref(q, k_q, k_scale, v_q, v_scale,
                                          cache_pos, softcap=softcap)
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"decode attention takes one query row, got {sq}")
    kh = k_q.shape[2]
    o = dak.decode_attention_q(
        q.reshape(b, kh, h // kh, d).contiguous(), k_q, k_scale, v_q,
        v_scale, cache_pos.to(torch.int32).contiguous(), softcap=softcap)
    return o.reshape(b, 1, h, d)
