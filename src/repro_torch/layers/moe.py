"""Mixture-of-Experts FFN with sort-based token dispatch.

The reference's dispatch, step for step:

  router gates (T, E) in f32 -> top-k (ties to the lower expert) ->
  renormalised gates -> flatten the (T*k) assignments -> stable sort by
  expert -> position in the expert -> scatter token ids into an
  (E, capacity) grid (assignments past an expert's capacity go to one
  overflow slot that is dropped; an empty slot holds the sentinel T) ->
  gather activations -> per-expert batched products -> scatter-add the
  gated outputs back in f32.

Capacity is ``max(1, round(T * k / E * capacity_factor))`` with Python's
round (half to even), so every row of a segment, an idle decode slot's
included, takes its place in the grid as in the reference.

Expert weights live under ``experts/{up,gate,down}`` with a leading
expert axis; LRD surgery decomposes them batched over layers and experts
(``{"w0", "w1"}`` or ``{"u", "xc", "v"}``).  The routed products are
plain batched products (``torch.matmul``), as the reference's are plain
``einsum``s outside any Pallas kernel; the shared experts are ordinary
linears through :func:`repro_torch.layers.param.apply_linear`, and so
through the chain kernels once decomposed.  A quantized or 2:4-packed
expert bank has no path here, as it has none in the reference
(``repro_torch.quant`` refuses to make one).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.mlp import ffn_hidden
from repro_torch.layers.param import (EMBED, EXPERTS, FFN, ParamBuilder,
                                      apply_linear, init_linear)
from repro_torch.layers.plan import matmul_f32


def init_moe(pb: ParamBuilder, name: str, d_model: int, d_ff: int,
             num_experts: int, num_shared: int, act: str = "swiglu") -> None:
    sub = pb.child(name)
    sub.param("router", (d_model, num_experts), (EMBED, EXPERTS),
              scale=0.02)
    ex = sub.child("experts")
    # each bank is a {"w": ...} subtree, so LRD surgery decomposes it
    # batched over the expert axis
    ex.child("up").param("w", (num_experts, d_model, d_ff),
                         (EXPERTS, EMBED, FFN))
    if act == "swiglu":
        ex.child("gate").param("w", (num_experts, d_model, d_ff),
                               (EXPERTS, EMBED, FFN))
    ex.child("down").param("w", (num_experts, d_ff, d_model),
                           (EXPERTS, FFN, EMBED))
    if num_shared:
        sh = sub.child("shared")
        init_linear(sh, "up", d_model, num_shared * d_ff, EMBED, FFN)
        if act == "swiglu":
            init_linear(sh, "gate", d_model, num_shared * d_ff, EMBED, FFN)
        init_linear(sh, "down", num_shared * d_ff, d_model, FFN, EMBED)


def _expert_matmul(w: dict, x: torch.Tensor) -> torch.Tensor:
    """``x (E, C, d_in)`` through per-expert weights -> ``(E, C, d_out)``:
    a dense bank ``w (E, d_in, d_out)``, an SVD pair ``w0 (E, d_in, R)``,
    ``w1 (E, R, d_out)`` or branched factors ``u (E, N, d_in, r1)``,
    ``xc (E, N, r1, r2)``, ``v (E, N, r2, d_out)``.  Each product rounds to
    ``x.dtype`` where the reference casts; the last branched product sums
    the branches inside the one contraction, as the reference's
    ``"necs,enso->eco"`` does."""
    if "w0" in w:
        h = torch.matmul(x, w["w0"])
        return torch.matmul(h, w["w1"])
    if "u" in w:
        e, n, _, _ = w["u"].shape
        h = torch.matmul(x.unsqueeze(1), w["u"])           # (E, N, C, r1)
        h = torch.matmul(h, w["xc"])                       # (E, N, C, r2)
        r2, d_out = w["v"].shape[-2:]
        h = h.transpose(1, 2).reshape(e, x.shape[1], n * r2)
        return torch.matmul(h, w["v"].reshape(e, n * r2, d_out))
    if "w" not in w:
        raise ValueError(
            f"expert bank with keys {sorted(w)}: the expert products take "
            "dense, SVD-pair or branched banks only")
    return torch.matmul(x, w["w"])


def _topk(gates: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest per row, ties to the lower index (a
    stable descending sort, cut to k)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(xt: torch.Tensor, router: torch.Tensor, top_k: int, cap: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Sort-based dispatch of ``xt (T, d)`` into ``(E, cap, d)`` slots.
    Returns ``(xe, slot_tok, slot_gate, aux)``: the gathered rows (empty
    slots zero), each slot's token (``T`` where empty), its gate (f32)
    and the Switch-style load-balance loss of the first choices."""
    t, d = xt.shape
    e = router.shape[-1]
    dev = xt.device
    logits = matmul_f32(xt, router)
    gates = torch.softmax(logits, dim=-1)
    gate_vals, eids = _topk(gates, top_k)                      # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    density = F.one_hot(eids[:, 0], e).to(torch.float32).mean(0)
    aux = e * torch.sum(density * gates.mean(0))

    flat_e = eids.reshape(-1)                                  # (T*k,)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(top_k)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_tok[order]
    # bincount's length depends on the values (FakeTensorMode refuses
    # it); a scatter of ones counts the same
    counts = torch.zeros(e, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * top_k, device=dev) - starts[se]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, e * cap)     # overflow
    slot_tok = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev)
    slot_tok[slot] = st
    slot_tok = slot_tok[:e * cap]
    slot_valid = slot_tok < t
    safe_tok = torch.where(slot_valid, slot_tok, 0)

    xe = xt[safe_tok].reshape(e, cap, d)
    xe = xe * slot_valid.reshape(e, cap, 1).to(xe.dtype)

    flat_gate = gate_vals.reshape(-1)[order]
    slot_gate = torch.zeros((e * cap + 1,), dtype=torch.float32, device=dev)
    slot_gate[slot] = flat_gate
    return xe, slot_tok, slot_gate[:e * cap], aux


def _combine(ye: torch.Tensor, slot_tok: torch.Tensor,
             slot_gate: torch.Tensor, t: int,
             dtype: torch.dtype) -> torch.Tensor:
    """Scatter-add the gated expert outputs ``ye (E*cap, d)`` back to
    ``(T, d)`` in f32 (empty slots land on the dropped row ``T``)."""
    y = torch.zeros((t + 1, ye.shape[-1]), dtype=torch.float32,
                    device=ye.device)
    y = y.index_add(0, slot_tok,
                    ye.to(torch.float32) * slot_gate[:, None])
    return y[:t].to(dtype)


def capacity(tokens: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: Python's round (half to even), at least one."""
    return int(max(1, round(tokens * top_k / num_experts * capacity_factor)))


def apply_moe(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float, act: str = "swiglu",
              dispatch_groups: int = 0, act_quantize: bool = False
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``x (B, S, d)`` -> ``(y (B, S, d), aux_loss)``.

    ``dispatch_groups = 0``, or a token count that does not split into
    ``G`` groups of at least ``E`` tokens: one global dispatch.  Else the
    grouped dispatch: each group of ``T / G`` consecutive tokens routes
    its own tokens at a per-group capacity, and the aux loss is the mean
    over groups.  ``act_quantize`` reaches the shared experts' linears."""
    b, s, d = x.shape
    t = b * s
    e = p["router"].shape[-1]
    ex = p["experts"]

    def expert_ffn(xe):
        up = _expert_matmul(ex["up"], xe)
        gate = _expert_matmul(ex["gate"], xe) if act == "swiglu" else None
        return _expert_matmul(ex["down"], ffn_hidden(up, gate, act,
                                                     xe.dtype))

    xt = x.reshape(t, d)
    g = dispatch_groups
    if g and t % g == 0 and t // g >= e:
        tg = t // g
        cap = capacity(tg, top_k, e, capacity_factor)
        parts = [_dispatch(xg, p["router"], top_k, cap)
                 for xg in xt.reshape(g, tg, d)]
        xe = torch.stack([q[0] for q in parts], 1)         # (E, G, cap, d)
        ye = expert_ffn(xe.reshape(e, g * cap, d)).reshape(e, g, cap, d)
        ye = ye.transpose(0, 1).reshape(g, e * cap, d)
        y = torch.cat([_combine(ye[i], parts[i][1], parts[i][2], tg,
                                x.dtype) for i in range(g)])
        aux = torch.stack([q[3] for q in parts]).mean()
    else:
        cap = capacity(t, top_k, e, capacity_factor)
        xe, slot_tok, slot_gate, aux = _dispatch(xt, p["router"], top_k,
                                                 cap)
        ye = expert_ffn(xe).reshape(e * cap, d)
        y = _combine(ye, slot_tok, slot_gate, t, x.dtype)

    if "shared" in p:
        sh = p["shared"]
        up_s = apply_linear(sh["up"], xt, act_quantize=act_quantize)
        g_s = (apply_linear(sh["gate"], xt, act_quantize=act_quantize)
               if act == "swiglu" else None)
        h_s = ffn_hidden(up_s, g_s, act, x.dtype)
        y = y + apply_linear(sh["down"], h_s, act_quantize=act_quantize)
    return y.reshape(b, s, d), aux
