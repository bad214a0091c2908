"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

Train and prefill run the *chunked* SSD algorithm: within-chunk
attention-like diagonal blocks plus an inter-chunk recurrence over chunk
states, carried in f32 by a Python loop over the chunks (the reference
scans them with ``lax.scan``).  Memory is O(S * d_inner + n_chunks *
d_state).

Decode keeps a per-layer recurrent state ``(B, nh, hd, N)`` plus a small
ring of the conv inputs; one step is O(1) in sequence length.  A layer's
state dict is written in place (the cache's leaves, or views of them).

The in/out projections go through :func:`apply_linear`, so LRD targets
them (``ssm_in`` / ``ssm_out``) and a decomposed tree runs them through
the chain kernels; the depthwise conv1d is already diagonal and is not
decomposed.  The scan, the conv and the recurrent update are plain torch,
as they are ``jnp`` in the reference (it has no kernel for them).

One departure from the reference: prefill's conv tails are the prompt's
last ``conv_width - 1`` inputs with zeros before the prompt's start, so a
prompt shorter than the tail continues exactly as the full-sequence
forward does (the reference keeps only the prompt's rows and its pool
writes them at the tail's start, over the slot's previous rows).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.layers.norm import gated_rms_norm, init_rms_norm
from repro_torch.layers.param import (CONV, EMBED, INNER, ParamBuilder,
                                      apply_linear, init_linear)


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    conv_width: int
    chunk: int


def dims_from_config(cfg) -> SSMDims:
    di = cfg.d_inner
    nh = cfg.resolved_ssm_heads
    return SSMDims(cfg.d_model, di, nh, di // nh, cfg.ssm_state,
                   cfg.ssm_conv_width, cfg.ssm_chunk)


def init_ssm(pb: ParamBuilder, name: str, dims: SSMDims) -> None:
    """The input projection is split by consumer (z | x, then B | C, then
    dt), as in the reference."""
    sub = pb.child(name)
    init_linear(sub, "in_proj", dims.d_model, 2 * dims.d_inner, EMBED, INNER)
    init_linear(sub, "bc_proj", dims.d_model, 2 * dims.d_state, EMBED, None)
    init_linear(sub, "dt_proj", dims.d_model, dims.n_heads, EMBED, None)
    sub.param("conv_x_w", (dims.conv_width, dims.d_inner), (CONV, INNER),
              scale=1.0 / dims.conv_width)
    sub.param("conv_x_b", (dims.d_inner,), (INNER,), init="zeros")
    sub.param("conv_bc_w", (dims.conv_width, 2 * dims.d_state), (CONV, None),
              scale=1.0 / dims.conv_width)
    sub.param("conv_bc_b", (2 * dims.d_state,), (None,), init="zeros")
    sub.param("a_log", (dims.n_heads,), (None,), init="zeros")
    sub.param("d_skip", (dims.n_heads,), (None,), init="ones")
    sub.param("dt_bias", (dims.n_heads,), (None,), init="zeros")
    init_rms_norm(sub, "norm", dims.d_inner)
    init_linear(sub, "out_proj", dims.d_inner, dims.d_model, INNER, EMBED)


# ---------------------------------------------------------------------------
# Chunked SSD scan (train / prefill)
# ---------------------------------------------------------------------------

def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dims: SSMDims,
                 init_state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD over full sequences, one chunk at a time.

    x (B, S, nh, hd); dt (B, S, nh) post-softplus; a (nh,) negative;
    b, c (B, S, N).  Returns (y (B, S, nh, hd) in x's dtype, final state
    (B, nh, hd, N) in x's dtype); the carry between chunks is f32.
    """
    bsz, s_orig, nh, hd = x.shape
    n = dims.d_state
    q = min(dims.chunk, s_orig)
    # pad to a chunk multiple with dt = 0 tokens: zero dt means no state
    # contribution and no decay, so the padding is exact
    pad = (-s_orig) % q
    dt, b, c = (t.to(torch.float32) for t in (dt, b, c))
    if pad:
        x, dt, b, c = (torch.cat([t, t.new_zeros(
            (bsz, pad, *t.shape[2:]))], 1) for t in (x, dt, b, c))
    mask = torch.ones((q, q), dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    carry = (x.new_zeros((bsz, nh, hd, n), dtype=torch.float32)
             if init_state is None else init_state.to(torch.float32))
    ys = []
    for i in range(0, s_orig + pad, q):
        xq, dtq, bq, cq = (t[:, i:i + q] for t in (x, dt, b, c))
        da = dtq * a[None, None, :]                        # (B, Q, nh)
        seg = torch.cumsum(da, dim=1)                      # inclusive
        total = seg[:, -1, :]                              # (B, nh)
        # within-chunk: att[i, j] = C_i.B_j exp(seg_i - seg_j) dt_j
        # (i >= j); masked before exp, where seg_i - seg_j > 0 overflows
        rel = seg[:, :, None, :] - seg[:, None, :, :]      # (B, Q, Q, nh)
        decay = torch.exp(torch.where(mask, rel, -torch.inf))
        cb = torch.einsum("bin,bjn->bij", cq, bq)          # (B, Q, Q)
        att = cb[..., None] * decay * dtq[:, None, :, :]   # (B, Q, Q, nh)
        y_diag = torch.einsum("bijh,bjhd->bihd", att.to(x.dtype), xq)
        # inter-chunk: y_i += C_i exp(seg_i) . state_before
        y_inter = (torch.einsum("bin,bhdn->bihd", cq, carry)
                   * torch.exp(seg)[..., None]).to(x.dtype)
        # state: exp(total) state + sum_j exp(total - seg_j) dt_j B_j x_j
        w = torch.exp(total[:, None, :] - seg) * dtq       # (B, Q, nh)
        st = torch.einsum("bjhd,bjn->bhdn",
                          xq.to(torch.float32) * w[..., None], bq)
        carry = torch.exp(total)[:, :, None, None] * carry + st
        ys.append(y_diag + y_inter)
    y = torch.cat(ys, 1)[:, :s_orig]
    return y, carry.to(x.dtype)


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d. seq (B, S, D), w (K, D) -> (B, S, D).

    ``tail`` (B, K-1, D) holds the previous tokens' inputs (decode);
    zeros when absent."""
    k, s = w.shape[0], seq.shape[1]
    if tail is None:
        tail = seq.new_zeros((seq.shape[0], k - 1, seq.shape[-1]))
    padded = torch.cat([tail, seq], 1)                     # (B, S+K-1, D)
    out = padded[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + padded[:, i:i + s] * w[i]
    return F.silu(out + b)


def _conv_tail(seq: torch.Tensor, k: int) -> torch.Tensor:
    """The conv inputs a continuation needs: the last ``k - 1`` rows of
    ``seq`` (B, S, D) with zeros before its start."""
    if seq.shape[1] < k - 1:
        seq = torch.cat([seq.new_zeros(
            (seq.shape[0], k - 1 - seq.shape[1], seq.shape[-1])), seq], 1)
    return seq[:, seq.shape[1] - (k - 1):]


def apply_ssm(p: dict, x: torch.Tensor, dims: SSMDims, *,
              state: dict | None = None, act_quantize: bool = False,
              norm_eps: float = 1e-5) -> tuple[torch.Tensor, dict | None]:
    """Full-sequence SSD (train / prefill).  Returns ``(y, state)``.

    ``state`` (if given) receives, in place, the final recurrent state and
    the conv tails (the pre-conv inputs), so decode continues the
    sequence."""
    bsz, s, _ = x.shape
    aq = act_quantize
    di, n, nh = dims.d_inner, dims.d_state, dims.n_heads
    zx = apply_linear(p["in_proj"], x, act_quantize=aq)     # (B, S, 2di)
    z, xc_in = zx[..., :di], zx[..., di:]
    bc_in = apply_linear(p["bc_proj"], x, act_quantize=aq)  # (B, S, 2N)
    dt = apply_linear(p["dt_proj"], x, act_quantize=aq)     # (B, S, nh)

    xc = _causal_conv(xc_in, p["conv_x_w"], p["conv_x_b"])
    bc = _causal_conv(bc_in, p["conv_bc_w"], p["conv_bc_b"])
    b, c = bc[..., :n], bc[..., n:]

    # torch's softplus is the identity above 20, jax's is not: they agree
    # in f32 there (log1p(exp(-20)) is below half an ulp of 20)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["a_log"].to(torch.float32))
    xh = xc.reshape(bsz, s, nh, dims.head_dim)

    y, final = _ssd_chunked(xh, dt, a, b, c, dims)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = gated_rms_norm(p["norm"], y.reshape(bsz, s, di), z, norm_eps)
    out = apply_linear(p["out_proj"], y, act_quantize=aq)

    if state is not None:
        k = dims.conv_width
        state["ssm"].copy_(final)
        state["conv_x"].copy_(_conv_tail(xc_in, k))
        state["conv_bc"].copy_(_conv_tail(bc_in, k))
    return out, state


def ssm_state_spec(batch: int, dims: SSMDims, dtype: torch.dtype
                   ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of one layer's recurrent state."""
    tail = dims.conv_width - 1
    return {
        "ssm": ((batch, dims.n_heads, dims.head_dim, dims.d_state), dtype),
        "conv_x": ((batch, tail, dims.d_inner), dtype),
        "conv_bc": ((batch, tail, 2 * dims.d_state), dtype),
    }


def init_ssm_state(batch: int, dims: SSMDims, dtype: torch.dtype,
                   device: str | torch.device = "cuda") -> dict:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in ssm_state_spec(batch, dims, dtype).items()}


def apply_ssm_decode(p: dict, x: torch.Tensor, dims: SSMDims, state: dict,
                     *, act_quantize: bool = False, norm_eps: float = 1e-5
                     ) -> tuple[torch.Tensor, dict]:
    """One decode step.  x (B, 1, d); ``state`` {"ssm", "conv_x",
    "conv_bc"} advances in place; O(1) in sequence length."""
    bsz = x.shape[0]
    aq = act_quantize
    di, n, nh = dims.d_inner, dims.d_state, dims.n_heads
    zx = apply_linear(p["in_proj"], x, act_quantize=aq)
    z, xc_in = zx[..., :di], zx[..., di:]
    bc_in = apply_linear(p["bc_proj"], x, act_quantize=aq)
    dt = apply_linear(p["dt_proj"], x, act_quantize=aq)

    xc = _causal_conv(xc_in, p["conv_x_w"], p["conv_x_b"],
                      tail=state["conv_x"])
    bc = _causal_conv(bc_in, p["conv_bc_w"], p["conv_bc_b"],
                      tail=state["conv_bc"])
    b, c = bc[:, 0, :n], bc[:, 0, n:]

    dt = F.softplus(dt.to(torch.float32)
                    + p["dt_bias"].to(torch.float32))[:, 0]  # (B, nh)
    a = -torch.exp(p["a_log"].to(torch.float32))
    da = torch.exp(dt * a[None, :])                          # (B, nh)
    xh = xc[:, 0].reshape(bsz, nh, dims.head_dim)

    # state' = exp(dt a) state + dt * B x^T ; y = C . state' + D x
    upd = (dt[:, :, None, None] * b.to(torch.float32)[:, None, None, :]
           * xh.to(torch.float32)[..., None])
    new_ssm = da[:, :, None, None] * state["ssm"].to(torch.float32) + upd
    y = torch.einsum("bn,bhdn->bhd", c.to(torch.float32), new_ssm)
    y = y.to(x.dtype) + xh * p["d_skip"].to(x.dtype)[None, :, None]
    y = gated_rms_norm(p["norm"], y.reshape(bsz, 1, di), z, norm_eps)
    out = apply_linear(p["out_proj"], y, act_quantize=aq)

    state["conv_x"].copy_(torch.cat([state["conv_x"][:, 1:], xc_in], 1))
    state["conv_bc"].copy_(torch.cat([state["conv_bc"][:, 1:], bc_in], 1))
    state["ssm"].copy_(new_ssm)
    return out, state
