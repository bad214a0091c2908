"""Layer merging -- paper §2.3 (Fig. 3) and its transformer form.

Adjacent linear maps with no nonlinearity between them compose into one
matrix, so after decomposition the factor layers can be multiplied back
into their neighbours: the model keeps its layer count and the
decomposition's parameter and FLOP savings.

* **CNN bottleneck merging** (Fig. 3): Tucker's ``U`` 1x1 factor goes
  into the preceding 1x1 conv, its ``V`` into the following one; a norm
  scale between them folds through (:func:`fold_scale`).
* **Attention product merging**: the scores see only the product
  W_q W_k^T and the output path only W_v W_o, so a decomposed attention
  re-merges into four thin matrices ``aq (d, H, r) / ak (d, r) /
  bv (d, r) / bo (r, H, d)`` -- the q/k/v/o layer count, params shrunk
  by about r/d, the KV cache the shared latent (structurally
  DeepSeek-MLA).  :func:`merge_attention` initialises them from dense
  weights by a joint SVD of the head-stacked products, in f32.

Everything here is plain torch on whatever device the weights are on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_F32 = torch.float32


def merge_linear(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(C,R) @ (R,S) -> (C,S): undo a decomposition into one dense layer."""
    return torch.matmul(a.to(_F32), b.to(_F32)).to(a.dtype)


def merge_conv1x1_into_u(conv1: torch.Tensor, u: torch.Tensor
                         ) -> torch.Tensor:
    """Absorb Tucker's U (C_mid, R1) into the preceding 1x1 conv:
    (1, 1, C_in, C_mid) HWIO -> (1, 1, C_in, R1)."""
    w = torch.einsum("hwim,mr->hwir", conv1.to(_F32), u.to(_F32))
    return w.to(conv1.dtype)


def merge_v_into_conv1x1(v: torch.Tensor, conv3: torch.Tensor
                         ) -> torch.Tensor:
    """Absorb Tucker's V (R2, C_mid) into the following 1x1 conv:
    (1, 1, C_mid, C_out) -> (1, 1, R2, C_out)."""
    w = torch.einsum("rm,hwmo->hwro", v.to(_F32), conv3.to(_F32))
    return w.to(conv3.dtype)


def fold_scale(w: torch.Tensor, scale: torch.Tensor, axis: int
               ) -> torch.Tensor:
    """Fold a per-channel norm scale through a linear map along
    ``axis``."""
    shape = [1] * w.ndim
    shape[axis] = w.shape[axis]
    return (w.to(_F32) * scale.to(_F32).reshape(shape)).to(w.dtype)


class MergedAttnFactors(NamedTuple):
    aq: torch.Tensor    # (d, H, qk_rank)
    ak: torch.Tensor    # (d, qk_rank)        shared key latent
    bv: torch.Tensor    # (d, vo_rank)        shared value latent
    bo: torch.Tensor    # (vo_rank, H, d)


def _products(wq, wk, wv, wo, num_heads: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-head products M_h = Wq_h Wk_h^T and P_h = Wv_h Wo_h,
    each (H, d, d) in f32."""
    d = wq.shape[0]
    hd = wq.shape[1] // num_heads
    q = wq.to(_F32).reshape(d, num_heads, hd)
    k = wk.to(_F32).reshape(d, num_heads, hd)
    v = wv.to(_F32).reshape(d, num_heads, hd)
    o = wo.to(_F32).reshape(num_heads, hd, d)
    return (torch.einsum("dhe,fhe->hdf", q, k),
            torch.einsum("dhe,hef->hdf", v, o))


def merge_attention(wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                    wo: torch.Tensor, *, num_heads: int, qk_rank: int,
                    vo_rank: int) -> MergedAttnFactors:
    """Jointly factorize the per-head products M_h = Wq_h Wk_h^T and
    P_h = Wv_h Wo_h with latents *shared across heads*: the shared
    factor is the leading singular basis of the head-stacked products
    (orthonormal), the per-head factors the products projected onto it
    (exact for a rank covering the products' span, least squares below).

    Shapes: wq/wk/wv (d, H*hd); wo (H*hd, d).  GQA inputs are broadcast
    to full heads by the caller.  SVD signs are arbitrary, so only the
    reconstructed products are determined."""
    d = wq.shape[0]
    m, p = _products(wq, wk, wv, wo, num_heads)

    _, _, vt = torch.linalg.svd(m.reshape(num_heads * d, d),
                                full_matrices=False)
    ak = vt[:qk_rank, :].T                          # (d, r) orthonormal
    aq = torch.einsum("hdf,fr->dhr", m, ak)         # least-squares left

    stacked_p = p.permute(1, 0, 2).reshape(d, num_heads * d)
    uu, _, _ = torch.linalg.svd(stacked_p, full_matrices=False)
    bv = uu[:, :vo_rank]                            # (d, r) orthonormal
    bo = torch.einsum("dr,hdf->rhf", bv, p)         # (r, H, d)

    dt = wq.dtype
    return MergedAttnFactors(aq.to(dt), ak.contiguous().to(dt),
                             bv.contiguous().to(dt), bo.to(dt))


def merged_attention_error(wq, wk, wv, wo, f: MergedAttnFactors,
                           num_heads: int) -> tuple[float, float]:
    """Relative Frobenius errors of the QK and VO product
    reconstructions."""
    m, p = _products(wq, wk, wv, wo, num_heads)
    m_hat = torch.einsum("dhr,fr->hdf", f.aq.to(_F32), f.ak.to(_F32))
    p_hat = torch.einsum("dr,rhf->hdf", f.bv.to(_F32), f.bo.to(_F32))

    def err(a, b):
        return float(torch.linalg.norm((a - b).ravel())
                     / (torch.linalg.norm(a.ravel()) + 1e-30))
    return err(m, m_hat), err(p, p_hat)


def merged_attention_params(d: int, num_heads: int, qk_rank: int,
                            vo_rank: int) -> int:
    return d * num_heads * qk_rank + d * qk_rank + d * vo_rank \
        + vo_rank * num_heads * d


def dense_attention_params(d: int, num_heads: int, num_kv_heads: int,
                           head_dim: int) -> int:
    return (d * num_heads * head_dim * 2
            + d * num_kv_heads * head_dim * 2)


def merge_lowrank_subtree(p: dict) -> dict:
    """Collapse a ``{"w0", "w1"}`` pair back to dense ``{"w"}`` (where
    Algorithm 1 finds the decomposed layer slower, or to undecompose)."""
    return {"w": merge_linear(p["w0"], p["w1"])}
