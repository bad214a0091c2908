"""The sequence splits of the attention kernels B10 (int8 latent MLA
decode), B9 (int8 paged decode), B8 (paged decode on a bf16 or f32
pool, the same split kernel as B9) and B5 (int8 slot-pool decode, the
same kernel's slot view), checked on the CPU.

The CUDA kernels run only on the card, so their work split and their
arithmetic are held here through plain stand-ins:

* the planners ``latent_split`` / ``paged_split`` / ``slot_split`` (plain
  Python, the wrappers' own) cover every position or table entry exactly
  once, in order, within the CTA budget;
* a numpy mirror of each kernel's split-and-fold arithmetic (per split an
  online softmax over the kernel's stages or passes, -1e30 masking, -inf
  marking a split that starts past a live slot's position, the per-entry
  V scale and the softcap of B9 -- B8 the same without scales -- then
  the fold in split order; B5 with one K scale folded into the query and
  one V scale applied after the fold) is held against the reference's
  Pallas kernels in interpret mode at 1e-5,
  normalised as the card's ``KERNEL_TOL`` is (max |a - b| / max |b|), in
  f32;
* a mirror of B10's bf16 hi + lo split of the folded query and of the
  softmax weights, at the served widths, stays within 1e-4 (f32) and
  2e-2 (bf16) of the plain version, where bf16 hi alone would miss f32's.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention_paged as jpaged
from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention_latent_q as dlk
from repro_torch.kernels import decode_attention_paged as dpk
from repro_torch.kernels import decode_attention_q as dak
from repro_torch.kernels import ref
from repro_torch.quant import kv as tkv

NEG = np.float32(-1e30)
SMS = 132


def _norm_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (nearest even) and back."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _fold(parts, scale_out=None):
    """The kernels' fold: ``parts`` [(m (R,), l (R,), O (R, W) or None)]
    in split order, O None for an empty split; out = sum_j e^(m_j - M) O_j
    / sum_j e^(m_j - M) l_j (times ``scale_out``), all f32."""
    m = np.stack([p[0] for p in parts])                       # (J, R)
    big = m.max(0)
    coef = np.where(m == -np.inf, np.float32(0),
                    np.exp(np.where(m == -np.inf, big, m) - big))
    ls = np.zeros_like(big)
    acc = np.zeros_like(next(p[2] for p in parts if p[2] is not None))
    for c, (_, l, o) in zip(coef, parts):
        ls = ls + c * l
        if o is not None:
            acc = acc + c[:, None] * o
    out = acc / ls[:, None]
    return out if scale_out is None else out * scale_out


def _online(state, s, v_of):
    """One online-softmax step of a split: logits ``s`` (R, P) f32 (-inf
    past the stage), ``v_of(w)`` the context of weights w (R, P)."""
    m, l, acc = state
    m_new = np.maximum(m, s.max(1))
    alpha = np.exp(m - m_new)
    w = np.where(s == -np.inf, np.float32(0), np.exp(s - m_new[:, None]))
    return (m_new, l * alpha + w.sum(1),
            acc * alpha[:, None] + v_of(w))


# ---------------------------------------------------------------------------
# B10: the latent split
# ---------------------------------------------------------------------------

def _terms(x, terms):
    """x as the products see it: f32 (``terms`` 0), bf16 hi (1), or bf16
    hi + lo (2, the tensor cores' split)."""
    if terms == 0:
        return [x]
    hi = _bf16(x)
    return [hi, _bf16(x - hi)][:terms]


def latent_mirror(q_lat, q_rope, cq, cs, rq, rs, pos, scale, plan,
                  terms=0):
    """B10's split kernel in numpy: q_lat (B,H,L), q_rope (B,H,R) f32;
    cq (B,S,L), rq (B,S,R) int8; cs (B,L), rs (B,R) f32; pos (B,) ->
    (B,H,L) f32.  ``terms``: how the query and the weights enter the
    products (:func:`_terms`; 2 on the tensor cores)."""
    b, h, lora = q_lat.shape
    s = cq.shape[1]
    f32 = np.float32
    out = np.zeros((b, h, lora), f32)
    for bi in range(b):
        qf = np.concatenate([q_lat[bi] * (cs[bi] * f32(scale)),
                             q_rope[bi] * (rs[bi] * f32(scale))], -1)
        qs = _terms(qf, terms)
        c = np.concatenate([cq[bi], rq[bi]], -1).astype(f32)
        cp = int(pos[bi])
        n_valid = s if cp < 0 else min(s, cp + 1)
        parts = []
        for begin, _ in plan.ranges():
            end = min(n_valid, begin + plan.span)
            if begin >= end:
                parts.append((np.full(h, -np.inf, f32), np.zeros(h, f32),
                              None))
                continue
            state = (np.full(h, -np.inf, f32), np.zeros(h, f32),
                     np.zeros((h, lora), f32))
            for s0 in range(begin, end, plan.bs):
                blk = c[s0:min(s, s0 + plan.bs)]
                logit = sum(qq @ blk.T for qq in qs).astype(f32)
                p = s0 + np.arange(blk.shape[0])
                logit = np.where(p <= cp, logit, NEG).astype(f32)

                def ctx(w, blk=blk):
                    return sum(ww @ blk[:, :lora]
                               for ww in _terms(w, terms)).astype(f32)
                state = _online(state, logit, ctx)
            parts.append(state)
        out[bi] = _fold(parts, cs[bi])
    return out


def _latent_inputs(b, s, h, lora, rope, pos, seed):
    rng = np.random.default_rng(seed)
    q_lat = rng.standard_normal((b, h, lora), np.float32) * 0.5
    q_rope = rng.standard_normal((b, h, rope), np.float32) * 0.5
    g = torch.Generator().manual_seed(seed)
    cq, cs = tkv.quantize_kv_prefill(torch.randn(b, s, lora, generator=g))
    rq, rs = tkv.quantize_kv_prefill(torch.randn(b, s, rope, generator=g))
    return (q_lat, q_rope, cq.numpy(), cs.numpy(), rq.numpy(), rs.numpy(),
            np.asarray(pos, np.int32))


#: (b, s, h, lora, rope, positions, splits asked, the Pallas kernel's
#: block): an idle slot (S a multiple of the Pallas block, which pads S
#: and would average its pad rows too); a live slot whose later splits
#: are empty; a ragged S (live slots only); one split; more splits than
#: live stages
LATENT_CASES = {
    "idle slot": (3, 128, 4, 32, 16, [127, 40, -1], 4, 32),
    "later splits empty": (2, 256, 20, 16, 8, [20, 255], 4, 64),
    "ragged S": (2, 100, 4, 32, 16, [99, 57], 3, 32),
    "one split": (2, 128, 4, 32, 16, [100, -1], 1, 32),
    "more splits than live": (2, 192, 2, 16, 8, [5, 70], 32, 64),
}


@pytest.mark.parametrize("label", list(LATENT_CASES))
def test_latent_split_mirror_matches_pallas_interpret(label):
    b, s, h, lora, rope, pos, splits, jbs = LATENT_CASES[label]
    args = _latent_inputs(b, s, h, lora, rope, pos, seed=s + h)
    scale = 1.0 / math.sqrt(lora + rope)
    plan = dlk.latent_split(b, h, s, lora, rope, SMS, splits=splits)
    got = latent_mirror(*args, scale, plan)
    jargs = [jnp.asarray(a[:, None]) if i < 2 else jnp.asarray(a)
             for i, a in enumerate(args)]
    pallas = np.asarray(jops.decode_attention_latent_q(
        *jargs, scale=scale, bs=jbs, force_kernel=True))[:, 0]
    assert _norm_err(got, pallas) <= 1e-5
    plain = ref.decode_attention_latent_q_ref(
        *(torch.from_numpy(a[:, None]) if i < 2 else torch.from_numpy(a)
          for i, a in enumerate(args)), scale=scale)[:, 0].numpy()
    assert _norm_err(got, plain) <= 1e-5
    if label == "later splits empty":
        assert any(begin > pos[0] for begin, _ in plan.ranges())
    if label == "more splits than live":
        assert plan.splits * plan.bs > pos[0] + 1


def _served_hi_lo_error(dtype: str, terms: int) -> float:
    """Normalised error of the latent mirror with ``terms`` query / weight
    terms against the plain version in the working type, at the served
    widths (128 heads, L 512, R 64, S 1024, positions in [512, 1024) and
    an idle slot): q rounded to ``dtype`` first, the output rounded to it
    last."""
    b, s, h, lora, rope = 2, 1024, 128, 512, 64
    args = list(_latent_inputs(b, s, h, lora, rope, [777, -1], seed=3))
    if dtype == "bfloat16":
        args[0], args[1] = _bf16(args[0]), _bf16(args[1])
    scale = 1.0 / math.sqrt(128 + rope)
    plan = dlk.latent_split(8, h, s, lora, rope, SMS)
    got = latent_mirror(*args, scale, plan, terms=terms)
    dt = getattr(torch, dtype)
    plain = ref.decode_attention_latent_q_ref(
        *(torch.from_numpy(a[:, None]).to(dt) if i < 2
          else torch.from_numpy(a) for i, a in enumerate(args)),
        scale=scale)[:, 0].float().numpy()
    if dtype == "bfloat16":
        got = _bf16(got)
    return _norm_err(got, plain)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
def test_latent_hi_lo_products_at_served_widths(dtype, tol):
    """The tensor-core path's bf16 hi + lo query and weights stay within
    the card's tolerance of the plain version in either working type."""
    assert _served_hi_lo_error(dtype, terms=2) <= tol


def test_latent_hi_alone_would_miss_the_f32_tolerance():
    """Why the kernel carries the lo terms: bf16 hi alone (one product
    each) stays within bf16's 2e-2 but not within f32's 1e-4."""
    assert _served_hi_lo_error("float32", terms=1) > 1e-4
    assert _served_hi_lo_error("bfloat16", terms=1) <= 2e-2


# ---------------------------------------------------------------------------
# B9: the paged split
# ---------------------------------------------------------------------------

def paged_mirror(q, kq, ks, vq, vs, tables, pos, softcap, plan):
    """The paged split kernel in numpy: q (B,KH,G,D) f32; B9's int8 pool
    kq/vq (NB+1,bs,KH,D) with scale rows ks/vs (NB+1,KH,D) f32, or B8's
    full-width pool (ks and vs None: the query scaled by 1/sqrt(D) alone,
    no V scale); tables (B,nblk); pos (B,) -> (B,KH,G,D) f32."""
    b, kh, g, d = q.shape
    bs = kq.shape[1]
    nblk = tables.shape[1]
    f32 = np.float32
    scale = f32(1.0 / math.sqrt(d))
    pp = 64 if bs >= 64 else min(64 // bs, 16) * bs
    out = np.zeros(q.shape, f32)
    for bi in range(b):
        cp = int(pos[bi])
        walk = nblk if cp < 0 else min(nblk, cp // bs + 1)
        for h in range(kh):
            parts = []
            for e0, _ in plan.entries():
                e1 = min(walk, e0 + plan.span)
                if e0 >= e1:
                    parts.append((np.full(g, -np.inf, f32),
                                  np.zeros(g, f32), None))
                    continue
                state = (np.full(g, -np.inf, f32), np.zeros(g, f32),
                         np.zeros((g, d), f32))
                for p0 in range(e0 * bs, e1 * bs, pp):
                    lp = np.arange(p0, min(e1 * bs, p0 + pp))
                    phys = tables[bi, lp // bs]
                    kk = kq[phys, lp % bs, h].astype(f32)
                    qk = (q[bi, h] * scale)[:, None, :] if ks is None \
                        else q[bi, h][:, None, :] * (ks[phys, h] * scale)
                    logit = (qk * kk[None]).sum(-1).astype(f32)
                    if softcap:
                        logit = (np.tanh(logit / f32(softcap))
                                 * f32(softcap)).astype(f32)
                    logit = np.where(lp <= cp, logit, NEG).astype(f32)

                    def ctx(w, lp=lp, phys=phys):
                        vv = vq[phys, lp % bs, h].astype(f32)
                        o = np.zeros((g, d), f32)
                        for ent in np.unique(lp // bs):
                            at = lp // bs == ent
                            part = w[:, at] @ vv[at]
                            o = o + (part if vs is None
                                     else part * vs[tables[bi, ent], h])
                        return o
                    state = _online(state, logit, ctx)
                parts.append(state)
            out[bi, h] = _fold(parts)
    return out


def _paged_inputs(b, kh, g, d, bs, nblk, nb, pos, seed):
    """q, the int8 pool with one scale row per block (quantized as the
    engine's insert quantizes a block), tables of shuffled physical
    blocks (the dummy NB past a slot's live entries)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh, g, d), np.float32)
    pool = []
    for _ in ("k", "v"):
        x = torch.from_numpy(rng.standard_normal((nb + 1, bs, kh, d),
                                                 np.float32))
        sc = tkv.kv_scales(x, axis=1)
        pool += [tkv.quantize_kv(x, sc[:, None]).numpy(), sc.numpy()]
    perm = rng.permutation(nb).astype(np.int32)
    tables = np.full((b, nblk), nb, np.int32)
    for i, cp in enumerate(pos):
        used = nblk if cp < 0 else cp // bs + 1
        tables[i, :used] = perm[i * nblk:i * nblk + used]
    return q, *pool, tables, np.asarray(pos, np.int32)


#: (b, kh, g, d, bs, nblk, nb, positions, softcap, splits asked)
PAGED_CASES = {
    "idle slot": (3, 2, 2, 16, 4, 6, 24, [23, 9, -1], 0.0, 3),
    "later splits empty": (2, 2, 4, 32, 8, 8, 20, [10, 63], 0.0, 4),
    "ragged positions, softcap": (2, 1, 4, 16, 4, 5, 12, [18, 7], 30.0, 2),
    "one split": (2, 2, 2, 16, 8, 4, 10, [31, -1], 0.0, 1),
    "more splits than live entries": (2, 1, 2, 16, 4, 6, 14, [2, 13],
                                      5.0, 6),
    "entry past one pass": (2, 1, 2, 16, 80, 2, 4, [150, 60], 0.0, 2),
}


@pytest.mark.parametrize("label", list(PAGED_CASES))
def test_paged_split_mirror_matches_pallas_interpret(label):
    b, kh, g, d, bs, nblk, nb, pos, softcap, splits = PAGED_CASES[label]
    args = _paged_inputs(b, kh, g, d, bs, nblk, nb, pos, seed=nb + bs)
    plan = dpk.paged_split(b, kh, nblk, SMS, splits=splits)
    got = paged_mirror(*args, softcap, plan)
    q, kq, ks, vq, vs, tables, cpos = args
    pallas = np.asarray(jpaged.decode_attention_paged_q(
        *map(jnp.asarray, (q, kq, ks, vq, vs, tables)),
        jnp.asarray(cpos[:, None]), softcap=softcap, interpret=True))
    assert _norm_err(got, pallas) <= 1e-5
    plain = ref.decode_attention_paged_q_ref(
        torch.from_numpy(q.reshape(b, 1, kh * g, d)),
        *map(torch.from_numpy, (kq, ks, vq, vs, tables, cpos)),
        softcap=softcap).numpy().reshape(b, kh, g, d)
    assert _norm_err(got, plain) <= 1e-5
    if label == "later splits empty":
        assert any(e0 > pos[0] // bs for e0, _ in plan.entries())
    if label == "more splits than live entries":
        assert plan.splits > pos[0] // bs + 1


# ---------------------------------------------------------------------------
# the planners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,s,lora,rope,sms,splits", [
    (8, 128, 1024, 512, 64, 132, None), (8, 128, 1000, 512, 64, 132, None),
    (3, 4, 70, 16, 8, 132, None), (2, 20, 129, 64, 16, 132, None),
    (1, 1, 5, 1024, 4, 132, None), (1, 128, 4096, 512, 64, 132, None),
    (8, 128, 1024, 512, 64, 132, 1), (2, 4, 100, 32, 16, 8, 64),
])
def test_latent_split_covers_each_position_once(b, h, s, lora, rope, sms,
                                                splits):
    plan = dlk.latent_split(b, h, s, lora, rope, sms, splits=splits)
    covered = [p for begin, end in plan.ranges() for p in range(begin, end)]
    assert covered == list(range(s))
    assert all(end > begin for begin, end in plan.ranges())
    assert plan.span % plan.bs == 0 and plan.bs in dlk.STAGE_POSITIONS
    assert dlk.latent_smem(lora, rope, plan.bs, plan.mt) <= 232448
    assert plan.tiles * plan.heads >= h > (plan.tiles - 1) * plan.heads
    assert 1 <= plan.splits <= dlk.MAX_SPLITS
    budget = splits or math.ceil(sms * dlk.CTAS_PER_SM / (b * plan.tiles))
    assert plan.splits <= max(1, budget)


def test_latent_split_served_plan():
    """The served latent pool: 4 head tiles of 32 x 8 slots x 4 splits of
    256 positions, 128 CTAs on 132 SMs, 64 positions per stage."""
    plan = dlk.latent_split(8, 128, 1024, 512, 64, 132)
    assert (plan.mt, plan.bs, plan.tiles, plan.splits, plan.span,
            plan.ctas) == (2, 64, 4, 4, 256, 128)


@pytest.mark.parametrize("lora,rope", [(40, 8), (2048, 64), (512, 6)])
def test_latent_split_refuses_what_the_kernel_does_not_take(lora, rope):
    with pytest.raises(ValueError):
        dlk.latent_split(2, 8, 64, lora, rope, 132)


@pytest.mark.parametrize("b,kh,nblk,sms,splits", [
    (8, 8, 64, 132, None), (3, 2, 5, 132, None), (2, 1, 3, 132, None),
    (2, 2, 40, 132, None), (8, 8, 64, 132, 1), (1, 1, 200, 132, None),
    (4, 8, 7, 16, 3),
])
def test_paged_split_covers_each_entry_once(b, kh, nblk, sms, splits):
    plan = dpk.paged_split(b, kh, nblk, sms, splits=splits)
    covered = [e for e0, e1 in plan.entries() for e in range(e0, e1)]
    assert covered == list(range(nblk))
    assert all(e1 > e0 for e0, e1 in plan.entries())
    assert 1 <= plan.splits <= dpk.MAX_SPLITS
    budget = splits or math.ceil(sms * dpk.CTAS_PER_SM / (b * kh))
    assert plan.splits <= max(1, budget)


def test_paged_split_served_plan():
    """The served paged pool: 8 KV heads x 8 slots x 8 splits of 8
    entries, 512 CTAs on 132 SMs."""
    plan = dpk.paged_split(8, 8, 64, 132)
    assert (plan.span, plan.splits, plan.ctas) == (8, 8, 512)


# ---------------------------------------------------------------------------
# B8: the full-width pools on the split kernel
# ---------------------------------------------------------------------------

def _full_inputs(b, kh, g, d, bs, nblk, nb, pos, seed):
    """q and a full-width f32 pool, tables of shuffled physical blocks
    (the dummy NB past a slot's live entries)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh, g, d), np.float32)
    k = rng.standard_normal((nb + 1, bs, kh, d), np.float32)
    v = rng.standard_normal((nb + 1, bs, kh, d), np.float32)
    perm = rng.permutation(nb).astype(np.int32)
    tables = np.full((b, nblk), nb, np.int32)
    for i, cp in enumerate(pos):
        used = nblk if cp < 0 else cp // bs + 1
        tables[i, :used] = perm[i * nblk:i * nblk + used]
    return q, k, v, tables, np.asarray(pos, np.int32)


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("label", list(PAGED_CASES))
def test_paged_split_full_width_mirror_matches_pallas_interpret(label,
                                                                esize):
    """B8's split kernel without scales, on the plans of a bf16 (esize 2)
    and an f32 (4) pool, in f32: idle slots (the uniform average over the
    whole table), softcaps before the mask, splits past a live slot's
    position, a block past one pass."""
    b, kh, g, d, bs, nblk, nb, pos, softcap, splits = PAGED_CASES[label]
    q, k, v, tables, cpos = _full_inputs(b, kh, g, d, bs, nblk, nb, pos,
                                         seed=nb + bs + esize)
    plan = dpk.paged_split(b, kh, nblk, SMS, splits=splits,
                           fit=(g, d, bs, esize, False))
    got = paged_mirror(q, k, None, v, None, tables, cpos, softcap, plan)
    pallas = np.asarray(jpaged.decode_attention_paged(
        *map(jnp.asarray, (q, k, v, tables)), jnp.asarray(cpos[:, None]),
        softcap=softcap, interpret=True))
    assert _norm_err(got, pallas) <= 1e-5
    plain = ref.decode_attention_paged_ref(
        torch.from_numpy(q.reshape(b, 1, kh * g, d)),
        *map(torch.from_numpy, (k, v, tables, cpos)),
        softcap=softcap).numpy().reshape(b, kh, g, d)
    assert _norm_err(got, plain) <= 1e-5


@pytest.mark.parametrize("g,d,bs,nblk,esize", [
    (4, 64, 16, 64, 2), (4, 64, 16, 64, 4), (8, 128, 128, 3, 4),
    (4, 64, 3, 40, 4), (16, 256, 16, 200, 2), (4, 256, 16, 128, 4),
    (4, 192, 16, 256, 4), (1, 256, 64, 30, 4)])
def test_paged_split_fits_full_width_pools(g, d, bs, nblk, esize):
    """On bf16 and f32 pools every table entry is covered once, in split
    order, and the planned span's ring fits shared memory; where a wide
    f32 row shrank the span, one entry more would not fit."""
    fit = (g, d, bs, esize, False)
    free = dpk.paged_split(2, 2, nblk, SMS)
    plan = dpk.paged_split(2, 2, nblk, SMS, fit=fit)
    covered = [e for e0, e1 in plan.entries() for e in range(e0, e1)]
    assert covered == list(range(nblk))
    assert 1 <= plan.splits <= dpk.MAX_SPLITS
    assert dpk.split_smem(*fit, plan.span) <= 232448
    assert plan.span <= free.span
    if plan.span < free.span:
        assert dpk.split_smem(*fit, plan.span + 1) > 232448


def test_paged_split_served_full_width_plan():
    """The served paged pool in bf16 and f32 takes B9's plan: 8 KV heads
    x 8 slots x 8 splits of 8 entries (two passes of 64 positions), 512
    CTAs; the ring is two stages of 64 K and 64 V rows of 64 values
    padded by 16 bytes."""
    for esize in (2, 4):
        fit = (4, 64, 16, esize, False)
        plan = dpk.paged_split(8, 8, 64, SMS, fit=fit)
        assert (plan.span, plan.splits, plan.ctas) == (8, 8, 512)
        assert plan == dpk.paged_split(8, 8, 64, SMS)
        ring = 2 * 2 * 64 * (64 * esize + 16)
        assert dpk.split_smem(*fit, plan.span) == \
            ring + 4 * 64 * 4 + 4 * 64 * 4 + 32 + 16


def test_paged_split_refuses_a_wide_f32_pool_past_its_passes():
    """An f32 pool of D 256 fits one 64-position pass a split: 2,048
    positions a slot take 32 splits, 4,096 would take 64 and raise."""
    fit = (4, 256, 16, 4, False)
    assert dpk.paged_split(1, 1, 128, SMS, fit=fit).splits == 32
    with pytest.raises(ValueError, match="no span"):
        dpk.paged_split(1, 1, 256, SMS, fit=fit)


# ---------------------------------------------------------------------------
# B5: the slot pool on the split kernel
# ---------------------------------------------------------------------------

def slot_mirror(q, kq, ks, vq, vs, pos, softcap, plan):
    """The split kernel's slot view in numpy: q (B,KH,G,D) f32; the int8
    slot pool kq/vq (B,S,KH,D) with one scale row per slot and head ks/vs
    (B,KH,D) f32; pos (B,) -> (B,KH,G,D) f32.  Entries of SLOT_ENTRY
    positions, one pass each, the last cut at S; the K scale and 1/sqrt(D)
    fold into the query once, the raw int8 V values are summed, and the V
    scale multiplies the fold's result."""
    b, kh, g, d = q.shape
    s = kq.shape[1]
    ent = dak.SLOT_ENTRY
    f32 = np.float32
    scale = f32(1.0 / math.sqrt(d))
    out = np.zeros(q.shape, f32)
    for bi in range(b):
        cp = int(pos[bi])
        walk = plan.nblk if cp < 0 else min(plan.nblk, cp // ent + 1)
        for h in range(kh):
            qk = q[bi, h] * (ks[bi, h] * scale)
            parts = []
            for e0, _ in plan.entries():
                e1 = min(walk, e0 + plan.span)
                if e0 >= e1:
                    parts.append((np.full(g, -np.inf, f32),
                                  np.zeros(g, f32), None))
                    continue
                state = (np.full(g, -np.inf, f32), np.zeros(g, f32),
                         np.zeros((g, d), f32))
                for p0 in range(e0 * ent, min(e1 * ent, s), ent):
                    lp = np.arange(p0, min(p0 + ent, s))
                    logit = (qk @ kq[bi, lp, h].astype(f32).T).astype(f32)
                    if softcap:
                        logit = (np.tanh(logit / f32(softcap))
                                 * f32(softcap)).astype(f32)
                    logit = np.where(lp <= cp, logit, NEG).astype(f32)

                    def ctx(w, lp=lp):
                        return w @ vq[bi, lp, h].astype(f32)
                    state = _online(state, logit, ctx)
                parts.append(state)
            out[bi, h] = _fold(parts, vs[bi, h])
    return out


def _slot_inputs(b, s, kh, g, d, pos, seed):
    """q and the int8 slot pool quantized as the engine's prefill
    quantizes it (one scale row per slot and head)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh, g, d), np.float32)
    pool = []
    for _ in ("k", "v"):
        x = torch.from_numpy(rng.standard_normal((b, s, kh, d), np.float32))
        xq, xs = tkv.quantize_kv_prefill(x)
        pool += [xq.numpy(), xs.numpy()]
    return q, *pool, np.asarray(pos, np.int32)


#: (b, s, kh, g, d, positions, softcap, splits asked, the Pallas kernel's
#: block): live slots whose later splits are empty; an idle slot at an S
#: the Pallas block divides; a softcap; one split; more splits than live
#: entries; a ragged S (live slots: the last entry cut at S)
SLOT_CASES = {
    "later splits empty": (2, 512, 2, 4, 32, [70, 511], 0.0, 4, 64),
    "idle slot": (3, 256, 2, 2, 16, [255, 30, -1], 0.0, 3, 64),
    "softcap": (2, 320, 1, 4, 16, [200, 319], 30.0, 2, 64),
    "one split": (2, 192, 2, 2, 16, [191, 5], 0.0, 1, 64),
    "more splits than live entries": (2, 384, 1, 2, 16, [3, 100], 5.0, 6,
                                      64),
    "ragged S": (3, 1000, 1, 4, 16, [999, 640, 63], 0.0, 8, 40),
}


@pytest.mark.parametrize("label", list(SLOT_CASES))
def test_slot_split_mirror_matches_pallas_interpret(label):
    b, s, kh, g, d, pos, softcap, splits, jbs = SLOT_CASES[label]
    args = _slot_inputs(b, s, kh, g, d, pos, seed=s + d)
    plan = dak.slot_split(b, kh, s, SMS, splits=splits, g=g, d=d)
    got = slot_mirror(*args, softcap, plan)
    q, kq, ks, vq, vs, cpos = args
    q4 = q.reshape(b, 1, kh * g, d)
    pallas = np.asarray(jops.decode_attention_q(
        *map(jnp.asarray, (q4, kq, ks, vq, vs, cpos)), softcap=softcap,
        bs=jbs, force_kernel=True)).reshape(b, kh, g, d)
    assert _norm_err(got, pallas) <= 1e-5
    plain = ref.decode_attention_q_ref(
        *map(torch.from_numpy, (q4, kq, ks, vq, vs, cpos)),
        softcap=softcap).numpy().reshape(b, kh, g, d)
    assert _norm_err(got, plain) <= 1e-5
    if label == "later splits empty":
        assert any(e0 * dak.SLOT_ENTRY > pos[0] for e0, _ in plan.entries())
    if label == "more splits than live entries":
        assert plan.splits > pos[0] // dak.SLOT_ENTRY + 1


def test_slot_split_idle_slot_at_a_ragged_s_is_the_plain_average():
    """An idle slot (no valid position) at S = 1,000 averages its 1,000
    positions, as the plain version does (the port's stated departure from
    the Pallas kernel, which pads S to its block and averages the pad rows
    too); its last entry stages no position of the next slot."""
    b, s, kh, g, d = 3, 1000, 2, 2, 16
    args = _slot_inputs(b, s, kh, g, d, [999, -1, 300], seed=11)
    plan = dak.slot_split(b, kh, s, SMS, g=g, d=d)
    got = slot_mirror(*args, 0.0, plan)
    q, kq, ks, vq, vs, cpos = args
    plain = ref.decode_attention_q_ref(
        *map(torch.from_numpy, (q.reshape(b, 1, kh * g, d), kq, ks, vq, vs,
                                cpos))).numpy().reshape(b, kh, g, d)
    assert _norm_err(got, plain) <= 1e-5
    uniform = vq[1].astype(np.float32).mean(0) * vs[1]      # (KH, D)
    np.testing.assert_allclose(got[1], np.broadcast_to(
        uniform[:, None], (kh, g, d)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,kh,s,sms,splits", [
    (8, 8, 1024, 132, None), (8, 8, 1000, 132, None), (3, 2, 70, 132, None),
    (2, 1, 129, 132, None), (1, 1, 64, 132, None), (8, 8, 1024, 132, 1),
    (1, 1, 4096, 132, None), (4, 8, 1000, 16, 3),
])
def test_slot_split_covers_each_position_once(b, kh, s, sms, splits):
    plan = dak.slot_split(b, kh, s, sms, splits=splits, g=4, d=64)
    ent = dak.SLOT_ENTRY
    covered = [p for e0, e1 in plan.entries()
               for p in range(e0 * ent, min(e1 * ent, s))]
    assert covered == list(range(s))
    assert all(min(e1 * ent, s) > e0 * ent for e0, e1 in plan.entries())
    assert plan.nblk == math.ceil(s / ent)
    assert 1 <= plan.splits <= dpk.MAX_SPLITS
    budget = splits or math.ceil(sms * dpk.CTAS_PER_SM / (b * kh))
    assert plan.splits <= max(1, budget)
    assert dpk.split_smem(4, 64, ent, 1, False, plan.span) <= 232448


def test_slot_split_served_plan():
    """The served slot pool (8 slots of 1,024 positions, and the ragged
    1,000, x 8 KV heads): 16 entries of 64, 8 splits of 2 entries (two
    passes), 512 CTAs, B9's plan; the ring is two stages of 64 K and 64 V
    int8 rows of 64 values padded by 16 bytes."""
    for s in (1024, 1000):
        plan = dak.slot_split(8, 8, s, SMS, g=4, d=64)
        assert (plan.nblk, plan.span, plan.splits, plan.ctas) == \
            (16, 2, 8, 512)
    ring = 2 * 2 * 64 * (64 + 16)
    assert dpk.split_smem(4, 64, dak.SLOT_ENTRY, 1, False, 2) == \
        ring + 4 * 64 * 4 + 4 * 64 * 4 + 16 + 16
