"""The work split of the bf16 two-phase split kernel of B1, B3 and B11
(``repro_torch.kernels.branched_matmul.lowrank_split``), checked on the
CPU, and its arithmetic mirrored in numpy for each of their weight
views.

The CUDA kernel runs only on the card, so what surrounds it is held here:

* the plan: each phase's K-slice length is a multiple of the stage depth
  BK, its items cover every weight element exactly once in the order the
  kernel decodes its item index (slice-major, then the 128-column tile),
  the scratch regions (P, then h) are aligned and do not overlap, and the
  served k/v plan is the one ``PERF.md`` describes;
* the arithmetic: a numpy mirror of the two phases -- each item's block of
  a factor staged a stage at a time as its weight view stages it (B11's
  ``Sparse24B``: a 2:4 pack expanded to ``round_bf16(value * scale)``,
  exactly 0 at a pruned row; B3's ``DequantB``: ``round_bf16(f32(q) *
  scale)``; B1's ``PlainB``: the bf16 values as they are), per-slice f32
  partials summed in slice order, ``h`` rounded to bf16 -- is held
  against the reference's ``lowrank_matmul_sq`` / ``lowrank_matmul_q`` /
  ``lowrank_matmul`` in Pallas interpret mode and against its plain
  reference, on the same seeded factors, at ``KERNEL_TOL["bfloat16"]``
  (2e-2) normalised as on the card (max |a - b| / max |b|): both sides
  round h to bf16, so a last-bit difference in an f32 sum can flip one
  rounding of h.
"""
import functools
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from _torch_parity import factor_weights  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.quant import quantize as jq  # noqa: E402
from repro.quant import sparse as jsp  # noqa: E402
from repro_torch.kernels import branched_matmul as bk  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SMS = 132  # SMs of an H100 SXM
TOL = chip_smoke.KERNEL_TOL["bfloat16"]
#: (M, C, R, S): the served k/v pair at decode and chunk rows, a ragged M,
#: M past one row block, DeepSeek-V2-width pairs, ragged C / R (multiples
#: of 4, not of BK) and S (past a 128-column tile)
SHAPES = [(8, 2048, 128, 512), (64, 2048, 128, 512), (37, 2048, 128, 512),
          (72, 2048, 128, 512), (8, 5120, 512, 1536), (8, 5120, 256, 576),
          (5, 36, 20, 70), (9, 200, 8, 129)]


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _counts(items, k, cols):
    """How often each cell of the (k, cols) weight is read, on the grid
    compressed to the items' edges (exact for rectangles)."""
    kb = np.unique([0, k] + [e for it in items for e in it[1:3]])
    cb = np.unique([0, cols] + [e for it in items for e in it[3:5]])
    assert kb[0] == 0 and kb[-1] == k and cb[0] == 0 and cb[-1] == cols
    grid = np.zeros((len(kb) - 1, len(cb) - 1), np.int64)
    for _, k0, k1, c0, c1 in items:
        assert 0 <= k0 < k1 <= k and 0 <= c0 < c1 <= cols
        grid[np.searchsorted(kb, k0):np.searchsorted(kb, k1),
             np.searchsorted(cb, c0):np.searchsorted(cb, c1)] += 1
    return grid


@pytest.mark.parametrize("items", [None, 8, 16, 64, (264, 4)])
@pytest.mark.parametrize("m,c,r,s", SHAPES)
def test_items_cover_every_weight_once_in_kernel_order(m, c, r, s, items):
    sp = bk.lowrank_split(m, c, r, s, SMS, items)
    for phase in (1, 2):
        k, nbr, cols, ks = sp.phase(phase)
        assert nbr == 1 and ks % bk.BK == 0 and ks > 0
        got = sp.items(phase)
        assert (_counts(got, k, cols) == 1).all()
        # the kernel's decode of item w: slice w // tiles, tile w % tiles
        tiles = math.ceil(cols / bk.BN)
        want = [(0, (w // tiles) * ks, min(k, (w // tiles + 1) * ks),
                 (w % tiles) * bk.BN, min(cols, (w % tiles + 1) * bk.BN))
                for w in range(sp.slices(phase) * tiles)]
        assert got == want
        target = bk.ITEMS_PER_SM * SMS if items is None else \
            items[phase - 1] if isinstance(items, tuple) else items
        if tiles <= target:
            assert len(got) <= max(target, tiles)
        # no finer slicing would stay within the target
        assert ks == bk.BK or math.ceil(k / (ks - bk.BK)) * tiles > target


@pytest.mark.parametrize("m,c,r,s", SHAPES)
def test_scratch_is_aligned_and_disjoint(m, c, r, s):
    sp = bk.lowrank_split(m, c, r, s, SMS)
    rows = min(m, bk.BM)
    partials = [sp.slices(i) * rows * cols * 4 for i, cols in ((1, r),
                                                               (2, s))
                if sp.slices(i) > 1]
    regions = sp.region_bytes()
    assert list(regions) == ["p", "h"]
    assert regions == {"p": max(partials, default=0), "h": rows * r * 2}
    off = sp.offsets()
    assert off["p"] == 0 and off["h"] >= regions["p"]
    assert all(o % bk.ALIGN == 0 for o in off.values())
    assert sp.scratch_bytes >= off["h"] + regions["h"]
    assert sp.scratch_bytes == sum(-(-b // bk.ALIGN) * bk.ALIGN
                                   for b in regions.values())


def test_served_plan():
    """llama3.2-1b's k/v pair at decode (M = 8) on 132 SMs: phase 1 one
    128-column tile in 64 K slices of one 32-row stage, phase 2 4 tiles x
    4 slices; P holds phase 1's 64 partials of 8 x 128 f32."""
    c, r, s = chip_smoke.LOWRANK_SHAPES["k,v"]
    sp = bk.lowrank_split(8, c, r, s, SMS)
    assert (sp.rows, sp.k1, sp.k2, sp.ctas) == (8, 32, 32, 132)
    assert (len(sp.items(1)), len(sp.items(2))) == (64, 16)
    assert sp.region_bytes() == {"p": 64 * 8 * 128 * 4, "h": 8 * 128 * 2}
    # the plans the chip run times beside it (``plan_us``): coarser
    # slices, one slice of phase 2 a column tile (no sum), fewer CTAs
    plans = {}
    for items, ctas in chip_smoke.LOWRANK_PLAN_SWEEP:
        if isinstance(items, tuple):
            items = tuple(bk.ITEMS_PER_SM * SMS if n is None else n
                          for n in items)
        p = bk.lowrank_split(8, c, r, s, SMS, items, ctas)
        plans[(items, ctas)] = (p.k1, p.k2, p.ctas)
    assert [plans[(n, None)][0] for n in (8, 16, 32)] == [256, 128, 64]
    assert plans[((264, 4), None)] == (32, 128, 132)
    assert plans[((264, 4), 0)] == (32, 128, 0)
    assert plans[(None, 64)] == (32, 32, 64)


@pytest.mark.parametrize("label", list(chip_smoke.LOWRANK_SHAPES))
def test_cta_cap_follows_the_phases_items(label):
    """The default plan caps the grid at one CTA a SM where no phase has
    more items than SMs (the k/v pair: 64 and 16 items) and takes the
    whole persistent grid where one has (the branches = 1 pairs: 192-258
    items), as the chip sweep chose; a cap asked for stays."""
    c, r, s = chip_smoke.LOWRANK_SHAPES[label]
    for m in (8, 64):
        sp = bk.lowrank_split(m, c, r, s, SMS)
        most = max(len(sp.items(1)), len(sp.items(2)))
        assert sp.ctas == (bk.LOWRANK_CTAS_PER_SM * SMS if most <= SMS
                           else 0)
        assert (sp.ctas > 0) == (label == "k,v")
        assert bk.lowrank_split(m, c, r, s, SMS, ctas=7).ctas == 7


def test_split_refuses_empty_sizes_and_a_third_phase():
    with pytest.raises(ValueError, match="positive"):
        bk.lowrank_split(8, 0, 16, 64, SMS)
    with pytest.raises(ValueError, match="positive"):
        bk.lowrank_split(8, 64, 16, 64, SMS, items=0)
    with pytest.raises(ValueError, match="positive"):
        bk.lowrank_split(8, 64, 16, 64, SMS, items=(4, 0))
    with pytest.raises(ValueError, match="positive"):
        bk.lowrank_split(8, 64, 16, 64, SMS, ctas=-1)
    with pytest.raises(ValueError, match="phases 1, 2"):
        bk.lowrank_split(8, 64, 16, 64, SMS).items(3)


def test_tile_fits_two_ctas_per_sm():
    """Both factors of a two-phase kernel take one view: B11's Sparse24B
    and B3's DequantB a ring of (A, raw weight) stages and two converted
    bf16 tiles, B1's PlainB a ring of (A, bf16 tile) stages -- each under
    the opt-in limit, two CTAs (with the 1 KB each that the card
    reserves) to an SM's 228 KB."""
    a_stage = bk.BM * (bk.BK + bk.PAD) * 2
    converted = 2 * bk.BK * (bk.BN + bk.PAD) * 2
    for kind, view, extra in (("lowrank_sq", "sparse24", converted),
                              ("lowrank_q", "dequant", converted),
                              ("lowrank_bf16", "plain", 0)):
        assert bk.VIEWS[kind] == (view, view)
        smem = bk.mma_smem_bytes(kind)
        assert smem == bk.STAGES * (a_stage + bk.RAW_STAGE[view]) + extra
        assert smem <= build.SMEM_LIMIT and 2 * (smem + 1024) <= 228 * 1024


# ---------------------------------------------------------------------------
# the two phases in numpy
# ---------------------------------------------------------------------------

def _expand(sp, idx, scale, k0, k1, c0, c1):
    """Rows k0:k1, columns c0:c1 of a (K, N) factor from its slot-major
    pack ``sp (2, K/4, N)``, ``idx (2, K/4, 1)``, ``scale (1, N)``, as
    ``Sparse24B`` converts a landed stage: row 4g + t is round_bf16(v *
    scale), v the f32 sum of the slots whose index is t, else exactly 0."""
    assert k0 % 4 == 0 and k1 % 4 == 0, "a group straddles a stage"
    out = np.zeros((k1 - k0, c1 - c0), np.float32)
    for k in range(k0, k1):
        g, t = divmod(k, 4)
        v = np.zeros(c1 - c0, np.float32)
        for i in range(2):
            if int(idx[i, g, 0]) == t:
                v = v + sp[i, g, c0:c1].astype(np.float32)
        out[k - k0] = v * scale[0, c0:c1]
    return _bf16(out)


def _dequant(q, scale, k0, k1, c0, c1):
    """Rows k0:k1, columns c0:c1 of an int8 / e4m3 factor ``q (K, N)``
    with ``scale (1, N)``, as ``DequantB`` converts a landed stage:
    round_bf16(f32(q) * scale)."""
    return _bf16(q[k0:k1, c0:c1].astype(np.float32) * scale[0, c0:c1])


def _plain(w, k0, k1, c0, c1):
    """Rows k0:k1, columns c0:c1 of a bf16 factor, as ``PlainB`` stages
    it: the values as they are."""
    return w[k0:k1, c0:c1]


def _run_phase(sp, phase, a, view):
    """One phase item by item: each item's block of the factor staged
    through ``view`` (rows k0:k1, columns c0:c1) a stage (BK rows) at a
    time, its f32 partial stored per K slice, the slices summed in order
    and rounded to bf16."""
    _, _, cols, ks = sp.phase(phase)
    part = np.zeros((sp.slices(phase), a.shape[0], cols), np.float32)
    for _, k0, k1, c0, c1 in sp.items(phase):
        w = np.concatenate([view(s0, min(s0 + bk.BK, k1), c0, c1)
                            for s0 in range(k0, k1, bk.BK)])
        part[k0 // ks, :, c0:c1] = a[:, k0:k1] @ w
    return _bf16(part.sum(0, dtype=np.float32))


def _mirror(sp, x, w0, w1):
    """The kernel's two phases, row block by row block, the factors read
    through the views ``w0`` and ``w1``."""
    y = np.zeros((x.shape[0], sp.s), np.float32)
    for row0 in range(0, x.shape[0], bk.BM):
        h = _run_phase(sp, 1, x[row0:row0 + bk.BM], w0)
        y[row0:row0 + bk.BM] = _run_phase(sp, 2, h, w1)
    return y


def _err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(a):
    """A JAX array as numpy, int8 kept, every float type as f32."""
    a = np.asarray(a)
    return a if a.dtype == np.int8 else a.astype(np.float32)


def _factors(mode, m, c, r, s):
    """Seeded factors of a mirror case and the views the kernel reads
    them through: 2:4 packs (``int8`` / ``fp8``, B11), quantized factors
    (``dequant-int8`` / ``dequant-fp8``, B3) or bf16 factors (``plain``,
    B1).  Returns the JAX operands after x, the two views and the
    reference's plain and Pallas entries."""
    ws = [factor_weights(m + i, shape, mode in ("int8", "fp8"))
          for i, shape in enumerate(((c, r), (r, s)))]
    if mode == "plain":
        jw = [jnp.asarray(w).astype(jnp.bfloat16) for w in ws]
        views = [functools.partial(_plain, _np(w)) for w in jw]
        return jw, views, jref.lowrank_matmul_ref, jops.lowrank_matmul
    if mode.startswith("dequant-"):
        pairs = [jq.quantize_array(jnp.asarray(w), mode[8:]) for w in ws]
        views = [functools.partial(_dequant, *map(_np, pr)) for pr in pairs]
        return ([a for pr in pairs for a in pr], views,
                jref.lowrank_matmul_q_ref, jops.lowrank_matmul_q)
    packs = [jsp.sparsify_array(jnp.asarray(w), mode=mode) for w in ws]
    views = [functools.partial(_expand, *map(_np, pk)) for pk in packs]
    return ([a for pk in packs for a in pk], views,
            jref.lowrank_matmul_sq_ref, jops.lowrank_matmul_sq)


#: mirror cases (M, C, R, S, items): slices of one stage (the default
#: plan at these widths) and long ones (``items`` 1-2), two row blocks
#: (M = 72), ragged C, R and S (multiples of 4, as 2:4 packs need); all
#: of them for 2:4 packs, all from the third on for the other views
_MIRROR_SHAPES = [(8, 256, 64, 200, None), (8, 256, 64, 200, 2),
                  (37, 96, 20, 70, None), (72, 64, 8, 129, None),
                  (5, 36, 20, 70, 1)]
#: and of the views of B1 and B3 alone: the served k/v pair at decode, a
#: ragged M and a chunk, the q,o pair of branches = 1 at decode, and a
#: ragged R that is not a multiple of 4
_DENSE_SHAPES = [(8, 2048, 128, 512, None), (37, 2048, 128, 512, None),
                 (64, 2048, 128, 512, None), (8, 2048, 512, 2048, None),
                 (9, 200, 17, 129, None)]
_DENSE_MODES = ("dequant-int8", "dequant-fp8", "plain")
_MIRROR_CASES = [(*shape, mode) for shape in _MIRROR_SHAPES
                 for mode in ("int8", "fp8")] + [
    (*shape, mode) for shape in _MIRROR_SHAPES[2:] + _DENSE_SHAPES
    for mode in _DENSE_MODES]


@pytest.mark.parametrize("m,c,r,s,items,mode", _MIRROR_CASES)
def test_mirror_matches_the_reference_and_pallas_interpret(m, c, r, s, items,
                                                           mode):
    """The mirror of the kernel's arithmetic through each weight view
    agrees with the reference's plain chain and its Pallas kernel
    (interpret mode, padded by the reference's ops entry) on the same
    factors and activations."""
    operands, views, plain, kernel = _factors(mode, m, c, r, s)
    xa = _bf16(np.random.default_rng(m + r).standard_normal((m, c),
                                                            np.float32))
    sp = bk.lowrank_split(m, c, r, s, SMS, items)
    assert items is None or sp.slices(1) < math.ceil(c / bk.BK)
    got = _mirror(sp, xa, *views)
    x = jnp.asarray(xa).astype(jnp.bfloat16)
    want = plain(x, *operands)
    pallas = kernel(x, *operands, force_kernel=True)
    assert _err(got, want.astype(jnp.float32)) <= TOL
    assert _err(got, pallas.astype(jnp.float32)) <= TOL
