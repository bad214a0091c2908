"""The work split of bf16 B11's two-phase split kernel
(``repro_torch.kernels.branched_matmul.lowrank_split``), checked on the
CPU, and its arithmetic mirrored in numpy.

The CUDA kernel runs only on the card, so what surrounds it is held here:

* the plan: each phase's K-slice length is a multiple of the stage depth
  BK, its items cover every weight element exactly once in the order the
  kernel decodes its item index (slice-major, then the 128-column tile),
  the scratch regions (P, then h) are aligned and do not overlap, and the
  served k/v plan is the one ``PERF.md`` describes;
* the arithmetic: a numpy mirror of the two phases -- each item's block of
  a 2:4 factor expanded a stage at a time as ``Sparse24B`` stages it
  (``round_bf16(value * scale)``, exactly 0 at a pruned row), per-slice
  f32 partials summed in slice order, ``h`` rounded to bf16 -- is held
  against the reference's ``lowrank_matmul_sq`` in Pallas interpret mode
  and against its plain reference, on the same seeded packs, at
  ``KERNEL_TOL["bfloat16"]`` (2e-2) normalised as on the card (max |a -
  b| / max |b|): both sides round h to bf16, so a last-bit difference in
  an f32 sum can flip one rounding of h.
"""
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
    """Both factors take the Sparse24B view: its ring of (A, pack) stages
    and two converted bf16 tiles, under the opt-in limit, two CTAs (with
    the 1 KB each that the card reserves) to an SM's 228 KB."""
    smem = bk.mma_smem_bytes("lowrank_sq")
    assert smem == bk.STAGES * (bk.BM * (bk.BK + bk.PAD) * 2
                                + bk.RAW_STAGE["sparse24"]) \
        + 2 * bk.BK * (bk.BN + bk.PAD) * 2
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


def _run_phase(sp, phase, a, pack):
    """One phase item by item: each item's block of the factor expanded a
    stage (BK rows) at a time, its f32 partial stored per K slice, the
    slices summed in order and rounded to bf16."""
    _, _, cols, ks = sp.phase(phase)
    part = np.zeros((sp.slices(phase), a.shape[0], cols), np.float32)
    for _, k0, k1, c0, c1 in sp.items(phase):
        w = np.concatenate([_expand(*pack, s0, min(s0 + bk.BK, k1), c0, c1)
                            for s0 in range(k0, k1, bk.BK)])
        part[k0 // ks, :, c0:c1] = a[:, k0:k1] @ w
    return _bf16(part.sum(0, dtype=np.float32))


def _mirror(sp, x, w0, w1):
    """The kernel's two phases, row block by row block."""
    y = np.zeros((x.shape[0], sp.s), np.float32)
    for row0 in range(0, x.shape[0], bk.BM):
        h = _run_phase(sp, 1, x[row0:row0 + bk.BM], w0)
        y[row0:row0 + bk.BM] = _run_phase(sp, 2, h, w1)
    return y


def _err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m,c,r,s,items", [
    (8, 256, 64, 200, None), (8, 256, 64, 200, 2), (37, 96, 20, 70, None),
    (72, 64, 8, 129, None), (5, 36, 20, 70, 1)])
def test_mirror_matches_the_reference_and_pallas_interpret(m, c, r, s, items,
                                                           mode):
    """Slices of one stage (the default plan at these widths) and long
    ones (``items`` 1-2), two row blocks (M = 72), ragged C, R and S: the
    mirror of the kernel's arithmetic agrees with the reference's plain
    chain and its Pallas kernel (interpret mode, padded by the reference's
    ops entry) on the same packs and activations."""
    packs = [jsp.sparsify_array(jnp.asarray(factor_weights(m + i, shape, True)),
                                mode=mode)
             for i, shape in enumerate(((c, r), (r, s)))]
    xa = _bf16(np.random.default_rng(m + r).standard_normal((m, c),
                                                            np.float32))
    sp = bk.lowrank_split(m, c, r, s, SMS, items)
    assert items is None or sp.slices(1) < math.ceil(c / bk.BK)
    got = _mirror(sp, xa, *[tuple(np.asarray(a).astype(np.float32)
                                  if a.dtype != jnp.int8 else np.asarray(a)
                                  for a in pk) for pk in packs])
    x = jnp.asarray(xa).astype(jnp.bfloat16)
    flat = [a for pk in packs for a in pk]
    want = jref.lowrank_matmul_sq_ref(x, *flat)
    pallas = jops.lowrank_matmul_sq(x, *flat, force_kernel=True)
    assert _err(got, want.astype(jnp.float32)) <= TOL
    assert _err(got, pallas.astype(jnp.float32)) <= TOL
