"""The work split of the bf16 split-phase branched kernel
(``repro_torch.kernels.branched_matmul.branched_split``), checked on the
CPU at every main-path shape of ``chip_smoke.py`` and a ragged one: each
phase's items cover every weight element exactly once, each phase has
enough items for the card, the scratch holds what the split implies, and
the tile fits shared memory.  The kernel decodes its item indices in the
order ``BranchedSplit.items`` lists them; running those items in numpy
reproduces the plain version.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.kernels import branched_matmul as bk  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SMS = 132  # SMs of an H100 SXM
SHAPES = {**chip_smoke.BRANCHED_SHAPES, **chip_smoke.DEEPSEEK_BRANCHED_SHAPES,
          "ragged": (3, 33, 5, 70)}
M_CASES = (1, 8, 37, 64, 72, 512)
CASES = [(label, m) for label in SHAPES for m in M_CASES]


def _split(label, m):
    n, c, r, s = SHAPES[label]
    return bk.branched_split(m, c, n, r, r, s, SMS)


def _cover_counts(items, branches, k, cols):
    """How often each cell of each branch's weight is read, on the grid
    compressed to the items' edges (exact for rectangles)."""
    counts = []
    for b in range(branches):
        mine = [it for it in items if it[0] == b]
        kb = np.unique([0, k] + [e for it in mine for e in it[1:3]])
        cb = np.unique([0, cols] + [e for it in mine for e in it[3:5]])
        assert kb[0] == 0 and kb[-1] == k and cb[0] == 0 and cb[-1] == cols
        grid = np.zeros((len(kb) - 1, len(cb) - 1), np.int64)
        for _, k0, k1, c0, c1 in mine:
            assert 0 <= k0 < k1 <= k and 0 <= c0 < c1 <= cols
            grid[np.searchsorted(kb, k0):np.searchsorted(kb, k1),
                 np.searchsorted(cb, c0):np.searchsorted(cb, c1)] += 1
        counts.append(grid)
    return counts


@pytest.mark.parametrize("label,m", CASES)
def test_items_cover_every_weight_once_and_fill_the_card(label, m):
    sp = _split(label, m)
    for phase in (1, 2, 3):
        k, branches, cols, _ = sp.phase(phase)
        items = sp.items(phase)
        for grid in _cover_counts(items, branches, k, cols):
            assert (grid == 1).all(), (phase, grid.min(), grid.max())
        # the finest split a phase could take: its tiles x BK chunks of K
        tiles = branches * math.ceil(cols / bk.BN)
        available = tiles * math.ceil(k / bk.BK)
        assert len(items) >= min(SMS, available), (phase, len(items))
        assert sp.phase(phase)[3] % bk.BK == 0
        if tiles <= bk.ITEMS_PER_SM * SMS:
            assert len(items) <= bk.ITEMS_PER_SM * SMS


@pytest.mark.parametrize("label,m", CASES)
def test_scratch_holds_what_the_split_implies(label, m):
    sp = _split(label, m)
    rows = min(m, bk.BM)
    partials = []
    for phase in (1, 2, 3):
        slices = {(k0, k1) for _, k0, k1, _, _ in sp.items(phase)}
        _, branches, cols, _ = sp.phase(phase)
        if len(slices) > 1:
            partials.append(len(slices) * rows * branches * cols * 4)
    regions = [max(partials, default=0), rows * sp.n * sp.r1 * 2,
               rows * sp.n * sp.r2 * 2]
    assert sp.scratch_bytes == sum(-(-b // bk.ALIGN) * bk.ALIGN
                                   for b in regions)
    off = sp.offsets()
    assert list(off) == ["p", "h1", "h2"]
    assert [o % bk.ALIGN for o in off.values()] == [0] * 3
    assert off["p"] == 0 and off["h1"] >= regions[0] \
        and off["h2"] >= off["h1"] + regions[1] \
        and sp.scratch_bytes >= off["h2"] + regions[2]


def test_tile_fits_shared_memory():
    assert bk.mma_smem_bytes() <= build.SMEM_LIMIT == 232448
    # two CTAs of the tile fit one SM's 228 KB
    assert 2 * bk.mma_smem_bytes() <= 228 * 1024


def test_split_refuses_empty_sizes():
    with pytest.raises(ValueError, match="positive"):
        bk.branched_split(8, 0, 4, 16, 16, 64, SMS)
    with pytest.raises(ValueError, match="phases 1, 2, 3"):
        bk.branched_split(8, 64, 4, 16, 16, 64, SMS).items(4)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


def _run_phase(sp, phase, a, w):
    """One phase in numpy, item by item: f32 partials per K slice of the
    branch's ``a`` columns times its weight, summed in slice order and
    rounded to bf16.  ``a`` (rows, K) shared by the branches in phase 1,
    else (rows, branches*K); ``w`` (branches, K, cols) -> (rows,
    branches*cols)."""
    k, nbr, cols, ks = sp.phase(phase)
    a_br = 0 if phase == 1 else k
    part = np.zeros((sp.slices(phase), a.shape[0], nbr * cols), np.float32)
    for b, k0, k1, c0, c1 in sp.items(phase):
        part[k0 // ks, :, b * cols + c0:b * cols + c1] = \
            a[:, b * a_br + k0:b * a_br + k1] @ w[b, k0:k1, c0:c1]
    return _bf16(part.sum(0, dtype=np.float32))


def _run_items(sp, x, u, xc, v):
    """The kernel's three phases in numpy, row block by row block."""
    y = np.zeros((x.shape[0], sp.s), np.float32)
    for row0 in range(0, x.shape[0], bk.BM):
        h1 = _run_phase(sp, 1, x[row0:row0 + bk.BM], u)
        h2 = _run_phase(sp, 2, h1, xc)
        y[row0:row0 + bk.BM] = _run_phase(sp, 3, h2,
                                          v.reshape(1, -1, sp.s))
    return y


@pytest.mark.parametrize("m,n,c,r,s", [(1, 3, 33, 5, 70), (72, 2, 200, 17,
                                                            129),
                                        (9, 4, 1100, 40, 300)])
def test_running_the_items_reproduces_the_plain_version(m, n, c, r, s):
    rng = np.random.default_rng(0)
    x = _bf16(rng.standard_normal((m, c), np.float32))
    u = _bf16(rng.standard_normal((n, c, r), np.float32) * c ** -0.5)
    xc = _bf16(rng.standard_normal((n, r, r), np.float32) * r ** -0.5)
    v = _bf16(rng.standard_normal((n, r, s), np.float32) * r ** -0.5)
    sp = bk.branched_split(m, c, n, r, r, s, SMS)
    assert sp.slices(1) > 1 or c <= bk.BK
    got = _run_items(sp, x, u, xc, v)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, u, xc, v)]
    want = ref.branched_matmul_ref(*t).to(torch.float32).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= chip_smoke.KERNEL_TOL["bfloat16"], err
