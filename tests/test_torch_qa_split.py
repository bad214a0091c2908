"""The split-phase s8 kernel of B7 (``branched_matmul_qa``), checked on the
CPU.

The CUDA kernel runs only on the card, so its work split, its tile and its
arithmetic are held here through plain stand-ins:

* the planner ``qa_split`` (plain Python, the wrapper's own) covers every
  (K slice, branch, column tile) of each phase exactly once, in the order
  the kernel decodes its item index, with K slices in whole stages and no
  phase-3 slice straddling two branches;
* a numpy model of the tile's fragments (ldmatrix on the activation rows
  stored in ``kpos`` order, ldmatrix.trans on the (K, N) factor and two
  byte permutes, the m16n8k32 s8 layouts) gives the exact int32 product;
* a numpy mirror of the split-phase arithmetic, following the plan's K
  slices (int32 partials per slice, the (row, branch) requantization, each
  branch's fold and the f32 branch sum in branch order), is bit-equal to
  the plain version ``ref.branched_matmul_qa_ref`` and to the reference's
  oracle, and within the act-quant tests' tolerance of the reference's
  Pallas kernel in interpret mode (1e-5 normalised in f32, one bf16
  rounding in bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import branched_matmul_qa as jqa
from repro.kernels import ref as jref
from repro.quant import quantize_array as jquantize_array
from repro_torch import bridge
from repro_torch.kernels import branched_matmul_qa as bak
from repro_torch.kernels import ref

SMS = 132
F32 = np.float32


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

#: (m, c, n, r1, r2, s): llama3.2-1b's branched linears at a prefill chunk,
#: a ragged chunk and a long prompt, and small ragged shapes
PLAN_CASES = [(64, 2048, 4, 128, 128, 2048), (64, 2048, 4, 192, 192, 8192),
              (64, 8192, 4, 192, 192, 2048), (37, 2048, 4, 192, 192, 8192),
              (512, 8192, 4, 192, 192, 2048), (1, 33, 3, 5, 5, 70),
              (9, 200, 1, 17, 17, 129), (8, 256, 2, 48, 40, 96)]


@pytest.mark.parametrize("m,c,n,r1,r2,s", PLAN_CASES)
@pytest.mark.parametrize("items", [None, 1, 64])
def test_qa_split_covers_each_item_once(m, c, n, r1, r2, s, items):
    plan = bak.qa_split(m, c, n, r1, r2, s, SMS, items)
    for i in plan.PHASES:
        k, nbr, width, ks = plan.phase(i)
        assert ks % bak.QBK == 0 and ks > 0
        got = plan.items(i)
        want = [(b, k0, min(k, k0 + ks), c0, min(width, c0 + bak.bk.BN))
                for k0 in range(0, k, ks) for b in range(nbr)
                for c0 in range(0, width, bak.bk.BN)]
        assert got == want
        # every (branch, K row, column) of the phase once
        seen = np.zeros((nbr, k, width), np.int32)
        for b, k0, k1, c0, c1 in got:
            seen[b, k0:k1, c0:c1] += 1
        assert (seen == 1).all()
    # phase 3 reads each branch's own (r2, S) factor: in the stacked
    # (N * r2, S) view, no slice straddles two branches
    for b, k0, k1, _, _ in plan.items(3):
        assert (b * r2 + k0) // r2 == (b * r2 + k1 - 1) // r2 == b


def test_qa_split_served_plans():
    """The served chunk (M = 64): phase 1 in slices of one stage (C = 2048)
    or four (C = 8192), phase 2 in one-stage slices of r1, phase 3 one
    slice of each branch at gate/up (256 items), one stage at q/o, down;
    the int32 partials of the largest phase dominate the scratch."""
    got = {}
    for m, c, n, r1, r2, s in PLAN_CASES[:3]:
        plan = bak.qa_split(m, c, n, r1, r2, s, SMS)
        got[(c, r1, s)] = (plan.k1, plan.k2, plan.k3,
                           *[len(plan.items(i)) for i in plan.PHASES])
        regions = plan.region_bytes()
        assert regions["xq"] == m * bak.kpad(c)
        assert regions["p"] == max(
            plan.slices(i) * n * 64 * plan.phase(i)[2] * 4
            for i in plan.PHASES)
        assert plan.scratch_bytes >= sum(regions.values())
    assert got == {(2048, 128, 2048): (64, 64, 64, 128, 8, 128),
                   (2048, 192, 8192): (64, 64, 192, 256, 24, 256),
                   (8192, 192, 2048): (256, 64, 64, 256, 24, 192)}


def test_qa_split_refuses_empty_sizes():
    with pytest.raises(ValueError):
        bak.qa_split(8, 0, 4, 32, 32, 64, SMS)
    with pytest.raises(ValueError):
        bak.qa_split(8, 64, 4, 32, 32, 64, SMS, items=0)


# ---------------------------------------------------------------------------
# the tile's fragments
# ---------------------------------------------------------------------------

def kpos(k: np.ndarray) -> np.ndarray:
    """Where value k of an int8 activation row is stored (qa_mma.cuh)."""
    i = k & 15
    return (k & ~15) | (((i & 7) >> 1) << 2) | ((i >> 3) << 1) | (i & 1)


def _ldmatrix(rows: list[np.ndarray], trans: bool) -> np.ndarray:
    """One 8x8 b16 matrix of ldmatrix: ``rows`` the 8 rows of 16 bytes
    (uint8) -> each lane's 32-bit register as 4 bytes (32, 4).  Not
    transposed: lane l holds row l / 4, b16 elements 2(l % 4), +1.
    Transposed: row 2(l % 4), then 2(l % 4) + 1, of b16 column l / 4."""
    out = np.zeros((32, 4), np.uint8)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        if trans:
            out[lane] = np.concatenate([rows[2 * t][2 * g:2 * g + 2],
                                        rows[2 * t + 1][2 * g:2 * g + 2]])
        else:
            out[lane] = rows[g][4 * t:4 * t + 4]
    return out


def _perm(a: np.ndarray, b: np.ndarray, sel: int) -> np.ndarray:
    """__byte_perm(a, b, sel) on (32, 4) byte registers."""
    both = np.concatenate([a, b], 1)
    return both[:, [(sel >> (4 * j)) & 7 for j in range(4)]]


def tile_model(a_store: np.ndarray, w: np.ndarray) -> np.ndarray:
    """One warp's m16n8k32 products as the kernel issues them: A (16, 32)
    rows as stored (kpos order, uint8 bytes of int8), W (32, 16) the warp's
    16 columns of the (K, N) factor -> the int32 (16, 16) tile."""
    a_rows = [a_store[r] for r in range(16)]
    # A: matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31)
    a = [_ldmatrix([a_rows[r][16 * j:16 * j + 16] for r in range(8 * i,
                                                                 8 * i + 8)],
                   trans=False) for i, j in ((0, 0), (1, 0), (0, 1), (1, 1))]
    # W: four 8-row matrices of the 16 columns, read as b16 and transposed
    wm = [_ldmatrix([w[r] for r in range(8 * i, 8 * i + 8)], trans=True)
          for i in range(4)]
    out = np.zeros((16, 16), np.int64)
    for e, sel in ((0, 0x6420), (1, 0x7531)):   # even, odd columns
        b0, b1 = _perm(wm[0], wm[1], sel), _perm(wm[2], wm[3], sel)
        # the m16n8k32 operands as the lanes' registers lay them out:
        # A[g (+8)][4t + i (+16)], B[4t + i (+16)][g]
        amat = np.zeros((16, 32), np.int64)
        bmat = np.zeros((32, 8), np.int64)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for i in range(4):
                amat[g, 4 * t + i] = a[0][lane, i].astype(np.int8)
                amat[g + 8, 4 * t + i] = a[1][lane, i].astype(np.int8)
                amat[g, 16 + 4 * t + i] = a[2][lane, i].astype(np.int8)
                amat[g + 8, 16 + 4 * t + i] = a[3][lane, i].astype(np.int8)
                bmat[4 * t + i, g] = b0[lane, i].astype(np.int8)
                bmat[16 + 4 * t + i, g] = b1[lane, i].astype(np.int8)
        d = amat @ bmat                                  # (16, 8)
        # lane (g, t) holds D columns 2t + j, the tile's 4t + 2j + e
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j in range(2):
                for row in (g, g + 8):
                    out[row, 4 * t + 2 * j + e] = d[row, 2 * t + j]
    return out


def test_tile_fragments_give_the_exact_product():
    """Activation rows stored in kpos order, the factor as it lies: the
    kernel's fragments multiply to A @ W exactly, extremes included."""
    rng = np.random.default_rng(7)
    a = rng.integers(-127, 128, (16, 32)).astype(np.int8)
    w = rng.integers(-127, 128, (32, 16)).astype(np.int8)
    a[0], w[:, 3] = 127, -127
    store = np.zeros((16, 32), np.int8)
    store[:, kpos(np.arange(32))] = a
    got = tile_model(store.view(np.uint8), w.view(np.uint8))
    np.testing.assert_array_equal(got, a.astype(np.int64) @ w)


def test_kpos_is_a_permutation_within_16():
    k = np.arange(64)
    p = kpos(k)
    assert sorted(p) == list(k)
    assert all((p[i] >> 4) == (i >> 4) for i in k)


# ---------------------------------------------------------------------------
# the split-phase arithmetic
# ---------------------------------------------------------------------------

def quant_rows(h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's per-row requantization in f32: absmax / 127, a safe
    divisor of 1 for a zero row, rint (half to even), clipped to +-127."""
    scale = (np.abs(h).max(-1) / F32(127)).astype(F32)
    safe = np.where(scale > 0, scale, F32(1)).astype(F32)
    q = np.clip(np.rint((h / safe[:, None]).astype(F32)), -127, 127)
    return q.astype(np.int8), scale


def _phase(a, w, plan, i):
    """Phase i's int32 sum per branch, from the partials of the plan's
    items (each slice's int32 product; int sums are exact in any order)."""
    _, nbr, width, _ = plan.phase(i)
    acc = np.zeros((nbr, a[0].shape[0], width), np.int64)
    for b, k0, k1, c0, c1 in plan.items(i):
        acc[b, :, c0:c1] += a[b][:, k0:k1].astype(np.int64) \
            @ w[b][k0:k1, c0:c1].astype(np.int64)
    assert np.abs(acc).max() < 2 ** 31
    return acc


def qa_mirror(x, uq, us, xcq, xcs, vq, vs, plan):
    """The split-phase kernel in numpy: x (M, C) f32 (already in x's
    type's values) -> y (M, S) f32 before the final rounding."""
    m = x.shape[0]
    n = uq.shape[0]
    xq, xs = quant_rows(x)
    y = np.zeros((m, vq.shape[-1]), F32)
    for row0 in range(0, m, plan.rows):
        rs = slice(row0, min(m, row0 + plan.rows))
        acc = _phase([xq[rs]] * n, uq, plan, 1)
        h1 = [(acc[b].astype(F32) * xs[rs, None]).astype(F32) * us[b]
              for b in range(n)]
        h1 = [quant_rows(h.astype(F32)) for h in h1]
        acc = _phase([h[0] for h in h1], xcq, plan, 2)
        h2 = [quant_rows(((acc[b].astype(F32) * h1[b][1][:, None])
                          .astype(F32) * xcs[b]).astype(F32))
              for b in range(n)]
        acc = _phase([h[0] for h in h2], vq, plan, 3)
        out = np.zeros((rs.stop - rs.start, y.shape[1]), F32)
        for b in range(n):       # the branch sum in branch order, from 0
            out = (out + ((acc[b].astype(F32) * h2[b][1][:, None])
                          .astype(F32) * vs[b]).astype(F32)).astype(F32)
        y[rs] = out
    return y


def _factor(rng, *shape):
    q, s = jquantize_array(jnp.asarray(rng.standard_normal(shape) * 0.05,
                                       jnp.float32))
    return np.asarray(q), np.asarray(s)


#: (m, n, c, r, s): M at a small chunk, a ragged one and a full row block
MIRROR_CASES = [(8, 4, 256, 32, 96), (37, 3, 256, 48, 128),
                (64, 2, 256, 64, 160)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,c,r,s", MIRROR_CASES)
def test_qa_mirror_is_bit_equal_to_plain_and_oracle(m, n, c, r, s, dtype):
    """The mirror on a plan of a few items a phase (so C and r are
    K-sliced) equals the plain version and the reference's oracle bit for
    bit, with an all-zero row exactly 0, and the reference's Pallas kernel
    within the act-quant tests' tolerance."""
    rng = np.random.default_rng(m + n + r)
    x = (rng.standard_normal((m, c)) * 0.1).astype(F32)
    x[m // 2] = 0
    x = np.asarray(jnp.asarray(x).astype(dtype)).astype(F32)
    facs = [_factor(rng, n, c, r), _factor(rng, n, r, r),
            _factor(rng, n, r, s)]
    args = [a for pair in facs for a in pair]
    plan = bak.qa_split(m, c, n, r, r, s, SMS, items=2 * n)
    assert plan.slices(1) > 1
    got = qa_mirror(x, args[0], args[1][:, 0], args[2], args[3][:, 0],
                    args[4], args[5][:, 0], plan)
    dt = getattr(torch, dtype)
    got_t = torch.from_numpy(got).to(dt)
    assert not got_t[m // 2].any()
    tx = torch.from_numpy(x).to(dt)
    targs = [bridge.to_torch(a, "cpu") for a in args]
    plain = ref.branched_matmul_qa_ref(tx, *targs)
    assert torch.equal(got_t, plain)
    jx = jnp.asarray(x).astype(dtype)
    jargs = [jnp.asarray(a) for a in args]
    oracle = np.asarray(jref.branched_matmul_qa_ref(jx, *jargs), F32)
    np.testing.assert_array_equal(got_t.to(torch.float32).numpy(), oracle)
    pallas = np.asarray(jqa.branched_matmul_qa(jx, *jargs, bm=m, bn=s,
                                               interpret=True), F32)
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert np.abs(got_t.to(torch.float32).numpy() - pallas).max() \
        <= tol * np.abs(oracle).max()


@pytest.mark.parametrize("items", [None, 1, 5])
def test_qa_mirror_does_not_depend_on_the_plan(items):
    """int32 partials add up exactly whatever the K slices: every plan
    gives the default plan's bits."""
    m, n, c, r, s = 16, 2, 320, 40, 72
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((m, c)) * 0.1).astype(F32)
    facs = [_factor(rng, n, c, r), _factor(rng, n, r, r),
            _factor(rng, n, r, s)]
    args = [facs[0][0], facs[0][1][:, 0], facs[1][0], facs[1][1][:, 0],
            facs[2][0], facs[2][1][:, 0]]
    want = qa_mirror(x, *args, bak.qa_split(m, c, n, r, r, s, SMS))
    got = qa_mirror(x, *args, bak.qa_split(m, c, n, r, r, s, SMS, items))
    np.testing.assert_array_equal(got, want)


def test_kpad_is_whole_stages():
    assert [bak.kpad(k) for k in (1, 33, 64, 65, 192, 2048)] == \
        [64, 64, 64, 128, 192, 2048]
