"""The split-phase s8 kernel's two-phase form, B6 (``lowrank_matmul_qa``),
checked on the CPU.

The CUDA kernel runs only on the card, so its work split and its
arithmetic are held here through plain stand-ins, as
``tests/test_torch_qa_split.py`` holds B7's (whose numpy model of the
s8 tile's fragments covers both kernels, and whose row quantization and
per-phase int32 sums this file reuses):

* the planner ``lowrank_qa_split`` (plain Python, the wrapper's own)
  covers every (K slice, column tile) of each phase exactly once, in the
  order the kernel decodes its item index, with K slices in whole stages,
  at llama3.2-1b's four SVD pairs and at small ragged shapes; its served
  plans and CTA cap are the ones ``PERF.md`` describes;
* a numpy mirror of the two phases, following the plan's K slices (int32
  partials per slice, the per-row requantization over R, the fold of the
  second product with no sum from 0), is bit-equal to the plain version
  ``ref.lowrank_matmul_qa_ref`` and to the reference's oracle (tolerance
  0) whatever the plan, an all-zero row and a row whose product is
  exactly 0 included, and within the act-quant tests' tolerance of the
  reference's Pallas ``lowrank_matmul_qa`` in interpret mode (1e-5
  normalised in f32, 2^-7 in bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lowrank_matmul_qa as jlqa
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.kernels import branched_matmul_qa as bak
from repro_torch.kernels import lowrank_matmul_qa as lak
from repro_torch.kernels import ref
from test_torch_qa_split import F32, SMS, _factor, _phase, quant_rows


# ---------------------------------------------------------------------------
# B6: the two-phase plan
# ---------------------------------------------------------------------------

#: llama3.2-1b's SVD pairs (C, R, S) under LRD (chip_smoke.LOWRANK_SHAPES)
LOWRANK_SHAPES = [(2048, 128, 512), (2048, 512, 2048), (2048, 768, 8192),
                  (8192, 768, 2048)]
#: (m, c, r, s): those pairs at a prefill chunk, a ragged chunk and a long
#: prompt, and small ragged shapes (C, R not whole stages, S past a tile)
LOWRANK_PLAN_CASES = [(m, *shape) for shape in LOWRANK_SHAPES
                      for m in (64, 37, 512)] + [
    (9, 200, 17, 129), (1, 33, 5, 70), (70, 130, 96, 300)]
#: plans: the default, one slice a phase (one count at or under the
#: phase's tiles), one slice in phase 2 only, a few items each
LOWRANK_PLANS = [None, 1, (None, 1), (1, None), 64]


@pytest.mark.parametrize("items", LOWRANK_PLANS)
@pytest.mark.parametrize("m,c,r,s", LOWRANK_PLAN_CASES)
def test_lowrank_qa_split_covers_each_item_once(m, c, r, s, items):
    """Each phase's items cover every (K row, column) of its factor once,
    in the order the kernel decodes its item index (slice-major, then the
    128-column tile), with K slices in whole stages of QBK."""
    plan = lak.lowrank_qa_split(m, c, r, s, SMS, items)
    assert plan.rows == min(m, 64)
    for i in plan.PHASES:
        k, nbr, width, ks = plan.phase(i)
        assert nbr == 1 and ks % bak.QBK == 0 and ks > 0
        got = plan.items(i)
        want = [(0, k0, min(k, k0 + ks), c0, min(width, c0 + bak.bk.BN))
                for k0 in range(0, k, ks)
                for c0 in range(0, width, bak.bk.BN)]
        assert got == want
        seen = np.zeros((k, width), np.int32)
        for _, k0, k1, c0, c1 in got:
            seen[k0:k1, c0:c1] += 1
        assert (seen == 1).all()


def test_lowrank_qa_split_served_plans():
    """The served chunk (M = 64), half an item a SM in phase 1 and one in
    phase 2: at k/v 32 phase-1 items of one stage and 8 phase-2 items
    (two slices of R = 128 by 4 tiles of S); at the wider pairs 64-66
    and 96-128; every one on one CTA a SM (132).  Every default phase
    stores partials, and p is the larger phase's."""
    got = {}
    for c, r, s in LOWRANK_SHAPES:
        plan = lak.lowrank_qa_split(64, c, r, s, SMS)
        got[(c, r, s)] = (plan.k1, plan.k2, plan.ctas,
                          *[len(plan.items(i)) for i in plan.PHASES])
        regions = plan.region_bytes()
        assert regions["p"] == max(plan.slices(i) * 64 * plan.phase(i)[2]
                                   * 4 for i in plan.PHASES)
        assert regions["xq"] == 64 * bak.kpad(c)
        assert regions["hq"] == 64 * bak.kpad(r)
        assert plan.scratch_bytes >= sum(regions.values())
    assert got == {(2048, 128, 512): (64, 64, 132, 32, 8),
                   (2048, 512, 2048): (128, 64, 132, 64, 128),
                   (2048, 768, 8192): (192, 384, 132, 66, 128),
                   (8192, 768, 2048): (768, 128, 132, 66, 96)}


def test_lowrank_qa_split_knobs_reach_c():
    """One count at or under a phase's tiles gives it one K slice (each
    phase still stores its int32 partials: the requantization needs
    whole rows, the fold sums them), a pair of counts sets each phase,
    and the CTA cap passes through to C (c_args: k1, k2, ctas)."""
    kv = lak.lowrank_qa_split(64, 2048, 128, 512, SMS, items=1)
    assert (kv.k1, kv.k2) == (2048, 128)
    assert kv.region_bytes()["p"] == 64 * 512 * 4
    only2 = lak.lowrank_qa_split(64, 2048, 128, 512, SMS, items=(None, 4))
    assert (only2.k1, only2.k2) == (64, 128)
    assert only2.region_bytes()["p"] == 32 * 64 * 128 * 4
    assert lak.lowrank_qa_split(64, 2048, 128, 512, SMS).c_args \
        == (64, 64, 132)
    assert lak.lowrank_qa_split(64, 2048, 128, 512, SMS, ctas=0).c_args \
        == (64, 64, 0)
    assert lak.lowrank_qa_split(64, 2048, 128, 512, SMS, ctas=64).ctas == 64


def test_lowrank_qa_split_refuses_empty_sizes():
    for dims in [(8, 0, 32, 64), (8, 64, 0, 64), (0, 64, 32, 64)]:
        with pytest.raises(ValueError):
            lak.lowrank_qa_split(*dims, SMS)
    with pytest.raises(ValueError):
        lak.lowrank_qa_split(8, 64, 32, 64, SMS, items=(4, 0))
    with pytest.raises(ValueError):
        lak.lowrank_qa_split(8, 64, 32, 64, SMS, ctas=-1)


# ---------------------------------------------------------------------------
# B6: the two-phase arithmetic
# ---------------------------------------------------------------------------

def lowrank_qa_mirror(x, w0q, w0s, w1q, w1s, plan):
    """The two-phase kernel in numpy: x (M, C) f32 (already in x's type's
    values) -> y (M, S) f32 before the final rounding.  Phase 1's int32
    sums from the plan's items, each row folded (acc * xs) * w0_scale and
    requantized over R; phase 2's, folded (acc * hs) * w1_scale with no
    sum from 0 (one branch)."""
    m = x.shape[0]
    xq, xs = quant_rows(x)
    y = np.zeros((m, w1q.shape[-1]), F32)
    for row0 in range(0, m, plan.rows):
        rs = slice(row0, min(m, row0 + plan.rows))
        acc = _phase([xq[rs]], w0q[None], plan, 1)[0]
        h = ((acc.astype(F32) * xs[rs, None]).astype(F32) * w0s).astype(F32)
        hq, hs = quant_rows(h)
        acc = _phase([hq], w1q[None], plan, 2)[0]
        y[rs] = ((acc.astype(F32) * hs[:, None]).astype(F32) * w1s
                 ).astype(F32)
    return y


def _lowrank_inputs(m, c, r, s, dtype, seed):
    """x with an all-zero row (m // 2) and a row (the last) that is
    non-zero only on input channels whose w0 rows are zero, so its product
    is exactly 0; seeded int8 factors quantized as the reference does."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, c)) * 0.1).astype(F32)
    w0q, w0s = _factor(rng, c, r)
    w1q, w1s = _factor(rng, r, s)
    w0q = w0q.copy()
    w0q[:8] = 0
    x[m // 2] = 0
    x[m - 1] = 0
    x[m - 1, :8] = rng.standard_normal(8)
    x = np.asarray(jnp.asarray(x).astype(dtype)).astype(F32)
    return x, w0q, w0s, w1q, w1s


#: (m, c, r, s): a decode-sized chunk, a ragged one, a full row block
LOWRANK_MIRROR_CASES = [(8, 256, 96, 160), (37, 320, 80, 130),
                        (64, 256, 136, 96)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,c,r,s", LOWRANK_MIRROR_CASES)
def test_lowrank_qa_mirror_is_bit_equal_to_plain_and_oracle(m, c, r, s,
                                                            dtype):
    """The mirror on a plan of one-stage K slices (C and R K-sliced)
    equals the plain version and the reference's oracle bit for bit (tol
    0), its zero row and its zero-product row exactly 0, and the
    reference's Pallas kernel in interpret mode within the act-quant
    tests' tolerance: 1e-5 (f32) / 2^-7 (bf16) of max |oracle|."""
    x, w0q, w0s, w1q, w1s = _lowrank_inputs(m, c, r, s, dtype, m + r)
    plan = lak.lowrank_qa_split(m, c, r, s, SMS, items=64)
    assert plan.slices(1) > 1 and plan.slices(2) > 1
    got = lowrank_qa_mirror(x, w0q, w0s[0], w1q, w1s[0], plan)
    dt = getattr(torch, dtype)
    got_t = torch.from_numpy(got).to(dt)
    assert not got_t[m // 2].any() and not got_t[m - 1].any()
    assert not torch.from_numpy(x[m - 1]).eq(0).all()
    args = [w0q, w0s, w1q, w1s]
    plain = ref.lowrank_matmul_qa_ref(
        torch.from_numpy(x).to(dt), *[bridge.to_torch(a, "cpu")
                                      for a in args])
    assert torch.equal(got_t, plain)
    jx = jnp.asarray(x).astype(dtype)
    jargs = [jnp.asarray(a) for a in args]
    oracle = np.asarray(jref.lowrank_matmul_qa_ref(jx, *jargs), F32)
    np.testing.assert_array_equal(got_t.to(torch.float32).numpy(), oracle)
    pallas = np.asarray(jlqa.lowrank_matmul_qa(jx, *jargs, bm=m, bn=s,
                                               interpret=True), F32)
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert np.abs(got_t.to(torch.float32).numpy() - pallas).max() \
        <= tol * np.abs(oracle).max()


@pytest.mark.parametrize("items", [1, (None, 1), (1, None), 5, (3, 2)])
def test_lowrank_qa_mirror_does_not_depend_on_the_plan(items):
    """int32 partials add up exactly whatever the K slices: every plan
    gives the default plan's bits (tol 0), across two row blocks."""
    m, c, r, s = 72, 320, 40, 200
    x, w0q, w0s, w1q, w1s = _lowrank_inputs(m, c, r, s, "float32", 3)
    args = (x, w0q, w0s[0], w1q, w1s[0])
    want = lowrank_qa_mirror(*args, lak.lowrank_qa_split(m, c, r, s, SMS))
    got = lowrank_qa_mirror(*args, lak.lowrank_qa_split(m, c, r, s, SMS,
                                                        items))
    np.testing.assert_array_equal(got, want)
