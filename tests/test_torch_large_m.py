"""The large-M form of bf16 B1 (``lowrank_matmul``) and B2
(``branched_matmul``), checked on the CPU: its plan
(``repro_torch.kernels.branched_matmul.large_m_plan``), the dispatch
between the forms, and its arithmetic mirrored in torch.

The CUDA kernel (``csrc/chain_wgmma.cuh``) runs only on the card, so what
surrounds it is held here:

* the plan: every product's output tiles cover each output element of
  each group exactly once, every stride it hands the kernel is a whole
  number of 16-byte granules (TMA's rule), an input whose row is not is
  copied into padded scratch, and the scratch regions are aligned and
  disjoint;
* the dispatch: bf16 takes the large-M form exactly at M >= LARGE_M, f32
  never, one counted call either way; the uncounted forced entries refuse
  f32 and empty factors before anything is launched;
* the arithmetic: a torch mirror of the products in the plan's order --
  each output tile summing its K blocks (and, in B2's last product, the
  branches) in f32, each product's output rounded to bf16 once -- held
  against the reference's plain chain and its Pallas kernel in interpret
  mode (padded by the reference's ``ops`` entry) on the same seeded bf16
  inputs, at ``KERNEL_TOL["bfloat16"]`` (2e-2) normalised as on the card
  (max |a - b| / max |b|): both sides round the rank intermediates to
  bf16, so a last-bit difference in an f32 sum can flip one rounding.
"""
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
from repro_torch.kernels import branched_matmul as bk  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import lowrank_matmul as lk  # noqa: E402

SMS = 132  # SMs of an H100 SXM
TOL = chip_smoke.KERNEL_TOL["bfloat16"]
L = bk.LARGE_M
#: B1 calls (M, C, R, S): the main path's (chip_smoke's train, hubert and
#: VLM rows, the searched k/v rank 191) and ragged ones
LOWRANK_DIMS = [(1024, 2048, 128, 512), (2000, 1280, 256, 1280),
                (2000, 1280, 128, 512), (1601, 8192, 384, 1024),
                (1024, 2048, 191, 512), (L - 1, 36, 20, 70),
                (L + 3, 200, 17, 129), (1, 8, 8, 8)]
#: B2 calls (M, C, N, r1, r2, S)
BRANCHED_DIMS = [(1024, 2048, 4, 128, 128, 2048),
                 (1024, 2048, 4, 192, 192, 8192),
                 (1024, 8192, 4, 192, 192, 2048),
                 (2000, 1280, 4, 128, 128, 5120),
                 (2000, 5120, 4, 128, 128, 1280),
                 (512, 2560, 4, 256, 256, 10240),
                 (L + 1, 33, 3, 5, 7, 70), (300, 72, 2, 20, 24, 130)]


def _cover(p: bk.Product) -> np.ndarray:
    """How often each output element of each group is written."""
    seen = np.zeros((p.out_groups, p.m, p.cols), np.int64)
    for z, r0, r1, c0, c1 in p.tiles():
        assert 0 <= r0 < r1 <= p.m and r1 - r0 <= p.bm
        assert 0 <= c0 < c1 <= p.cols and c1 - c0 <= p.bn
        seen[z, r0:r1, c0:c1] += 1
    return seen


@pytest.mark.parametrize("dims", LOWRANK_DIMS + BRANCHED_DIMS)
def test_tiles_cover_every_output_once(dims):
    plan = bk.large_m_plan(dims, SMS)
    assert len(plan.products) == (2 if len(dims) == 4 else 3)
    for p in plan.products:
        assert p.bm in bk.WG_BM and p.bn in bk.WG_BN
        assert 2 <= p.stages <= bk.WG_STAGES
        assert p.stages * (p.bm + p.bn) * bk.WG_BK * 2 <= (
            build.SMEM_LIMIT if len(p.tiles()) <= SMS else bk.WG_TWO_CTA_RING)
        assert (_cover(p) == 1).all()
        # the grid's order: columns fastest, then rows, then the group
        assert p.tiles() == sorted(p.tiles(), key=lambda t: (t[0], t[1],
                                                             t[3]))


@pytest.mark.parametrize("dims", LOWRANK_DIMS + BRANCHED_DIMS)
@pytest.mark.parametrize("misaligned", [frozenset(), frozenset({"x"})])
def test_scratch_regions_are_aligned_and_disjoint(dims, misaligned):
    plan = bk.large_m_plan(dims, SMS, misaligned)
    names = [n for n, _ in plan.regions]
    inter = ["h"] if len(dims) == 4 else ["h1", "h2"]
    assert names[-len(inter):] == inter
    assert set(names[:-len(inter)]) == plan.copies >= misaligned
    offs, sizes = plan.offsets(), plan.region_bytes()
    spans = sorted((offs[n], offs[n] + sizes[n]) for n in names)
    assert all(a % bk.ALIGN == 0 for a, _ in spans)
    assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.scratch_bytes
    for name, shape in plan.regions:
        assert shape[-1] % 8 == 0
    for p in plan.products:
        strides = (p.a_ld, p.a_group, p.b_ld, p.b_group, p.c_group)
        assert all(s % 8 == 0 for s in strides), strides
        assert p.c_ld % 8 == 0 or p.out == "y"


def test_inputs_of_ragged_rows_are_copied():
    """The searched k/v rank 191 makes w0's rows 382 bytes: copied into
    192-wide rows; w1 (191 rows of 512) is read in place."""
    plan = bk.large_m_plan((1024, 2048, 191, 512), SMS)
    assert plan.copies == {"w0"}
    assert dict(plan.regions) == {"w0": (2048, 192), "h": (1024, 192)}
    p1, p2 = plan.products
    assert (p1.b_ld, p1.cols, p1.c_ld) == (192, 191, 192)
    assert (p2.a_ld, p2.k, p2.b_ld) == (192, 191, 512)
    with pytest.raises(ValueError):
        bk.large_m_plan((1024, 2048, 191, 512), SMS, frozenset({"h"}))
    with pytest.raises(ValueError):
        bk.large_m_plan((1024, 0, 191, 512), SMS)


@pytest.mark.parametrize("m", [1, 64, L - 1, L, L + 1, 2000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["lowrank", "branched"])
def test_dispatch_takes_large_m_exactly_at_bf16_past_large_m(
        monkeypatch, kind, dtype, m):
    calls = []
    for mod, name in ((bk, "launch_large_m"), (bk, "_launch_mma"),
                      (bk, "launch_f32"), (bk, "_launch_cluster"),
                      (lk, "_launch_mma"), (lk, "_launch_cluster")):
        monkeypatch.setattr(mod, name, lambda *a, name=name, **k:
                            calls.append(name))
    x = torch.zeros(m, 16, dtype=dtype)
    if kind == "lowrank":
        ws = (torch.zeros(16, 8, dtype=dtype), torch.zeros(8, 24,
                                                           dtype=dtype))
        monkeypatch.setattr(lk, "check_operands",
                            lambda *a: (m, 16, 8, 24))
        mod, fn = lk, lk.lowrank_matmul
    else:
        ws = (torch.zeros(2, 16, 8, dtype=dtype),) * 3
        monkeypatch.setattr(bk, "check_operands",
                            lambda *a: (m, 16, 2, 8, 8, 24))
        mod, fn = bk, bk.branched_matmul
    n0 = mod.launches
    y = fn(x, *ws)
    assert y.shape == (m, 24) and mod.launches == n0 + 1
    want = ("launch_f32" if dtype == torch.float32 else
            "launch_large_m" if m >= L else "_launch_mma")
    assert calls == [want]
    assert bk.chain_form(dtype, m) == {"launch_f32": "f32",
                                       "launch_large_m": "large_m",
                                       "_launch_mma": "split"}[want]


def test_forced_forms_refuse_before_launching(monkeypatch):
    """The uncounted large-M entry refuses f32 and empty factors, and a
    large-M call refuses the split plan's knobs, with nothing launched."""
    calls = []
    monkeypatch.setattr(bk, "launch_large_m", lambda *a: calls.append(a))
    monkeypatch.setattr(bk, "launch_split", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(lk, "check_operands", lambda x, w0, w1: (
        x.shape[0], x.shape[1], w0.shape[1], w1.shape[1]))
    x32 = torch.zeros(L, 16)
    w0, w1 = torch.zeros(16, 8), torch.zeros(8, 24)
    n0 = lk.launches
    with pytest.raises(TypeError):
        lk.large_m_lowrank_matmul(x32, w0, w1)
    xb = x32.bfloat16()
    with pytest.raises(ValueError):
        lk.large_m_lowrank_matmul(xb, torch.zeros(16, 0, dtype=xb.dtype),
                                  torch.zeros(0, 24, dtype=xb.dtype))
    with pytest.raises(ValueError):
        lk.lowrank_matmul_split(xb, w0.bfloat16(), w1.bfloat16(), items=8)
    assert calls == [] and lk.launches == n0


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)


def _mirror(plan: bk.LargeMPlan, operands: dict) -> torch.Tensor:
    """The products of ``plan`` in order, tile by tile as the kernel runs
    them: each tile sums its K blocks of WG_BK (and, for a summing
    product, the branches, branch-major) in f32 from bf16 values, then
    rounds once to bf16.  ``operands``: x and the factors, bf16, named as
    in the plan."""
    vals = {k: t.float() for k, t in operands.items()}
    for p in plan.products:
        a, b = vals[p.a], vals[p.b]
        if b.ndim == 2:
            b = b[None]
        if a.ndim == 2:
            a = a[:, None, :]
        out = torch.zeros(p.m, p.out_groups, p.cols)
        for z, r0, r1, c0, c1 in p.tiles():
            acc = torch.zeros(r1 - r0, c1 - c0)
            for s in range(p.sum_groups):
                g = z + s
                ag = a[r0:r1, g if p.a_groups > 1 else 0]
                for k0 in range(0, p.k, bk.WG_BK):
                    k1 = min(p.k, k0 + bk.WG_BK)
                    acc += ag[:, k0:k1] @ b[g, k0:k1, c0:c1]
            out[r0:r1, z, c0:c1] = acc.to(torch.bfloat16).float()
        vals[p.out] = out[:, 0] if p.out_groups == 1 else out
    return vals["y"]


def _err(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    return float((got - want).abs().max() / want.abs().max())


#: mirror cases: M on both sides of LARGE_M (ragged: not a multiple of the
#: 128-row tile), ragged C, R and S (R not a granule: a copied factor)
_LOWRANK_MIRROR = [(L - 1, 72, 20, 70), (L + 3, 136, 40, 200),
                   (L + 40, 96, 19, 129), (130, 64, 64, 64)]
_BRANCHED_MIRROR = [(L - 5, 72, 3, 20, 24, 70), (L + 1, 40, 2, 16, 9, 130),
                    (2 * L + 7, 64, 4, 8, 8, 66)]


@pytest.mark.parametrize("m,c,r,s", _LOWRANK_MIRROR)
def test_lowrank_mirror_matches_the_reference_and_pallas_interpret(m, c, r,
                                                                   s):
    x = _bf16(np.random.default_rng(m).standard_normal((m, c)))
    w0 = _bf16(factor_weights(m + 1, (c, r)))
    w1 = _bf16(factor_weights(m + 2, (r, s)))
    got = _mirror(bk.large_m_plan((m, c, r, s), SMS),
                  {"x": x, "w0": w0, "w1": w1})
    jx, j0, j1 = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (x, w0, w1))
    assert _err(got, jref.lowrank_matmul_ref(jx, j0, j1)) <= TOL
    assert _err(got, jops.lowrank_matmul(jx, j0, j1,
                                         force_kernel=True)) <= TOL


@pytest.mark.parametrize("m,c,n,r1,r2,s", _BRANCHED_MIRROR)
def test_branched_mirror_matches_the_reference_and_pallas_interpret(
        m, c, n, r1, r2, s):
    x = _bf16(np.random.default_rng(m).standard_normal((m, c)))
    u = _bf16(factor_weights(m + 1, (n, c, r1)))
    xc = _bf16(factor_weights(m + 2, (n, r1, r2)))
    v = _bf16(factor_weights(m + 3, (n, r2, s)))
    plan = bk.large_m_plan((m, c, n, r1, r2, s), SMS)
    assert plan.products[-1].sum_groups == n
    got = _mirror(plan, {"x": x, "u": u, "xc": xc, "v": v})
    jx, ju, jxc, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (x, u, xc, v))
    assert _err(got, jref.branched_matmul_ref(jx, ju, jxc, jv)) <= TOL
    assert _err(got, jops.branched_matmul(jx, ju, jxc, jv,
                                          force_kernel=True)) <= TOL


def test_the_branch_sum_rounds_once():
    """The mirror sums the branches in f32 inside the K loop and rounds y
    once, as the reference does; rounding each branch's contribution
    first, then their sum, gives other bits at these inputs."""
    m, c, n, r, s = L, 32, 4, 8, 16
    rng = np.random.default_rng(3)
    x = _bf16(rng.standard_normal((m, c)))
    u, xc, v = (_bf16(factor_weights(i, sh)) for i, sh in enumerate(
        ((n, c, r), (n, r, r), (n, r, s))))
    plan = bk.large_m_plan((m, c, n, r, r, s), SMS)
    got = _mirror(plan, {"x": x, "u": u, "xc": xc, "v": v})
    jx, ju, jxc, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                       for t in (x, u, xc, v))
    want = torch.from_numpy(np.array(
        jref.branched_matmul_ref(jx, ju, jxc, jv).astype(jnp.float32)))
    h2 = [((x.float() @ u[i].float()).bfloat16().float()
           @ xc[i].float()).bfloat16().float() for i in range(n)]
    per_branch = sum((h2[i] @ v[i].float()).bfloat16().float()
                     for i in range(n)).bfloat16().float()
    assert _err(got, want) <= 2 ** -8
    assert not torch.equal(per_branch, want)
