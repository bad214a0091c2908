"""The f32 form of B1 (``lowrank_matmul``) and B2 (``branched_matmul``),
checked on the CPU: its plan
(``repro_torch.kernels.branched_matmul.f32_plan``), the dispatch between
the forms, and its arithmetic mirrored in torch.

The CUDA kernel (``csrc/chain_f32.cu``) runs only on the card, so what
surrounds it is held here:

* the plan: every product's output tiles cover each output element of
  each group exactly once, its K slices cover K in order, every stride of
  an intermediate is a whole number of 16-byte granules and an input
  whose stride is not (the ResNets' fc rank 335) is read by 4-byte copies,
  and the scratch regions are aligned and disjoint;
* the dispatch: f32 B1 / B2 take the f32 form at every M, one counted
  call, and refuse empty factors before anything is launched; f32 B3 /
  B4 / B11 / B12 still take the cluster kernel;
* the arithmetic: a torch mirror of the products in the plan's order --
  each operand split into tf32 hi and lo (``cvt.rna`` emulated on the
  bits), each K slice of each tile summing lo*hi + hi*lo + hi*hi in f32,
  the slices added in order -- held against the reference's plain chain
  and its Pallas kernel in interpret mode (through the reference's
  ``ops`` entry) on the same seeded numpy f32 inputs, at the VLM's
  per-branch ranks 768 / 960 (narrowed widths) and at the fc's (2,048,
  335, 1,000), at ``KERNEL_TOL["float32"]`` (1e-4) normalised as on the
  card (max |a - b| / max |b|).
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
from repro_torch.kernels import branched_matmul_q as bqk  # noqa: E402
from repro_torch.kernels import branched_matmul_sq as bsk  # noqa: E402
from repro_torch.kernels import lowrank_matmul as lk  # noqa: E402
from repro_torch.kernels import lowrank_matmul_q as lqk  # noqa: E402
from repro_torch.kernels import lowrank_matmul_sq as lsk  # noqa: E402

torch.set_num_threads(1)

SMS = 132  # SMs of an H100 SXM
TOL = chip_smoke.KERNEL_TOL["float32"]
#: B1 calls (M, C, R, S): the ResNets' fc (ratio and searched ranks) at
#: M = 32 / 1, the VLM's k / v at decode and its cross k / v over the
#: image tokens, hubert's q,k,v,o, llama's k,v, and ragged ones
LOWRANK_DIMS = [(32, 2048, 335, 1000), (1, 2048, 335, 1000),
                (32, 2048, 256, 1000), (8, 8192, 384, 1024),
                (1601, 8192, 384, 1024), (500, 1280, 256, 1280),
                (37, 2048, 128, 512), (1, 33, 5, 70), (9, 200, 17, 129)]
#: B2 calls (M, C, N, r1, r2, S): the VLM's f32 rows at M = 8 / 128, a
#: rank past the cluster kernel's 4-row block, the family train shapes
#: and ragged ones
BRANCHED_DIMS = [(8, 8192, 4, 768, 768, 28672),
                 (128, 8192, 4, 768, 768, 28672),
                 (8, 28672, 4, 768, 768, 8192),
                 (128, 28672, 4, 768, 768, 8192),
                 (8, 8192, 4, 960, 960, 128256),
                 (128, 8192, 4, 960, 960, 128256),
                 (8, 256, 4, 1600, 1600, 256),
                 (256, 2048, 4, 224, 224, 163840),
                 (500, 1280, 4, 128, 128, 5120),
                 (1, 33, 3, 5, 5, 70), (9, 200, 1, 17, 17, 129),
                 (40, 72, 2, 20, 23, 130)]


def _cover(p: bk.F32Product) -> np.ndarray:
    """How often each output element of each group is written."""
    seen = np.zeros((p.groups, p.m, p.cols), np.uint8)
    for z, r0, r1, c0, c1 in p.tiles():
        assert 0 <= r0 < r1 <= p.m and r1 - r0 <= p.bm
        assert 0 <= c0 < c1 <= p.cols and c1 - c0 <= bk.F32_BN
        seen[z, r0:r1, c0:c1] += 1
    return seen


@pytest.mark.parametrize("dims", LOWRANK_DIMS + BRANCHED_DIMS)
def test_tiles_cover_every_output_once_and_slices_cover_k(dims):
    plan = bk.f32_plan(dims, SMS)
    assert len(plan.products) == (2 if len(dims) == 4 else 3)
    m = dims[0]
    for p in plan.products:
        assert p.bm == min(h for h in bk.F32_BM if m <= h or h == 64)
        assert (_cover(p) == 1).all()
        # the grid's order: rows fastest, then columns, then the group
        assert p.tiles() == sorted(p.tiles(), key=lambda t: (t[0], t[3],
                                                             t[1]))
        # K slices: whole ring stages, in order, end to end, and only
        # where the tiles alone leave SMs idle
        assert p.ks % bk.F32_BK == 0
        ks = p.k_slices()
        assert ks[0][0] == 0 and ks[-1][1] == p.k
        assert all(a < b for a, b in ks)
        assert all(b == c for (_, b), (c, _) in zip(ks, ks[1:]))
        items = len(p.tiles()) * p.slices
        if p.slices > 1:
            assert len(p.tiles()) < bk.F32_ITEMS_PER_SM * SMS
            assert p.ks >= bk.F32_MIN_SLICE
            assert items <= bk.F32_ITEMS_PER_SM * SMS + len(p.tiles())


def test_decode_products_fill_the_card_with_k_slices():
    """At the VLM's gate,up and M = 8 the first two products have 24
    output tiles each and take K slices up to about two items per SM; the
    last one has 224 tiles over K = N*r2 = 3,072 and none."""
    p1, p2, p3 = bk.f32_plan((8, 8192, 4, 768, 768, 28672), SMS).products
    assert (len(p1.tiles()), p1.slices, p1.ks) == (24, 11, 768)
    assert (len(p2.tiles()), p2.slices) == (24, 6)
    assert (len(p3.tiles()), p3.slices, p3.k) == (224, 1, 3072)
    assert p1.bm == p2.bm == p3.bm == 16


@pytest.mark.parametrize("dims", LOWRANK_DIMS + BRANCHED_DIMS)
def test_strides_are_granules_or_read_by_four_bytes(dims):
    """Every intermediate's stride is whole 16-byte granules, so the
    kernel reads it by 16-byte copies; an input is read so where its
    strides are whole granules too, else by 4-byte copies."""
    plan = bk.f32_plan(dims, SMS)
    inter = {name for name, _ in plan.regions}
    for p in plan.products:
        a_vec, b_vec = p.granules()
        if p.a in inter:
            assert a_vec
        want_b = all(s % 4 == 0 for s in (p.b_ld, p.b_group))
        assert b_vec == want_b
    for name, shape in plan.regions:
        assert name == "p" or shape[-1] % 4 == 0


def test_the_fc_rank_335_is_read_by_four_byte_copies():
    """The fc's w0 (2,048, 335) has 1,340-byte rows: its product reads it
    in place by 4-byte copies; h (32, 336) is padded to a granule, and w1
    (335 rows of 1,000) is read by 16-byte copies."""
    p1, p2 = bk.f32_plan((32, 2048, 335, 1000), SMS).products
    assert (p1.b, p1.b_ld, p1.granules()) == ("w0", 335, (True, False))
    assert (p1.out, p1.c_ld, p2.a_ld, p2.k) == ("h", 336, 336, 335)
    assert p2.granules() == (True, True)


@pytest.mark.parametrize("dims", LOWRANK_DIMS + BRANCHED_DIMS)
def test_scratch_regions_are_aligned_and_disjoint(dims):
    plan = bk.f32_plan(dims, SMS)
    names = [n for n, _ in plan.regions]
    inter = ["h"] if len(dims) == 4 else ["h1", "h2"]
    sliced = [p for p in plan.products if p.slices > 1]
    assert names == inter + (["p"] if sliced else [])
    offs, sizes = plan.offsets(), plan.region_bytes()
    spans = sorted((offs[n], offs[n] + sizes[n]) for n in names)
    assert all(a % bk.ALIGN == 0 for a, _ in spans)
    assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.scratch_bytes
    if sliced:
        assert sizes["p"] == 4 * max(p.slices * p.groups * p.m * p.p_ld
                                     for p in sliced)
        assert all(p.p_ld % 4 == 0 and p.p_ld >= p.cols for p in sliced)
        assert plan.tickets == max(len(p.tiles()) for p in sliced)
    else:
        assert plan.tickets == 0


def test_plan_refuses_empty_sizes():
    with pytest.raises(ValueError):
        bk.f32_plan((8, 0, 335, 1000), SMS)
    with pytest.raises(ValueError):
        bk.f32_plan((8, 64, 4, 0, 8, 16), SMS)
    with pytest.raises(ValueError):
        bk.f32_plan((8, 64, 8), SMS)


@pytest.mark.parametrize("m", [1, 8, 127, 128, 1601])
@pytest.mark.parametrize("kind", ["lowrank", "branched"])
def test_f32_takes_the_f32_form_at_every_m(monkeypatch, kind, m):
    calls = []
    for mod, name in ((bk, "launch_f32"), (bk, "launch_large_m"),
                      (bk, "_launch_mma"), (bk, "_launch_cluster"),
                      (lk, "_launch_mma"), (lk, "_launch_cluster")):
        monkeypatch.setattr(mod, name, lambda *a, name=name, **k:
                            calls.append(name))
    x = torch.zeros(m, 16)
    if kind == "lowrank":
        ws = (torch.zeros(16, 8), torch.zeros(8, 24))
        monkeypatch.setattr(lk, "check_operands", lambda *a: (m, 16, 8, 24))
        mod, fn = lk, lk.lowrank_matmul
    else:
        ws = (torch.zeros(2, 16, 8),) * 3
        monkeypatch.setattr(bk, "check_operands",
                            lambda *a: (m, 16, 2, 8, 8, 24))
        mod, fn = bk, bk.branched_matmul
    n0 = mod.launches
    y = fn(x, *ws)
    assert y.shape == (m, 24) and mod.launches == n0 + 1
    assert calls == ["launch_f32"]
    assert bk.chain_form(torch.float32, m) == "f32"


def test_f32_form_refuses_empty_factors_and_plan_knobs(monkeypatch):
    """Empty factors (C or R of 0) raise before anything is launched, as
    in bf16; an f32 B1 call refuses the split plan's knobs."""
    calls = []
    monkeypatch.setattr(bk, "launch_f32", lambda *a: calls.append(a))
    monkeypatch.setattr(lk, "check_operands", lambda x, w0, w1: (
        x.shape[0], x.shape[1], w0.shape[1], w1.shape[1]))
    monkeypatch.setattr(bk, "check_operands", lambda x, u, xc, v: (
        x.shape[0], x.shape[1], u.shape[0], u.shape[2], xc.shape[2],
        v.shape[2]))
    n0, b0 = lk.launches, bk.launches
    with pytest.raises(ValueError):
        lk.lowrank_matmul(torch.zeros(8, 16), torch.zeros(16, 0),
                          torch.zeros(0, 24))
    with pytest.raises(ValueError):
        lk.lowrank_matmul(torch.zeros(8, 0), torch.zeros(0, 8),
                          torch.zeros(8, 24))
    with pytest.raises(ValueError):
        lk.lowrank_matmul_split(torch.zeros(8, 16), torch.zeros(16, 8),
                                torch.zeros(8, 24), items=8)
    with pytest.raises(ValueError):
        bk.branched_matmul(torch.zeros(8, 16), torch.zeros(2, 16, 0),
                           torch.zeros(2, 0, 8), torch.zeros(2, 8, 24))
    assert calls == [] and lk.launches == n0 and bk.launches == b0


_QUANTIZED = {
    "lowrank_matmul_q": (lqk, lqk.lowrank_matmul_q, 5, (8, 16, 8, 24)),
    "lowrank_matmul_sq": (lsk, lsk.lowrank_matmul_sq, 7, (8, 16, 8, 24)),
    "branched_matmul_q": (bqk, bqk.branched_matmul_q, 7,
                          (8, 16, 2, 8, 8, 24)),
    "branched_matmul_sq": (bsk, bsk.branched_matmul_sq, 9,
                           (8, 16, 2, 8, 8, 24))}


@pytest.mark.parametrize("name", list(_QUANTIZED))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_and_sparse_chains_keep_their_forms(monkeypatch, name,
                                                      dtype):
    """f32 B3 / B4 / B11 / B12 still take the cluster kernel (B-7 leaves
    them), bf16 the split-phase kernel: one counted launch each."""
    mod, fn, nargs, dims = _QUANTIZED[name]
    calls = []
    for launcher in ("_launch_cluster", "_launch_mma"):
        monkeypatch.setattr(mod, launcher, lambda *a, launcher=launcher,
                            **k: calls.append(launcher))
    monkeypatch.setattr(mod, "_check", lambda *a: dims)
    n0 = mod.launches
    y = fn(torch.zeros(dims[0], dims[1], dtype=dtype),
           *(torch.zeros(1),) * (nargs - 1))
    assert y.shape == (dims[0], dims[-1]) and y.dtype == dtype
    assert mod.launches == n0 + 1
    assert calls == ["_launch_cluster" if dtype == torch.float32
                     else "_launch_mma"]


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round the f32 bits to 10 mantissa bits, to
    nearest with ties away from zero (finite values)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def test_tf32_rounding_is_cvt_rna():
    """Ties go away from zero; the low 13 bits are cleared; hi + lo keeps
    a to about 2^-22 of its value."""
    one = torch.tensor([1.0])
    tie = (one.view(torch.int32) + 0x1000).view(torch.float32)
    below = (one.view(torch.int32) + 0xFFF).view(torch.float32)
    assert _tf32(tie).item() == 1.0 + 2.0 ** -10
    assert _tf32(-tie).item() == -(1.0 + 2.0 ** -10)
    assert _tf32(below).item() == 1.0
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10_000).astype(np.float32))
    hi, lo = _split(a)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi + lo - a).abs() <= a.abs() * 2.0 ** -21).all()


def _mirror(plan: bk.F32Plan, operands: dict) -> torch.Tensor:
    """The products of ``plan`` in order, as the kernel runs them: each
    operand split into tf32 hi / lo, each K slice of each output tile
    summing lo@hi + hi@lo + hi@hi in f32, the slices' partials added in
    slice order.  ``operands``: x and the factors, f32, named as in the
    plan."""
    vals = dict(operands)
    for p in plan.products:
        a, b = vals[p.a], vals[p.b]
        a = a.reshape(p.m, -1) if a.ndim > 2 else a
        b = b.reshape(p.groups, p.k, p.cols) if b.ndim == 3 else b[None]
        out = torch.zeros(p.m, p.groups, p.cols)
        for z, r0, r1, c0, c1 in p.tiles():
            a0 = z * p.a_group
            total = None
            for k0, k1 in p.k_slices():
                ah, al = _split(a[r0:r1, a0 + k0:a0 + k1])
                bh, bl = _split(b[z if b.shape[0] > 1 else 0, k0:k1, c0:c1])
                part = al @ bh + ah @ bl + ah @ bh
                total = part if total is None else total + part
            out[r0:r1, z, c0:c1] = total
        if p.out == "y":
            vals["y"] = out[:, 0]
        elif p.out == "h2":
            vals["h2"] = out.reshape(p.m, -1)
        else:  # h (M, R) or h1 (M, N, r1): rows padded to a granule
            pad = p.c_group or p.c_ld
            vals[p.out] = torch.nn.functional.pad(
                out, (0, pad - p.cols)).reshape(p.m, -1)
    return vals["y"]


def _err(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    return float((got - want).abs().max() / want.abs().max())


#: mirror cases: the fc, the VLM's per-branch ranks at narrowed widths,
#: and ragged ones (K not a multiple of the slice, a rank not a granule)
_LOWRANK_MIRROR = [(32, 2048, 335, 1000), (1, 2048, 335, 1000),
                   (3, 160, 384, 96), (40, 72, 19, 130)]
_BRANCHED_MIRROR = [(8, 256, 4, 768, 768, 160), (4, 128, 2, 960, 960, 96),
                    (9, 200, 3, 17, 23, 70)]


@pytest.mark.parametrize("m,c,r,s", _LOWRANK_MIRROR)
def test_lowrank_mirror_matches_the_reference_and_pallas_interpret(m, c, r,
                                                                   s):
    x = np.random.default_rng(m).standard_normal((m, c)).astype(np.float32)
    w0 = factor_weights(m + 1, (c, r))
    w1 = factor_weights(m + 2, (r, s))
    plan = bk.f32_plan((m, c, r, s), SMS)
    got = _mirror(plan, {"x": torch.from_numpy(x), "w0": torch.from_numpy(
        w0), "w1": torch.from_numpy(w1)})
    jx, j0, j1 = (jnp.asarray(t) for t in (x, w0, w1))
    assert _err(got, jref.lowrank_matmul_ref(jx, j0, j1)) <= TOL
    assert _err(got, jops.lowrank_matmul(jx, j0, j1,
                                         force_kernel=True)) <= TOL


@pytest.mark.parametrize("m,c,n,r1,r2,s", _BRANCHED_MIRROR)
def test_branched_mirror_matches_the_reference_and_pallas_interpret(
        m, c, n, r1, r2, s):
    x = np.random.default_rng(m).standard_normal((m, c)).astype(np.float32)
    u = factor_weights(m + 1, (n, c, r1))
    xc = factor_weights(m + 2, (n, r1, r2))
    v = factor_weights(m + 3, (n, r2, s))
    plan = bk.f32_plan((m, c, n, r1, r2, s), SMS)
    assert plan.products[-1].k == n * r2 and plan.products[-1].groups == 1
    got = _mirror(plan, {k: torch.from_numpy(t) for k, t in
                         (("x", x), ("u", u), ("xc", xc), ("v", v))})
    jx, ju, jxc, jv = (jnp.asarray(t) for t in (x, u, xc, v))
    assert _err(got, jref.branched_matmul_ref(jx, ju, jxc, jv)) <= TOL
    assert _err(got, jops.branched_matmul(jx, ju, jxc, jv,
                                          force_kernel=True)) <= TOL


def test_the_mirror_needs_the_split():
    """One tf32 product a term (plain TF32) misses 1e-4 at the fc's
    shape, where the split holds it: the low half is what keeps f32's
    tolerance."""
    m, c, r, s = 32, 2048, 335, 1000
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m, c)).astype(np.float32))
    w0 = torch.from_numpy(factor_weights(1, (c, r)))
    w1 = torch.from_numpy(factor_weights(2, (r, s)))
    want = (x.double() @ w0.double()) @ w1.double()
    plain = (_tf32(_tf32(x) @ _tf32(w0)) @ _tf32(w1)).double()
    split = _mirror(bk.f32_plan((m, c, r, s), SMS),
                    {"x": x, "w0": w0, "w1": w1}).double()

    def err(a):
        return float((a - want).abs().max() / want.abs().max())
    assert err(plain) > TOL
    assert err(split) <= TOL / 100
