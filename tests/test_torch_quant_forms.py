"""B3 (``lowrank_matmul_q``) and B4 (``branched_matmul_q``) on the forms
B1 / B2 run, checked on the CPU: bf16 at M >= LARGE_M_Q on the large-M
form (``csrc/chain_wgmma.cuh``), whose CTAs convert the factors' int8 /
e4m3 tiles to bf16 in registers and cut the K loop of a product whose
tiles leave the card idle into slices; f32 at every M on the f32 form
(``csrc/chain_f32.cu``) reading the factors' bytes too.  The earlier
large-M design (the dequantizing pass, ``csrc/chain_dequant.cu``, then B1
/ B2's products) stays as the card's yardstick.

The kernels run only on the card, so what surrounds them is held here:

* the dequantizing pass, mirrored in torch: ``round(f32(q) * scale)``
  into padded rows, zero past the row's end -- bit-equal to the port's
  plain dequantization (``ref._dq``) and to the JAX reference's, int8 and
  e4m3, to bf16 (round to nearest even) and to f32;
* the plans: the earlier large-M design's (the card's yardstick) gives
  every factor a bf16 region and otherwise B1 / B2's products (the new
  form's plans, its converting stage and its dispatch through the real
  launcher: ``test_torch_quant_large_m.py``); a quantized f32 call keeps
  B1 / B2's plan too, hands each product its factor's scales (v's by
  branch, every r2 rows), copies int8 rows 16 bytes at a time where they
  are whole granules and 4 bytes where they are whole words, and
  dequantizes a factor of other rows (the ResNets' fc rank 335) into f32
  scratch first;
* the arithmetic: a mirror of the converting, sliced mainloop (each stage
  converted as the pass would, each slice summed in f32, the partials
  added in slice order and rounded once) and the pass fed into the f32
  mirror of ``test_torch_f32_chain.py``, held against the reference's
  ``lowrank_matmul_q_ref`` / ``branched_matmul_q_ref`` and its Pallas
  kernels in interpret mode on the same seeded numpy inputs (bf16 at
  ``KERNEL_TOL["bfloat16"]``, f32 at 1e-4), at ragged M on both sides of
  LARGE_M_Q, at ranks 191 / 335 and at branches a K slice straddles;
* the dispatch, with the launchers stubbed: bf16 below LARGE_M_Q the
  split kernel, at or past it the large-M form, f32 the f32 form at every
  M, f32 B11 / B12 still the cluster kernel; one counted launch a call;
  empty factors refused before any form.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import branched_matmul as bk  # noqa: E402
from repro_torch.kernels import branched_matmul_q as bqk  # noqa: E402
from repro_torch.kernels import branched_matmul_sq as bsk  # noqa: E402
from repro_torch.kernels import lowrank_matmul_q as lqk  # noqa: E402
from repro_torch.kernels import lowrank_matmul_sq as lsk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_f32_chain import _mirror as f32_mirror  # noqa: E402
from test_torch_large_m import _mirror as large_m_mirror  # noqa: E402

torch.set_num_threads(1)

SMS = 132  # SMs of an H100 SXM
L = bk.LARGE_M_Q
QDT = {"int8": np.int8, "fp8": ml_dtypes.float8_e4m3fn}
TORCH_QDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
TOL = chip_smoke.KERNEL_TOL
#: B3 (M, C, R, S) and B4 (M, C, N, r1, r2, S) calls of the kernels
#: phase: the VLM's cross k / v and its prefill rows, zamba2's at M = 512,
#: llama's at decode, the ResNets' fc, the rank past the cluster kernel's
#: 4-row block, and ragged ones
LOWRANK_DIMS = [(1601, 8192, 384, 1024), (512, 8192, 384, 1024),
                (8, 2048, 128, 512), (64, 2048, 128, 512),
                (32, 2048, 335, 1000), (1, 2048, 335, 1000),
                (1024, 2048, 191, 512), (L - 1, 36, 20, 70),
                (3, 33, 5, 70)]
BRANCHED_DIMS = [(512, 2048, 4, 192, 192, 8192),
                 (512, 8192, 4, 768, 768, 28672),
                 (8, 8192, 4, 960, 960, 128256),
                 (128, 28672, 4, 768, 768, 8192),
                 (8, 256, 4, 1600, 1600, 256),
                 (L + 1, 33, 3, 5, 7, 70), (40, 72, 2, 20, 23, 130)]


def _quantized(rng, shape, mode):
    """(q, scale) numpy: int8 / e4m3 values of a factor (K, cols) or stack
    (N, K, cols), one positive f32 scale a (branch and) column."""
    k, cols = shape[-2:]
    if mode == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        q = (rng.standard_normal(shape, np.float32) * 64).astype(QDT[mode])
    scale = (rng.uniform(0.5, 1.5, (*shape[:-2], 1, cols))
             / (64 * k ** 0.5)).astype(np.float32)
    return q, scale


def _torch_q(q: np.ndarray) -> torch.Tensor:
    """A numpy int8 / e4m3 array as the torch tensor of the same bytes."""
    if q.dtype == np.int8:
        return torch.from_numpy(q)
    return torch.from_numpy(q.view(np.uint8)).view(torch.float8_e4m3fn)


def dq_pass(q: torch.Tensor, scale: torch.Tensor, ld: int,
            dtype: torch.dtype) -> torch.Tensor:
    """The dequantizing pass (``csrc/chain_dequant.cu``) on one factor:
    its region of padded rows (..., K, ld), ``round_dtype(f32(q) *
    scale)`` in the first ``cols`` columns (the f32 product rounded to
    nearest, then, for bf16, to nearest even once), zeros after."""
    cols = q.shape[-1]
    assert ld >= cols and ld * torch.finfo(dtype).bits % 128 == 0
    out = torch.zeros((*q.shape[:-1], ld), dtype=dtype)
    out[..., :cols] = (q.to(torch.float32) * scale).to(dtype)
    return out


def _shapes(dims):
    m, c, s = dims[0], dims[1], dims[-1]
    if len(dims) == 4:
        return {"w0": (c, dims[2]), "w1": (dims[2], s)}
    n, r1, r2 = dims[2:5]
    return {"u": (n, c, r1), "xc": (n, r1, r2), "v": (n, r2, s)}


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(64, 96), (37, 191), (2, 33, 335),
                                   (3, 5, 70)])
def test_dequant_pass_is_the_plain_dequantization(shape, dtype, mode):
    """The pass's values are the port's plain dequantization (``ref._dq``)
    and the JAX reference's (``(q.astype(f32) * scale).astype(dtype)``,
    ``repro/kernels/ref.py``) bit for bit; its padding is zero."""
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    qn, sn = _quantized(rng, shape, mode)
    q, sc = _torch_q(qn), torch.from_numpy(sn)
    dt = getattr(torch, dtype)
    per = 8 if dtype == "bfloat16" else 4
    ld = -(-shape[-1] // per) * per
    region = dq_pass(q, sc, ld, dt)
    got = region[..., :shape[-1]]
    assert torch.equal(got, ref._dq(q, sc, dt))
    want = (jnp.asarray(qn).astype(jnp.float32) * jnp.asarray(sn)).astype(
        jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    assert (region[..., shape[-1]:] == 0).all()


@pytest.mark.parametrize("dims", LOWRANK_DIMS + BRANCHED_DIMS)
def test_large_m_quantized_plan_is_b1_b2s_on_regions(dims):
    """The earlier large-M design's plan (chip_smoke's ``prev_ms``): every
    factor in a region of rows padded to whole granules, aligned and
    disjoint, filled by the pass (its spec: 7 integers a factor); the
    products are B1 / B2's tile for tile, each factor read from its
    region."""
    plan = bk.large_m_plan(dims, SMS, quantized=True, dequant=True)
    plain = bk.large_m_plan(dims, SMS)
    shapes = _shapes(dims)
    assert plan.dequant == set(shapes) and plan.copies >= plan.dequant
    offs, sizes = plan.offsets(), plan.region_bytes()
    spans = sorted((offs[n], offs[n] + sizes[n]) for n, _ in plan.regions)
    assert all(a % bk.ALIGN == 0 for a, _ in spans)
    assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))
    regions = dict(plan.regions)
    for name, sh in shapes.items():
        assert regions[name] == sh[:-1] + (-(-sh[-1] // 8) * 8,)
    for p, q in zip(plan.products, plain.products):
        assert p.tiles() == q.tiles()
        assert (p.a, p.b, p.out, p.k, p.bm, p.bn, p.sum_groups) == (
            q.a, q.b, q.out, q.k, q.bm, q.bn, q.sum_groups)
        if p.b in shapes:
            assert p.b_ld == regions[p.b][-1]
            assert p.b_group == p.k * p.b_ld
    names = bk._inputs(dims) + ("y",) + tuple(n for n, _ in plan.regions) \
        + bk._quant_names(dims, True)
    slot = {n: i for i, n in enumerate(names)}
    spec = bk.dequant_spec(dims, plan.regions, plan.dequant, slot)
    assert len(spec) == 7 * len(shapes)
    for i, (name, sh) in enumerate(shapes.items()):
        q, s, out, groups, rows, cols, ld = spec[7 * i:7 * i + 7]
        assert (names[q], names[s], out) == (f"{name}_q", f"{name}_scale",
                                             slot[name])
        assert (groups, rows, cols, ld) == (
            sh[0] if len(sh) == 3 else 1, sh[-2], sh[-1], regions[name][-1])


@pytest.mark.parametrize("dims", LOWRANK_DIMS + BRANCHED_DIMS)
@pytest.mark.parametrize("qcode", [0, 1])
def test_f32_quantized_plan_reads_bytes_and_scales(dims, qcode):
    """A quantized call's f32 plan is B1 / B2's (tiles, K slices,
    intermediates): each product reads its factor's bytes with its scales
    (one a column; v's by branch, every r2 rows), 16 bytes at a time where
    the rows are whole granules, 4 where whole words; a factor of other
    rows is dequantized first into f32 padded rows, read as an f32
    factor."""
    plan = bk.f32_plan(dims, SMS, qcode)
    plain = bk.f32_plan(dims, SMS)
    shapes = _shapes(dims)
    ragged = {f for f, sh in shapes.items() if sh[-1] % 4}
    assert plan.dequant == ragged
    regions = dict(plan.regions)
    assert [n for n, _ in plan.regions][:len(ragged)] == [
        f for f in shapes if f in ragged]
    for f in ragged:
        assert regions[f] == shapes[f][:-1] + (-(-shapes[f][-1] // 4) * 4,)
    assert plan.tickets == plain.tickets
    assert {n: s for n, s in plan.regions if n not in ragged} == dict(
        plain.regions)
    offs, sizes = plan.offsets(), plan.region_bytes()
    spans = sorted((offs[n], offs[n] + sizes[n]) for n, _ in plan.regions)
    assert all(a % bk.ALIGN == 0 for a, _ in spans)
    assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))
    names = bk._inputs(dims) + ("y",) + tuple(n for n, _ in plan.regions) \
        + bk._quant_names(dims, True)
    slot = {n: i for i, n in enumerate(names)}
    for p, q in zip(plan.products, plain.products):
        assert p.tiles() == q.tiles() and p.k_slices() == q.k_slices()
        assert (p.a_ld, p.a_group, p.c_ld, p.c_group) == (
            q.a_ld, q.a_group, q.c_ld, q.c_group)
        spec = p.spec(slot)
        assert len(spec) == 20 and spec[:3] == q.spec(slot)[:3]
        if p.b in ragged:
            assert (p.bq, p.scale, spec[17:]) == (-1, None, (-1, -1, 0))
            assert p.b_ld == regions[p.b][-1] and p.granules()[1]
            continue
        rows = shapes[p.b][-1]
        assert (p.bq, p.scale, p.b_ld) == (qcode, f"{p.b}_scale", rows)
        assert spec[17:] == (qcode, slot[f"{p.b}_scale"], p.s_rows)
        assert p.s_rows == (dims[4] if p.b == "v" else p.k)
        # 16-byte copies where a row is whole granules, else 4-byte ones
        assert p.granules()[1] == (rows % 16 == 0 and p.b_group % 16 == 0)


def test_f32_granule_choice_for_int8_rows():
    """The fc (2,048, 335, 1,000): w0's 335-byte rows are dequantized
    first (no cp.async size fits); w1's 1,000-byte rows go by 4-byte
    copies; llama's k,v (2,048, 128, 512) by 16-byte copies; a rank of 20
    (whole words, not granules) by 4-byte copies."""
    p1, p2 = bk.f32_plan((32, 2048, 335, 1000), SMS, 0).products
    assert (p1.b, p1.bq, p1.b_ld, p1.granules()) == ("w0", -1, 336,
                                                     (True, True))
    assert (p2.b, p2.bq, p2.b_ld, p2.granules()) == ("w1", 0, 1000,
                                                     (True, False))
    for p in bk.f32_plan((8, 2048, 128, 512), SMS, 0).products:
        assert p.bq == 0 and p.granules() == (True, True)
    u, xc, v = bk.f32_plan((40, 72, 2, 20, 24, 130), SMS, 1).products
    assert [p.bq for p in (u, xc, v)] == [1, 1, -1]
    assert u.granules()[1] is False and xc.granules()[1] is False
    assert bk.f32_plan((40, 72, 2, 20, 24, 130), SMS, 1).dequant == {"v"}


def _mirror_inputs(dims, mode, dtype, seed):
    """Seeded numpy x and quantized factors, as torch tensors and as the
    JAX arrays of the same values."""
    rng = np.random.default_rng(seed)
    np_dt = np.float32
    x = rng.standard_normal((dims[0], dims[1])).astype(np_dt)
    facs = {f: _quantized(rng, sh, mode) for f, sh in _shapes(dims).items()}
    xt = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    tq = {f: (_torch_q(q), torch.from_numpy(s)) for f, (q, s) in facs.items()}
    jq = [jnp.asarray(a) for q, s in facs.values() for a in (q, s)]
    return xt, tq, jx, jq


def _err(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    return float((got.float() - want).abs().max() / want.abs().max())


def converting_mirror(plan: bk.LargeMPlan, x: torch.Tensor,
                      factors: dict) -> torch.Tensor:
    """The quantized large-M products of ``plan`` in order, tile by tile
    as the kernel runs them: each iteration's stage (K block ``it % kb`` of
    group ``z + it // kb``) converted to bf16 as the pass converts it
    (asserted), its product summed in f32 into its K slice's partial; the
    partials added in slice order, 0 first, and rounded once to bf16.
    ``factors``: name -> (int8 / e4m3 values, f32 scales)."""
    vals = {"x": x.float()}
    for p in plan.products:
        q, sc = factors[p.b]
        cols = q.shape[-1]
        dq = dq_pass(q, sc, -(-cols // 8) * 8, torch.bfloat16)[
            ..., :cols].float()
        if q.ndim == 2:
            q, sc, dq = q[None], sc[None], dq[None]
        a = vals[p.a]
        if a.ndim == 2:
            a = a[:, None, :]
        kb = -(-p.k // bk.WG_BK)
        out = torch.zeros(p.m, p.out_groups, p.cols)
        for z, r0, r1, c0, c1 in p.tiles():
            parts = []
            for i0, i1 in p.k_slices():
                acc = torch.zeros(r1 - r0, c1 - c0)
                for it in range(i0, i1):
                    g = z + it // kb
                    k0 = (it % kb) * bk.WG_BK
                    k1 = min(p.k, k0 + bk.WG_BK)
                    stage = (q[g, k0:k1, c0:c1].to(torch.float32)
                             * sc[g, :, c0:c1]).to(torch.bfloat16).float()
                    assert torch.equal(stage, dq[g, k0:k1, c0:c1])
                    ag = a[r0:r1, g if p.a_groups > 1 else 0]
                    acc += ag[:, k0:k1] @ stage
                parts.append(acc)
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            out[r0:r1, z, c0:c1] = total.to(torch.bfloat16).float()
        vals[p.out] = out[:, 0] if p.out_groups == 1 else out
    return vals["y"]


#: mirror cases: B3 at rank 191, ragged M on both sides of LARGE_M_Q, its
#: first product K-sliced or not; B4 at ragged ranks, its first product
#: sliced and its last product's slices straddling branches
_MIRROR = [(L - 1, 96, 191, 70), (L + 3, 520, 191, 70),
           (2 * L + 5, 600, 40, 130), (L + 1, 40, 2, 16, 9, 130),
           (L - 5, 600, 4, 20, 150, 130)]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dims", _MIRROR)
def test_large_m_mirror_matches_the_reference_and_pallas_interpret(dims,
                                                                   mode):
    """The converting, K-sliced mainloop's mirror, at ragged M on both
    sides of LARGE_M_Q (the forced entry runs the form below it), against
    the reference's plain chain and its Pallas kernel in interpret mode on
    the same inputs."""
    bf = torch.bfloat16
    x, tq, jx, jq = _mirror_inputs(dims, mode, bf, dims[0] + len(dims))
    plan = bk.large_m_plan(dims, SMS, quantized=True)
    got = converting_mirror(plan, x, tq)
    if len(dims) == 4:
        want = jref.lowrank_matmul_q_ref(jx, *jq)
        kern = jops.lowrank_matmul_q(jx, *jq, force_kernel=True)
    else:
        want = jref.branched_matmul_q_ref(jx, *jq)
        kern = jops.branched_matmul_q(jx, *jq, force_kernel=True)
    assert _err(got, want) <= TOL["bfloat16"]
    assert _err(got, kern) <= TOL["bfloat16"]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dims", [(32, 256, 335, 100), (1, 256, 335, 100),
                                  (9, 96, 191, 70), (8, 128, 4, 24, 40, 96),
                                  (40, 72, 2, 20, 23, 130)])
def test_f32_mirror_matches_the_reference_and_pallas_interpret(dims, mode):
    """The f32 form on quantized factors: each B value is f32(q) * scale
    rounded to nearest (converted in shared memory, or by the pass for a
    factor of ragged rows) -- the pass's f32 mirror -- fed into the
    split-TF32 mirror in the plan's order, against the reference's plain
    chain and its Pallas kernel in interpret mode, at 1e-4."""
    f32 = torch.float32
    x, tq, jx, jq = _mirror_inputs(dims, mode, f32, dims[0] + len(dims))
    plan = bk.f32_plan(dims, SMS, lqk.QDTYPES[TORCH_QDT[mode]])
    ops = {"x": x}
    for f, (q, s) in tq.items():
        ops[f] = dq_pass(q, s, -(-q.shape[-1] // 4) * 4, f32)[
            ..., :q.shape[-1]]
        assert torch.equal(ops[f], ref._dq(q, s, f32))
    got = f32_mirror(plan, ops)
    if len(dims) == 4:
        want = jref.lowrank_matmul_q_ref(jx, *jq)
        kern = jops.lowrank_matmul_q(jx, *jq, force_kernel=True)
    else:
        want = jref.branched_matmul_q_ref(jx, *jq)
        kern = jops.branched_matmul_q(jx, *jq, force_kernel=True)
    assert _err(got, want) <= TOL["float32"]
    assert _err(got, kern) <= TOL["float32"]


_KINDS = {"lowrank_matmul_q": (lqk, lqk.lowrank_matmul_q, 5, (16, 8, 24)),
          "branched_matmul_q": (bqk, bqk.branched_matmul_q, 7,
                                (16, 2, 8, 8, 24))}


@pytest.mark.parametrize("m", [1, 8, bk.LARGE_M, L - 1, L, 1601])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", list(_KINDS))
def test_dispatch_takes_the_form_chain_form_names(monkeypatch, name, dtype,
                                                  m):
    """bf16 below LARGE_M_Q the split-phase kernel (B1 / B2's LARGE_M
    included), at or past it the large-M form, f32 the f32 form at every
    M, each with the factors' scales and storage code; one counted launch
    a call."""
    mod, fn, nargs, sizes = _KINDS[name]
    calls = []
    for launcher in ("launch_f32", "launch_large_m"):
        monkeypatch.setattr(bk, launcher, lambda *a, launcher=launcher, **k:
                            calls.append((launcher, k["scales"],
                                          k["qcode"], k["products"])))
    for launcher in ("_launch_mma", "_launch_cluster"):
        monkeypatch.setattr(mod, launcher, lambda *a, launcher=launcher,
                            **k: calls.append((launcher,)))
    dims = (m, *sizes)
    monkeypatch.setattr(mod, "_check", lambda *a: dims)
    factors = [torch.zeros(1, dtype=torch.float8_e4m3fn), torch.ones(1)] * 3
    n0 = mod.launches
    y = fn(torch.zeros(m, sizes[0], dtype=dtype), *factors[:nargs - 1])
    assert y.shape == (m, sizes[-1]) and mod.launches == n0 + 1
    form = bk.chain_form(dtype, m, quantized=True)
    assert form == ("f32" if dtype == torch.float32 else
                    "large_m" if m >= L else "split")
    assert bk.LARGE_M <= L
    if form == "split":
        assert calls == [("_launch_mma",)]
    else:
        assert calls == [("launch_" + form, tuple(factors[1:nargs - 1:2]),
                          1, True)]


@pytest.mark.parametrize("name", ["lowrank_matmul_sq", "branched_matmul_sq"])
def test_f32_sparse_chains_keep_the_cluster_kernel(monkeypatch, name):
    """f32 B11 / B12 (2:4 packs) are not this form's: they still take the
    cluster kernel (ROADMAP B-7)."""
    mod = {"lowrank_matmul_sq": lsk, "branched_matmul_sq": bsk}[name]
    nargs, dims = ((7, (8, 16, 8, 24)) if name == "lowrank_matmul_sq"
                   else (9, (8, 16, 2, 8, 8, 24)))
    calls = []
    for launcher in ("_launch_cluster", "_launch_mma"):
        monkeypatch.setattr(mod, launcher, lambda *a, launcher=launcher,
                            **k: calls.append(launcher))
    for launcher in ("launch_f32", "launch_large_m"):
        monkeypatch.setattr(bk, launcher, lambda *a, launcher=launcher,
                            **k: calls.append(launcher))
    monkeypatch.setattr(mod, "_check", lambda *a: dims)
    n0 = mod.launches
    getattr(mod, name)(torch.zeros(8, 16), *(torch.zeros(1),) * (nargs - 1))
    assert calls == ["_launch_cluster"] and mod.launches == n0 + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [8, L])
def test_empty_factors_are_refused_before_any_form(monkeypatch, m, dtype):
    """C or R of 0 raise before anything is launched, in every form, and
    nothing is counted; the forced entries refuse f32 first."""
    calls = []
    for mod, launcher in ((bk, "launch_f32"), (bk, "launch_large_m"),
                          (lqk, "_launch_mma"), (bqk, "_launch_mma"),
                          (lqk, "_launch_cluster"), (bqk, "_launch_cluster")):
        monkeypatch.setattr(mod, launcher, lambda *a, **k: calls.append(a))
    q8, s = torch.zeros(16, 0, dtype=torch.int8), torch.zeros(1, 0)
    x = torch.zeros(m, 16, dtype=dtype)
    monkeypatch.setattr(lqk, "_check", lambda *a: (m, 16, 0, 24))
    monkeypatch.setattr(bqk, "_check", lambda *a: (m, 16, 2, 0, 8, 24))
    n0 = (lqk.launches, bqk.launches)
    with pytest.raises(ValueError):
        lqk.lowrank_matmul_q(x, q8, s, q8, s)
    with pytest.raises(ValueError):
        bqk.branched_matmul_q(x, q8, s, q8, s, q8, s)
    for fn in (lqk.split_lowrank_matmul_q, lqk.large_m_lowrank_matmul_q):
        with pytest.raises(TypeError if dtype == torch.float32
                           else ValueError):
            fn(x, q8, s, q8, s)
    for fn in (bqk.split_branched_matmul_q, bqk.large_m_branched_matmul_q):
        with pytest.raises(TypeError if dtype == torch.float32
                           else ValueError):
            fn(x, q8, s, q8, s, q8, s)
    assert calls == [] and (lqk.launches, bqk.launches) == n0
