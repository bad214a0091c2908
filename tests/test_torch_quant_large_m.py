"""The large-M form of B3 (``lowrank_matmul_q``) and B4
(``branched_matmul_q``) at bf16 M >= LARGE_M_Q, checked on the CPU: its
CTAs read the factors' int8 / e4m3 bytes by TMA, convert each k16 step to
bf16 in registers as wgmma's A operand of the transposed product
(``csrc/chain_wgmma.cuh``) and cut the K loop of a product whose tiles
leave the card idle into slices, summed in slice order by the last CTA of
a tile; no dequantizing pass.

The kernels run only on the card, so what surrounds them is held here:

* the plans: no factor in a bf16 region (int8 copies only for rows that
  are not whole 16-byte granules or a misaligned base), B1 / B2's tiles
  and intermediates, K slices (whole iterations, in order, none empty)
  only where a product's tiles are fewer than the SMs -- at the VLM's k,v
  and zamba2's in_proj,up,gate first products -- and the scratch at the
  VLM's gate,up (M = 512) the intermediates alone;
* the register fragments: the kernel's exact int8 conversion for every
  byte, and each consumer thread's A fragments, load by load from a
  stage's TMA boxes, the pass's values in wgmma's register layout with a
  warp's rows permuted, the accumulators covering the tile once;
* the mainloop's mirror (``test_torch_quant_forms.converting_mirror``):
  bit-equal to the earlier design (the pass, then B1 / B2's products)
  where no product slices, within ``KERNEL_TOL`` of it where some do;
* the dispatch through the real launcher on CPU tensors, the library
  stubbed: no pass, one host call, the factors' storage code, one counted
  launch; the earlier design, forced, runs the pass and counts nothing.
"""
import contextlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from repro_torch.kernels import branched_matmul as bk  # noqa: E402
from repro_torch.kernels import branched_matmul_q as bqk  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import lowrank_matmul_q as lqk  # noqa: E402
from test_torch_large_m import _cover  # noqa: E402
from test_torch_large_m import _mirror as large_m_mirror  # noqa: E402
from test_torch_quant_forms import (  # noqa: E402
    BRANCHED_DIMS, L, LOWRANK_DIMS, SMS, TOL, TORCH_QDT, _MIRROR,
    _mirror_inputs, _quantized, _shapes, _torch_q, converting_mirror,
    dq_pass)

torch.set_num_threads(1)


def _disjoint(plan) -> None:
    """The plan's regions lie at ALIGN-aligned offsets, apart, inside its
    scratch."""
    offs, sizes = plan.offsets(), plan.region_bytes()
    spans = sorted((offs[n], offs[n] + sizes[n]) for n, _ in plan.regions)
    assert all(a % bk.ALIGN == 0 for a, _ in spans)
    assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.scratch_bytes


@pytest.mark.parametrize("dims", LOWRANK_DIMS + BRANCHED_DIMS)
def test_large_m_quantized_plan_reads_the_factors_bytes(dims):
    """A quantized call's large-M plan: no factor in a bf16 region -- an
    int8 copy of padded rows only where its rows are not whole 16-byte
    granules -- regions aligned and disjoint, B1 / B2's intermediates and
    products, on tiles of 64 columns and 128 or 256 rows covering each
    output once; each product reads its factor's bytes in place (strides
    whole granules) with its scales; its K loop in whole iterations, in order,
    none empty, sliced only where its tiles are fewer than the SMs (then
    about two CTAs an SM, a ring that fits two), the partials' region the
    largest sliced product's and a ticket a tile; its spec 23 integers."""
    plan = bk.large_m_plan(dims, SMS, quantized=True)
    plain = bk.large_m_plan(dims, SMS)
    shapes = _shapes(dims)
    ragged = {f for f, sh in shapes.items() if sh[-1] % 16}
    assert plan.dequant == set() and plan.qcopies == ragged
    assert plan.copies == ragged | (plain.copies - set(shapes))
    regions, plain_regions = dict(plan.regions), dict(plain.regions)
    for f in ragged:
        assert regions[f] == shapes[f][:-1] + (-(-shapes[f][-1] // 16) * 16,)
        assert plan.itemsize(f) == 1
    for k in ("x", "h", "h1", "h2"):
        assert regions.get(k) == plain_regions.get(k)
    _disjoint(plan)
    sliced = [p for p in plan.products if p.slices > 1]
    assert ("p" in regions) == bool(sliced)
    if sliced:
        assert regions["p"] == (max(p.partial_floats() for p in sliced),)
        assert plan.tickets == max(len(p.tiles()) for p in sliced)
    names = bk._inputs(dims) + ("y",) + tuple(n for n, _ in plan.regions) \
        + bk._quant_names(dims, True)
    slot = {n: i for i, n in enumerate(names)}
    for p, q in zip(plan.products, plain.products):
        assert q.slices == 1 and q.scale is None
        assert (p.a, p.b, p.out, p.k, p.a_ld, p.a_group, p.c_ld,
                p.c_group) == (q.a, q.b, q.out, q.k, q.a_ld, q.a_group,
                               q.c_ld, q.c_group)
        assert (p.bm, p.bn) in bk.WG_TILES_Q
        assert (_cover(p) == 1).all()
        assert p.scale == f"{p.b}_scale"
        assert p.b_ld == regions.get(p.b, shapes[p.b])[-1]
        assert p.b_ld % 16 == 0 and p.b_group == p.k * p.b_ld
        ranges = p.k_slices()
        assert ranges[0][0] == 0 and ranges[-1][1] == p.iters
        assert all(a < b for a, b in ranges)
        assert all(b == c for (_, b), (c, _) in zip(ranges, ranges[1:]))
        tiles = len(p.tiles())
        # 128-wide tiles: one CTA an SM, at least half the SMs' worth
        slots = SMS if p.bn == 128 else 2 * SMS
        assert p.bn == 64 or 2 * tiles >= SMS
        assert (p.slices > 1) == (2 * tiles < slots and p.iters
                                  >= 2 * bk.WG_MIN_SLICE)
        assert tiles * p.slices <= max(tiles, slots)
        ring = p.stages * (2 * p.bm + p.bn) * bk.WG_BK
        assert 2 <= p.stages <= bk.WG_STAGES and ring <= (
            bk.WG_RING_Q if p.bn == 128 or tiles * p.slices <= SMS
            else bk.WG_TWO_CTA_RING_Q)
        assert bk.WG_RING_Q + 1024 + 16 * bk.WG_STAGES + 16 \
            <= build.SMEM_LIMIT
        # 128-row tiles of 64 columns only where their slices stay long
        if (p.bm, p.bn) == (128, 64):
            assert p.ks >= bk.WG_MIN_ROWS_SLICE
        spec, old = p.spec(slot), q.spec(slot)
        assert len(spec) == 23 and len(old) == 23
        assert spec[:4] == old[:4] and spec[8:16] == old[8:16]
        assert spec[16:19] == (p.bm, p.bn, p.stages)
        assert spec[4:8] == (slot[p.b], p.b_ld, p.b_group, p.b_groups)
        assert old[19:] == (-1, q.iters, -1, 0)
        assert spec[19:] == (slot[p.scale], p.ks,
                             slot["p"] if p.slices > 1 else -1,
                             p.p_ld if p.slices > 1 else 0)


def test_k_slices_where_the_tiles_leave_the_card_idle():
    """Several K slices, about two CTAs an SM, where a product's tiles fill
    less than half the card's slots: the VLM's k,v first product (64 x 64
    tiles: 12 at M = 128, 48 at M = 512, over 128 K blocks; 128 x 64 at
    its cross k / v, M = 1,601: 78) and zamba2's in_proj,up,gate one (M =
    512: 96 of 64 x 64); one slice where 128 x 128 tiles fill half the
    SMs (the VLM's gate,up and down at M = 512), and every call of them
    bit-equal to the earlier design.  B4's last product walks the
    branches: a slice may straddle two.  The scratch at the VLM's gate,up,
    M = 512: the intermediates alone, under 10 MB, against the earlier
    design's 237.5 MB."""
    kv = (8192, 384, 1024)
    for m, tile in ((128, (64, 64)), (512, (64, 64)), (1601, (128, 64))):
        first = bk.large_m_plan((m, *kv), SMS, quantized=True).products[0]
        assert (first.bm, first.bn) == tile
        assert 2 * len(first.tiles()) < 2 * SMS
        assert SMS < len(first.tiles()) * first.slices <= 2 * SMS
    zin = bk.large_m_plan((512, 2048, 4, 192, 192, 8192), SMS,
                          quantized=True).products[0]
    assert len(zin.tiles()) == 96 and zin.slices > 1
    gu = (512, 8192, 4, 768, 768, 28672)
    for dims in (gu, (512, 28672, 4, 768, 768, 8192)):
        plan = bk.large_m_plan(dims, SMS, quantized=True)
        assert [p.slices for p in plan.products] == [1, 1, 1]
        assert [p.bn for p in plan.products] == [128, 128, 128]
    plan = bk.large_m_plan(gu, SMS, quantized=True)
    assert [n for n, _ in plan.regions] == ["h1", "h2"]
    assert plan.scratch_bytes == 2 * 512 * 4 * 768 * 2 < 10e6
    assert bk.large_m_plan(gu, SMS, quantized=True,
                           dequant=True).scratch_bytes == 237_502_464
    v = bk.large_m_plan((260, 72, 4, 20, 150, 130), SMS,
                        quantized=True).products[2]
    blocks = -(-150 // bk.WG_BK)
    assert (v.sum_groups, v.iters) == (4, 4 * blocks) and v.slices > 1
    assert any(a // blocks != (b - 1) // blocks for a, b in v.k_slices())


def test_int8_copies_for_ragged_rows_and_misaligned_bases():
    """The searched rank 191 (191-byte rows of w0) and a ragged S (70-byte
    rows of w1) take int8 copies of 192- / 80-byte rows; a misaligned
    factor's base an int8 copy of its own rows; a misaligned x a bf16
    copy; the earlier design gives every factor a bf16 region."""
    plan = bk.large_m_plan((1024, 2048, 191, 70), SMS, quantized=True)
    assert plan.qcopies == plan.copies == {"w0", "w1"}
    assert dict(plan.regions)["w0"] == (2048, 192)
    assert dict(plan.regions)["w1"] == (191, 80)
    assert plan.region_bytes()["w0"] == 2048 * 192
    plan = bk.large_m_plan((300, 256, 64, 128), SMS,
                           frozenset({"w1", "x"}), quantized=True)
    assert plan.qcopies == {"w1"} and plan.copies == {"w1", "x"}
    assert plan.region_bytes()["x"] == 300 * 256 * 2
    old = bk.large_m_plan((300, 256, 64, 128), SMS, quantized=True,
                          dequant=True)
    assert old.dequant == {"w0", "w1"} and old.qcopies == set()
    with pytest.raises(ValueError):
        bk.large_m_plan((300, 256, 64, 128), SMS, dequant=True)


def _int8_word_to_f32(w: np.ndarray) -> np.ndarray:
    """The kernel's int8 conversion (``pair_to_f32``), byte by byte of
    32-bit words (the lowest first): byte b + 128 as the low mantissa bits
    of 2^23, minus 2^23 + 128, in f32."""
    u = w.astype(np.uint32) ^ np.uint32(0x80808080)
    out = [((u >> np.uint32(8 * j)) & np.uint32(0xFF)) | np.uint32(0x4B000000)
           for j in range(4)]
    return np.stack([o.view(np.float32) - np.float32(8388736.0)
                     for o in out], -1)


def test_int8_conversion_is_exact_for_every_byte():
    """f32 of every int8 value, four a word, as the kernel converts it."""
    b = np.arange(256, dtype=np.uint32)
    words = b | (b[::-1] << 8) | (((b + 7) % 256) << 16) | \
        (((b * 5) % 256) << 24)
    got = _int8_word_to_f32(words)
    want = np.stack([(words >> np.uint32(8 * j)) & np.uint32(0xFF)
                     for j in range(4)], -1).astype(np.uint8).view(np.int8)
    assert np.array_equal(got, want.astype(np.float32))


def _fragments(raw: np.ndarray, bn: int, wg: int, warp: int, lane: int,
               kk: int) -> list:
    """The four 16-bit word pairs ``load_frag`` reads for a k16 step
    (``chain_wgmma.cuh``): the thread's column pair nl = 64 wg + 16 warp +
    2 g at K rows 16 kk + 2 t + (0, 1, 8, 9), from the stage's bytes laid
    out as BN / 16 TMA boxes of 64 rows x 16 bytes (``raw``: the flat
    stage region)."""
    g, t = lane // 4, lane % 4
    nl = 64 * wg + 16 * warp + 2 * g
    base = (nl // 16) * 64 * 16 + nl % 16 + 2 * t * 16 + kk * 256
    return [raw[base + off:base + off + 2] for off in (0, 16, 128, 144)]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("bn,bm", [(64, 256), (64, 128)])
def test_register_fragments_are_the_dequantized_tile(bn, bm, mode):
    """Each consumer thread's A fragments, mirrored load by load as
    ``load_frag`` builds them from a stage's TMA boxes and converted as the
    pass converts (``dq_pass``), are the transposed weight tile in
    mma.m16n8k16's A layout with a warp's rows permuted (row g: column 2g,
    row g + 8: column 2g + 1); and the accumulators' rows and columns (row
    g + 8h: column 2g + h; column 8j + 2t + e: output row) cover the
    bm x bn output tile once, each thread's column pair adjacent."""
    rng = np.random.default_rng(bn + bm)
    qn, sn = _quantized(rng, (64, bn), mode)
    want = dq_pass(_torch_q(qn), torch.from_numpy(sn), bn,
                   torch.bfloat16).float().numpy()
    raw = np.concatenate([qn.view(np.uint8)[:, 16 * j:16 * j + 16].ravel()
                          for j in range(bn // 16)])
    seen = np.zeros((bm, bn), np.int64)
    for wg in range(bn // 64):
        for warp in range(4):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                n = 64 * wg + 16 * warp + 2 * g
                sc = sn[0, n:n + 2]
                for kk in range(4):
                    words = _fragments(raw, bn, wg, warp, lane, kk)
                    vals = [(_torch_q(w.view(qn.dtype)).float()
                             * torch.from_numpy(sc)).to(torch.bfloat16)
                            .float().numpy() for w in words]
                    k = 16 * kk + 2 * t
                    # a[0] (row g: column n, k, k+1), a[1] (row g + 8:
                    # column n + 1), a[2] / a[3] the same at k + 8, k + 9
                    frag = [(vals[0][0], vals[1][0]), (vals[0][1], vals[1][1]),
                            (vals[2][0], vals[3][0]), (vals[2][1], vals[3][1])]
                    slots = [(n, k), (n + 1, k), (n, k + 8), (n + 1, k + 8)]
                    for (a0, a1), (col, kr) in zip(frag, slots):
                        assert (a0, a1) == (want[kr, col], want[kr + 1, col])
                for j in range(bm // 8):
                    for h in range(2):
                        for e in range(2):
                            seen[8 * j + 2 * t + e, n + h] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dims", _MIRROR)
def test_converting_mirror_is_the_pass_where_no_product_slices(dims, mode):
    """Where no product slices (a plan for one SM: its tiles fill it), the
    converting mainloop is bit-equal to the earlier design, the pass fed
    into B1 / B2's large-M mirror; on an H100's 132 SMs the cases of 520
    and 600 columns of x slice, which moves only the order of the f32
    sums: within KERNEL_TOL of it."""
    bf = torch.bfloat16
    x, tq, _, _ = _mirror_inputs(dims, mode, bf, dims[0] + len(dims))
    one = bk.large_m_plan(dims, 1, quantized=True)
    assert all(p.slices == 1 for p in one.products)
    ops = {"x": x}
    for f, (q, s) in tq.items():
        ops[f] = dq_pass(q, s, -(-q.shape[-1] // 8) * 8, bf)[
            ..., :q.shape[-1]]
    old = large_m_mirror(bk.large_m_plan(dims, 1, quantized=True,
                                         dequant=True), ops)
    assert torch.equal(converting_mirror(one, x, tq), old)
    plan = bk.large_m_plan(dims, SMS, quantized=True)
    assert any(p.slices > 1 for p in plan.products) == (dims[1] > 512)
    got = converting_mirror(plan, x, tq)
    assert float((got - old).abs().max() / old.abs().max()) <= TOL[
        "bfloat16"]


class _Lib:
    """The library's two large-M entries, recording their calls."""

    def __init__(self):
        self.calls = []

    def lrk_chain_wgmma(self, n, spec, ptrs, qcode, tickets, n_tickets,
                        stream):
        self.calls.append(("lrk_chain_wgmma", n, list(spec), qcode,
                           n_tickets))
        return 0

    def lrk_dequant_rows(self, n, spec, ptrs, qcode, out_dtype, stream):
        self.calls.append(("lrk_dequant_rows", n))
        return 0


def _stub_card(monkeypatch) -> _Lib:
    """Runs ``launch_large_m`` on CPU tensors: the library, the SM count,
    the tickets and the stream stubbed."""
    lib = _Lib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "tickets", lambda device, n: torch.zeros(
        max(n, 1024), dtype=torch.int32))
    monkeypatch.setattr(bk, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return lib


#: B3 (C, R, S) and B4 (C, N, r1, r2, S) shapes of the dispatch through the
#: real launcher: the VLM's k,v, the searched rank 191 (int8 copies of
#: w0 / w1's rows), zamba2's in_proj,up,gate
_LAUNCHED = [(8192, 384, 1024), (2048, 191, 70), (2048, 4, 192, 192, 8192)]


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m", [L, 1601])
@pytest.mark.parametrize("sizes", _LAUNCHED)
def test_bf16_large_m_call_launches_no_pass(monkeypatch, sizes, m, mode):
    """A bf16 B3 / B4 call at M >= LARGE_M_Q, through the real launcher:
    no dequantizing pass, one host call of the plan's products with the
    factors' storage code and the tickets of its sliced ones, one counted
    launch; the forced earlier design runs the pass, then B1 / B2's
    products (storage code -1), and counts nothing."""
    lib = _stub_card(monkeypatch)
    lowrank = len(sizes) == 3
    mod, fn, prev = (
        (lqk, lqk.lowrank_matmul_q, lqk.prev_large_m_lowrank_matmul_q)
        if lowrank else (bqk, bqk.branched_matmul_q,
                         bqk.prev_large_m_branched_matmul_q))
    dims = (m, *sizes)
    monkeypatch.setattr(mod, "_check", lambda *a: dims)
    shapes = _shapes(dims)
    rng = np.random.default_rng(m)
    args = [torch.zeros(m, dims[1], dtype=torch.bfloat16)]
    for sh in shapes.values():
        qn, sn = _quantized(rng, sh, mode)
        args += [_torch_q(qn), torch.from_numpy(sn)]
    n0 = mod.launches
    y = fn(*args)
    assert y.shape == (m, dims[-1]) and mod.launches == n0 + 1
    plan = bk.large_m_plan(dims, SMS, quantized=True)
    (entry, n, spec, qcode, n_tickets), = lib.calls
    assert (entry, n) == ("lrk_chain_wgmma", len(plan.products))
    assert qcode == lqk.QDTYPES[TORCH_QDT[mode]]
    assert n_tickets >= plan.tickets
    assert spec[20::23] == [p.ks for p in plan.products]
    lib.calls.clear()
    prev(*args)
    assert [c[0] for c in lib.calls] == ["lrk_dequant_rows",
                                         "lrk_chain_wgmma"]
    assert lib.calls[1][3] == -1 and mod.launches == n0 + 1
