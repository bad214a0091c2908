"""The split-phase branched kernel on quantized (B4) and 2:4-packed (B12)
factors, mirrored item by item in numpy on the CPU.

The kernel runs the work split of ``branched_split`` unchanged and reads
each factor through a weight view of ``csrc/mma_chain.cuh``: DequantB
stages ``round_bf16(f32(q) * scale)``, Sparse24B expands each 2:4 group
into four rows (exactly 0 where pruned).  Phase 3 reads v as one stack
of ``N * r2`` rows, so a row's scale (and, for a pack, its group) comes
from branch ``row // r2``; where r2 is not a multiple of the stage depth
BK, a stage straddles two branches.  The mirror below stages every item
through the same address arithmetic, on the flat arrays, and the three
phases' result is held against the JAX reference's
``branched_matmul_q_ref`` / ``branched_matmul_sq_ref`` on the same seeded
numpy inputs.
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
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import branched_matmul as bk  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SMS = 132  # SMs of an H100 SXM
QDT = {"int8": np.int8, "fp8": ml_dtypes.float8_e4m3fn}
TOL = chip_smoke.KERNEL_TOL["bfloat16"]


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _quantized(rng, shape, mode):
    """(q, scale): values of a factor stack (N, K, cols) in int8 or e4m3
    with one positive f32 scale per branch and column (N, 1, cols)."""
    n, k, cols = shape
    if mode == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        q = (rng.standard_normal(shape, np.float32) * 64).astype(QDT[mode])
    scale = (rng.uniform(0.5, 1.5, (n, 1, cols)) / (64 * k ** 0.5)
             ).astype(np.float32)
    return q, scale


def _packed(rng, shape, mode):
    """(sp, idx, scale): a 2:4 pack of a stack (N, K, cols), slot-major as
    the reference packs it: sp (N, 2, K/4, cols), idx (N, 2, K/4, 1) two
    distinct row positions per group, scale (N, 1, cols)."""
    n, k, cols = shape
    q, scale = _quantized(rng, (n, k // 2, cols), mode)
    sp = q.reshape(n, 2, k // 4, cols)
    pos = np.sort(np.stack([rng.permutation(4)[:2]
                            for _ in range(n * k // 4)]), axis=1)
    idx = pos.reshape(n, k // 4, 2).transpose(0, 2, 1)[..., None]
    return sp, np.ascontiguousarray(idx.astype(np.int8)), scale


class DequantMirror:
    """DequantB on the flat arrays: row k of column c of the stack at
    ``k * ld + c``, its scale at ``(k // R) * ld + c``."""

    def __init__(self, q, scale, ld, rows):
        self.q, self.scale = q.reshape(-1), scale.reshape(-1)
        self.ld, self.R = ld, rows

    def branch(self, n):
        m = DequantMirror(self.q, self.scale, self.ld, self.R)
        m.q = self.q[n * self.R * self.ld:]
        m.scale = self.scale[n * self.ld:]
        return m

    def rows(self, k0, k1, c0, c1):
        out = np.zeros((k1 - k0, c1 - c0), np.float32)
        for k in range(k0, k1):
            b = k // self.R
            vals = self.q[k * self.ld + c0:k * self.ld + c1].astype(
                np.float32)
            s = self.scale[b * self.ld + c0:b * self.ld + c1]
            out[k - k0] = vals * s
        return _bf16(out)


class Sparse24Mirror:
    """Sparse24B on the flat arrays: per branch b, sp (2, R/4, ld) at
    ``b * (R/2) * ld``, idx (2, R/4) at ``b * (R/2)``, scale at
    ``b * ld``; row k is group ``(k - b*R) // 4``, position ``k % 4``,
    the f32 sum of the slots that hold it, else exactly 0."""

    def __init__(self, sp, idx, scale, ld, rows):
        self.sp, self.idx = sp.reshape(-1), idx.reshape(-1)
        self.scale = scale.reshape(-1)
        self.ld, self.R = ld, rows

    def branch(self, n):
        m = Sparse24Mirror(self.sp, self.idx, self.scale, self.ld, self.R)
        m.sp = self.sp[n * (self.R // 2) * self.ld:]
        m.idx = self.idx[n * (self.R // 2):]
        m.scale = self.scale[n * self.ld:]
        return m

    def rows(self, k0, k1, c0, c1):
        assert k0 % 4 == 0 and k1 % 4 == 0, "a group straddles a stage"
        out = np.zeros((k1 - k0, c1 - c0), np.float32)
        for k in range(k0, k1):
            b, r = divmod(k, self.R)
            g = r // 4
            acc = np.zeros(c1 - c0, np.float32)
            for i in range(2):
                at = b * (self.R // 2) + i * (self.R // 4) + g
                if int(self.idx[at]) == k % 4:
                    row = (b * (self.R // 2) + i * (self.R // 4) + g) \
                        * self.ld
                    acc = acc + self.sp[row + c0:row + c1].astype(np.float32)
            out[k - k0] = acc * self.scale[b * self.ld + c0:b * self.ld + c1]
        return _bf16(out)


def _run_phase(sp, phase, a, view):
    """One phase item by item: each item's weight block staged through
    ``view`` a stage (BK rows) at a time, its f32 partial stored per K
    slice, the slices summed in order and rounded to bf16."""
    k, nbr, cols, ks = sp.phase(phase)
    a_br = 0 if phase == 1 else k
    part = np.zeros((sp.slices(phase), a.shape[0], nbr * cols), np.float32)
    straddles = 0
    for b, k0, k1, c0, c1 in sp.items(phase):
        w = view.branch(b)
        blocks = []
        for s0 in range(k0, k1, bk.BK):
            s1 = min(s0 + bk.BK, k1)
            straddles += (s0 // w.R) != ((s1 - 1) // w.R)
            blocks.append(w.rows(s0, s1, c0, c1))
        part[k0 // ks, :, b * cols + c0:b * cols + c1] = \
            a[:, b * a_br + k0:b * a_br + k1] @ np.concatenate(blocks)
    return _bf16(part.sum(0, dtype=np.float32)), straddles


def _run_items(sp, x, u, xc, v):
    """The kernel's three phases in numpy, row block by row block; also
    the number of phase-3 stages that straddle two branches."""
    y = np.zeros((x.shape[0], sp.s), np.float32)
    straddles = 0
    for row0 in range(0, x.shape[0], bk.BM):
        h1, _ = _run_phase(sp, 1, x[row0:row0 + bk.BM], u)
        h2, _ = _run_phase(sp, 2, h1, xc)
        y[row0:row0 + bk.BM], n = _run_phase(sp, 3, h2, v)
        straddles += n
    return y, straddles


def _check(got, want, r2, straddles):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err
    # phase 3 crosses branches inside a stage exactly where r2 % BK != 0
    assert (straddles > 0) == (r2 % bk.BK != 0)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m,n,c,r,s", [(1, 3, 33, 5, 70),
                                       (72, 2, 200, 17, 129),
                                       (9, 4, 1100, 40, 300)])
def test_quantized_items_reproduce_the_reference(m, n, c, r, s, mode):
    rng = np.random.default_rng(m + r)
    x = _bf16(rng.standard_normal((m, c), np.float32))
    (uq, us), (xq, xs), (vq, vs) = (_quantized(rng, shape, mode) for shape
                                    in ((n, c, r), (n, r, r), (n, r, s)))
    sp = bk.branched_split(m, c, n, r, r, s, SMS)
    got, straddles = _run_items(
        sp, x, DequantMirror(uq, us, r, c), DequantMirror(xq, xs, r, r),
        DequantMirror(vq, vs, s, r))
    want = jref.branched_matmul_q_ref(
        jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray,
                                                  (uq, us, xq, xs, vq, vs)))
    _check(got, np.asarray(want.astype(jnp.float32)), r, straddles)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m,n,c,r,s", [(1, 3, 32, 8, 70),
                                       (72, 2, 200, 20, 129),
                                       (9, 4, 1100, 40, 300)])
def test_sparse_items_reproduce_the_reference(m, n, c, r, s, mode):
    rng = np.random.default_rng(m + r)
    x = _bf16(rng.standard_normal((m, c), np.float32))
    u = _packed(rng, (n, c, r), mode)
    xq, xs = _quantized(rng, (n, r, r), mode)
    v = _packed(rng, (n, r, s), mode)
    sp = bk.branched_split(m, c, n, r, r, s, SMS)
    got, straddles = _run_items(
        sp, x, Sparse24Mirror(*u, r, c), DequantMirror(xq, xs, r, r),
        Sparse24Mirror(*v, s, r))
    want = jref.branched_matmul_sq_ref(
        jnp.asarray(x).astype(jnp.bfloat16),
        *map(jnp.asarray, (*u, xq, xs, *v)))
    _check(got, np.asarray(want.astype(jnp.float32)), r, straddles)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_mirrors_address_the_stacks_as_the_port_expands_them(mode):
    """Read as phase 3 reads v -- the whole stack of N*r rows, a row's
    branch r apart, r = 20 so rows of two branches share a stage -- the
    views' address arithmetic gives the port's own dequantized and
    expanded factors: exact zeros at pruned rows, each row its branch's
    scale."""
    from repro_torch.quant.sparse import expand_sparse
    rng = np.random.default_rng(3)
    n, r, s = 3, 20, 70
    q, scale = _quantized(rng, (n, r, s), mode)
    dq = (torch.from_numpy(q.astype(np.float32)) * torch.from_numpy(scale)
          ).to(torch.bfloat16).float().numpy().reshape(n * r, s)
    assert (DequantMirror(q, scale, s, r).rows(0, n * r, 0, s) == dq).all()
    sp, idx, sc = _packed(rng, (n, r, s), mode)
    to_t = (lambda a: torch.from_numpy(a.astype(np.float32)).to(
        torch.float8_e4m3fn)) if mode == "fp8" else torch.from_numpy
    dense = expand_sparse(to_t(sp), torch.from_numpy(idx),
                          torch.from_numpy(sc), torch.bfloat16)
    got = Sparse24Mirror(sp, idx, sc, s, r).rows(0, n * r, 0, s)
    assert (got == dense.float().numpy().reshape(n * r, s)).all()
    assert ((got != 0).reshape(n, r // 4, 4, s).sum(2) <= 2).all()


@pytest.mark.parametrize("kind", list(bk.VIEWS))
def test_split_kernels_fit_two_ctas_per_sm(kind):
    """Each split-phase kernel's tile fits the opt-in limit, and two CTAs
    (with the 1 KB each that the card reserves) fit one SM's 228 KB."""
    smem = bk.mma_smem_bytes(kind)
    assert smem <= build.SMEM_LIMIT
    assert 2 * (smem + 1024) <= 228 * 1024
    assert bk.mma_smem_bytes("bf16") == bk.mma_smem_bytes()
