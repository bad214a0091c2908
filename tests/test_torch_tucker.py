"""Tucker-2 and branched Tucker (paper Eq. 4-7, 17-20) in the port
against the reference.

Singular vectors differ in sign between ``jnp.linalg.svd`` and
``torch.linalg.svd``, so the decompositions are compared by their
reconstructions (within 1e-5 relative) and their errors; the rank and
accounting helpers are compared for equality.

The weights have a decaying spectrum on both channel modes, as trained
conv weights do.  On white-noise weights adjacent singular values of an
unfolding nearly coincide, and the two libraries' f32 SVDs return bases
rotated within such a cluster: the plain Tucker reconstruction then
differs by up to 2e-5 and the branched one, whose block truncation
depends on the basis and not only on the subspace, by up to 6e-5
(measured on (3, 64, 64) and (3, 128, 128) Gaussian weights).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_resnet import one_thread  # noqa: F401  (autouse fixture)

from repro.core import branching as jbranching
from repro.core import tucker as jtucker
from repro_torch.core import branching, tucker

#: (k, C, S, r1, r2) of the decompositions compared
CASES = [(3, 16, 24, 8, 12), (3, 64, 64, 22, 22), (1, 32, 16, 8, 5),
         (7, 3, 16, 3, 8), (3, 128, 128, 38, 38)]


def _w(seed, k, c, s):
    """A (k, k, C, S) weight whose C and S modes decay by 0.9 a channel."""
    rng = np.random.default_rng(seed)
    core = rng.standard_normal((k, k, c, s)) * (c * k * k) ** -0.5
    qa = np.linalg.qr(rng.standard_normal((c, c)))[0] * 0.9 ** np.arange(c)
    qb = np.linalg.qr(rng.standard_normal((s, s)))[0] * 0.9 ** np.arange(s)
    w = np.einsum("hwcs,dc,ts->hwdt", core, qa, qb, optimize=True)
    return w.astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("k,c,s,r1,r2", CASES)
def test_tucker2_equals_reference(k, c, s, r1, r2):
    w = _w(k * 100 + c, k, c, s)
    jf = jtucker.tucker2_decompose(jnp.asarray(w), r1, r2)
    tf = tucker.tucker2_decompose(torch.from_numpy(w), r1, r2)
    assert [tuple(t.shape) for t in tf] == [a.shape for a in jf]
    assert all(t.dtype == torch.float32 for t in tf)
    got = tucker.reconstruct(tf).numpy()
    assert _rel(got, np.asarray(jtucker.reconstruct(jf))) <= 1e-5
    assert abs(tucker.approximation_error(torch.from_numpy(w), tf)
               - jtucker.approximation_error(jnp.asarray(w), jf)) <= 1e-5
    # U and V have orthonormal columns / rows, as HOSVD's do
    eye = torch.eye(tf.u.shape[1])
    assert torch.allclose(tf.u.t() @ tf.u, eye, atol=1e-5)


def test_full_rank_tucker_is_exact():
    w = _w(7, 3, 16, 24)
    f = tucker.tucker2_decompose(torch.from_numpy(w), 16, 24)
    assert tucker.approximation_error(torch.from_numpy(w), f) <= 1e-5


def test_bf16_weight_keeps_its_dtype():
    w = torch.from_numpy(_w(8, 3, 16, 16)).to(torch.bfloat16)
    f = tucker.tucker2_decompose(w, 8, 8)
    assert {t.dtype for t in f} == {torch.bfloat16}
    assert tucker.reconstruct(f).dtype == torch.bfloat16


@pytest.mark.parametrize("c,s,k", [(64, 64, 3), (128, 128, 3), (256, 256, 3),
                                   (512, 512, 3), (3, 64, 7), (16, 40, 3),
                                   (64, 256, 1)])
@pytest.mark.parametrize("alpha", [1.0001, 1.5, 2.0, 4.0])
def test_ratio_ranks_and_accounting_equal_reference(c, s, k, alpha):
    r1, r2 = tucker.ratio_ranks(c, s, k, alpha)
    assert (r1, r2) == jtucker.ratio_ranks(c, s, k, alpha)
    assert tucker.ratio_ranks(c, s, k, alpha, beta=0.5) == \
        jtucker.ratio_ranks(c, s, k, alpha, beta=0.5)
    assert tucker.tucker2_params(c, s, k, r1, r2) == \
        jtucker.tucker2_params(c, s, k, r1, r2)
    assert tucker.dense_conv_params(c, s, k) == \
        jtucker.dense_conv_params(c, s, k)
    for hw in (7, 56):
        assert tucker.tucker2_flops(c, s, k, r1, r2, hw) == \
            jtucker.tucker2_flops(c, s, k, r1, r2, hw)
        assert tucker.dense_conv_flops(c, s, k, hw) == \
            jtucker.dense_conv_flops(c, s, k, hw)
    if alpha > 1.0:
        assert tucker.tucker2_params(c, s, k, r1, r2) <= \
            tucker.dense_conv_params(c, s, k) / alpha * 1.05 + c + s


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("k,c,s,r1,r2", [(3, 16, 24, 8, 12),
                                         (3, 64, 64, 22, 22),
                                         (3, 64, 96, 32, 48)])
def test_branch_tucker_equals_reference(n, k, c, s, r1, r2):
    w = _w(n * 1000 + c, k, c, s)
    jf = jbranching.branch_tucker(jnp.asarray(w), r1, r2, n)
    tf = branching.branch_tucker(torch.from_numpy(w), r1, r2, n)
    assert [tuple(t.shape) for t in tf] == [a.shape for a in jf]
    got = branching.reconstruct_conv(tf).numpy()
    assert _rel(got, np.asarray(jbranching.reconstruct_conv(jf))) <= 1e-5
    err = branching.branch_error(torch.from_numpy(w), tf)
    assert abs(err - jbranching.branch_error(jnp.asarray(w), jf)) <= 1e-5
    # dropping the off-diagonal blocks costs more than the full core
    full = tucker.tucker2_decompose(torch.from_numpy(w), n * tf.u.shape[-1],
                                    n * tf.v.shape[-2])
    assert err >= tucker.approximation_error(torch.from_numpy(w), full) - 1e-6


@pytest.mark.parametrize("c,s,k,r1,r2,n", [(64, 64, 3, 32, 32, 2),
                                           (256, 256, 3, 128, 128, 4),
                                           (16, 40, 3, 12, 20, 4),
                                           (2048, 1000, 1, 335, 335, 2)])
def test_branched_params_equal_reference(c, s, k, r1, r2, n):
    assert branching.branched_conv_params(c, s, k, r1, r2, n) == \
        jbranching.branched_conv_params(c, s, k, r1, r2, n)
    assert branching.branched_linear_params(c, s, r1, r2, n) == \
        jbranching.branched_linear_params(c, s, r1, r2, n)
    # paper Eq. 18-20: the core shrinks by N
    assert branching.branched_conv_params(c, s, k, r1, r2, n) < \
        tucker.tucker2_params(c, s, k, r1, r2) or n == 1
