"""The kernels' plain versions vs the reference's oracles and vs the
Pallas kernels (interpret mode on the CPU), on the same numpy inputs.

Tolerances: f32 at rtol = atol = 1e-5 (the same products summed in
another order); bf16 compared in f32 at 2e-2 (intermediates round to
bf16 in both, so a last-bit difference in an f32 partial sum can flip
one rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

C, S = 48, 200            # S is not a multiple of 128

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a).astype(JDT[dtype]),
            torch.from_numpy(a).to(TDT[dtype]))


def _close(got: torch.Tensor, want, dtype: str):
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [8, 32])
@pytest.mark.parametrize("m", [1, 8, 37])
def test_lowrank_plain_matches_reference_and_pallas(m, r, dtype):
    rng = np.random.default_rng(m * 100 + r)
    x, tx = _pair(rng.standard_normal((m, C), np.float32), dtype)
    w0, tw0 = _pair(rng.standard_normal((C, r), np.float32) * C ** -0.5,
                    dtype)
    w1, tw1 = _pair(rng.standard_normal((r, S), np.float32) * r ** -0.5,
                    dtype)
    got = ref.lowrank_matmul_ref(tx, tw0, tw1)
    assert tuple(got.shape) == (m, S)
    _close(got, jref.lowrank_matmul_ref(x, w0, w1), dtype)
    _close(got, jops.lowrank_matmul(x, w0, w1, force_kernel=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("r", [8, 32])
@pytest.mark.parametrize("m", [1, 8, 37])
def test_branched_plain_matches_reference_and_pallas(m, r, n, dtype):
    rng = np.random.default_rng(m * 1000 + r * 10 + n)
    x, tx = _pair(rng.standard_normal((m, C), np.float32), dtype)
    u, tu = _pair(rng.standard_normal((n, C, r), np.float32) * C ** -0.5,
                  dtype)
    xc, txc = _pair(rng.standard_normal((n, r, r), np.float32) * r ** -0.5,
                    dtype)
    v, tv = _pair(rng.standard_normal((n, r, S), np.float32) * r ** -0.5,
                  dtype)
    got = ref.branched_matmul_ref(tx, tu, txc, tv)
    assert tuple(got.shape) == (m, S)
    _close(got, jref.branched_matmul_ref(x, u, xc, v), dtype)
    _close(got, jops.branched_matmul(x, u, xc, v, force_kernel=True), dtype)


def test_ops_flatten_leading_dims_and_keep_cpu_on_plain_path():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 3, C), np.float32))
    w0 = torch.from_numpy(rng.standard_normal((C, 8), np.float32))
    w1 = torch.from_numpy(rng.standard_normal((8, S), np.float32))
    y = ops.lowrank_matmul(x, w0, w1)
    assert tuple(y.shape) == (2, 3, S)
    torch.testing.assert_close(
        y, ref.lowrank_matmul_ref(x.reshape(6, C), w0, w1).reshape(2, 3, S),
        rtol=0, atol=0)
    u = torch.from_numpy(rng.standard_normal((2, C, 8), np.float32))
    xc = torch.from_numpy(rng.standard_normal((2, 8, 8), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 8, S), np.float32))
    yb = ops.branched_matmul(x, u, xc, v)
    torch.testing.assert_close(
        yb, ref.branched_matmul_ref(x.reshape(6, C), u, xc, v).reshape(
            2, 3, S), rtol=0, atol=0)


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import lowrank_matmul as lk
    x = torch.zeros((4, C))
    with pytest.raises(ValueError, match="not a CUDA device"):
        lk.lowrank_matmul(x, torch.zeros((C, 8)), torch.zeros((8, S)))
    with pytest.raises(ValueError, match="not a CUDA device"):
        bk.branched_matmul(x, torch.zeros((2, C, 8)), torch.zeros((2, 8, 8)),
                           torch.zeros((2, 8, S)))
