"""The plain sparse chains B11 ``lowrank_matmul_sq_ref`` and B12
``branched_matmul_sq_ref`` vs the reference's oracles and its Pallas
kernels (interpret mode on the CPU), on packs made by the reference from
the same numpy weights (some groups keeping their top positions, 2 and
3), with ragged M and S and a leading batch dim; the ``ops`` entries and
the CUDA wrappers' refusal of CPU tensors.

Tolerances: f32 at rtol = atol = 1e-5 (the same exact products summed in
another order); bf16 compared in f32 at 2e-2, as the other chains (an
intermediate that rounds to bf16 in both can differ by one last bit after
a last-bit difference in its f32 sum).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import factor_weights
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.quant import quantize as jq
from repro.quant import sparse as jsp
from repro_torch import bridge
from repro_torch.kernels import ops, ref
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# B11 / B12 plain versions vs the reference's oracle and Pallas kernels
# ---------------------------------------------------------------------------

def _pack(seed, shape, mode, top_rows=True):
    """A factor packed by the reference: (jax triple, torch triple)."""
    w = factor_weights(seed, shape, top_rows)
    jt = jsp.sparsify_array(jnp.asarray(w), mode=mode)
    return jt, tuple(bridge.array_to_tensor(np.asarray(a), "cpu")
                     for a in jt)


def _qpair(seed, shape, mode):
    w = factor_weights(seed, shape)
    jt = jq.quantize_array(jnp.asarray(w), mode)
    return jt, tuple(bridge.array_to_tensor(np.asarray(a), "cpu")
                     for a in jt)


def _x(seed, shape, dtype):
    xa = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return jnp.asarray(xa).astype(JDT[dtype]), \
        torch.from_numpy(xa).to(TDT[dtype])


def _close(got: torch.Tensor, want, dtype: str):
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


C, S = 48, 200            # S is not a multiple of 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m", [1, 8, 37])
def test_lowrank_sq_plain_matches_reference_and_pallas(m, mode, dtype):
    jw0, tw0 = _pack(m, (C, 16), mode)
    jw1, tw1 = _pack(m + 1, (16, S), mode)
    x, tx = _x(m, (m, C), dtype)
    got = ref.lowrank_matmul_sq_ref(tx, *tw0, *tw1)
    assert tuple(got.shape) == (m, S)
    _close(got, jref.lowrank_matmul_sq_ref(x, *jw0, *jw1), dtype)
    _close(got, jops.lowrank_matmul_sq(x, *jw0, *jw1, force_kernel=True),
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m", [1, 8, 37])
def test_branched_sq_plain_matches_reference_and_pallas(m, mode, dtype):
    n, r1, r2 = 3, 8, 12
    ju, tu = _pack(100 + m, (n, C, r1), mode)
    jxc, txc = _qpair(200 + m, (n, r1, r2), mode)
    jv, tv = _pack(300 + m, (n, r2, S), mode)
    x, tx = _x(m, (m, C), dtype)
    got = ref.branched_matmul_sq_ref(tx, *tu, *txc, *tv)
    assert tuple(got.shape) == (m, S)
    _close(got, jref.branched_matmul_sq_ref(x, *ju, *jxc, *jv), dtype)
    _close(got, jops.branched_matmul_sq(x, *ju, *jxc, *jv,
                                        force_kernel=True), dtype)


def test_sq_ops_flatten_leading_dims():
    jw0, tw0 = _pack(1, (C, 16), "int8")
    jw1, tw1 = _pack(2, (16, S), "int8")
    x, tx = _x(3, (2, 3, C), "float32")
    y = ops.lowrank_matmul_sq(tx, *tw0, *tw1)
    assert tuple(y.shape) == (2, 3, S)
    torch.testing.assert_close(y, ref.lowrank_matmul_sq_ref(
        tx.reshape(6, C), *tw0, *tw1).reshape(2, 3, S), rtol=0, atol=0)
    _close(y, jops.lowrank_matmul_sq(x, *jw0, *jw1, force_kernel=True),
           "float32")
    ju, tu = _pack(4, (2, C, 8), "int8")
    jxc, txc = _qpair(5, (2, 8, 8), "int8")
    jv, tv = _pack(6, (2, 8, S), "int8")
    yb = ops.branched_matmul_sq(tx, *tu, *txc, *tv)
    assert tuple(yb.shape) == (2, 3, S)
    _close(yb, jops.branched_matmul_sq(x, *ju, *jxc, *jv,
                                       force_kernel=True), "float32")


def test_sq_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import branched_matmul_sq as bsk
    from repro_torch.kernels import lowrank_matmul_sq as lsk
    _, tw0 = _pack(1, (C, 16), "int8")
    _, tw1 = _pack(2, (16, S), "int8")
    with pytest.raises(ValueError, match="not a CUDA device"):
        lsk.lowrank_matmul_sq(torch.zeros((4, C)), *tw0, *tw1)
    _, tu = _pack(4, (2, C, 8), "int8")
    _, txc = _qpair(5, (2, 8, 8), "int8")
    _, tv = _pack(6, (2, 8, S), "int8")
    with pytest.raises(ValueError, match="not a CUDA device"):
        bsk.branched_matmul_sq(torch.zeros((4, C)), *tu, *txc, *tv)
