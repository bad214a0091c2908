"""The explicit backward of the two chain kernels of the training path
(B1 ``lowrank_matmul``, B2 ``branched_matmul``) against autograd of their
plain versions, for every subset of inputs that needs a gradient, in f32
(within 1e-5 of the largest element: the same products summed in another
order) and bf16 (within chip_smoke's KERNEL_TOL of 2e-2: the rank
intermediates round to bf16 in both); the frozen factors' missing
cotangents; the ops' routing under autograd; the serve-only kernels'
refusal under autograd."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import autograd as kgrad
from repro_torch.kernels import ops, ref
from _torch_parity import torch_threads
from test_torch_train import _norm_err, _toks, port_grads


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield

def _rnd(rng, *shape, scale=1.0, dtype=torch.float32):
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            * scale).to(dtype)


def _needs_cases(n):
    """Every non-empty subset of n inputs, as bool tuples."""
    return [tuple(bool(i >> j & 1) for j in range(n))
            for i in range(1, 2 ** n)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("needs", _needs_cases(3))
def test_lowrank_backward_matches_autograd_of_plain(needs, dtype, tol):
    rng = np.random.default_rng(3)
    m, c, r, s = 37, 48, 16, 40
    x = _rnd(rng, m, c, dtype=dtype)
    w0 = _rnd(rng, c, r, scale=c ** -0.5, dtype=dtype)
    w1 = _rnd(rng, r, s, scale=r ** -0.5, dtype=dtype)
    g = _rnd(rng, m, s, dtype=dtype)
    ins = [t.clone().requires_grad_(n) for t, n in zip((x, w0, w1), needs)]
    want = torch.autograd.grad(ref.lowrank_matmul_ref(*ins), [
        t for t in ins if t.requires_grad], g)
    got = kgrad.lowrank_matmul_bwd(g, x, w0, w1, needs)
    assert [d is None for d in got] == [not n for n in needs]
    for d, w in zip([d for d in got if d is not None], want):
        assert d.dtype == w.dtype and d.shape == w.shape
        assert _norm_err(d.float().numpy(), w.float().numpy()) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("needs", _needs_cases(4))
def test_branched_backward_matches_autograd_of_plain(needs, dtype, tol):
    rng = np.random.default_rng(4)
    m, c, n, r1, r2, s = 37, 48, 3, 16, 8, 40
    x = _rnd(rng, m, c, dtype=dtype)
    u = _rnd(rng, n, c, r1, scale=c ** -0.5, dtype=dtype)
    xc = _rnd(rng, n, r1, r2, scale=r1 ** -0.5, dtype=dtype)
    v = _rnd(rng, n, r2, s, scale=r2 ** -0.5, dtype=dtype)
    g = _rnd(rng, m, s, dtype=dtype)
    ins = [t.clone().requires_grad_(k)
           for t, k in zip((x, u, xc, v), needs)]
    want = torch.autograd.grad(ref.branched_matmul_ref(*ins), [
        t for t in ins if t.requires_grad], g)
    got = kgrad.branched_matmul_bwd(g, x, u, xc, v, needs)
    assert [d is None for d in got] == [not k for k in needs]
    for d, w in zip([d for d in got if d is not None], want):
        assert d.dtype == w.dtype and d.shape == w.shape
        assert _norm_err(d.float().numpy(), w.float().numpy()) <= tol


def test_frozen_factors_form_no_cotangent(monkeypatch):
    """Under freeze the chains' backward is asked for no w0 / u / v
    gradient: the Functions see them detached."""
    seen = []
    for name in ("lowrank_matmul_bwd", "branched_matmul_bwd"):
        orig = getattr(kgrad, name)

        def spy(g, *args, needs, _orig=orig, _name=name):
            seen.append((_name, tuple(needs)))
            return _orig(g, *args, needs=needs)
        monkeypatch.setattr(kgrad, name, spy)
    port_grads("branched", True, _toks(seed=5))
    assert {n for n, _ in seen} == {"lowrank_matmul_bwd",
                                    "branched_matmul_bwd"}
    for name, needs in seen:
        if name == "lowrank_matmul_bwd":     # (x, w0, w1)
            assert needs == (True, False, True)
        else:                                # (x, u, xc, v)
            assert needs == (True, False, True, False)


def test_ops_route_grad_calls_through_the_functions():
    rng = np.random.default_rng(6)
    x = _rnd(rng, 2, 5, 24).requires_grad_(True)
    w0, w1 = _rnd(rng, 24, 8), _rnd(rng, 8, 16)
    y = ops.lowrank_matmul(x, w0, w1)
    assert y.shape == (2, 5, 16) and y.requires_grad
    with torch.no_grad():
        assert torch.equal(ops.lowrank_matmul(x, w0, w1), y.detach())
    (dx,) = torch.autograd.grad(y.sum(), [x])
    assert dx.shape == x.shape


def test_serve_only_kernels_raise_under_grad():
    rng = np.random.default_rng(7)
    x = _rnd(rng, 4, 32).requires_grad_(True)
    q = torch.ones(32, 8, dtype=torch.int8)
    q2 = torch.ones(8, 16, dtype=torch.int8)
    sc, sc2 = torch.ones(1, 8), torch.ones(1, 16)
    for fn in (ops.lowrank_matmul_q, ops.lowrank_matmul_qa):
        with pytest.raises(RuntimeError, match="serve-time kernel"):
            fn(x, q, sc, q2, sc2)
        with torch.no_grad():
            assert fn(x, q, sc, q2, sc2).shape == (4, 16)
