"""Training parity of the port against the reference on the CPU (f32
smoke trees: dense, SVD, SVD+branched): the §2.2 freeze mask key for
key, the loss and every leaf's gradient against ``jax.value_and_grad``
with freeze on and off, the remat policies, the explicit backward of the
trees built by the port and bridged into the reference.  (The explicit
backward of the chain kernels: ``test_torch_train_grad.py``.)

Tolerance: f32 on both sides, sums in another order; a gradient leaf
within 1e-4 of its largest element (measured about 2e-6), the loss
within 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (flat, jax_cfg, port_tree, to_jax, torch_cfg,
                          torch_threads)
from repro.core.freezing import trainable_mask as jmask
from repro.models.api import get_model as jget_model
from repro.models.blocks import BlockOpts as JBlockOpts
from repro_torch.core import freezing
from repro_torch.kernels import ref
from repro_torch.models.api import get_model
from repro_torch.models.blocks import BlockOpts
from repro_torch.train.steps import value_and_grad

TREES = ["dense", "svd", "branched"]
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _toks(b=2, s=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _norm_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    d = np.abs(np.asarray(got, np.float64) - want).max()
    return d / max(np.abs(want).max(), 1e-30)


def _fresh(name):
    """A private copy of the port's smoke tree (the cached one is shared)."""
    def copy(t):
        return ({k: copy(v) for k, v in t.items()} if isinstance(t, dict)
                else t.detach().clone())
    return copy(port_tree(name))


def jax_params(name):
    return to_jax(port_tree(name))


def port_grads(name, freeze, toks, remat="none"):
    tm = get_model(torch_cfg(), "cpu")
    tp = freezing.set_requires_grad(_fresh(name), freeze=freeze)
    loss, _, grads = value_and_grad(
        lambda p, b: tm.loss(p, b, opts=BlockOpts(freeze), remat=remat),
        tp, {"tokens": torch.from_numpy(toks)})
    return loss, grads


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("name", TREES)
def test_trainable_mask_matches_reference(name, freeze):
    want = {k: bool(v) for k, v in
            flat(jmask(jax_params(name), enabled=freeze)).items()}
    tp = port_tree(name)
    got = flat(freezing.trainable_mask(tp, enabled=freeze))
    assert got == want
    counts = (freezing.trainable_param_count(tp, freezing.trainable_mask(
        tp, enabled=freeze)), freezing.frozen_param_count(
            tp, freezing.trainable_mask(tp, enabled=freeze)))
    assert counts[0] + counts[1] == sum(v.numel() for v in flat(tp).values())
    # the name rule also freezes the attention v projection (its path
    # holds "v"), the dense tree's included
    assert (counts[1] > 0) == freeze


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("name", TREES)
def test_loss_and_grads_match_reference(name, freeze):
    toks = _toks()
    jm = jget_model(jax_cfg())
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)},
                          opts=JBlockOpts(freeze_factors=freeze)),
        has_aux=True)(jax_params(name))
    tl, tg = port_grads(name, freeze, toks)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    jg, tg = flat(jax.tree.map(np.asarray, jg)), flat(tg)
    assert set(jg) == set(tg)
    stopped = [k for k, g in tg.items() if g is None]
    if freeze and name != "dense":
        # the factors the forward stops: w0 of every SVD pair, u / v of
        # every branched linear; the reference's cotangent there is 0
        assert stopped and all(k.rsplit("/", 1)[1] in ("w0", "u", "v")
                               for k in stopped)
    else:
        assert stopped == []
    for k in stopped:
        assert not np.any(jg[k]), k
    for k, g in tg.items():
        if g is not None:
            assert _norm_err(g.numpy(), jg[k]) <= GRAD_TOL, k


def _count_calls(monkeypatch):
    calls = {"lowrank": 0, "branched": 0}
    for kind in calls:
        orig = getattr(ref, f"{kind}_matmul_ref")

        def counted(*a, _orig=orig, _kind=kind):
            calls[_kind] += 1
            return _orig(*a)
        monkeypatch.setattr(ref, f"{kind}_matmul_ref", counted)
    return calls


@pytest.mark.parametrize("name", ["svd", "branched"])
def test_remat_policies_give_same_gradients(name, monkeypatch):
    """none / dots / full: the same loss and gradients; "full" runs every
    chain forward twice, "dots" keeps the chain outputs (once)."""
    toks = _toks(seed=1)
    calls = _count_calls(monkeypatch)
    out = {}
    for remat in ("none", "dots", "full"):
        before = dict(calls)
        loss, grads = port_grads(name, True, toks, remat)
        out[remat] = (loss, flat(grads),
                      {k: calls[k] - before[k] for k in calls})
    n_none = out["none"][2]
    assert sum(n_none.values()) > 0
    assert out["dots"][2] == n_none
    assert out["full"][2] == {k: 2 * n for k, n in n_none.items()}
    for remat in ("dots", "full"):
        assert float(out[remat][0]) == pytest.approx(float(out["none"][0]),
                                                     rel=1e-6)
        for k, g in out["none"][1].items():
            if g is None:
                assert out[remat][1][k] is None
            else:
                assert _norm_err(out[remat][1][k].numpy(),
                                 g.numpy()) <= 1e-6, (remat, k)


def test_remat_matches_reference_under_full():
    toks = _toks(seed=2)
    jm = jget_model(jax_cfg())
    (jl, _), jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)},
                          opts=JBlockOpts(freeze_factors=True), remat="full"),
        has_aux=True)(jax_params("branched"))
    tl, tg = port_grads("branched", True, toks, "full")
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    jg = flat(jax.tree.map(np.asarray, jg))
    for k, g in flat(tg).items():
        if g is not None:
            assert _norm_err(g.numpy(), jg[k]) <= GRAD_TOL, k
