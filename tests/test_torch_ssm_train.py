"""Training parity of the SSM and hybrid trees (mamba2's and zamba2's
smoke configs; f32, one tree built by the port and bridged into the
reference): the loss and every gradient against ``jax.value_and_grad``
with the §2.2 freeze on and off (the zamba2 shared block's gradient
collects both of its invocations), and the recurrent trunk under
checkpointing.

Tolerance: the loss within 1e-5 relative, a gradient leaf within 1e-4 of
its largest element (as the dense and MoE trees' training parity)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (copy_tree, flat, smoke_cfg, smoke_port_tree,
                           to_jax, torch_threads)
from repro.models.api import get_model as jget_model
from repro.models.blocks import BlockOpts as JBlockOpts
from repro_torch.core import freezing
from repro_torch.models.api import get_model
from repro_torch.models.blocks import BlockOpts
from repro_torch.train.steps import value_and_grad

TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), \
        err / np.abs(want).max()


def _toks(b=2, s=40, seed=0):
    """40 tokens: past the smoke chunk (32), not a multiple of it."""
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name,tree,freeze", [
    ("mamba2-2.7b", "dense", False), ("mamba2-2.7b", "branched", True),
    ("zamba2-1.2b", "svd", False), ("zamba2-1.2b", "branched", True),
])
def test_loss_and_grads_match_reference(name, tree, freeze):
    """One loss and every gradient (the shared block's collects both
    invocations), the §2.2 freeze on and off."""
    toks = _toks()
    tp = copy_tree(smoke_port_tree(name, tree)[0])
    jp = to_jax(tp)
    jm = jget_model(smoke_cfg(name, "jax"))
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)},
                          opts=JBlockOpts(freeze_factors=freeze)),
        has_aux=True)(jp)
    tm = get_model(smoke_cfg(name, "torch"), "cpu")
    tl, taux, tg = value_and_grad(
        lambda p, b: tm.loss(p, b, opts=BlockOpts(freeze)),
        freezing.set_requires_grad(tp, freeze=freeze),
        {"tokens": torch.from_numpy(toks)})
    assert float(tl) == pytest.approx(float(jl), rel=TOL)
    assert float(taux["ce"]) == pytest.approx(float(jaux["ce"]), rel=TOL)
    jg, tg = flat(jax.tree.map(np.asarray, jg)), flat(tg)
    assert set(jg) == set(tg)
    stopped = [k for k, g in tg.items() if g is None]
    assert bool(stopped) == freeze
    for k in stopped:
        assert not np.any(jg[k]), k
    for k, g in tg.items():
        if g is not None:
            _close(g, jg[k], tol=GRAD_TOL)
    assert float(tg["blocks/ssm/a_log"].abs().max()) > 0


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_keeps_the_gradients(remat):
    """The recurrent trunk under checkpointing: the same loss and
    gradients as without."""
    name = "zamba2-1.2b"
    toks = {"tokens": torch.from_numpy(_toks())}
    tm = get_model(smoke_cfg(name, "torch"), "cpu")
    out = {}
    for r in ("none", remat):
        tp = freezing.set_requires_grad(
            copy_tree(smoke_port_tree(name, "branched")[0]), freeze=False)
        out[r] = value_and_grad(lambda p, b: tm.loss(p, b, remat=r), tp,
                                toks)
    assert float(out[remat][0]) == pytest.approx(float(out["none"][0]),
                                                 rel=1e-6)
    want = flat(out["none"][2])
    for k, g in flat(out[remat][2]).items():
        _close(g, want[k].numpy(), tol=1e-5)
