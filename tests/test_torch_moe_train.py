"""Training parity of the MoE trees (moonshot's smoke config; f32, one
tree built by the port and bridged into the reference): the loss (cross
entropy plus 0.01 x the load-balance loss) and every gradient against
``jax.value_and_grad`` with the §2.2 freeze on and off, on the global
and the grouped dispatch; the freeze mask key for key (DeepSeek-V2's
tree with its unstacked first block too); the surgery's decisions on the
expert banks and shared experts.

Tolerance: the loss within 1e-5 relative, a gradient leaf within 1e-4 of
its largest element (as the dense trees' training parity)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CFG_LRD, copy_tree, flat, smoke_cfg,
                           smoke_port_tree, to_jax, torch_threads)
from repro.configs.base import LRDConfig as JLRD
from repro.core.freezing import trainable_mask as jmask
from repro.core.surgery import decompose_model as jdecompose
from repro.models.api import get_model as jget_model
from repro.models.blocks import BlockOpts as JBlockOpts
from repro_torch.configs.base import LRDConfig
from repro_torch.core import freezing
from repro_torch.core.surgery import decompose_model
from repro_torch.models.api import get_model
from repro_torch.models.blocks import BlockOpts
from repro_torch.train.steps import value_and_grad

TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


def _toks(b=2, s=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name,tree,freeze,groups", [
    ("moonshot-v1-16b-a3b", "svd", False, 4),
    ("moonshot-v1-16b-a3b", "svd", True, 4),
    ("moonshot-v1-16b-a3b", "branched", True, 0),
])
def test_loss_and_grads_match_reference(name, tree, freeze, groups):
    """64 tokens over 4 dispatch groups take the grouped dispatch (16
    tokens a group, 8 experts); groups 0 the global one."""
    toks = _toks()
    tp = copy_tree(smoke_port_tree(name, tree)[0])
    jp = to_jax(tp)
    jm = jget_model(smoke_cfg(name, "jax", moe_dispatch_groups=groups))
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)},
                          opts=JBlockOpts(freeze_factors=freeze)),
        has_aux=True)(jp)
    tm = get_model(smoke_cfg(name, "torch", moe_dispatch_groups=groups),
                   "cpu")
    tl, taux, tg = value_and_grad(
        lambda p, b: tm.loss(p, b, opts=BlockOpts(freeze)),
        freezing.set_requires_grad(tp, freeze=freeze),
        {"tokens": torch.from_numpy(toks)})
    assert float(tl) == pytest.approx(float(jl), rel=TOL)
    assert float(taux["aux"]) == pytest.approx(float(jaux["aux"]), rel=TOL)
    assert float(taux["aux"]) > 0
    jg, tg = flat(jax.tree.map(np.asarray, jg)), flat(tg)
    assert set(jg) == set(tg)
    stopped = [k for k, g in tg.items() if g is None]
    if freeze:
        # the experts' frozen factors are stopped as the reference's
        # _expert_matmul stops them (w0; u, v)
        assert any("/experts/" in k for k in stopped)
        assert all(k.rsplit("/", 1)[1] in ("w0", "u", "v") for k in stopped)
    else:
        assert stopped == []
    for k in stopped:
        assert not np.any(jg[k]), k
    for k, g in tg.items():
        if g is not None:
            _close(g, jg[k], tol=GRAD_TOL)
    assert float(np.abs(tg["blocks/moe/router"].numpy()).max()) > 0


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "deepseek-v2-236b"])
def test_trainable_mask_matches_reference(name):
    tp = smoke_port_tree(name, "branched")[0]
    want = {k: bool(v) for k, v in
            flat(jmask(to_jax(tp), enabled=True)).items()}
    assert flat(freezing.trainable_mask(tp, enabled=True)) == want


def test_surgery_matches_reference():
    """moonshot's dense smoke tree through both surgeries: the same
    labels (``moe_*`` for the banks, ``ffn_*`` for the shared experts),
    kinds, ranks and sizes."""
    name = "moonshot-v1-16b-a3b"
    dense, axes = smoke_port_tree(name, "dense")
    _, _, trep = decompose_model(dense, axes, LRDConfig(**CFG_LRD["branched"]))
    _, _, jrep = jdecompose(to_jax(dense), axes, JLRD(**CFG_LRD["branched"]))
    got = sorted((d.path, d.label, d.kind, d.rank, d.params_after)
                 for d in trep.decisions)
    assert got == sorted((d.path, d.label, d.kind, d.rank, d.params_after)
                         for d in jrep.decisions)
    labels = {d.label for d in trep.decisions}
    assert {"moe_up", "moe_gate", "moe_down", "ffn_up"} <= labels
    tree = smoke_port_tree(name, "branched")[0]
    # expert banks decompose batched over layers and experts
    u = tree["blocks"]["moe"]["experts"]["up"]["u"]
    cfg = smoke_cfg(name, "torch")
    assert u.shape[:3] == (cfg.num_layers, cfg.moe_num_experts, 4)
