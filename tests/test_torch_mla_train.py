"""Training parity of DeepSeek-V2's MLA trees (the smoke config; f32, one
tree built by the port and bridged into the reference): the loss and
every gradient leaf against ``jax.value_and_grad`` of the reference's
``loss``.

Cases: the dense-family MLA stack (``moe_first_dense=0``, no experts) and
the registered tree with its experts (the unstacked ``first`` block with
the dense FFN, then MoE layers; the loss adds 0.01 x the load-balance
loss); the SVD and the branched trees; the §2.2 freeze on and off.

Tolerance: the loss within 1e-5 relative, a gradient leaf within 1e-4 of
its largest element (as ``test_torch_moe_train.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CFG_LRD, copy_tree, flat, smoke_cfg, to_jax,
                           torch_threads)
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
NAME = "deepseek-v2-236b"
#: the dense-family MLA stack: every layer the first layer's dense FFN
NO_EXPERTS = dict(family="dense", moe_num_experts=0, moe_first_dense=0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _cfgs(experts: bool):
    kw = {} if experts else NO_EXPERTS
    return smoke_cfg(NAME, "jax", **kw), smoke_cfg(NAME, "torch", **kw)


_TREES: dict = {}


def _port_tree(experts: bool, tree: str):
    """The port's tree (CPU, seed 0), decomposed with ``CFG_LRD[tree]``;
    a private copy of one cached build."""
    key = (experts, tree)
    if key not in _TREES:
        cfg = _cfgs(experts)[1]
        params, axes = get_model(cfg, "cpu").init(
            torch.Generator().manual_seed(0))
        params, _, rep = decompose_model(params, axes,
                                         LRDConfig(**CFG_LRD[tree]))
        assert rep.decisions
        _TREES[key] = params
    return copy_tree(_TREES[key])


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = np.abs(got.detach().numpy().astype(np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("tree", ["svd", "branched"])
@pytest.mark.parametrize("experts", [False, True])
def test_loss_and_grads_match_reference(experts, tree, freeze):
    toks = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(
        np.int32)
    jcfg, tcfg = _cfgs(experts)
    tp = _port_tree(experts, tree)
    if experts:
        assert "first" in tp and "moe" in tp["blocks"]
    else:
        assert "first" not in tp and "moe" not in tp["blocks"]
    assert "mla" in tp["blocks"]
    jp = to_jax(tp)
    jm = jget_model(jcfg)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)},
                          opts=JBlockOpts(freeze_factors=freeze)),
        has_aux=True))(jp)
    tm = get_model(tcfg, "cpu")
    tl, taux, tg = value_and_grad(
        lambda p, b: tm.loss(p, b, opts=BlockOpts(freeze)),
        freezing.set_requires_grad(tp, freeze=freeze),
        {"tokens": torch.from_numpy(toks)})
    assert float(tl) == pytest.approx(float(jl), rel=TOL)
    if experts:
        assert float(taux["aux"]) == pytest.approx(float(jaux["aux"]),
                                                   rel=TOL)
        assert float(taux["aux"]) > 0
    jg, tg = flat(jax.tree.map(np.asarray, jg)), flat(tg)
    assert set(jg) == set(tg)
    stopped = [k for k, g in tg.items() if g is None]
    if freeze:
        assert stopped
        assert all(k.rsplit("/", 1)[1] in ("w0", "u", "v", "w")
                   for k in stopped), stopped
    else:
        assert stopped == []
    for k in stopped:
        assert not np.any(jg[k]), k
    for k, g in tg.items():
        if g is not None:
            _close(g, jg[k], GRAD_TOL)
    # the latent path carries a gradient into MLA's own projections
    mla = [k for k in tg if "/mla/" in k and tg[k] is not None]
    assert mla and any(float(tg[k].abs().max()) > 0 for k in mla)


def test_dense_and_moe_trees_differ_only_where_expected():
    """The expert tree's MLA stack has one layer fewer than the dense
    one's (the unstacked first block holds the other)."""
    dense = _port_tree(False, "svd")
    moe = _port_tree(True, "svd")
    lead = {k: v.shape[0] for k, v in flat(dense["blocks"]["mla"]).items()}
    got = {k: v.shape[0] for k, v in flat(moe["blocks"]["mla"]).items()}
    assert set(lead) == set(got)
    cfg = _cfgs(True)[1]
    assert set(lead.values()) == {cfg.num_layers}
    assert set(got.values()) == {cfg.num_layers - cfg.moe_first_dense}
