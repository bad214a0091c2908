"""Surgery of the port vs the reference on the same dense smoke tree:
the same decisions (path, kind, rank, params), and reconstructions
``w0 @ w1`` / ``sum u xc v`` within 1e-4 relative (SVD signs are
arbitrary, so factors are compared through their products)."""
import numpy as np
import pytest
import torch

from _torch_parity import jax_tree, to_numpy, torch_cfg
from repro.configs.base import LRDConfig as JLRD
from repro.core import rank_selection as jrs
from repro.core.surgery import decompose_model as jdecompose
from repro_torch import bridge
from repro_torch.configs.base import LRDConfig
from repro_torch.core import rank_selection as rs
from repro_torch.core import svd as tsvd
from repro_torch.core.surgery import decompose_model
from repro_torch.models.lm import LMModel
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

CASES = [
    dict(rank_mode="aligned", rank_align=32, min_dim=48, branches=1),
    dict(rank_mode="aligned", rank_align=32, min_dim=48, branches=4),
    dict(rank_mode="ratio", min_dim=48, branches=1),
    dict(rank_mode="ratio", min_dim=48, branches=4),
    dict(rank_mode="aligned", rank_align=8, min_dim=32, branches=2),
    dict(rank_mode="ratio", compression=3.0, min_dim=32, branches=1),
]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, (*prefix, k)))
        return out
    return {"/".join(prefix): tree}


def _product(node: dict) -> np.ndarray:
    f = {k: np.asarray(v, np.float64) for k, v in node.items()}
    if "w0" in f:
        return f["w0"] @ f["w1"]
    if "xc" in f:
        return np.einsum("...ncr,...nrs,...nso->...co", f["u"], f["xc"],
                         f["v"])
    return f["w"]


def _node(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_decisions_and_reconstructions_match_reference(case):
    jparams, jaxes = jax_tree("dense")
    jp2, _, jrep = jdecompose(jparams, jaxes, JLRD(enabled=True, **case))
    tparams = bridge.to_torch(to_numpy(jparams), "cpu")
    _, taxes = LMModel(torch_cfg(), "cpu").init(
        torch.Generator().manual_seed(0))
    tp2, _, trep = decompose_model(tparams, taxes,
                                   LRDConfig(enabled=True, **case))

    def table(rep):
        return {d.path: (d.label, d.kind, d.rank, d.shape, d.params_before,
                         d.params_after, d.flops_before, d.flops_after)
                for d in rep.decisions}
    assert table(trep) == table(jrep)
    assert trep.summary() == jrep.summary()

    jl, tl = _leaves(to_numpy(jp2)), _leaves(tp2)
    assert jl.keys() == tl.keys()
    for k in jl:
        assert tuple(tl[k].shape) == jl[k].shape, k
    for d in jrep.decomposed:
        want = _product(_node(to_numpy(jp2), d.path))
        got = _product({k: v.numpy() for k, v in
                        _node(tp2, d.path).items()})
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < 1e-4, (d.path, err)


@pytest.mark.parametrize("c,s,alpha", [(64, 64, 2.0), (64, 192, 2.0),
                                       (2048, 8192, 2.0), (2048, 512, 2.0),
                                       (300, 700, 3.0)])
@pytest.mark.parametrize("mode,align", [("ratio", 128), ("aligned", 128),
                                        ("aligned", 32)])
def test_rank_selection_matches_reference(c, s, alpha, mode, align):
    assert rs.select_rank(c, s, compression=alpha, mode=mode, align=align) \
        == jrs.select_rank(c, s, compression=alpha, mode=mode, align=align)


def test_search_mode_waits_for_the_cost_model():
    """The cost model has come: ``search`` runs Algorithm 1 on the H100
    spec and picks the reference's rank on the same spec fields."""
    import dataclasses
    from repro.analysis import hw_specs as jhw
    from repro.core import cost_model as jcm
    from repro_torch.analysis import hw_specs as hw
    spec = jhw.HardwareSpec(**{
        f.name: getattr(hw.H100, f.name)
        for f in dataclasses.fields(jhw.HardwareSpec)})
    for c, s in ((64, 64), (2048, 512)):
        want = jrs.select_rank(
            c, s, compression=2.0, mode="search",
            timer=jcm.make_model_timer(4096, c, s, spec=spec),
            t_dense=jcm.make_dense_time(4096, c, s, spec=spec))
        assert rs.select_rank(c, s, compression=2.0, mode="search") == want
    assert rs.select_rank(2048, 512, compression=2.0, mode="search") == 191


def test_randomized_svd_error_bound():
    rng = np.random.default_rng(0)
    # exactly rank-16 matrix: the randomized range finder recovers it
    w = (rng.standard_normal((96, 16)) @ rng.standard_normal((16, 80))
         ).astype(np.float32)
    f = tsvd.randomized_svd(torch.from_numpy(w), 16)
    rel = np.linalg.norm(tsvd.reconstruct(f).numpy() - w) / np.linalg.norm(w)
    assert rel < 1e-4
    assert f.w0.shape == (96, 16) and f.w1.shape == (16, 80)
