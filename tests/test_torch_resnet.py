"""The ResNets (``models/resnet.py``, the paper's own benchmark
architectures) in the port against the reference: forward and surgery.

Every tree is the reference's (``tests/_torch_resnet.py``), bridged into
the port: the dense tree and the paper's Table 3 rows (vanilla LRD,
searched ranks, merged bottlenecks, branched Tucker at N = 2 and 4, the
int8 vanilla tree) give the reference's logits within 1e-5 normalised,
which covers XLA's asymmetric ``SAME`` padding of the stride-2 stem,
convs and -inf max pool.  The port's own surgery on the bridged dense
tree takes the reference's decisions, decision for decision, at smoke
width and, shapes only, at resnet50's full width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_resnet as R
from _torch_resnet import one_thread  # noqa: F401  (autouse fixture)
from repro.configs import registry as jreg
from repro.configs.base import LRDConfig as JLRD
from repro.core import surgery as jsurgery
from repro.models import resnet as jresnet
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LRDConfig
from repro_torch.core import surgery
from repro_torch.layers.plan import build_plan
from repro_torch.models import resnet
from repro_torch.tree import paths


@pytest.fixture
def reference_on_h100(monkeypatch):
    import functools
    from repro.core import cost_model as jcm
    for name in R.BOUND:
        monkeypatch.setattr(jcm, name, functools.partial(
            getattr(jcm, name), spec=R.J_H100))


def port_model():
    return resnet.ResNetModel(R.cfg("torch"), "cpu")


def port_axes():
    return port_model().init(torch.Generator().manual_seed(0))[1]


@pytest.mark.parametrize("name", R.TREES)
def test_forward_equals_reference(name):
    x = R.images(3)["images"]
    want = np.asarray(R.jax_forward()(R.jax_tree(name), jnp.asarray(x)))
    m = port_model()
    with torch.no_grad():
        got = m.forward(R.torch_tree(name), torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    assert R.norm_err(got.numpy(), want) <= 1e-5
    assert m.layer_count(R.torch_tree(name)) == \
        R.jax_model().layer_count(R.jax_tree(name))


def test_axes_equal_reference():
    assert port_axes() == R.jax_dense()[1]


def test_tree_kinds_cover_every_conv_path():
    """The trees hold what the forward test means to cover: SVD 1x1 convs
    and a Tucker 3x3, branched Tucker at N = 2 and 4, merged bottlenecks
    back at the original layer count, int8 Tucker cores."""
    def kinds(name):
        blk = R.torch_tree(name)["stage2"]["block0"]
        return {build_plan(blk[k]).kind for k in ("conv1", "conv2")}
    assert kinds("vanilla_lrd") == {"lowrank", "tucker_conv"}
    assert kinds("vanilla_int8") == {"lowrank", "tucker_conv"}
    assert kinds("layer_branching") == {"dense", "branched_tucker_conv"}
    assert kinds("layer_merging") == {"dense"}
    for name, n in (("layer_branching", 4), ("branching_n2", 2)):
        assert R.torch_tree(name)["stage2"]["block0"]["conv2"][
            "core"].shape[0] == n
    assert port_model().layer_count(R.torch_tree("layer_merging")) == \
        port_model().layer_count(R.torch_tree("dense")) == 18
    assert "core_q" in R.torch_tree("vanilla_int8")["stage2"]["block0"][
        "conv2"]


def _table(rep):
    return {d.path: (d.label, d.kind, d.rank, d.shape, d.params_before,
                     d.params_after, d.flops_before, d.flops_after,
                     d.reason) for d in rep.decisions}


@pytest.mark.parametrize("name", list(R.TABLE3))
def test_surgery_decisions_equal_reference(name, reference_on_h100):
    """The port's surgery on the bridged dense tree decides as the
    reference's: label, kind, rank, shape, params and FLOPs before and
    after, reason."""
    jparams, jrep = R.decomposed(name)
    with torch.no_grad():
        tp2, _, trep = surgery.decompose_model(
            R.torch_tree("dense"), port_axes(), LRDConfig(**R.TABLE3[name]))
    assert _table(trep) == _table(jrep)
    assert trep.summary() == jrep.summary()
    assert port_model().layer_count(tp2) == \
        R.jax_model().layer_count(jparams)
    assert sorted(p for p, _ in paths(tp2)) == sorted(
        tuple(getattr(k, "key", k) for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(jparams)[0])


def test_surgery_report_kinds():
    """Which decisions the smoke trees take: the stem is never targeted,
    1x1 convs are ``conv1x1`` SVD pairs, 3x3 convs Tucker (branched
    Tucker where the branch ranks reach 8), the fc an SVD pair."""
    by = {d.path: d for d in R.decomposed("vanilla_lrd")[1].decisions}
    assert (by["stem"].label, by["stem"].kind) == ("stem", "skip")
    assert (by["stage0/block0/conv1"].label,
            by["stage0/block0/conv1"].kind) == ("conv1x1", "svd")
    assert by["stage0/block0/conv2"].kind == "tucker"
    assert (by["fc"].label, by["fc"].kind) == ("fc", "svd")
    kinds = {d.kind for d in R.decomposed("layer_branching")[1].decisions}
    assert kinds == {"skip", "tucker", "branched_tucker"}


def _shape_only_factors(monkeypatch):
    """Zero factors of the right shapes in both surgeries: the decisions
    depend on the shapes alone, and a full ResNet's SVDs are slow here."""
    import repro.core.surgery as js
    from repro.core.svd import SVDFactors as JSVD
    from repro.core.tucker import TuckerFactors as JTF
    from repro_torch.core.svd import SVDFactors as TSVD
    from repro_torch.core.tucker import TuckerFactors as TTF

    def factors(lib, svd, tf):
        def decompose_auto(w, rank):
            c, s = w.shape[-2:]
            r = min(rank, c, s)
            return svd(lib.zeros((c, r)), lib.zeros((r, s)))

        def tucker2_decompose(w, r1, r2):
            k, _, c, s = w.shape
            r1, r2 = min(r1, c), min(r2, s)
            return tf(lib.zeros((c, r1)), lib.zeros((k, k, r1, r2)),
                      lib.zeros((r2, s)))
        return decompose_auto, tucker2_decompose
    for mod, fns in ((js, factors(jnp, JSVD, JTF)),
                     (surgery, factors(torch, TSVD, TTF))):
        monkeypatch.setattr(mod, "decompose_auto", fns[0])
        monkeypatch.setattr(mod, "tucker2_decompose", fns[1])


@pytest.mark.parametrize("mode", ["ratio", "search"])
def test_full_resnet50_decisions_equal_reference(mode, monkeypatch,
                                                 reference_on_h100):
    """resnet50 at full width decides as the reference (factors zeroed):
    the vanilla tree has 36 SVD 1x1 convs, 16 Tucker 3x3 convs (the first
    at ranks (38, 38)) and the fc as an SVD pair at rank 335; the search
    on the H100 model keeps the fc at rank 256."""
    _shape_only_factors(monkeypatch)
    lrd = dict(R.BASE, rank_mode=mode)
    tparams, taxes = resnet.ResNetModel(treg.get("resnet50").full,
                                        "meta").init(None)
    # zero-strided zeros: no memory, and numpy's on the reference side
    # (its surgery only reads shapes and sizes with the factors faked)
    jparams = jax.tree.map(lambda t: np.broadcast_to(
        np.float32(0), tuple(t.shape)), tparams)
    _, _, jrep = jsurgery.decompose_model(jparams, taxes, JLRD(**lrd))
    tparams = jax.tree.map(lambda t: torch.zeros(()).expand(t.shape),
                           tparams)
    _, _, trep = surgery.decompose_model(tparams, taxes, LRDConfig(**lrd))
    assert _table(trep) == _table(jrep)
    by = {d.path: d for d in trep.decisions}
    if mode == "ratio":
        kinds = [(d.label, d.kind) for d in trep.decisions]
        assert kinds.count(("conv1x1", "svd")) == 36
        assert kinds.count(("conv", "tucker")) == 16
        assert by["stage0/block0/conv2"].rank == (38, 38)
        assert by["fc"].rank == 335 and by["stem"].kind == "skip"
    else:
        assert by["fc"].rank == 256


@pytest.mark.parametrize("arch,want", [("resnet50", 25.56e6),
                                       ("resnet101", 44.55e6),
                                       ("resnet152", 60.19e6)])
def test_param_counts_match_paper_table1(arch, want):
    """Paper Table 1: 25.56M / 44.55M / 60.19M, as
    ``tests/test_arch_smoke.py`` checks the reference."""
    cfg = treg.get(arch).full
    n = resnet.analytic_param_count(cfg)
    assert abs(n - want) / want < 0.005
    assert n == jresnet.analytic_param_count(jreg.get(arch).full)
    params, _ = resnet.ResNetModel(cfg, "meta").init(None)
    assert sum(t.numel() for _, t in paths(params)) == n


@pytest.mark.parametrize("arch", ["resnet50", "resnet101", "resnet152"])
def test_configs_mirror_reference(arch):
    for which in ("full", "smoke"):
        j = getattr(jreg.get(arch), which)
        t = getattr(treg.get(arch), which)
        for f in ("name", "family", "resnet_width", "num_classes",
                  "img_size", "dtype"):
            assert getattr(t, f) == getattr(j, f), (which, f)
        assert tuple(t.resnet_stage_blocks) == tuple(j.resnet_stage_blocks)
    assert not treg.get(arch).full.has_decode


def test_branched_1x1_tree_refused_naming_the_subtree():
    """Branched 1x1 convs (``{u, xc, v}``, here where ``rank_align=4``
    lets the smoke widths branch them): the reference's forward raises
    ``KeyError: 'core'``, the port's a ValueError naming the first such
    subtree on the forward's path."""
    lrd = dict(R.BASE, compression=1.0001, branches=2, rank_align=4)
    jp, _, jrep = R.bound_surgery(lrd)
    first = next(d.path for d in jrep.decisions
                 if d.label == "conv1x1" and d.kind == "branched")
    x = R.images(1)["images"]
    with pytest.raises(KeyError, match="core"):        # raised while tracing
        R.jax_forward()(jp, jnp.asarray(x))
    with torch.no_grad():
        tp, _, _ = surgery.decompose_model(R.torch_tree("dense"),
                                           port_axes(), LRDConfig(**lrd))
        with pytest.raises(ValueError, match=first):
            port_model().forward(tp, torch.from_numpy(x))


def test_merge_bottleneck_equals_reference_and_leaves_its_input():
    cores = R.torch_tree("dense")
    with torch.no_grad():
        cores, _, _ = surgery.decompose_model(
            cores, port_axes(), LRDConfig(**R.TABLE3["layer_merging"]))
    merged = resnet.merge_bottleneck(cores)
    assert "tucker_u" in cores["stage0"]["block0"]["conv2"]
    blk = merged["stage0"]["block0"]
    assert set(blk["conv2"]) == {"w"}
    r1, r2 = blk["conv2"]["w"].shape[-2:]
    assert blk["conv1"]["w"].shape[-1] == r1
    assert blk["conv3"]["w"].shape[-2] == r2
    assert torch.equal(blk["norm1"]["scale"], torch.ones(r1))
    assert torch.equal(blk["norm2"]["bias"], torch.zeros(r2))
    want = jresnet.merge_bottleneck(R.jnp_tree(
        jax.tree.map(np.asarray, cores)))
    for path, leaf in paths(merged):
        ref = want
        for k in path:
            ref = ref[k]
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-6, err_msg=str(path))
