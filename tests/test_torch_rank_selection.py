"""Algorithm 1 (paper §2.1) in the port against the reference.

``tests/test_rank_selection.py`` replays on the port at the H100 (the
port's default spec) and at the reference's TPU fields.  ``select_rank``
/ ``algorithm1`` give the reference's rank, times and searched ranks on
the same spec fields, and ``decompose_model(rank_mode="search")`` on the
smoke llama gives the reference's decisions and, through its own SVDs,
the reference's logits within the surgery tests' 1e-4.  The reference's
default spec is the TPU's, so its side runs with its cost model bound to
a reference ``HardwareSpec`` carrying the port's H100 numbers.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from _torch_parity import jax_cfg, torch_cfg
from repro.analysis import hw_specs as jhw
from repro.configs.base import LRDConfig as JLRD
from repro.core import cost_model as jcm
from repro.core import rank_selection as jrs
from repro.core import svd as jsvd
from repro.core.surgery import decompose_model as jdecompose
from repro.models.api import get_model as jget_model
from repro_torch import bridge
from repro_torch.analysis import hw_specs as hw
from repro_torch.configs.base import RANK_MODE_SEARCH, LRDConfig
from repro_torch.core import cost_model as cm
from repro_torch.core import rank_selection as rs
from repro_torch.core import svd as tsvd
from repro_torch.core.surgery import decompose_model
from repro_torch.models.api import get_model
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

TPU = hw.HardwareSpec(**dataclasses.asdict(jhw.TPU_V5E))
#: the port's H100 in the reference's class (it has no f32 rate and no
#: L2 field)
J_H100 = jhw.HardwareSpec(**{
    f.name: getattr(hw.H100, f.name)
    for f in dataclasses.fields(jhw.HardwareSpec)})
SPECS = {"h100": hw.H100, "tpu-fields": TPU}
#: each port spec and the reference spec with the same fields
PAIRS = {"h100": (hw.H100, J_H100), "tpu-fields": (TPU, jhw.TPU_V5E)}
spec_ids = pytest.mark.parametrize("spec", list(SPECS.values()),
                                   ids=list(SPECS))


# -- tests/test_rank_selection.py, replayed ---------------------------------

@spec_ids
def test_staircase(spec):
    """t(r) under the tile model is flat within a 128-tile and jumps
    across the boundary (the paper's Fig. 2 cliff)."""
    t = cm.make_model_timer(4096, 2048, 8192, spec=spec)
    assert t(300) == pytest.approx(t(384), rel=0.02)
    assert t(256) < t(257)


@spec_ids
def test_dense_vs_lowrank_crossover(spec):
    big = cm.lowrank_layer_time(4096, 4096, 16384, 1024, spec=spec)
    assert big < cm.dense_layer_time(4096, 4096, 16384, spec=spec)
    small = cm.lowrank_layer_time(4096, 256, 256, 64, spec=spec)
    assert small > cm.dense_layer_time(4096, 256, 256, spec=spec) * 0.9


@spec_ids
def test_branched_core_shrinks_time(spec):
    base = cm.branched_layer_time(4096, 2048, 2048, 1024, 1024, 1,
                                  spec=spec)
    branched = cm.branched_layer_time(4096, 2048, 2048, 1024, 1024, 4,
                                      spec=spec)
    assert branched < base


@spec_ids
def test_finds_tile_boundary(spec):
    """On the stepwise cost model the search returns a tile-aligned rank,
    the closed-form ``align_rank``."""
    m, c, s = 4096, 2048, 8192
    dec = rs.algorithm1(cm.make_model_timer(m, c, s, spec=spec),
                        cm.make_dense_time(m, c, s, spec=spec), 1309, 300)
    assert dec.rank % 128 == 0
    assert dec.rank == rs.align_rank(1309, 128)


@spec_ids
def test_org_when_dense_faster(spec):
    """A memory-bound small layer never wins from decomposition: ORG."""
    m, c, s = 4096, 512, 512
    dec = rs.algorithm1(cm.make_model_timer(m, c, s, spec=spec),
                        cm.make_dense_time(m, c, s, spec=spec), 128, 32)
    assert dec.keep_original


@spec_ids
def test_speedup_reported(spec):
    m, c, s = 4096, 4096, 16384
    dec = rs.algorithm1(cm.make_model_timer(m, c, s, spec=spec),
                        cm.make_dense_time(m, c, s, spec=spec), 1024, 256)
    assert not dec.keep_original
    assert dec.speedup() > 1.0


@given(rank=st.integers(1, 4096))
@settings(max_examples=60, deadline=None)
def test_align_rank_properties(rank):
    r = rs.align_rank(rank, 128)
    assert r >= 8
    assert r <= max(rank, 8)
    if rank >= 128:
        assert r % 128 == 0


@spec_ids
def test_select_rank_modes(spec):
    r_ratio = rs.select_rank(2048, 8192, compression=2.0, mode="ratio")
    r_aligned = rs.select_rank(2048, 8192, compression=2.0, mode="aligned")
    assert r_aligned % 128 == 0
    assert r_aligned <= r_ratio
    r_search = rs.select_rank(
        2048, 8192, compression=2.0, mode=RANK_MODE_SEARCH,
        timer=cm.make_model_timer(4096, 2048, 8192, spec=spec),
        t_dense=cm.make_dense_time(4096, 2048, 8192, spec=spec))
    assert r_search == rs.ORG or r_search % 8 == 0


def test_max_branches_guard():
    assert rs.max_branches(1024) == 8
    assert rs.max_branches(100) == 1


# -- the port against the reference -----------------------------------------

SEARCH_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
                 (5120, 1536), (16384, 5120), (64, 192), (300, 700)]


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("c,s", SEARCH_SHAPES)
def test_search_equals_reference(pair, c, s):
    """select_rank(mode="search") and algorithm1's whole decision (rank,
    times, searched ranks) on the same spec fields."""
    spec, jspec = PAIRS[pair]
    for m in (1, 8, 64, 4096):
        for comp, frac in ((2.0, 0.25), (1.5, 0.5), (3.0, 0.25)):
            kw = dict(compression=comp, mode="search", rank_min_frac=frac,
                      m_tokens=m)
            jkw = dict(kw, timer=jcm.make_model_timer(m, c, s, spec=jspec),
                       t_dense=jcm.make_dense_time(m, c, s, spec=jspec))
            tkw = dict(kw, timer=cm.make_model_timer(m, c, s, spec=spec),
                       t_dense=cm.make_dense_time(m, c, s, spec=spec))
            assert rs.select_rank(c, s, **tkw) == jrs.select_rank(c, s,
                                                                  **jkw)
            if pair == "h100":       # the port's default spec
                assert rs.select_rank(c, s, **kw) == jrs.select_rank(c, s,
                                                                     **jkw)
            r0 = tsvd.ratio_rank(c, s, comp)
            start, r_min, step = rs.search_plan(r0, frac)
            got = rs.algorithm1(tkw["timer"], tkw["t_dense"], start, r_min,
                                step=step)
            want = jrs.algorithm1(jkw["timer"], jkw["t_dense"], start,
                                  r_min, step=step)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_llama_ranks_on_the_h100():
    """The searched ranks of llama3.2-1b's linears at 4,096 rows on the
    H100 spec: q/o 384, k/v 191, gate/up/down 768."""
    got = {(c, s): rs.select_rank(c, s, compression=2.0, mode="search")
           for c, s in ((2048, 2048), (2048, 512), (2048, 8192),
                        (8192, 2048))}
    assert got == {(2048, 2048): 384, (2048, 512): 191,
                   (2048, 8192): 768, (8192, 2048): 768}


def test_algorithm1_flat_timer_takes_largest_fastest_rank():
    dec = rs.algorithm1(lambda r: 1.0, 2.0, 16, 4)
    assert dec == rs.RankDecision(16, 2.0, 1.0, tuple(range(16, 3, -1)))
    assert dataclasses.astuple(dec) == dataclasses.astuple(
        jrs.algorithm1(lambda r: 1.0, 2.0, 16, 4))
    assert rs.algorithm1(lambda r: 3.0, 2.0, 16, 4).keep_original


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown rank mode"):
        rs.select_rank(64, 64, compression=2.0, mode="energy")


# -- svd helpers ------------------------------------------------------------

def test_energy_rank_monotone():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))
    r90 = tsvd.energy_rank(w, 0.90)
    r99 = tsvd.energy_rank(w, 0.99)
    assert r90 <= r99 <= 64


@pytest.mark.parametrize("shape", [(64, 64), (48, 80), (96, 32)])
def test_svd_helpers_equal_reference(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal((shape[0], 8)) @ rng.standard_normal(
        (8, shape[1])) + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    for e in (0.5, 0.9, 0.95, 0.99, 0.999):
        assert tsvd.energy_rank(tw, e) == jsvd.energy_rank(jw, e)
    for r in (1, 4, 8, 16):
        got = tsvd.approximation_error(tw, tsvd.svd_decompose(tw, r))
        want = jsvd.approximation_error(jw, jsvd.svd_decompose(jw, r))
        assert got == pytest.approx(want, rel=1e-4, abs=1e-6)
    c, s = shape
    for r in (1, 7, 32):
        assert tsvd.lowrank_params(c, s, r) == jsvd.lowrank_params(c, s, r)
        assert tsvd.svd_flops_per_row(c, s, r) \
            == jsvd.svd_flops_per_row(c, s, r)
    assert tsvd.dense_flops_per_row(c, s) == jsvd.dense_flops_per_row(c, s)


# -- decompose_model(rank_mode="search") ------------------------------------

#: smoke-llama surgeries where the search keeps some linears dense (ORG)
#: and decomposes others: SVD pairs, branched, a different floor
SURGERY_CASES = [
    dict(m_tokens=64, lrd=dict(min_dim=16)),
    dict(m_tokens=128, lrd=dict(min_dim=16, branches=2, rank_align=8)),
    dict(m_tokens=37, lrd=dict(min_dim=16, compression=1.5,
                               rank_min_frac=0.5)),
    dict(m_tokens=4096, lrd=dict(min_dim=16)),
]


@pytest.fixture
def reference_on_h100(monkeypatch):
    """The reference's cost model with the port's H100 numbers as its
    default spec (its own default is the TPU's)."""
    for name in ("make_model_timer", "make_dense_time"):
        monkeypatch.setattr(jcm, name, functools.partial(
            getattr(jcm, name), spec=J_H100))


@pytest.mark.parametrize("case", SURGERY_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in {"m": c["m_tokens"], **c["lrd"]}.items()))
def test_search_surgery_equals_reference(case, reference_on_h100):
    lrd = dict(enabled=True, rank_mode="search", **case["lrd"])
    jm = jget_model(jax_cfg())
    jparams, jaxes = jm.init(jax.random.PRNGKey(0))
    jp2, _, jrep = jdecompose(jparams, jaxes, JLRD(**lrd),
                              m_tokens=case["m_tokens"])
    tm = get_model(torch_cfg(), "cpu")
    _, taxes = tm.init(torch.Generator().manual_seed(0))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, jparams), "cpu")
    tp2, _, trep = decompose_model(tparams, taxes, LRDConfig(**lrd),
                                   m_tokens=case["m_tokens"])

    def table(rep):
        return {d.path: (d.label, d.kind, d.rank, d.shape, d.params_before,
                         d.params_after, d.flops_before, d.flops_after,
                         d.reason) for d in rep.decisions}
    assert table(trep) == table(jrep)
    assert trep.summary() == jrep.summary()
    kinds = {d.kind for d in trep.decisions}
    if case["m_tokens"] == 4096:
        assert not kinds & {"svd", "branched"}
    else:
        assert "org" in kinds and kinds & {"svd", "branched"}

    toks = np.random.default_rng(1).integers(1, 250, (2, 11)).astype(
        np.int32)
    jl, _ = jm.prefill(jp2, {"tokens": jnp.asarray(toks)},
                       jm.init_cache(2, 16))
    tl, _ = tm.prefill(tp2, {"tokens": torch.from_numpy(toks).long()},
                       tm.init_cache(2, 16))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
