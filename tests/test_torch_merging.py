"""Layer merging (paper §2.3) in the port against the reference.

``TestMerging`` of ``tests/test_branching_merging.py`` replays on the
port; every merge function meets the reference's on the same numpy
inputs (``merge_linear`` within 1e-6 relative; ``merge_attention`` by
its reconstructed products within 1e-4 relative and its errors within
1e-4, since SVD signs differ between the two libraries); and a decoder
block holding a ``merged`` attention subtree, bridged into the
reference, gives the reference's ``apply_block`` within 1e-5 (f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_cfg, to_jax, torch_cfg
from repro.core import merging as jmerging
from repro.models.blocks import apply_block as japply_block
from repro_torch.core import freezing
from repro_torch.core import merging
from repro_torch.layers.param import ParamBuilder
from repro_torch.models.blocks import apply_block, init_block
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield


def _rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def _attn(seed, d, h, hd, scale=0.1):
    return [_rnd(seed + i, *shp, scale=scale) for i, shp in
            enumerate([(d, h * hd)] * 3 + [(h * hd, d)])]


# -- TestMerging of tests/test_branching_merging.py, replayed ---------------

def test_merge_linear_exact():
    a, b = _rnd(0, 32, 8), _rnd(1, 8, 24)
    np.testing.assert_allclose(merging.merge_linear(_t(a), _t(b)).numpy(),
                               a @ b, atol=1e-5)


def test_conv1x1_merges():
    conv1, u = _rnd(2, 1, 1, 16, 32), _rnd(3, 32, 8)
    merged = merging.merge_conv1x1_into_u(_t(conv1), _t(u))
    assert merged.shape == (1, 1, 16, 8)
    np.testing.assert_allclose(merged[0, 0].numpy(), conv1[0, 0] @ u,
                               atol=1e-5)


def test_merged_attention_full_rank_recovers_products():
    """At qk_rank >= head_dim * heads the joint factorization is exact on
    the QK^T and V O products."""
    d, h, hd = 32, 4, 8
    w = [_t(a) for a in _attn(4, d, h, hd)]
    f = merging.merge_attention(*w, num_heads=h, qk_rank=d, vo_rank=d)
    e_qk, e_vo = merging.merged_attention_error(*w, f, h)
    assert e_qk < 1e-4 and e_vo < 1e-4


def test_merged_attention_lowrank_params():
    """Savings regime: rank < head_dim."""
    d, h, hd = 4096, 32, 128
    dense = merging.dense_attention_params(d, h, h, hd)
    merged = merging.merged_attention_params(d, h, 64, 64)
    assert merged < dense // 2


def test_merged_error_decreases_with_rank():
    d, h, hd = 24, 2, 8
    w = [_t(a) for a in _attn(8, d, h, hd, scale=1.0)]
    errs = []
    for r in (4, 12, 24):
        f = merging.merge_attention(*w, num_heads=h, qk_rank=r, vo_rank=r)
        errs.append(merging.merged_attention_error(*w, f, h)[0])
    assert errs[0] >= errs[1] >= errs[2]


# -- the port against the reference ----------------------------------------

@pytest.mark.parametrize("c,r,s", [(32, 8, 24), (300, 17, 700),
                                   (2048, 191, 512)])
def test_merge_linear_equals_reference(c, r, s):
    a, b = _rnd(c, c, r, scale=c ** -0.5), _rnd(s, r, s, scale=r ** -0.5)
    got = merging.merge_linear(_t(a), _t(b)).numpy()
    want = np.asarray(jmerging.merge_linear(jnp.asarray(a), jnp.asarray(b)))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    sub = merging.merge_lowrank_subtree({"w0": _t(a), "w1": _t(b)})
    assert set(sub) == {"w"} and torch.equal(sub["w"], _t(got))


def test_conv_merges_and_fold_scale_equal_reference():
    conv1, u = _rnd(10, 1, 1, 16, 32), _rnd(11, 32, 8)
    v, conv3 = _rnd(12, 8, 32), _rnd(13, 1, 1, 32, 24)
    w, scale = _rnd(14, 3, 3, 16, 32), _rnd(15, 32)
    pairs = [
        (merging.merge_conv1x1_into_u(_t(conv1), _t(u)),
         jmerging.merge_conv1x1_into_u(jnp.asarray(conv1), jnp.asarray(u))),
        (merging.merge_v_into_conv1x1(_t(v), _t(conv3)),
         jmerging.merge_v_into_conv1x1(jnp.asarray(v), jnp.asarray(conv3))),
    ] + [(merging.fold_scale(_t(w), _t(scale[:w.shape[ax]]), ax),
          jmerging.fold_scale(jnp.asarray(w),
                              jnp.asarray(scale[:w.shape[ax]]), ax))
         for ax in (2, 3)]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _products(f):
    """The QK and VO products a set of merged factors reconstructs."""
    aq, ak, bv, bo = (np.asarray(x, np.float64) for x in f)
    return (np.einsum("dhr,fr->hdf", aq, ak),
            np.einsum("dr,rhf->hdf", bv, bo))


@pytest.mark.parametrize("d,h,hd,r", [(32, 4, 8, 32), (32, 4, 8, 12),
                                      (64, 4, 16, 16), (48, 2, 8, 5)])
def test_merge_attention_equals_reference(d, h, hd, r):
    """The errors within 1e-4 absolute and the reconstructed products
    within 1e-4 relative (the factors themselves differ by SVD signs)."""
    w = _attn(d + r, d, h, hd, scale=0.2)
    f = merging.merge_attention(*map(_t, w), num_heads=h, qk_rank=r,
                                vo_rank=r)
    jf = jmerging.merge_attention(*map(jnp.asarray, w), num_heads=h,
                                  qk_rank=r, vo_rank=r)
    assert [tuple(x.shape) for x in f] == [x.shape for x in jf]
    errs = merging.merged_attention_error(*map(_t, w), f, h)
    jerrs = jmerging.merged_attention_error(*map(jnp.asarray, w), jf, h)
    np.testing.assert_allclose(errs, jerrs, rtol=0, atol=1e-4)
    for got, want in zip(_products([x.numpy() for x in f]), _products(jf)):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert merging.merged_attention_params(d, h, r, r) \
        == jmerging.merged_attention_params(d, h, r, r)
    assert merging.dense_attention_params(d, h, h // 2, hd) \
        == jmerging.dense_attention_params(d, h, h // 2, hd)


def _merged_block(cfg, rank):
    """One smoke-llama layer (f32, seed 0) whose attention is replaced by
    the merged factors of its own q/k/v/o (k / v broadcast to all heads,
    as the caller of ``merge_attention`` must)."""
    pb = ParamBuilder(torch.Generator().manual_seed(0), torch.float32, "cpu")
    init_block(pb, cfg)
    p = pb.params
    a = p.pop("attn")
    g = cfg.num_heads // cfg.num_kv_heads
    hd = cfg.resolved_head_dim

    def full_heads(w):
        return w.reshape(cfg.d_model, cfg.num_kv_heads, hd).repeat_interleave(
            g, dim=1).reshape(cfg.d_model, cfg.num_heads * hd)
    f = merging.merge_attention(a["q"]["w"], full_heads(a["k"]["w"]),
                                full_heads(a["v"]["w"]), a["o"]["w"],
                                num_heads=cfg.num_heads, qk_rank=rank,
                                vo_rank=rank)
    p["merged"] = f._asdict()
    return p


@pytest.mark.parametrize("rank", [8, 16, 32])
def test_block_with_merged_attention_equals_reference(rank):
    cfg, jcfg = torch_cfg(), jax_cfg()
    p = _merged_block(cfg, rank)
    jp = to_jax(p)
    x = _rnd(99, 2, 13, cfg.d_model)
    pos = np.broadcast_to(np.arange(13), (2, 13)).astype(np.int32)
    got, cache, _ = apply_block(p, _t(x), cfg, positions=_t(pos).long())
    want, jcache, _ = japply_block(jp, jnp.asarray(x), jcfg,
                                   positions=jnp.asarray(pos))
    assert cache is None and jcache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_freeze_stops_the_merged_latents():
    """Under the §2.2 freeze the forward detaches the merged attention's
    shared latents ``ak`` / ``bv`` (the reference's stop_gradient), not
    ``aq`` / ``bo``."""
    p = {"merged": {k: _t(_rnd(i, 4, 4)).requires_grad_()
                    for i, k in enumerate(("aq", "ak", "bv", "bo"))}}
    out = freezing.stop_frozen_factors(p)["merged"]
    assert {k for k, v in out.items() if v.requires_grad} == {"aq", "bo"}
    freezing.set_requires_grad(p, freeze=True)
    assert {k for k, v in p["merged"].items() if v.requires_grad} \
        == {"aq", "bo"}


def test_init_merged_attention_matches_reference_layout():
    """The merged attention's params: the reference's names, shapes and
    logical axes; a freshly initialised subtree runs through the block's
    merged branch."""
    import jax
    from repro.layers import attention as jattn
    from repro.layers.param import ParamBuilder as JParamBuilder
    from repro_torch.layers import attention as tattn
    pb = ParamBuilder(torch.Generator().manual_seed(0), torch.float32, "cpu")
    tattn.init_merged_attention(pb, "merged", 64, 4, 16, 12, 12)
    jpb = JParamBuilder(jax.random.PRNGKey(0), jnp.float32)
    jattn.init_merged_attention(jpb, "merged", 64, 4, 16, 12, 12)
    assert pb.axes == jpb.axes
    assert {k: tuple(v.shape) for k, v in pb.params["merged"].items()} \
        == {k: v.shape for k, v in jpb.params["merged"].items()}
    x = torch.from_numpy(_rnd(5, 1, 7, 64))
    y = tattn.apply_merged_attention(pb.params["merged"], x,
                                     positions=torch.arange(7)[None])
    assert y.shape == x.shape and torch.isfinite(y).all()
