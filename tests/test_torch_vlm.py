"""The VLM family (llama-3.2-vision-90b) against the reference on the CPU,
at its smoke widths: the config field for field, layer norm, the gated
cross attention and its K/V, forward logits, prefill + 2 decode steps
(the cache included, ``cross_kv`` key for key), the loss and every
gradient against ``jax.value_and_grad``, the cache trees of both pool
kinds, and the surgery decisions (the cross linears labelled as the
reference labels them).

The smoke VLM has one super block (5 layers, a cross block every 5th);
every model-level case runs at 5 and at 10 layers (two super blocks), so
a fault in indexing the stacked cross blocks or ``cross_kv`` shows.  The
cross gate starts at zero, where the cross attention adds nothing: every
tree here sets it to 0.5, and the image embeddings are random (std 0.2).
One tree built by the port is bridged into the reference.  Tolerance
(f32): logits, cache leaves and the loss within 1e-4 (1e-5 for the
loss) of the largest reference value, a gradient leaf within 1e-4 of its
largest element."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (TREE_LRD, copy_tree, flat, smoke_cfg, to_jax,
                           torch_threads)
from repro.configs import registry as jreg
from repro.configs.base import LRDConfig as JLRD
from repro.core.surgery import decompose_model as jdecompose
from repro.layers import attention as jattn
from repro.layers import norm as jnorm
from repro.models.api import get_model as jget_model
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LRDConfig
from repro_torch.core import freezing
from repro_torch.core.surgery import decompose_model
from repro_torch.layers import attention as tattn
from repro_torch.layers import norm as tnorm
from repro_torch.models.api import get_model
from repro_torch.train.steps import value_and_grad

VLM = "llama-3.2-vision-90b"
TREES = ["dense", "svd", "branched"]
LAYERS = [5, 10]
GATE = 0.5
TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), \
        err / max(np.abs(want).max(), 1e-30)


def cfg(side: str, layers: int = 5):
    return smoke_cfg(VLM, side, num_layers=layers)


@functools.lru_cache(maxsize=None)
def vlm_tree(layers: int, tree: str):
    """(params, axes) of a smoke VLM tree built by the port (CPU, seed
    0), every cross gate at :data:`GATE`, decomposed with
    :data:`TREE_LRD`."""
    params, axes = get_model(cfg("torch", layers), "cpu").init(
        torch.Generator().manual_seed(0))
    params["cross"]["cross_attn"]["gate"].fill_(GATE)
    if TREE_LRD[tree] is not None:
        params, axes, _ = decompose_model(params, axes,
                                          LRDConfig(**TREE_LRD[tree]))
    return params, axes


def _inputs(b=2, s=12, seed=0):
    c = cfg("torch")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, c.vocab_size, (b, s)).astype(np.int32)
    img = (rng.standard_normal((b, c.num_image_tokens, c.d_model))
           * 0.2).astype(np.float32)
    return toks, img


def _batches(toks, img):
    return ({"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)},
            {"tokens": torch.from_numpy(toks).long(),
             "image_embeds": torch.from_numpy(img)})


# ---------------------------------------------------------------------------
# config and layers
# ---------------------------------------------------------------------------

def test_config_mirrors_reference():
    for which in ("full", "smoke"):
        j = getattr(jreg.get(VLM), which)
        t = getattr(treg.get(VLM), which)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (which, f.name)
        for prop in ("resolved_head_dim", "has_decode", "subquadratic"):
            assert getattr(t, prop) == getattr(j, prop), (which, prop)
    full = treg.get(VLM).full
    assert (full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size,
            full.cross_attn_every, full.num_image_tokens) == (
        8192, 64, 8, 128, 28672, 128256, 5, 1601)
    m = get_model(full, "cpu")
    assert (m.n_super, m.n_self_per, m.n_stack) == (20, 4, 80)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.api import synth_inputs
    b = synth_inputs(full, ShapeConfig("t", 8, 1, "train"),
                     torch.Generator().manual_seed(0))
    assert tuple(b["image_embeds"].shape) == (1, 1601, 8192)
    assert b["image_embeds"].dtype == torch.bfloat16


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    want = jnorm.layer_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = tnorm.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x))
    _close(got, want, 1e-6)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tnorm.layer_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            xb).dtype == torch.bfloat16


@pytest.mark.parametrize("gate", [0.0, GATE])
def test_cross_attention_matches_reference(gate):
    """``cross_attn_kv`` and ``apply_cross_attention`` on random weights,
    the image width (48) other than d_model (64); at gate 0 the output is
    exactly zero on both sides."""
    rng = np.random.default_rng(1)
    d, kv_dim, h, kh, hd, b, s, t = 64, 48, 4, 2, 16, 2, 7, 11

    def w(i, o):
        return {"w": (rng.standard_normal((i, o)) * i ** -0.5).astype(
            np.float32)}
    p = {"q": w(d, h * hd), "k": w(kv_dim, kh * hd), "v": w(kv_dim, kh * hd),
         "o": w(h * hd, d), "gate": np.float32(gate)}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    img = (rng.standard_normal((b, t, kv_dim)) * 0.2).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), p)
    dims = dict(num_kv_heads=kh, head_dim=hd)
    jkv = jattn.cross_attn_kv(jp, jnp.asarray(img), **dims)
    tkv = tattn.cross_attn_kv(tp, torch.from_numpy(img), **dims)
    for k in ("k", "v"):
        assert tuple(tkv[k].shape) == (b, t, kh, hd)
        _close(tkv[k], jkv[k], 1e-5)
    want = jattn.apply_cross_attention(jp, jnp.asarray(x), jnp.asarray(img),
                                       num_heads=h, **dims)
    got = tattn.apply_cross_attention(tp, torch.from_numpy(x),
                                      torch.from_numpy(img), num_heads=h,
                                      **dims)
    via_kv = tattn.apply_cross_attention(tp, torch.from_numpy(x), kv=tkv,
                                         num_heads=h, **dims)
    assert torch.equal(got, via_kv)
    if gate == 0.0:
        assert not np.any(np.asarray(want)) and not torch.any(got)
    else:
        assert float(got.abs().max()) > 0
        _close(got, want, 1e-5)


def test_noncausal_attention_at_head_dim_80():
    """``chunked_attention`` with ``causal=False`` (the encoder's and the
    cross attention's) at hubert's head dim 80, over more keys than
    queries and more query chunks than one."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 24, 4, 80)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 80)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 80)).astype(np.float32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False, q_chunk=8)
    got = tattn.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False,
                                  q_chunk=8)
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# the model: forward, prefill + decode, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("tree", TREES)
def test_forward_logits_match_reference(layers, tree):
    params = vlm_tree(layers, tree)[0]
    jb, tb = _batches(*_inputs())
    jm = jget_model(cfg("jax", layers))
    jp = to_jax(params)
    jx, _ = jm.forward(jp, jb)
    want = jm.logits(jp, jx)
    tm = get_model(cfg("torch", layers), "cpu")
    assert (tm.n_super, tm.n_self_per) == (jm.n_super, jm.n_self_per)
    with torch.no_grad():
        tx, aux = tm.forward(params, tb)
        got = tm.logits(params, tx)
    assert float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("tree", TREES)
def test_prefill_decode_match_reference(layers, tree):
    """A 10-token prefill with random image embeddings and 2 decode
    steps; every cache leaf after them (``self``'s K/V and the image
    K/V of every super block) against the reference's."""
    params = vlm_tree(layers, tree)[0]
    toks, img = _inputs()
    s, b = 10, 2
    jm = jget_model(cfg("jax", layers))
    jp = to_jax(params)
    tm = get_model(cfg("torch", layers), "cpu")
    jc = jm.init_cache(b, toks.shape[1])
    tc = tm.init_cache(b, toks.shape[1])
    jb, tb = _batches(toks[:, :s], img)
    jl, jc = jm.prefill(jp, jb, jc)
    with torch.inference_mode():
        tl, tc = tm.prefill(params, tb, tc)
        _close(tl, jl)
        for t in range(s, toks.shape[1]):
            pos = np.full((b,), t, np.int32)
            jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.asarray(pos), jc)
            tl, tc = tm.decode_step(params, torch.from_numpy(
                toks[:, t:t + 1]).long(), torch.from_numpy(pos), tc)
            _close(tl, jl)
    jflat = flat(jax.tree.map(np.asarray, jc))
    assert set(flat(tc)) == set(jflat)
    for k, v in flat(tc).items():
        _close(v, jflat[k])
    assert float(tc["cross_kv"]["k"][-1].abs().max()) > 0


@pytest.mark.parametrize("layers,tree,freeze", [
    (5, "dense", False), (10, "svd", False), (10, "branched", True),
])
def test_loss_and_grads_match_reference(layers, tree, freeze):
    """One loss and every gradient (the stacked cross gates' included),
    the §2.2 freeze on and off."""
    from repro.models.blocks import BlockOpts as JBlockOpts
    from repro_torch.models.blocks import BlockOpts
    jb, tb = _batches(*_inputs(s=10, seed=3))
    tp = copy_tree(vlm_tree(layers, tree)[0])
    jp = to_jax(tp)
    jm = jget_model(cfg("jax", layers))
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jb, opts=JBlockOpts(freeze_factors=freeze)),
        has_aux=True)(jp)
    tm = get_model(cfg("torch", layers), "cpu")
    tl, taux, tg = value_and_grad(
        lambda p, b: tm.loss(p, b, opts=BlockOpts(freeze)),
        freezing.set_requires_grad(tp, freeze=freeze), tb)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_TOL)
    assert float(taux["ce"]) == pytest.approx(float(jaux["ce"]),
                                              rel=LOSS_TOL)
    jg, tg = flat(jax.tree.map(np.asarray, jg)), flat(tg)
    assert set(jg) == set(tg)
    stopped = [k for k, g in tg.items() if g is None]
    assert bool(stopped) == freeze
    for k in stopped:
        assert not np.any(jg[k]), k
    for k, g in tg.items():
        if g is not None:
            _close(g, jg[k], TOL)
    assert tuple(tg["cross/cross_attn/gate"].shape) == (layers // 5,)
    assert float(tg["cross/cross_attn/gate"].abs().min()) > 0


def test_remat_keeps_the_gradients():
    """The self and cross blocks under ``remat="full"`` give the
    gradients of the plain run."""
    _, tb = _batches(*_inputs(s=8, seed=4))
    tm = get_model(cfg("torch", 10), "cpu")
    out = []
    for remat in ("none", "full"):
        tp = freezing.set_requires_grad(copy_tree(vlm_tree(10, "svd")[0]),
                                        freeze=False)
        out.append(value_and_grad(
            lambda p, b: tm.loss(p, b, remat=remat), tp, tb))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in flat(out[0][2]).items():
        torch.testing.assert_close(flat(out[1][2])[k], g, rtol=1e-6,
                                   atol=1e-7)


def test_image_path_moves_the_logits():
    """At gate 0.5 other image embeddings give other logits; at gate 0
    (a fresh tree) they give the same."""
    toks, img = _inputs()
    _, tb = _batches(toks, img)
    _, tb2 = _batches(toks, img[::-1].copy())
    tm = get_model(cfg("torch", 10), "cpu")
    gated = vlm_tree(10, "dense")[0]
    fresh = copy_tree(gated)
    fresh["cross"]["cross_attn"]["gate"].zero_()
    with torch.no_grad():
        def lg(p, b):
            return tm.logits(p, tm.forward(p, b)[0])
        assert not torch.allclose(lg(gated, tb), lg(gated, tb2))
        assert torch.equal(lg(fresh, tb), lg(fresh, tb2))


# ---------------------------------------------------------------------------
# caches, surgery, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("kv_quantize", [None, "int8"])
def test_cache_tree_matches_reference(layers, kv_quantize):
    """Key for key, shape for shape and dtype for dtype: ``self`` with its
    ``(n_super, n_self_per)`` lead, ``cross_kv`` in the model dtype over
    either pool; one plan per self block."""
    jm = jget_model(cfg("jax", layers))
    tm = get_model(cfg("torch", layers), "cpu")
    jc = flat(jm.init_cache(3, 16, kv_quantize=kv_quantize))
    tc = flat(tm.init_cache(3, 16, kv_quantize=kv_quantize))
    assert set(tc) == set(jc)
    for k, v in tc.items():
        assert tuple(v.shape) == tuple(jc[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(jc[k].dtype), k
    assert tc["cross_kv/k"].dtype == torch.float32
    assert len(tm.cache_plans(kv_quantize)) == len(
        jm.cache_plans(kv_quantize)) == 4 * (layers // 5)
    with pytest.raises(ValueError, match="paged"):
        from repro_torch.layers.cache import PagedGeometry
        tm.init_cache(9, 4, paged=PagedGeometry(4, 8, 2, 4))


def test_surgery_matches_reference():
    """The same decisions (path, label, kind, rank, sizes) on both sides
    (the branched tree: SVD pairs and branched linears): the cross
    block's q / k / v / o decomposed as attention linears (batched over
    the ``n_super`` stack), the scalar gate untouched."""
    dense, axes = vlm_tree(10, "dense")
    lrd = TREE_LRD["branched"]
    tparams, _, trep = decompose_model(dense, axes, LRDConfig(**lrd))
    _, _, jrep = jdecompose(to_jax(dense), axes, JLRD(**lrd))
    got = sorted((d.path, d.label, d.kind, d.rank, tuple(d.shape),
                  d.params_after) for d in trep.decisions)
    assert got == sorted((d.path, d.label, d.kind, d.rank, tuple(d.shape),
                          d.params_after) for d in jrep.decisions)
    by = {d.path: d for d in trep.decisions}
    for p in "qkvo":
        d = by[f"cross/cross_attn/{p}"]
        assert d.label == f"attn_{p}" and d.kind not in ("skip", "org")
        assert d.shape[0] == 2
    assert torch.equal(tparams["cross"]["cross_attn"]["gate"],
                       torch.full((2,), GATE))


def test_bridge_round_trip_keeps_the_nested_stacks():
    """The stacked 0-d gates ``(n_super,)`` and the nested VLM stacks
    cross the bridge to the reference's arrays and back key for key,
    bit for bit."""
    from repro_torch import bridge
    params = vlm_tree(10, "branched")[0]
    back = bridge.to_torch(bridge.to_numpy(params), "cpu")
    got, want = flat(back), flat(params)
    assert set(got) == set(want) and "cross/cross_attn/gate" in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert tuple(got["cross/cross_attn/gate"].shape) == (2,)


def test_cross_attn_every_is_checked():
    with pytest.raises(ValueError, match="cross_attn_every"):
        get_model(dataclasses.replace(cfg("torch"), num_layers=7), "cpu")
    with pytest.raises(ValueError, match="cross_attn_every"):
        get_model(dataclasses.replace(cfg("torch"), cross_attn_every=0),
                  "cpu")
