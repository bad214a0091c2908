"""Layers of the port vs the reference on the same numpy inputs (f32):
apply_linear for every kind, RMSNorm, SwiGLU, RoPE, prefill and decode
attention, and the gqa_f32 cache writes — including the clamped offset
write and the dropped out-of-bounds decode write."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jattn
from repro.layers import cache as jcache
from repro.layers.mlp import apply_mlp as japply_mlp
from repro.layers.norm import rms_norm as jrms_norm
from repro.layers.param import apply_linear as japply_linear
from repro_torch.layers import attention as tattn
from repro_torch.layers import cache as tcache
from repro_torch.layers.mlp import apply_mlp
from repro_torch.layers.norm import rms_norm
from repro_torch.layers.param import apply_linear
from repro_torch.layers.plan import build_plan

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(t: torch.Tensor, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def _linear_tree(kind: str, rng, c=24, s=40):
    if kind == "dense":
        return {"w": rng.standard_normal((c, s), np.float32) * 0.2}
    if kind == "lowrank":
        return {"w0": rng.standard_normal((c, 8), np.float32) * 0.2,
                "w1": rng.standard_normal((8, s), np.float32) * 0.2}
    return {"u": rng.standard_normal((3, c, 4), np.float32) * 0.2,
            "xc": rng.standard_normal((3, 4, 4), np.float32) * 0.2,
            "v": rng.standard_normal((3, 4, s), np.float32) * 0.2}


@pytest.mark.parametrize("kind", ["dense", "lowrank", "branched"])
@pytest.mark.parametrize("lead", [(5,), (2, 3), (4, 1)])
def test_apply_linear_matches_reference(kind, lead):
    rng = np.random.default_rng(3)
    tree = _linear_tree(kind, rng)
    x = rng.standard_normal((*lead, 24), np.float32)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = {k: torch.from_numpy(v) for k, v in tree.items()}
    got = apply_linear(tp, torch.from_numpy(x))
    _close(got, japply_linear(jp, jnp.asarray(x)))
    assert build_plan(tp).kind == kind


def test_plan_accounting_matches_reference():
    from repro.layers.plan import build_plan as jbuild_plan
    rng = np.random.default_rng(4)
    for kind in ("dense", "lowrank", "branched"):
        tree = _linear_tree(kind, rng)
        jp = jbuild_plan({k: jnp.asarray(v) for k, v in tree.items()})
        tp = build_plan({k: torch.from_numpy(v) for k, v in tree.items()})
        assert tp.kind == jp.kind
        assert tp.matmul_chain() == jp.matmul_chain()
        assert tp.flops_per_token == jp.flops_per_token
        assert tp.weight_bytes == jp.weight_bytes
        assert tp.param_count == jp.param_count
        assert tp.kernel_for((4, 24)) == (None if kind == "dense" else kind)


def test_quantized_keys_raise_not_implemented():
    # int8 pairs are served now (tests/test_torch_quant.py); the 2:4-packed
    # int8 layout still waits for its ROADMAP item
    with pytest.raises(NotImplementedError, match="A11"):
        build_plan({"w0_sp": torch.zeros((2, 1, 2), dtype=torch.int8),
                    "w0_idx": torch.zeros((2, 1, 1), dtype=torch.int8),
                    "w0_scale": torch.zeros((1, 2)),
                    "w1": torch.zeros((2, 4))})


def test_rms_norm_and_swiglu_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 24), np.float32)
    scale = rng.standard_normal((24,), np.float32)
    _close(rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jrms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    tree = {n: _linear_tree(k, rng, *dims) for n, k, dims in (
        ("up", "lowrank", (24, 40)), ("gate", "branched", (24, 40)),
        ("down", "dense", (40, 24)))}
    jp = {n: {k: jnp.asarray(v) for k, v in t.items()}
          for n, t in tree.items()}
    tp = {n: {k: torch.from_numpy(v) for k, v in t.items()}
          for n, t in tree.items()}
    _close(apply_mlp(tp, torch.from_numpy(x)), japply_mlp(jp, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(6)
    pos = np.array([[0, 1, 2, 7], [30, 31, 32, 100]], np.int32)
    x = rng.standard_normal((2, 4, 3, 16), np.float32)
    js, jc = jattn.rope_sincos(jnp.asarray(pos), 16, theta)
    ts, tc = tattn.rope_sincos(torch.from_numpy(pos), 16, theta)
    _close(ts, js)
    _close(tc, jc)
    _close(tattn.apply_rope(torch.from_numpy(x), ts, tc),
           jattn.apply_rope(jnp.asarray(x), js, jc))


@pytest.mark.parametrize("q_offset,skv,q_chunk", [(0, 6, 1024), (5, 16, 1024),
                                                  (0, 8, 4)])
def test_chunked_attention_matches_reference(q_offset, skv, q_chunk):
    rng = np.random.default_rng(7)
    sq = 6 if skv == 6 else 8
    q = rng.standard_normal((2, sq, 4, 16), np.float32)
    k = rng.standard_normal((2, skv, 2, 16), np.float32)
    v = rng.standard_normal((2, skv, 2, 16), np.float32)
    got = tattn.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, q_offset=q_offset,
                                  q_chunk=q_chunk)
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=True, q_offset=q_offset,
                                   q_chunk=q_chunk)
    _close(got, want)


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((3, 1, 4, 16), np.float32)
    k = rng.standard_normal((3, 10, 2, 16), np.float32)
    v = rng.standard_normal((3, 10, 2, 16), np.float32)
    pos = np.array([0, 4, 9], np.int32)
    jplan = jcache.gqa_plan(2, 16, jnp.float32)
    tplan = tcache.gqa_plan(2, 16, torch.float32)
    want = jplan.attend_decode(jnp.asarray(q), {"k": jnp.asarray(k),
                                                "v": jnp.asarray(v)},
                               jnp.asarray(pos))
    got = tplan.attend_decode(torch.from_numpy(q),
                              {"k": torch.from_numpy(k),
                               "v": torch.from_numpy(v)},
                              torch.from_numpy(pos))
    _close(got, want)


# -- cache writes --------------------------------------------------------------

def _pools(rng, b=3, s=12):
    k = rng.standard_normal((b, s, 2, 4), np.float32)
    v = rng.standard_normal((b, s, 2, 4), np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


def _new(rng, b, sq):
    vals = {n: rng.standard_normal((b, sq, 2, 4), np.float32)
            for n in ("k", "v")}
    return ({n: jnp.asarray(a) for n, a in vals.items()},
            {n: torch.from_numpy(a) for n, a in vals.items()})


def _same_cache(t: dict, j: dict):
    for n in ("k", "v"):
        np.testing.assert_array_equal(t[n].numpy(), np.asarray(j[n]))


JPLAN = jcache.gqa_plan(2, 4, jnp.float32)
TPLAN = tcache.gqa_plan(2, 4, torch.float32)


def test_write_prefill_matches_reference():
    rng = np.random.default_rng(9)
    jc, tc = _pools(rng)
    jn, tn = _new(rng, 3, 5)
    _same_cache(TPLAN.write_prefill(tc, tn, 3), JPLAN.write_prefill(jc, jn,
                                                                     3))


@pytest.mark.parametrize("start,sq,plen", [
    (4, 4, 6),      # pad rows past prompt_len zeroed
    (10, 4, 13),    # window runs past the end: start clamps to 8
    (0, 12, 12),    # whole pool
])
def test_write_chunk_matches_reference_incl_clamp(start, sq, plen):
    rng = np.random.default_rng(10 + start)
    jc, tc = _pools(rng, b=1)
    jn, tn = _new(rng, 1, sq)
    jout, jview = JPLAN.write_chunk(jc, jn, jnp.asarray(start),
                                    jnp.asarray(plen))
    tout, tview = TPLAN.write_chunk(tc, tn, start, plen)
    _same_cache(tout, jout)
    _same_cache(tview, jview)


@pytest.mark.parametrize("pos", [[0, 5, 11], [12, 3, 40], [11, 12, 12]])
def test_write_decode_matches_reference_and_drops_out_of_bounds(pos):
    rng = np.random.default_rng(11)
    jc, tc = _pools(rng)
    before = {n: t.clone() for n, t in tc.items()}
    vals = {n: rng.standard_normal((3, 2, 4), np.float32) for n in "kv"}
    p = np.array(pos, np.int32)
    jout = JPLAN.write_decode(jc, {n: jnp.asarray(a) for n, a in vals.items()},
                              jnp.asarray(p))
    tout = TPLAN.write_decode(tc, {n: torch.from_numpy(a)
                                   for n, a in vals.items()},
                              torch.from_numpy(p))
    _same_cache(tout, jout)
    for b, q in enumerate(pos):
        if q >= 12:     # dropped: the slot's whole row is untouched
            for n in "kv":
                assert torch.equal(tout[n][b], before[n][b])
