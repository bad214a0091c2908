"""The int8 KV pool in the port vs the reference on the same numpy
inputs: prefill quantization, the running-max token and chunk writes
(bit for bit, including the steps that grow a scale, grow none, land out
of bounds or carry a NaN), the staging-cache quantization, the
``gqa_int8`` plan's bytes, decode attention over the pool (plain version
vs the reference's oracle and its Pallas kernel in interpret mode), and
one attention layer's decode on an int8 cache.

Tolerances: the quantized values and scales are compared exactly where
both frameworks quantize the same inputs, and within one int8 step (and
1e-5 on the scales) where the inputs come out of each framework's own
projections; attention outputs at rtol = atol = 1e-5 in f32 (the same
softmax summed in another order) and 2e-2 in bf16 (the output rounds to
bf16 once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.layers import attention as jattn
from repro.layers import cache as jcache
from repro.quant import kv as jkv
from repro_torch.kernels import ref
from repro_torch.layers import attention as tattn
from repro_torch.layers import cache as tcache
from repro_torch.quant import kv as tkv
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _same(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _pool(rng, b=3, s=12, kh=2, d=8):
    """A warm int8 pool: the reference's prefill quantization of random
    K, as (jax q, jax scale, torch q, torch scale)."""
    x = rng.standard_normal((b, s, kh, d), np.float32)
    q, scale = jkv.quantize_kv_prefill(jnp.asarray(x))
    return q, scale, _t(q), _t(scale)


def test_quantize_kv_prefill_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 2, 8), np.float32) * 3.0
    x[0, 4, 1, 3] = np.nan            # a poisoned value lands as 0
    x[1, :, 0, 2] = 0.0               # an all-zero channel: scale 0
    jq, js = jkv.quantize_kv_prefill(jnp.asarray(x))
    tq, ts = tkv.quantize_kv_prefill(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _same(tq, jq)
    _same(ts, js)
    assert int(tq[0, 4, 1, 3]) == 0 and float(ts[1, 0, 2]) == 0.0
    _same(tkv.dequantize_kv(tq, ts), jkv.dequantize_kv(jq, js))


@pytest.mark.parametrize("case", ["grows", "grows_none", "out_of_bounds",
                                  "nan_row", "negative_pos"])
def test_kv_write_token_matches_reference(case):
    rng = np.random.default_rng(1)
    jq, js, tq, ts = _pool(rng)
    pos = np.array([3, 7, 11], np.int32)
    new = rng.standard_normal((3, 2, 8), np.float32) * 0.1  # inside scales
    if case == "grows":
        new[1, 0, 4] = 50.0           # slot 1's channel (0, 4) grows
    elif case == "out_of_bounds":
        pos[2] = 12                   # dropped row; its scale still grows
        new[2] *= 100.0
    elif case == "nan_row":
        new[0, 1, :] = np.nan
    elif case == "negative_pos":
        pos[0] = -1                   # wraps to the last position
    hist = tq.clone()
    jq2, js2 = jkv.kv_write_token(jq, js, jnp.asarray(new), jnp.asarray(pos))
    tq2, ts2 = tkv.kv_write_token(tq, ts, _t(new), _t(pos))
    assert tq2 is tq and ts2 is ts    # in place
    _same(tq, jq2)
    _same(ts, js2)
    grew = bool((ts2 > _t(np.asarray(js))).any())
    assert grew == (case in ("grows", "out_of_bounds"))
    if case == "grows_none":          # history bit-exact, one row written
        rows = torch.ones(tq.shape[:2], dtype=torch.bool)
        rows[torch.arange(3), torch.from_numpy(pos).long()] = False
        assert torch.equal(tq[rows], hist[rows])
    if case == "out_of_bounds":       # nothing of slot 2 landed unscaled
        assert float(ts[2].max()) > float(np.asarray(js)[2].max())
    if case == "nan_row":             # the row lands 0, history unchanged
        assert int(tq[0, 3, 1].abs().max()) == 0
        assert torch.equal(tq[0, :3], hist[0, :3])


@pytest.mark.parametrize("start,c,grow", [(4, 3, False), (10, 4, True),
                                          (0, 12, True)])
def test_kv_write_chunk_matches_reference(start, c, grow):
    rng = np.random.default_rng(2 + start)
    jq, js, tq, ts = _pool(rng, b=1)
    new = rng.standard_normal((1, c, 2, 8), np.float32) * (
        5.0 if grow else 0.1)
    jq2, js2 = jkv.kv_write_chunk(jq, js, jnp.asarray(new),
                                  jnp.asarray(start))
    tkv.kv_write_chunk(tq, ts, _t(new), start)
    _same(tq, jq2)
    _same(ts, js2)


@pytest.mark.parametrize("prompt_len", [None, 5])
def test_quantize_kv_tree_matches_reference(prompt_len):
    rng = np.random.default_rng(3)
    cache = {"blocks": {n: rng.standard_normal((2, 1, 8, 2, 4), np.float32)
                        for n in ("k", "v")}}
    jout = jkv.quantize_kv_tree(
        {"blocks": {n: jnp.asarray(a) for n, a in cache["blocks"].items()}},
        None if prompt_len is None else jnp.asarray(prompt_len))
    tout = tkv.quantize_kv_tree(
        {"blocks": {n: _t(a) for n, a in cache["blocks"].items()}},
        prompt_len)
    assert sorted(tout["blocks"]) == ["k_q", "k_scale", "v_q", "v_scale"]
    for n in tout["blocks"]:
        _same(tout["blocks"][n], jout["blocks"][n])


def test_gqa_int8_plan_bytes_and_leaves_match_reference():
    jp = jcache.gqa_plan(8, 64, jnp.bfloat16, "int8")
    tp = tcache.gqa_plan(8, 64, torch.bfloat16, "int8")
    assert tp.family == jp.family == "gqa_int8"
    assert (tp.bytes_per_token, tp.bytes_per_slot) == \
        (jp.bytes_per_token, jp.bytes_per_slot)
    assert tp.bytes_per_step(8, 1024) == jp.bytes_per_step(8, 1024) == \
        tkv.kv_bytes_per_step(8, 1024, 8, 64, quantize="int8") == \
        jkv.kv_bytes_per_step(8, 1024, 8, 64, quantize="int8")
    spec = jp.spec(3, 16)
    leaves = tp.leaves(3, 16)
    assert leaves.keys() == spec.keys()
    for n, (shape, dt) in leaves.items():
        assert shape == spec[n].shape and str(dt).split(".")[-1] == \
            str(spec[n].dtype), n
    with pytest.raises(ValueError, match="kv quant mode"):
        tcache.gqa_plan(8, 64, torch.bfloat16, "int4")


def _attn_inputs(rng, b, s, kh=2, g=3, d=16):
    q = rng.standard_normal((b, 1, kh * g, d), np.float32)
    k = rng.standard_normal((b, s, kh, d), np.float32)
    v = rng.standard_normal((b, s, kh, d), np.float32)
    kq, ks = jkv.quantize_kv_prefill(jnp.asarray(k))
    vq, vs = jkv.quantize_kv_prefill(jnp.asarray(v))
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 3.0])
@pytest.mark.parametrize("s,pos", [
    (128, [0, 57, 127, -1]),          # -1: a slot with no valid position
    (200, [0, 130, 199, 64]),         # S padded to 256 in the Pallas call
])
def test_decode_attention_q_plain_matches_reference_and_pallas(s, pos,
                                                               softcap,
                                                               dtype):
    rng = np.random.default_rng(s)
    q, kq, ks, vq, vs = _attn_inputs(rng, len(pos), s)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jqr = jnp.asarray(q).astype(jdt)
    cp = np.array(pos, np.int32)
    args = (kq, ks, vq, vs, jnp.asarray(cp))
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    got = ref.decode_attention_q_ref(tq, _t(kq), _t(ks), _t(vq), _t(vs),
                                     _t(cp), softcap=softcap)
    assert got.dtype == tq.dtype and tuple(got.shape) == q.shape
    for want in (jref.decode_attention_q_ref(jqr, *args, softcap=softcap),
                 jops.decode_attention_q(jqr, *args, softcap=softcap,
                                         force_kernel=True)):
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32),
                                   **TOL[dtype])


def _close_cache(tc: dict, jc: dict) -> None:
    """Scales within f32 rounding, values within one step: the K/V that
    reach the cache come out of projections and RoPE computed by the two
    frameworks, equal to the last bit only up to rounding."""
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n + "_scale"].numpy(),
                                   np.asarray(jc[n + "_scale"]),
                                   **TOL["float32"])
        diff = tc[n + "_q"].to(torch.int32) - _t(jc[n + "_q"]).to(
            torch.int32)
        assert int(diff.abs().max()) <= 1, n


def test_attention_layer_decode_on_int8_cache_matches_reference():
    rng = np.random.default_rng(5)
    d_model, h, kh, hd, s, b = 32, 4, 2, 8, 16, 3
    p = {n: {"w": rng.standard_normal((d_model, (h if n in "qo" else kh)
                                       * hd), np.float32) * 0.2}
         for n in "qkv"}
    p["o"] = {"w": rng.standard_normal((h * hd, d_model), np.float32) * 0.2}
    jp = {n: {"w": jnp.asarray(t["w"])} for n, t in p.items()}
    tp = {n: {"w": _t(t["w"])} for n, t in p.items()}
    kw = dict(num_heads=h, num_kv_heads=kh, head_dim=hd, rope_theta=1e4)
    jplan = jcache.gqa_plan(kh, hd, jnp.float32, "int8")
    tplan = tcache.gqa_plan(kh, hd, torch.float32, "int8")
    jc, tc = jplan.init(b, s), tplan.init(b, s, "cpu")
    # prefill 6 tokens (prompt_len 5 masks the last out of the scales)
    x = rng.standard_normal((b, 6, d_model), np.float32)
    pos = np.broadcast_to(np.arange(6), (b, 6))
    jo, jc = jattn.apply_attention(jp, jnp.asarray(x),
                                   positions=jnp.asarray(pos), cache=jc,
                                   prompt_len=jnp.asarray(5), plan=jplan,
                                   **kw)
    to, tc = tattn.apply_attention(tp, _t(x), positions=_t(pos), cache=tc,
                                   prompt_len=5, plan=tplan, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL["float32"])
    _close_cache(tc, jc)
    for step in range(3):               # decode; no plan: classified
        x1 = rng.standard_normal((b, 1, d_model), np.float32) * (1 + step)
        cp = np.array([5 + step, 2, 15], np.int32)
        jo, jc = jattn.apply_attention(
            jp, jnp.asarray(x1), positions=jnp.asarray(cp)[:, None],
            cache=jc, cache_pos=jnp.asarray(cp), **kw)
        to, tc = tattn.apply_attention(tp, _t(x1), positions=_t(cp)[:, None],
                                       cache=tc, cache_pos=_t(cp), **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                   **TOL["float32"])
        _close_cache(tc, jc)
