"""MLA in the port vs the reference on the same numpy inputs (f32): the
``mla_latent`` / ``mla_latent_int8`` plan contract, the latent writes,
the int8 latent decode attention's plain version (vs the reference's
oracle and its Pallas kernel in interpret mode), the DeepSeek-V2 config
and the refusal of its MoE family, the surgery labels of an MLA stack,
and the chain kernels' row-block choice at DeepSeek-V2's wide ranks.
``apply_mla`` itself is held against the reference in
``test_torch_mla_layer.py``.

Tolerances: quantized values and scales exactly where both frameworks
quantize the same inputs; attention outputs at rtol = atol = 1e-5 in f32
(the same sums taken in another order); the Pallas kernel within 1e-2,
the reference's own bound for its kernel against its oracle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (MLA_CFG_NAMES, MLA_LRD, flat, mla_cfg,
                           mla_port_tree, mla_tree_for_jax)
from repro.core.surgery import decompose_model as jdecompose
from repro.configs.base import LRDConfig as JLRD
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.layers import cache as jcache
from repro.quant import kv as jkv
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.core.surgery import decompose_model as tdecompose
from repro_torch.kernels import build
from repro_torch.kernels import ref
from repro_torch.layers import attention as tattn
from repro_torch.layers import cache as tcache
from repro_torch.models.api import get_model
from repro_torch.models.blocks import block_cache_spec
from repro_torch.quant import kv as tkv
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _same(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _close(t: torch.Tensor, j, **tol) -> None:
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


# ---------------------------------------------------------------------------
# plan contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("cfg_name", MLA_CFG_NAMES)
def test_latent_plan_matches_reference(cfg_name, quant):
    """Family, leaves (names, shapes, dtypes), bytes and the key-sniffing
    round trip of the latent plans equal the reference's."""
    jp = jcache.build_cache_plan(mla_cfg(cfg_name, "jax"), jnp.float32,
                                 quant)
    tp = tcache.build_cache_plan(mla_cfg(cfg_name, "torch"), torch.float32,
                                 quant)
    assert tp.family == jp.family == ("mla_latent_int8" if quant
                                      else "mla_latent")
    assert tp.mla and tp.quantized == jp.quantized == bool(quant)
    spec = jp.spec(3, 16)
    leaves = tp.leaves(3, 16)
    assert list(leaves) == list(spec)
    for name, (shape, dtype) in leaves.items():
        assert shape == spec[name].shape, name
        assert str(dtype).split(".")[-1] == spec[name].dtype.name, name
    for attr in ("bytes_per_token", "bytes_per_slot"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert tp.bytes_per_step(8, 1024) == jp.bytes_per_step(8, 1024)
    init = tp.init(3, 16, "cpu")
    assert tcache.plan_from_cache(init) == tp
    assert tattn.mla_cache_spec(3, 16, mla_cfg(cfg_name, "torch"),
                                torch.float32, quant) == leaves
    assert block_cache_spec(mla_cfg(cfg_name, "torch"), 3, 16,
                            torch.float32, quant) == leaves
    if quant:
        assert float(tkv.dequantize_kv(init["ckv_q"], init["ckv_scale"])
                     .abs().max()) == 0.0


def test_latent_plan_guards():
    """Latent plans attend only through the latent executor, GQA plans
    only through theirs; a paged geometry refuses an MLA stack."""
    gqa = tcache.gqa_plan(2, 8, torch.float32)
    mla = tcache.mla_plan(16, 8, torch.float32)
    q = torch.zeros(1, 1, 4, 8)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        mla.attend_decode(q, mla.init(1, 8, "cpu"), pos)
    with pytest.raises(ValueError):
        gqa.attend_decode_latent(q, q, gqa.init(1, 8, "cpu"), pos,
                                 scale=1.0)
    geom = tcache.PagedGeometry(block_size=4, num_blocks=8, slots=2,
                                blocks_per_slot=4)
    with pytest.raises(ValueError, match="paged"):
        tcache.build_cache_plan(mla_cfg("mla-tiny", "torch"), torch.float32,
                                "int8", geom)


# ---------------------------------------------------------------------------
# latent writes (quant.kv on (B, S, r) leaves)
# ---------------------------------------------------------------------------

def test_write_token_latent_matches_reference_and_round_trips():
    """Token by token into an empty int8 latent pool, a NaN row and an
    out-of-bounds position included: values and scales bit-identical to
    the reference's, and the pool dequantizes to within 1.5 steps."""
    rng = np.random.default_rng(0)
    b, s, r = 2, 7, 16
    x = rng.standard_normal((b, s + 1, r), np.float32)
    x[1, 4, 3] = np.nan
    jc, js = jnp.zeros((b, s, r), jnp.int8), jnp.zeros((b, r), jnp.float32)
    tc, ts = torch.zeros(b, s, r, dtype=torch.int8), torch.zeros(b, r)
    for t in range(s + 1):
        pos = np.array([t, min(t, s - 1)], np.int32)    # slot 0 ends OOB
        jc, js = jkv.kv_write_token(jc, js, jnp.asarray(x[:, t]),
                                    jnp.asarray(pos))
        tkv.kv_write_token(tc, ts, _t(x[:, t]), _t(pos))
        _same(tc, jc)
        _same(ts, js)
    # slot 0 holds positions 0..s-1 (its last write was dropped)
    back = tkv.dequantize_kv(tc, ts)[0]
    assert bool(((back - _t(x[0, :s])).abs()
                 <= 1.5 * ts[0] + 1e-8).all())


@pytest.mark.parametrize("prompt_len", [None, 5])
def test_quantize_kv_tree_latent_stacked_matches_reference(prompt_len):
    """Stacked (L, 1, S, r) latent staging caches quantize bit-identically
    to the reference's, reduced over the sequence axis -2 with the pad
    tail masked, and equal the plan's quantize-on-insert prefill."""
    rng = np.random.default_rng(1)
    tree = {"blocks": {"ckv": rng.standard_normal((3, 1, 8, 16),
                                                  np.float32),
                       "krope": rng.standard_normal((3, 1, 8, 4),
                                                    np.float32)}}
    jout = jkv.quantize_kv_tree(
        jax.tree.map(jnp.asarray, tree),
        None if prompt_len is None else jnp.asarray(prompt_len))["blocks"]
    tout = tkv.quantize_kv_tree(
        {"blocks": {n: _t(a) for n, a in tree["blocks"].items()}},
        prompt_len)["blocks"]
    assert sorted(tout) == ["ckv_q", "ckv_scale", "krope_q", "krope_scale"]
    assert tout["ckv_scale"].shape == (3, 1, 16)
    for n in tout:
        _same(tout[n], jout[n])
    plan = tcache.mla_plan(16, 4, torch.float32, "int8")
    want = plan.write_prefill(
        plan.init(1, 8, "cpu"),
        {k: _t(v[0]) for k, v in tree["blocks"].items()}, prompt_len)
    for n in ("ckv_q", "ckv_scale", "krope_q", "krope_scale"):
        assert torch.equal(tout[n][0], want[n]), n


def test_write_chunk_latent_matches_token_loop_and_reference():
    """One chunk write's running-max scale equals the token loop's, and
    the chunk write equals the reference's bit for bit."""
    rng = np.random.default_rng(2)
    new = rng.standard_normal((1, 5, 8), np.float32)
    tc, ts = torch.zeros(1, 16, 8, dtype=torch.int8), torch.zeros(1, 8)
    tkv.kv_write_chunk(tc, ts, _t(new), 3)
    jc, js = jkv.kv_write_chunk(jnp.zeros((1, 16, 8), jnp.int8),
                                jnp.zeros((1, 8), jnp.float32),
                                jnp.asarray(new), jnp.asarray(3))
    _same(tc, jc)
    _same(ts, js)
    lc, ls = torch.zeros(1, 16, 8, dtype=torch.int8), torch.zeros(1, 8)
    for t in range(5):
        tkv.kv_write_token(lc, ls, _t(new[:, t]),
                           torch.tensor([3 + t], dtype=torch.int32))
    assert torch.equal(ts, ls)


# ---------------------------------------------------------------------------
# B10's plain version
# ---------------------------------------------------------------------------

#: the reference's LATENT_SHAPES (b, s, h, lora, rope, bs)
LATENT_SHAPES = [(2, 64, 4, 32, 16, 32), (3, 100, 2, 16, 8, 64),
                 (1, 16, 8, 64, 8, 128)]


def _latent_inputs(b, s, h, lora, rope, seed=0, idle=0):
    """q_lat, q_rope (f32), the int8 latent pool quantized as the engine
    quantizes a prefill, and cache_pos in [1, s - 1) (the last ``idle``
    slots -1: no valid position), as numpy arrays."""
    rng = np.random.default_rng(seed)
    q_lat = rng.standard_normal((b, 1, h, lora), np.float32) * 0.5
    q_rope = rng.standard_normal((b, 1, h, rope), np.float32) * 0.5
    # the port's prefill quantization (bit-identical to the reference's)
    cq, cs = tkv.quantize_kv_prefill(
        torch.randn(b, s, lora, generator=torch.Generator().manual_seed(
            seed)))
    rq, rs = tkv.quantize_kv_prefill(
        torch.randn(b, s, rope, generator=torch.Generator().manual_seed(
            seed + 1)))
    pos = rng.integers(1, s - 1, b).astype(np.int32)
    if idle:
        pos[-idle:] = -1
    return [np.asarray(a) for a in (q_lat, q_rope, cq.numpy(), cs.numpy(),
                                    rq.numpy(), rs.numpy(), pos)]


@pytest.mark.parametrize("b,s,h,lora,rope,bs", LATENT_SHAPES)
def test_latent_ref_matches_reference_oracle_and_pallas(b, s, h, lora, rope,
                                                        bs):
    args = _latent_inputs(b, s, h, lora, rope, seed=b * s)
    scale = 1.0 / ((lora + rope) ** 0.5)
    got = ref.decode_attention_latent_q_ref(*map(_t, args), scale=scale)
    jargs = [jnp.asarray(a) for a in args]
    assert got.shape == (b, 1, h, lora)
    _close(got, jref.decode_attention_latent_q_ref(*jargs, scale=scale))
    pallas = jops.decode_attention_latent_q(*jargs, scale=scale, bs=bs,
                                            force_kernel=True)
    _close(got, pallas, rtol=0, atol=1e-2)


@pytest.mark.parametrize("s", [64, 100])
def test_latent_ref_idle_slot_averages_every_position(s):
    """A slot with no valid position gets the oracle's finite uniform
    average of the whole pool.  The comparison with the reference's
    oracle runs at both S; its Pallas kernel pads S to a multiple of its
    block and averages the zero pad rows too, so it is compared only at
    an S that needs no padding (64)."""
    args = _latent_inputs(3, s, 2, 16, 8, seed=s, idle=1)
    got = ref.decode_attention_latent_q_ref(*map(_t, args), scale=0.25)
    jargs = [jnp.asarray(a) for a in args]
    _close(got, jref.decode_attention_latent_q_ref(*jargs, scale=0.25))
    assert torch.isfinite(got).all()
    cc = _t(args[2]).float() * _t(args[3])[:, None]
    _close(got[2, 0], cc[2].mean(0).expand(2, 16).numpy())
    if s % 32 == 0:
        _close(got, jops.decode_attention_latent_q(
            *jargs, scale=0.25, bs=32, force_kernel=True), rtol=0,
            atol=1e-2)


def test_latent_ref_equals_f32_attend_on_dequantized_pool():
    """B10's plain version == the plan's full-width latent attend on the
    dequantized pool (same masking semantics)."""
    q_lat, q_rope, cq, cs, rq, rs, pos = map(
        _t, _latent_inputs(2, 32, 4, 16, 8, seed=5))
    got = ref.decode_attention_latent_q_ref(q_lat, q_rope, cq, cs, rq, rs,
                                            pos, scale=0.2)
    plan = tcache.mla_plan(16, 8, torch.float32)
    want = plan.attend_decode_latent(
        q_lat, q_rope, {"ckv": tkv.dequantize_kv(cq, cs),
                        "krope": tkv.dequantize_kv(rq, rs)}, pos, scale=0.2)
    torch.testing.assert_close(got, want, **TOL)
    qplan = tcache.mla_plan(16, 8, torch.float32, "int8")
    via_plan = qplan.attend_decode_latent(
        q_lat, q_rope, {"ckv_q": cq, "ckv_scale": cs, "krope_q": rq,
                        "krope_scale": rs}, pos, scale=0.2)
    assert torch.equal(via_plan, got)


# ---------------------------------------------------------------------------
# model-level refusals and surgery labels
# ---------------------------------------------------------------------------

def test_moe_family_refused_naming_a13():
    """The MoE family is served now (DeepSeek-V2 with its experts and its
    unstacked dense first block), as are the SSM, hybrid, VLM, encoder
    and ResNet families: no family is refused naming a ROADMAP item (A13)
    any more.  A VLM config without cross-attention layers is refused
    (the reference asserts ``cross_attn_every > 1``); an encoder-family
    config builds without a token embedding.  A dense-family config with
    experts builds dense FFNs, as the reference's does."""
    params, _ = get_model(treg.get("deepseek-v2-236b").smoke, "cpu").init(
        torch.Generator().manual_seed(0))
    assert "moe" in params["blocks"] and "mlp" in params["first"]
    vlm = dataclasses.replace(mla_cfg("deepseek-smoke", "torch"),
                              family="vlm")
    with pytest.raises(ValueError, match="cross_attn_every"):
        get_model(vlm, "cpu")
    enc = dataclasses.replace(mla_cfg("deepseek-smoke", "torch"),
                              family="encoder", is_encoder=True)
    params, _ = get_model(enc, "cpu").init(torch.Generator().manual_seed(0))
    assert "embed" not in params and "bias" in params["final_norm"]
    from repro_torch.models.resnet import ResNetModel
    assert isinstance(get_model(treg.get("resnet50").smoke, "cpu"),
                      ResNetModel)
    dense_moe = dataclasses.replace(mla_cfg("deepseek-smoke", "torch"),
                                    moe_num_experts=8)
    params, _ = get_model(dense_moe, "cpu").init(
        torch.Generator().manual_seed(0))
    assert "mlp" in params["blocks"] and "moe" not in params["blocks"]


def test_deepseek_config_mirrors_reference():
    from repro.configs import registry as jreg
    for which in ("full", "smoke"):
        j = getattr(jreg.get("deepseek-v2-236b"), which)
        t = getattr(treg.get("deepseek-v2-236b"), which)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (which, f.name)
        assert t.resolved_moe_d_ff == j.resolved_moe_d_ff


@pytest.mark.parametrize("cfg_name", ["deepseek-smoke"])
def test_surgery_report_classifies_mla_as_reference(cfg_name):
    """The same dense MLA tree through both packages' surgery: every
    linear gets the reference's label, kind and rank, and the factor
    shapes match; under the default targets the mla_* projections stay
    dense.  (The port's axes tree holds the reference's axis names, so
    both passes read the same one.)"""
    params = mla_port_tree(cfg_name, "dense")
    _, taxes = get_model(mla_cfg(cfg_name, "torch"), "cpu").init(
        torch.Generator().manual_seed(0))
    jparams = mla_tree_for_jax(cfg_name, "dense")
    for tree in ("branched", "svd+branched"):
        kw = MLA_LRD[tree]
        tp, _, trep = tdecompose(params, taxes, TLRD(**kw))
        jpp, _, jrep = jdecompose(jparams, taxes, JLRD(**kw))
        got = {d.path: (d.label, d.kind, d.rank) for d in trep.decisions}
        want = {d.path: (d.label, d.kind, d.rank) for d in jrep.decisions}
        assert got == want
        assert {p: tuple(v.shape) for p, v in flat(tp).items()} == \
            {p: tuple(v.shape) for p, v in flat(jpp).items()}
        labels = {d.label for d in trep.decisions if "/mla/" in
                  f"/{d.path}/"}
        assert labels == ({"mla_qb", "mla_kva", "mla_kvb", "attn_o"}
                          | ({"mla_qa"} if cfg_name != "mla-tiny"
                             else set()))
        if tree == "branched":
            assert {d.label for d in trep.decomposed} >= {"attn_o"}
            assert not any(d.label.startswith("mla_")
                           for d in trep.decomposed)


# ---------------------------------------------------------------------------
# the chain kernels' row block at wide ranks
# ---------------------------------------------------------------------------

def _branched_smem(itemsize: int, n: int, r: int):
    """The shared memory formula of ``lrk_common.cuh::branched_smem`` (f32
    staging of BM x KC activations and KC x 64 weights, KC = 128 at 8
    rows and 32 at 32 rows, plus both rank intermediates in the
    activation type), as the smem function the wrapper is handed."""
    def at(bm: int) -> int:
        kc = 128 if bm <= 8 else 32
        return (bm * kc + kc * 64) * 4 + bm * n * 2 * r * itemsize
    return at


@pytest.mark.parametrize("shape,itemsize,m,want_bm", [
    ("llama gate,up", 2, 64, 32),          # (4, 2048, 192, 8192): fits
    ("llama gate,up", 2, 8, 8),            # decode rows
    ("deepseek o", 2, 64, 8),              # r = 480: 258,048 B at 32
    ("deepseek ffn", 2, 64, 8),            # r = 448
    ("deepseek unembed", 2, 64, 8),        # r = 608
    ("deepseek unembed", 4, 64, 8),        # f32, 192,512 B at 8 rows
    ("deepseek o", 2, 37, 8),
])
def test_chain_bm_picks_8_rows_where_32_do_not_fit(shape, itemsize, m,
                                                   want_bm):
    ranks = {"llama gate,up": 192, "deepseek o": 480, "deepseek ffn": 448,
             "deepseek unembed": 608}
    smem_at = _branched_smem(itemsize, 4, ranks[shape])
    bm, smem = build.chain_bm(m, smem_at)
    assert bm == want_bm
    assert smem == smem_at(bm) <= build.SMEM_LIMIT
    if m > 8 and bm == 8:
        assert smem_at(32) > build.SMEM_LIMIT


@pytest.mark.parametrize("shape,r,m", [
    ("vlm gate,up / down", 768, 8), ("vlm gate,up / down", 768, 128),
    ("vlm unembed", 960, 8), ("vlm unembed", 960, 128),
])
def test_chain_bm_picks_4_rows_at_the_vlm_f32_ranks(shape, r, m):
    """f32 chains at the VLM's per-branch ranks fit neither 32 nor 8
    rows (233,472 / 282,624 B at 8) and launch at 4 (133,120 / 157,696
    B); bf16's cluster heights stop at 8."""
    smem_at = _branched_smem(4, 4, r)
    assert smem_at(8) > build.SMEM_LIMIT
    bm, smem = build.chain_bm(m, smem_at, build.chain_heights(torch.float32))
    assert (bm, smem) == (4, {768: 133_120, 960: 157_696}[r])
    assert build.chain_fit(m, smem_at, build.F32_HEIGHTS, shape) == (bm,
                                                                     smem)
    assert build.chain_heights(torch.bfloat16) == build.HEIGHTS == (32, 8)


def test_chain_fit_raises_past_the_4_row_block():
    """Where even 4 rows do not fit, the f32 choice reports the 4-row
    bytes and the gate raises naming the kernel and its ranks."""
    smem_at = _branched_smem(4, 4, 1600)
    assert smem_at(4) > build.SMEM_LIMIT
    assert build.chain_bm(64, smem_at, build.F32_HEIGHTS) == (4, smem_at(4))
    with pytest.raises(ValueError, match=r"ranks \(1600, 1600\) needs "
                       r"\d+ B of shared memory at 4 rows"):
        build.chain_fit(64, smem_at, build.F32_HEIGHTS,
                        "branched_matmul kernel at 4 branches of ranks "
                        "(1600, 1600)")
    with pytest.raises(ValueError, match="at 8 rows"):
        build.chain_fit(64, smem_at, build.HEIGHTS, "bf16 cluster kernel")


def test_chain_bm_reports_an_8_row_launch_that_does_not_fit():
    """Where even 8 rows do not fit, the choice reports the 8-row bytes
    and the wrapper's gate raises on them."""
    bm, smem = build.chain_bm(64, lambda bm: 300_000 * bm)
    assert (bm, smem) == (8, 2_400_000)
    bm, smem = build.chain_bm(4, lambda bm: 1000 * bm)
    assert (bm, smem) == (8, 8000)
