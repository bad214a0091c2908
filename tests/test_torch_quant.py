"""Weight quantization in the port vs the reference on the same numpy
inputs: quantize_array bit for bit (int8 and fp8), the tree rewrite and
its axes, the fp8 bridge, the plans' accounting and kernel choice, and
the plain quantized chains vs the reference's oracles and its Pallas
kernels (interpret mode on the CPU).

Tolerances: f32 chains at rtol = atol = 1e-5 (the same exact products
summed in another order); bf16 chains compared in f32 at 2e-2, as the
unquantized chains (an intermediate that rounds to bf16 in both can
differ by one last bit after a last-bit difference in its f32 sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flat, jax_tree, to_numpy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.layers import plan as jplan
from repro.layers.param import apply_linear as japply_linear
from repro.quant import quantize as jq
from repro_torch import bridge
from repro_torch.kernels import ref
from repro_torch.layers import plan as tplan
from repro_torch.layers.param import apply_linear
from repro_torch.quant import quantize as tq

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bits(a) -> np.ndarray:
    """Raw bytes of an array or tensor (fp8 compared through uint8)."""
    if isinstance(a, torch.Tensor):
        return bridge.tensor_to_array(a).view(np.uint8)
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("shape", [(40, 24), (3, 40, 24)])
def test_quantize_array_is_bit_identical_to_reference(mode, shape):
    rng = np.random.default_rng(len(shape))
    w = (rng.standard_normal(shape, np.float32)
         * rng.uniform(0.01, 10.0, (1,) * (len(shape) - 1) + (shape[-1],)
                       ).astype(np.float32))
    w[..., 5] = 0.0                                    # a zero channel
    jq_, js = jq.quantize_array(jnp.asarray(w), mode)
    tq_, ts = tq.quantize_array(torch.from_numpy(w), mode)
    assert tq_.dtype == {"int8": torch.int8,
                         "fp8": torch.float8_e4m3fn}[mode]
    np.testing.assert_array_equal(_bits(tq_), _bits(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[..., 5].abs().max()) == 0.0       # zero channel: scale 0
    assert float(tq_[..., 5].to(torch.float32).abs().max()) == 0.0
    np.testing.assert_array_equal(
        tq.dequantize_array(tq_, ts, torch.float32).numpy(),
        np.asarray(jq.dequantize_array(jq_, js, jnp.float32)))
    assert tq.relative_error(torch.from_numpy(w), mode) == pytest.approx(
        jq.relative_error(jnp.asarray(w), mode), rel=1e-6)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_tree_keys_axes_and_idempotence_match_reference(mode):
    params, axes = jax_tree("branched")
    jqp, jqa = jq.quantize_tree(params, mode, axes=axes)
    tqp, tqa = tq.quantize_tree(bridge.to_torch(to_numpy(params), "cpu"),
                                mode, axes=axes)
    jf, tf = flat(jqp), flat(tqp)
    assert tf.keys() == jf.keys()
    for k in jf:
        np.testing.assert_array_equal(_bits(tf[k]), _bits(jf[k]), err_msg=k)
    is_axes = lambda a: isinstance(a, tuple)            # noqa: E731
    assert jax.tree.leaves(tqa, is_leaf=is_axes) == \
        jax.tree.leaves(jqa, is_leaf=is_axes)
    assert flat(tqa).keys() == flat(jqa).keys()
    again = flat(tq.quantize_tree(tqp, mode))           # idempotent
    assert again.keys() == tf.keys()
    assert all(again[k] is tf[k] for k in tf)
    assert tq.tree_bytes(tqp) == jq.tree_bytes(jqp)
    back = flat(tq.dequantize_tree(tqp, torch.float32))
    jback = flat(jq.dequantize_tree(jqp, jnp.float32))
    assert back.keys() == jback.keys()
    for k in jback:
        np.testing.assert_array_equal(_bits(back[k]), _bits(jback[k]))


def test_fp8_tree_crosses_the_bridge_bit_exactly():
    jqp = to_numpy(jq.quantize_tree(jax_tree("svd")[0], "fp8"))
    tt = bridge.to_torch(jqp, "cpu")
    src, got = flat(jqp), flat(tt)
    fp8 = [k for k, a in src.items() if a.dtype.name == "float8_e4m3fn"]
    assert fp8 and all(got[k].dtype == torch.float8_e4m3fn for k in fp8)
    back = flat(bridge.to_numpy(tt))
    for k, a in src.items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(_bits(back[k]), _bits(a))


@pytest.mark.parametrize("targets", [None, ("w0", "u")],
                         ids=["all", "mixed"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("name", ["svd", "branched"])
def test_plans_match_reference_on_quantized_trees(name, mode, targets):
    kw = {} if targets is None else {"targets": targets}
    jqp = jq.quantize_tree(jax_tree(name)[0], mode, **kw)
    tqp = bridge.to_torch(to_numpy(jqp), "cpu")
    jsum = jplan.tree_summary(jplan.build_plan_tree(jqp))
    tsum = tplan.tree_summary(tplan.build_plan_tree(tqp))
    for k in ("linears", "by_kind", "quantized", "param_count",
              "weight_bytes", "quant_bytes"):
        assert tsum[k] == jsum[k], k
    layer0 = lambda t: jax.tree.map(lambda a: a[0], t)   # noqa: E731
    jl, tl = flat(layer0(jqp["blocks"])), flat(tqp["blocks"])
    for sub in ("attn/q", "attn/k", "attn/o", "mlp/down"):
        jp = {k.split("/")[-1]: v for k, v in jl.items()
              if k.rsplit("/", 1)[0] == sub}
        tp = {k.split("/")[-1]: v[0] for k, v in tl.items()
              if k.rsplit("/", 1)[0] == sub}
        jpl, tpl = jplan.build_plan(jp), tplan.build_plan(tp)
        assert (tpl.kind, tpl.quantized, tpl.fully_quantized) == \
            (jpl.kind, jpl.quantized, jpl.fully_quantized), sub
        assert (tpl.weight_bytes, tpl.quant_bytes) == \
            (jpl.weight_bytes, jpl.quant_bytes), sub
        d_in = tpl.factors[0].shape[-2]
        want = jpl.kernel_for((4, d_in), use_pallas=True)
        # a mixed plan runs the plain chain's kernel on dequantized
        # factors, where the reference takes its dequantizing jnp path
        assert tpl.kernel_for((4, d_in)) == (want or tpl.kind), sub
        x = np.random.default_rng(0).standard_normal((2, 3, d_in),
                                                     np.float32)
        np.testing.assert_allclose(
            apply_linear(tp, torch.from_numpy(x)).numpy(),
            np.asarray(japply_linear(jp, jnp.asarray(x))),
            **TOL["float32"])


def _qpair(rng, shape, mode):
    """A factor quantized by the reference, as (jax q, jax scale, torch q,
    torch scale); values scaled like the surgery's factors."""
    w = rng.standard_normal(shape, np.float32) * shape[-2] ** -0.5
    q, s = jq.quantize_array(jnp.asarray(w), mode)
    tqv = bridge.array_to_tensor(np.asarray(q), "cpu")
    return q, s, tqv, torch.from_numpy(np.array(s))


def _close(got: torch.Tensor, want, dtype: str):
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


C, S = 48, 200            # S is not a multiple of 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m", [1, 8, 37])
def test_lowrank_q_plain_matches_reference_and_pallas(m, mode, dtype):
    rng = np.random.default_rng(m)
    xa = rng.standard_normal((m, C), np.float32)
    x, tx = jnp.asarray(xa).astype(JDT[dtype]), \
        torch.from_numpy(xa).to(TDT[dtype])
    w0q, w0s, tw0q, tw0s = _qpair(rng, (C, 16), mode)
    w1q, w1s, tw1q, tw1s = _qpair(rng, (16, S), mode)
    got = ref.lowrank_matmul_q_ref(tx, tw0q, tw0s, tw1q, tw1s)
    assert tuple(got.shape) == (m, S)
    _close(got, jref.lowrank_matmul_q_ref(x, w0q, w0s, w1q, w1s), dtype)
    _close(got, jops.lowrank_matmul_q(x, w0q, w0s, w1q, w1s,
                                      force_kernel=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m", [1, 8, 37])
def test_branched_q_plain_matches_reference_and_pallas(m, mode, dtype):
    rng = np.random.default_rng(100 + m)
    xa = rng.standard_normal((m, C), np.float32)
    x, tx = jnp.asarray(xa).astype(JDT[dtype]), \
        torch.from_numpy(xa).to(TDT[dtype])
    n, r = 3, 8
    uq, us, tuq, tus = _qpair(rng, (n, C, r), mode)
    xq, xs, txq, txs = _qpair(rng, (n, r, r), mode)
    vq, vs, tvq, tvs = _qpair(rng, (n, r, S), mode)
    got = ref.branched_matmul_q_ref(tx, tuq, tus, txq, txs, tvq, tvs)
    assert tuple(got.shape) == (m, S)
    _close(got, jref.branched_matmul_q_ref(x, uq, us, xq, xs, vq, vs), dtype)
    _close(got, jops.branched_matmul_q(x, uq, us, xq, xs, vq, vs,
                                       force_kernel=True), dtype)


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import branched_matmul_q as bqk
    from repro_torch.kernels import decode_attention_q as dak
    from repro_torch.kernels import lowrank_matmul_q as lqk
    x = torch.zeros((2, 8))
    q8, s1 = torch.zeros((8, 4), dtype=torch.int8), torch.zeros((1, 4))
    with pytest.raises(ValueError, match="not a CUDA device"):
        lqk.lowrank_matmul_q(x, q8, s1, q8.T.contiguous(), torch.zeros((1, 8)))
    u = torch.zeros((2, 8, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="not a CUDA device"):
        bqk.branched_matmul_q(x, u, torch.zeros((2, 1, 4)),
                              torch.zeros((2, 4, 4), dtype=torch.int8),
                              torch.zeros((2, 1, 4)),
                              torch.zeros((2, 4, 8), dtype=torch.int8),
                              torch.zeros((2, 1, 8)))
    kv = torch.zeros((2, 16, 2, 16), dtype=torch.int8)
    sc = torch.zeros((2, 2, 16))
    with pytest.raises(ValueError, match="CUDA only"):
        dak.decode_attention_q(torch.zeros((2, 2, 3, 16)), kv, sc, kv, sc,
                               torch.zeros((2,), dtype=torch.int32))
