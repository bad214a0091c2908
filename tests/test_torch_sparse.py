"""2:4 sparsity in the port vs the reference on the same numpy inputs — a
replay of ``tests/test_sparse.py``, packing and trees: ``sparsify_array``
bit for bit (int8, e4m3 and unquantized, ties included), ``expand_sparse``
exactly, ``sparsify_tree`` / ``desparsify_tree`` with their axes on a
whole smoke tree and on a small one (every mode, partial targets,
idempotence, skipped dims, quantize afterwards), the axes alignment, and
``sparsify_model``.  The plans are in ``tests/test_torch_sparse_plan.py``,
the plain sparse chains in ``tests/test_torch_sparse_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_same, factor_weights, flat,
                           port_tree_with_axes, to_jax)
from repro.core.surgery import sparsify_model as jsparsify_model
from repro.quant import quantize as jq
from repro.quant import sparse as jsp
from repro_torch.configs.base import LRDConfig
from repro_torch.core.surgery import sparsify_model
from repro_torch.quant import quantize as tq
from repro_torch.quant import sparse as tsp
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
MODES = ("int8", "fp8", "none")


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(32, 16), (3, 40, 24)])
def test_sparsify_array_is_bit_identical_to_reference(shape, mode):
    w = factor_weights(len(shape), shape, top_rows=True)
    w[..., 3] = 0.0                                 # a zero output channel
    got = tsp.sparsify_array(torch.from_numpy(w), mode=mode)
    want = jsp.sparsify_array(jnp.asarray(w), mode=mode)
    for g, jw, name in zip(got, want, ("sp", "idx", "scale")):
        assert_same(g, jw, name)
    idx = got[1].numpy()
    assert (idx[..., 0, :, :] < idx[..., 1, :, :]).all()     # ascending
    assert (idx[..., 0, ::2, 0] == 2).all()         # the dominant top rows
    assert tsp.relative_error_sparse(torch.from_numpy(w), mode=mode) == \
        pytest.approx(jsp.relative_error_sparse(jnp.asarray(w), mode=mode),
                      rel=1e-6)


def test_bf16_pack_keeps_dtype_and_tie_keeps_lower_row():
    """mode="none" keeps a bf16 factor's values bit for bit; rows of equal
    L1 norm (a tie) keep the lower positions, as the reference's stable
    argsort does."""
    w = factor_weights(1, (16, 8))
    w[4:8] = w[4]                                   # group 1: a 4-way tie
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = tsp.sparsify_array(wb, mode="none")
    want = jsp.sparsify_array(jnp.asarray(w).astype(jnp.bfloat16),
                              mode="none")
    for g, jw, name in zip(got, want, ("sp", "idx", "scale")):
        assert_same(g, jw, name)
    assert got[0].dtype == torch.bfloat16 and got[2] is None
    assert got[1][:, 1, 0].tolist() == [0, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_expand_sparse_is_exact(mode, dtype):
    w = factor_weights(7, (2, 24, 40), top_rows=True)
    jpack = jsp.sparsify_array(jnp.asarray(w), mode=mode)
    tpack = tsp.sparsify_array(torch.from_numpy(w), mode=mode)
    got = tsp.expand_sparse(*tpack, dtype=TDT[dtype])
    want = jsp.expand_sparse(*jpack, dtype=JDT[dtype])
    assert_same(got, want)
    dense = got.to(torch.float32).numpy()
    assert ((dense == 0).all(-1).sum(-1) >= 12).all()   # pruned rows zero
    # the default dtypes: bf16 when dequantizing, else the values' own
    assert_same(tsp.expand_sparse(*tpack), jsp.expand_sparse(*jpack))


def test_indivisible_input_dim_raises():
    with pytest.raises(ValueError, match="divisible"):
        tsp.sparsify_array(torch.zeros((30, 8)))
    with pytest.raises(ValueError, match="pattern"):
        tsp.pattern_nm("4:8")


# ---------------------------------------------------------------------------
# Tree rewrite
# ---------------------------------------------------------------------------

def test_sparsify_tree_matches_reference_on_a_smoke_tree():
    """The whole SVD+branched smoke tree, packed to int8 by both: every
    leaf bit for bit, the axes, quantize_tree afterwards (the core xc
    quantized, the packs skipped) and the inverse."""
    params, axes = port_tree_with_axes("branched")
    jp, ja = jsp.sparsify_tree(to_jax(params), axes=axes)
    tp, ta = tsp.sparsify_tree(params, axes=axes)
    jf, tf = flat(jp), flat(tp)
    assert tf.keys() == jf.keys()
    assert any(k.endswith("_sp") for k in tf)
    for k in jf:
        assert_same(tf[k], jf[k], k)
    is_axes = lambda a: isinstance(a, tuple)            # noqa: E731
    assert jax.tree.leaves(ta, is_leaf=is_axes) == \
        jax.tree.leaves(ja, is_leaf=is_axes)
    assert flat(ta).keys() == flat(ja).keys()
    tq_, jq_ = flat(tq.quantize_tree(tp)), flat(jq.quantize_tree(jp))
    assert tq_.keys() == jq_.keys()
    assert any(k.endswith("xc_q") for k in tq_)
    for k in jq_:
        assert_same(tq_[k], jq_[k], k)
    jd, td = flat(jsp.desparsify_tree(jp, jnp.float32)), \
        flat(tsp.desparsify_tree(tp, torch.float32))
    assert td.keys() == jd.keys() == flat(params).keys()
    for k in jd:
        assert_same(td[k], jd[k], k)


def _small_tree(seed: int = 0) -> tuple[dict, dict]:
    """A nested tree of one SVD pair and one branched linear with a
    leading layer axis, a norm and an embedding, with its axes."""
    w = lambda i, *sh: torch.from_numpy(factor_weights(seed + i, sh))  # noqa
    params = {"embed": w(0, 10, 16), "norm": torch.ones(16),
              "blocks": {"k": {"w0": w(1, 2, 16, 8), "w1": w(2, 2, 8, 12)},
                         "o": {"u": w(3, 2, 2, 16, 4),
                               "xc": w(4, 2, 2, 4, 4),
                               "v": w(5, 2, 2, 4, 16)}}}
    axes = {"embed": ("vocab", "embed"), "norm": ("embed",),
            "blocks": {"k": {"w0": ("layers", "embed", "rank"),
                             "w1": ("layers", "rank", "qkv")},
                       "o": {"u": ("layers", "branch", "qkv", "rank"),
                             "xc": ("layers", "branch", "rank", "rank"),
                             "v": ("layers", "branch", "rank", "embed")}}}
    return params, axes


@pytest.mark.parametrize("targets", [None, ("w0", "u")],
                         ids=["all", "partial"])
@pytest.mark.parametrize("mode", MODES)
def test_sparsify_tree_keys_axes_and_idempotence_match_reference(mode,
                                                                 targets):
    params, axes = _small_tree()
    kw = {} if targets is None else {"targets": targets}
    jp, ja = jsp.sparsify_tree(to_jax(params), mode=mode, axes=axes, **kw)
    tp, ta = tsp.sparsify_tree(params, mode=mode, axes=axes, **kw)
    jf, tf = flat(jp), flat(tp)
    assert tf.keys() == jf.keys()
    for k in jf:
        assert_same(tf[k], jf[k], k)
    assert flat(ta) == flat(ja)
    assert "blocks/k/w0_sp" in tf and "blocks/o/u_sp" in tf
    assert ("blocks/k/w1_sp" in tf) == (targets is None)
    assert "embed" in tf and "blocks/o/xc" in tf        # not targeted
    again, again_axes = tsp.sparsify_tree(tp, mode=mode, axes=ta)
    assert flat(again).keys() == tf.keys() and again_axes == ta
    back = flat(tsp.desparsify_tree(tp, torch.float32))
    assert back.keys() == flat(params).keys()
    for k, v in flat(jsp.desparsify_tree(jp, jnp.float32)).items():
        assert_same(back[k], v, k)


def test_sparsify_tree_skips_indivisible_and_quantized_nodes():
    w = torch.from_numpy(factor_weights(3, (30, 8)))
    assert set(tsp.sparsify_tree({"w0": w, "w1": w.T.contiguous()})) == \
        {"w0", "w1_sp", "w1_idx", "w1_scale"}
    q = tq.quantize_tree({"w0": w[:28], "w1": w[:8].T.contiguous()})
    assert tsp.sparsify_tree(q).keys() == q.keys()
    assert not tsp.is_sparse(q) and tsp.is_sparse(tsp.sparsify_tree(
        {"w0": w[:28]}))


def test_align_quantized_axes_covers_sparse_leaves():
    w0, w1 = (torch.from_numpy(factor_weights(s, sh))
              for s, sh in ((1, (32, 16)), (2, (16, 48))))
    axes = {"w0": ("embed", "rank"), "w1": ("rank", "ffn")}
    sp, sp_axes = tsp.sparsify_tree({"w0": w0, "w1": w1}, axes=axes)
    aligned = tq.align_quantized_axes(sp, axes)
    assert aligned == sp_axes
    assert aligned == jq.align_quantized_axes(
        {k: None for k in sp}, axes)
    assert aligned["w0_sp"] == (None, "embed", "rank")
    assert aligned["w0_idx"] == (None, "embed", None)
    assert aligned["w0_scale"] == (None, "rank")


@pytest.mark.parametrize("quantize", ["int8", "none"])
def test_sparsify_model_matches_reference(quantize):
    from repro.configs.base import LRDConfig as JLRD
    params, axes = port_tree_with_axes("branched")
    lrd = dict(sparsify="2:4", quantize=quantize)
    jp, ja = jsparsify_model(to_jax(params), axes, JLRD(**lrd))
    tp, ta = sparsify_model(params, axes, LRDConfig(**lrd))
    jf, tf = flat(jp), flat(tp)
    assert tf.keys() == jf.keys()
    for k in jf:
        assert_same(tf[k], jf[k], k)
    assert flat(ta) == flat(ja)
    assert sparsify_model(params, axes, LRDConfig()) == (params, axes)


@pytest.mark.parametrize("mode", MODES)
def test_packs_are_contiguous(mode):
    """The kernels read the packs as dense row-major tiles."""
    w = torch.from_numpy(factor_weights(9, (2, 16, 8)))
    for t in tsp.sparsify_array(w, mode=mode):
        assert t is None or t.is_contiguous()
