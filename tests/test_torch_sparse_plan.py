"""The port's plans on 2:4 trees vs the reference's: per-factor specs,
``param_count``, ``weight_bytes``, ``quant_bytes``, ``flops_per_token``,
``chain_density``, ``tree_summary``, the kernel each plan takes (with and
without act-quant: sparse plans take ``*_sq`` or the expanded plain
chain, never a qa kernel), ``plan_qa_eligible``, and ``apply_linear``
against the reference's execution (f32, rtol = atol = 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import factor_weights, flat, port_tree_with_axes, to_jax
from repro.core import cost_model as jcost
from repro.layers import plan as jplan
from repro_torch.core import cost_model
from repro_torch.layers import plan as tplan
from repro_torch.layers.param import apply_linear
from repro_torch.quant import quantize as tq
from repro_torch.quant import sparse as tsp
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

MODES = ("int8", "fp8", "none")


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("targets", [None, ("w0", "u")],
                         ids=["all", "partial"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["svd", "branched"])
def test_plans_match_reference_on_sparse_trees(name, mode, targets):
    """The engine's load pipeline (pack, then quantize the rest) run by
    the port on a smoke tree, the result bridged into the reference (the
    packing itself is held to the reference's in
    ``tests/test_torch_sparse.py``)."""
    kw = {} if targets is None else {"targets": targets}
    tp = tsp.sparsify_tree(port_tree_with_axes(name)[0], mode=mode, **kw)
    if mode != "none":
        tp = tq.quantize_tree(tp, mode)
    jp = to_jax(tp)
    jsum = jplan.tree_summary(jplan.build_plan_tree(jp))
    tsum = tplan.tree_summary(tplan.build_plan_tree(tp))
    for k in ("linears", "by_kind", "quantized", "sparse", "param_count",
              "weight_bytes", "quant_bytes"):
        assert tsum[k] == jsum[k], k
    layer0 = lambda t: jax.tree.map(lambda a: a[0], t)   # noqa: E731
    jl, tl = flat(layer0(jp["blocks"])), flat(tp["blocks"])
    for sub in ("attn/q", "attn/k", "mlp/down"):
        jn = {k.split("/")[-1]: v for k, v in jl.items()
              if k.rsplit("/", 1)[0] == sub}
        tn = {k.split("/")[-1]: v[0] for k, v in tl.items()
              if k.rsplit("/", 1)[0] == sub}
        jpl, tpl = jplan.build_plan(jn), tplan.build_plan(tn)
        assert (tpl.kind, tpl.quantized, tpl.sparse) == \
            (jpl.kind, jpl.quantized, jpl.sparse), sub
        for k in ("param_count", "weight_bytes", "quant_bytes",
                  "flops_per_token"):
            assert getattr(tpl, k) == getattr(jpl, k), (sub, k)
        assert tpl.chain_density() == jpl.chain_density(), sub
        for tf_, jf_ in zip(tpl.factors, jpl.factors):
            assert (tf_.shape, tf_.sparsity, tf_.idx_shape, tf_.density,
                    tf_.stored_size, tf_.bytes) == \
                (jf_.shape, jf_.sparsity, jf_.idx_shape, jf_.density,
                 jf_.stored_size, jf_.bytes), (sub, tf_.name)
        d_in = tpl.factors[0].shape[-2]
        for aq in (False, True):
            want = jpl.kernel_for((4, d_in), True, aq)
            # where the reference takes its jnp path, the port expands
            # the factors and runs the plain chain's kernel
            assert tpl.kernel_for((4, d_in), aq) == (want or tpl.kind), sub
            assert cost_model.plan_qa_eligible(tpl, aq) == \
                jcost.plan_qa_eligible(jpl, aq), sub
        x = np.random.default_rng(0).standard_normal((2, 3, d_in),
                                                     np.float32)
        np.testing.assert_allclose(
            apply_linear(tn, torch.from_numpy(x)).numpy(),
            np.asarray(jpl.execute(jn, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_kernel_names_and_qa_eligibility_of_sparse_plans(mode):
    """Canonical compound layouts take the sparse kernels, with or
    without act-quant; never the qa kernels, and the cost model agrees."""
    def w(seed, *shape):
        return torch.from_numpy(factor_weights(seed, shape))
    lr = tsp.sparsify_tree({"w0": w(1, 32, 16), "w1": w(2, 16, 48)},
                           mode=mode)
    br_plain = {"u": w(3, 2, 32, 8), "xc": w(4, 2, 8, 8), "v": w(5, 2, 8, 48)}
    br = tq.quantize_tree(tsp.sparsify_tree(br_plain, mode=mode), mode)
    for tree, name in ((lr, "lowrank_sq"), (br, "branched_sq")):
        plan = tplan.build_plan(tree)
        assert plan.sparse and plan.fully_quantized
        for aq in (False, True):
            assert plan.kernel_for((8, 32), aq) == name
            assert not cost_model.plan_qa_eligible(plan, aq)
    assert tplan.build_plan(lr).factors[0].idx_shape == (2, 8, 1)
    # an unquantized pack and a packed core take the expanded plain chain
    none = tsp.sparsify_tree({"w0": w(1, 32, 16), "w1": w(2, 16, 48)},
                             mode="none")
    assert tplan.build_plan(none).kernel_for((8, 32), True) == "lowrank"
    sp_core = tsp.sparsify_tree(br_plain, mode=mode,
                                targets=("u", "xc", "v"))
    assert tplan.build_plan(sp_core).kernel_for((8, 32)) == "branched"


def test_weight_bytes_formula():
    c, r, s = 32, 16, 48
    plan = tplan.build_plan(tsp.sparsify_tree(
        {"w0": torch.from_numpy(factor_weights(1, (c, r))),
         "w1": torch.from_numpy(factor_weights(2, (r, s)))}))
    assert plan.weight_bytes == (c * r + r * s) // 2 + (c + r) // 2 \
        + 4 * (r + s)
    assert plan.quant_bytes == plan.weight_bytes
    assert plan.param_count == (c * r + r * s) // 2
    assert plan.chain_density() == (0.5, 0.5)
    assert plan.flops_per_token == (c * r + r * s)
