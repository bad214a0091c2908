"""``apply_conv`` (dense, 1x1 SVD pair, Tucker-2, branched Tucker) in the
port against the reference's on the same numpy inputs.

Each case runs NHWC activations through the same factor tree in both
packages, within 1e-5 normalised (max |port - reference| / max
|reference|, f32), at stride 1 and 2 on even and odd sides (32 and 33:
XLA's ``SAME`` puts the extra row and column of a stride-2 window at
the bottom and right).  The grouped core is also held against the plain
sum of its branches at N = 2 and 4 with unequal branches, which a swapped
group axis would break.  The int8 cases replay the reference's
``TestConvCoreQuant`` (``tests/test_quant.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_resnet import one_thread  # noqa: F401  (autouse fixture)

from repro.layers import conv as jconv
from repro.quant.quantize import quantize_tree as jquantize_tree
from repro_torch import bridge
from repro_torch.layers import conv, plan
from repro_torch.quant.quantize import quantize_tree

TOL = 1e-5


def _rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _dense(seed, k, c, s):
    return {"w": _rnd(seed, k, k, c, s, scale=(c * k * k) ** -0.5)}


def _lowrank(seed, c, r, s):
    return {"w0": _rnd(seed, c, r, scale=c ** -0.5),
            "w1": _rnd(seed + 1, r, s, scale=r ** -0.5)}


def _tucker(seed, c, r1, r2, s, k=3):
    return {"tucker_u": _rnd(seed, c, r1, scale=c ** -0.5),
            "core": _rnd(seed + 1, k, k, r1, r2, scale=(r1 * k * k) ** -0.5),
            "tucker_v": _rnd(seed + 2, r2, s, scale=r2 ** -0.5)}


def _branched(seed, n, c, r1, r2, s, k=3):
    """Branched Tucker factors whose branches differ in scale (branch j
    by j + 1), so a swapped branch or group axis shows."""
    grow = (np.arange(n, dtype=np.float32) + 1.0)
    return {"u": _rnd(seed, n, c, r1, scale=c ** -0.5),
            "core": _rnd(seed + 1, n, k, k, r1, r2,
                         scale=(r1 * k * k) ** -0.5)
            * grow[:, None, None, None, None],
            "v": _rnd(seed + 2, n, r2, s, scale=r2 ** -0.5)
            * grow[::-1, None, None].copy()}


def _err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _both(p, x, **kw):
    """(port, reference) outputs of one subtree on NHWC ``x``."""
    jp = jax.tree.map(jnp.asarray, p)
    tp = bridge.to_torch(p, "cpu")
    return (conv.apply_conv(tp, torch.from_numpy(x), **kw).numpy(),
            np.asarray(jconv.apply_conv(jp, jnp.asarray(x), **kw)))


TREES = {
    "dense 3x3": lambda: _dense(1, 3, 16, 24),
    "dense 7x7 stem": lambda: _dense(2, 7, 16, 24),
    "dense 1x1": lambda: _dense(3, 1, 16, 24),
    "svd 1x1": lambda: _lowrank(4, 16, 6, 24),
    "tucker": lambda: _tucker(5, 16, 8, 12, 24),
    "branched N2": lambda: _branched(6, 2, 16, 4, 6, 24),
    "branched N4": lambda: _branched(7, 4, 16, 4, 3, 24),
}


@pytest.mark.parametrize("side", [32, 33])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("tree", list(TREES))
def test_apply_conv_equals_reference(tree, stride, side):
    x = _rnd(side + stride, 2, side, side, 16)
    got, want = _both(TREES[tree](), x, stride=stride)
    assert got.shape == want.shape == (2, -(-side // stride),
                                       -(-side // stride), 24)
    assert _err(got, want) <= TOL


@pytest.mark.parametrize("side,k,stride,pads", [
    (224, 7, 2, (2, 3)), (32, 7, 2, (2, 3)), (112, 3, 2, (0, 1)),
    (16, 3, 2, (0, 1)), (33, 3, 2, (1, 1)), (56, 3, 1, (1, 1)),
    (56, 1, 2, (0, 0)), (33, 1, 2, (0, 0))])
def test_same_padding_is_xlas(side, k, stride, pads):
    assert conv.same_pads(side, k, stride) == pads


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_grouped_core_is_the_sum_of_branches(n, stride):
    """The grouped conv of the branched core equals each branch's own
    Tucker chain, summed (paper Fig. 4)."""
    p = bridge.to_torch(_branched(11 + n, n, 16, 4, 6, 24), "cpu")
    x = torch.from_numpy(_rnd(3, 2, 32, 32, 16))
    y = conv.apply_conv(p, x, stride=stride)
    want = sum(conv.apply_conv({"tucker_u": p["u"][j], "core": p["core"][j],
                                "tucker_v": p["v"][j]}, x, stride=stride)
               for j in range(n))
    assert _err(y, want) <= TOL


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("tree", ["tucker", "branched N2", "branched N4",
                                  "svd 1x1"])
def test_int8_factors_equal_reference(tree, stride):
    """int8 Tucker / branched Tucker factors (per-channel scales), as the
    reference's ``TestConvCoreQuant``: the quantized tree is the
    reference's bit for bit, ``apply_conv`` dequantizes it through the
    plan to the reference's output, and stays within 5e-2 of the f32
    factors."""
    p = TREES[tree]()
    tq = quantize_tree(bridge.to_torch(p, "cpu"))
    jq = jquantize_tree(jax.tree.map(jnp.asarray, p))
    assert set(tq) == set(jq)
    for k in tq:
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
    if "core" in p:
        assert tq["core_q"].dtype == torch.int8
        assert tq["core_scale"].dtype == torch.float32
    assert conv.conv_out_channels(tq) == 24
    x = _rnd(9, 2, 16, 16, 16)
    got = conv.apply_conv(tq, torch.from_numpy(x), stride=stride).numpy()
    want = np.asarray(jconv.apply_conv(jq, jnp.asarray(x), stride=stride))
    assert _err(got, want) <= TOL
    y = conv.apply_conv(bridge.to_torch(p, "cpu"), torch.from_numpy(x),
                        stride=stride).numpy()
    assert np.linalg.norm(got - y) / np.linalg.norm(y) <= 5e-2


@pytest.mark.parametrize("tree", list(TREES))
def test_conv_out_channels_and_kind(tree):
    p = TREES[tree]()
    tp = bridge.to_torch(p, "cpu")
    assert conv.conv_out_channels(tp) == jconv.conv_out_channels(
        jax.tree.map(jnp.asarray, p)) == 24
    from repro.layers import plan as jplan
    kind = plan.build_plan(tp).kind
    assert kind == jplan.build_plan(jax.tree.map(jnp.asarray, p)).kind
    assert (plan.build_plan(tp).matmul_chain()
            == jplan.build_plan(jax.tree.map(jnp.asarray, p)).matmul_chain()
            or kind == plan.KIND_DENSE)
    if kind in plan.CONV_KINDS:
        assert plan.build_plan(tp).kernel_for((8, 16)) is None
        with pytest.raises(ValueError, match="conv plan"):
            plan.build_plan(tp).execute(tp, torch.zeros(8, 16))


def test_branched_1x1_refused_naming_the_subtree():
    """A branched ``{u, xc, v}`` conv subtree: the reference's apply_conv
    raises ``KeyError: 'core'``; the port refuses it with a ValueError
    that names the subtree."""
    p = {"u": _rnd(1, 2, 16, 4), "xc": _rnd(2, 2, 4, 4),
         "v": _rnd(3, 2, 4, 24)}
    x = _rnd(4, 1, 8, 8, 16)
    with pytest.raises(KeyError, match="core"):
        jconv.apply_conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    with pytest.raises(ValueError, match="stage2/block0/conv1"):
        conv.apply_conv(bridge.to_torch(p, "cpu"), torch.from_numpy(x),
                        name="stage2/block0/conv1")


def test_nhwc_views_are_not_copies():
    x = torch.randn(2, 8, 8, 16)
    assert conv.nchw(x).data_ptr() == x.data_ptr()
    assert conv.nchw(x).is_contiguous(memory_format=torch.channels_last)
    y = conv.apply_conv(bridge.to_torch(_dense(1, 3, 16, 24), "cpu"), x)
    assert y.is_contiguous()
