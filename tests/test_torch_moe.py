"""The port's MoE layer (``layers/moe.py``) against the reference's on
the CPU, f32, from the same numpy inputs: the sort-based dispatch (top-k
ties to the lower expert, capacity overflow, the empty-slot sentinel, an
all-zero row), the f32 combine, ``apply_moe`` on the global and the
grouped dispatch (with and without shared experts, SwiGLU and GELU), the
expert products of dense, SVD-pair and branched banks; and the refusal
of a quantized or 2:4-packed decomposed expert bank.  (The MoE trees'
training parity: ``test_torch_moe_train.py``.)

Tolerance: integer outputs (slot tokens) equal; f32 values within 1e-5
of their largest element."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import smoke_cfg, smoke_port_tree, torch_threads
from repro.layers import moe as jmoe
from repro_torch.configs.base import LRDConfig, RunConfig
from repro_torch.core.surgery import decompose_model
from repro_torch.layers import moe
from repro_torch.quant.quantize import quantize_tree
from repro_torch.quant.sparse import sparsify_tree
from repro_torch.serve.engine import ServeEngine

TOL = 1e-5
D, E, K = 16, 8, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# dispatch / combine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,cap", [(24, 8), (24, 2), (9, 1), (6, 40)],
                         ids=["roomy", "overflow", "cap1", "wide"])
def test_dispatch_and_combine_match_reference(t, cap):
    """Rows 0 and 3 are all zero: uniform gates, so their top-k is the
    tie rule's (the lowest experts)."""
    xt = _rand(0, t, D)
    xt[[0, 3]] = 0.0
    router = _rand(1, D, E, scale=0.5)
    want = jmoe._dispatch(jnp.asarray(xt), jnp.asarray(router), K, cap)
    got = moe._dispatch(_t(xt), _t(router), K, cap)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        _close(g, w)
    # the zero rows took experts 0 and 1 at gate 1/2 each
    _, eids = moe._topk(torch.softmax(_t(xt) @ _t(router), -1), K)
    assert eids[0].tolist() == eids[3].tolist() == [0, 1]
    ye = _rand(2, E * cap, D)
    _close(moe._combine(_t(ye), got[1], got[2], t, torch.float32),
           jmoe._combine(jnp.asarray(ye), want[1], want[2], t,
                         jnp.float32))
    if cap == 2:      # some assignments overflowed into the dropped slot
        assert (got[1] < t).sum() < t * K


def test_topk_breaks_ties_to_the_lower_index():
    gates = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4]])
    vals, idx = moe._topk(gates, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(gates.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_capacity_rounds_half_to_even():
    # t * k / e * factor = 2.5 -> 2 (Python's round), 3.5 -> 4
    assert moe.capacity(4, 1, 2, 1.25) == 2
    assert moe.capacity(28, 1, 10, 1.25) == 4
    assert moe.capacity(8, 6, 160, 1.25) == 1      # DeepSeek-V2 decode
    assert moe.capacity(8, 6, 64, 1.25) == 1       # moonshot decode


# ---------------------------------------------------------------------------
# apply_moe and the expert products
# ---------------------------------------------------------------------------

def _moe_params(seed, act, shared):
    """One MoE layer's params from numpy: the router, the banks, and the
    shared experts when ``shared``."""
    rng = np.random.default_rng(seed)
    f = 24

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)
    p = {"router": w(D, E) * 2,
         "experts": {"up": {"w": w(E, D, f)}, "down": {"w": w(E, f, D)}}}
    if act == "swiglu":
        p["experts"]["gate"] = {"w": w(E, D, f)}
    if shared:
        p["shared"] = {"up": {"w": w(D, 2 * f)}, "down": {"w": w(2 * f, D)}}
        if act == "swiglu":
            p["shared"]["gate"] = {"w": w(D, 2 * f)}
    return p


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("shape,groups", [((2, 32), 0), ((2, 32), 4),
                                          ((3, 11), 7), ((2, 8), 4)],
                         ids=["global", "grouped", "indivisible",
                              "groups-under-E"])
def test_apply_moe_matches_reference(shape, groups, act):
    """``groups`` 4 on 64 tokens takes the grouped dispatch (16 tokens a
    group >= E); 33 tokens over 7 groups and 16 tokens over 4 groups
    (4 < E a group) fall back to the global one."""
    p = _moe_params(3, act, shared=act == "swiglu")
    x = _rand(4, *shape, D)
    x[0, 0] = 0.0
    kw = dict(top_k=K, capacity_factor=1.25, act=act,
              dispatch_groups=groups)
    wy, waux = jmoe.apply_moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              **kw)
    y, aux = moe.apply_moe(jax.tree.map(_t, p), _t(x), **kw)
    _close(y, wy)
    assert float(aux) == pytest.approx(float(waux), rel=TOL)


def _banks(kind, seed=5):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)
    if kind == "dense":
        return {"w": w(E, D, 12)}
    if kind == "lowrank":
        return {"w0": w(E, D, 6), "w1": w(E, 6, 12)}
    return {"u": w(E, 3, D, 4), "xc": w(E, 3, 4, 4), "v": w(E, 3, 4, 12)}


@pytest.mark.parametrize("kind", ["dense", "lowrank", "branched"])
def test_expert_matmul_matches_reference(kind):
    bank = _banks(kind)
    x = _rand(6, E, 5, D)
    want = jmoe._expert_matmul(jax.tree.map(jnp.asarray, bank),
                               jnp.asarray(x), "up", jmoe.MoEOpts())
    _close(moe._expert_matmul(jax.tree.map(_t, bank), _t(x)), want)


def test_expert_matmul_refuses_other_banks():
    with pytest.raises(ValueError, match="expert bank"):
        moe._expert_matmul({"w0_q": torch.zeros(E, D, 4)},
                           torch.zeros(E, 2, D))


# ---------------------------------------------------------------------------
# the refusal of quantized / packed expert banks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("how", ["quantize", "sparsify", "engine"])
def test_quantized_decomposed_expert_bank_refused(how):
    """The reference's _expert_matmul reads w0 / u and so cannot run a
    quantized or packed bank (KeyError at its first forward); the port
    refuses to make one."""
    tp = smoke_port_tree("moonshot-v1-16b-a3b", "branched")[0]
    with pytest.raises(ValueError, match="experts"):
        if how == "quantize":
            quantize_tree(tp, "int8")
        elif how == "sparsify":
            sparsify_tree(tp, "2:4", mode="int8")
        else:
            ServeEngine(RunConfig(model=smoke_cfg("moonshot-v1-16b-a3b",
                                                  "torch")), tp,
                        device="cpu", quantize="int8", slots=2, max_seq=32)


def test_dense_expert_banks_pass_quantization_untouched():
    """An undecomposed (ORG) bank's ``w`` is not a factor key: it passes
    through, as in the reference, while the decomposed shared experts
    quantize."""
    import dataclasses
    dense, axes = smoke_port_tree("moonshot-v1-16b-a3b", "dense")
    lrd = dataclasses.replace(LRDConfig(enabled=True, rank_mode="ratio",
                                        min_dim=16),
                              targets=("attn_q", "ffn_up", "ffn_down"))
    tp, _, _ = decompose_model(dense, axes, lrd)
    q = quantize_tree(tp, "int8")
    assert q["blocks"]["moe"]["experts"] is not None
    for bank in ("up", "gate", "down"):
        assert set(q["blocks"]["moe"]["experts"][bank]) == {"w"}
        assert torch.equal(q["blocks"]["moe"]["experts"][bank]["w"],
                           tp["blocks"]["moe"]["experts"][bank]["w"])
    assert "w0_q" in q["blocks"]["moe"]["shared"]["up"]


@pytest.mark.parametrize("shape", [(3, 40, 24), (2, 24, 40), (2, 3, 32, 32)])
def test_gram_svd_keeps_the_top_singular_triplets(shape):
    """The batched Gram path of the SVD (taken for a batch of matrices
    on a CUDA device, an expert bank's) gives the top singular values of
    ``torch.linalg.svd`` and the same rank-r reconstruction, tall and
    wide, within 1e-4 of the largest (the f32 Gram matrix squares the
    condition, so the smallest of a full rank lose digits first); a CPU
    tensor still takes ``torch.linalg.svd``."""
    from repro_torch.core import svd
    w = torch.from_numpy(_rand(7, *shape))
    u2, s2, vt2 = torch.linalg.svd(w, full_matrices=False)
    for r in (6, min(shape[-2:])):
        u, s, vt = svd._gram_svd(w, r)
        _close(s, s2[..., :r].numpy(), tol=1e-4)
        rec = (u * s[..., None, :]) @ vt
        want = (u2[..., :r] * s2[..., None, :r]) @ vt2[..., :r, :]
        _close(rec, want.numpy(), tol=1e-4)
    f = svd.svd_decompose(w, 6)
    want = svd.SVDFactors(
        u2[..., :6] * s2[..., None, :6].sqrt(),
        s2[..., :6, None].sqrt() * vt2[..., :6, :])
    assert torch.equal(f.w0, want.w0) and torch.equal(f.w1, want.w1)


def test_chip_smoke_routing_counts_near_ties_apart():
    """The MoE checks' routing comparison (``chip_smoke._routing``): a
    reordered top-k is the same routing; a swap at the top-k boundary is
    a near tie where the reference's gates of the two experts lie within
    ``ROUTER_TIE`` of each other, else a routing difference."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    gates = torch.tensor([[0.5, 0.3, 0.1, 0.1 + 1e-7],
                          [0.4, 0.35, 0.2, 0.05]])
    want = [(torch.tensor([[0, 1], [0, 1]]), gates)]
    same = chip_smoke._routing([(torch.tensor([[1, 0], [0, 1]]), gates)],
                               want)
    assert same["choices_equal"] == "4/4" and same["reordered_tokens"] == 1
    tie = torch.tensor([[0.5, 0.3, 0.3 + 1e-7, 0.1], [0.4, 0.35, 0.2, 0.05]])
    got = chip_smoke._routing([(torch.tensor([[0, 2], [0, 1]]), tie)],
                              [(torch.tensor([[0, 1], [0, 1]]), tie)])
    assert got["near_ties"] == 1 and got["beyond_near_ties"] == 0
    assert got["first_unequal"]["experts"] == [2, 1]
    far = chip_smoke._routing([(torch.tensor([[0, 1], [0, 2]]), gates)],
                              want)
    assert far["near_ties"] == 0 and far["beyond_near_ties"] == 1


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "deepseek-v2-236b"])
def test_reference_tree_layout_is_the_ports(name):
    """The reference's MoE trees (DeepSeek-V2's with its unstacked
    ``first`` block) have the port's layout key for key, shape for shape
    and dtype for dtype (``jax.eval_shape`` of the reference's init), so
    the bridge carries ``router``, ``experts`` and ``first`` over as they
    are."""
    from _torch_parity import flat
    from repro.models.api import get_model as jget_model
    jm = jget_model(smoke_cfg(name, "jax"))
    want = flat(jax.eval_shape(lambda k: jm.init(k)[0],
                               jax.random.PRNGKey(0)))
    got = flat(smoke_port_tree(name, "dense")[0])
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert any(k.endswith("moe/router") for k in got)
    assert ("first/mlp/up/w" in got) == (name == "deepseek-v2-236b")
