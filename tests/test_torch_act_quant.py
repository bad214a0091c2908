"""The port's int8 activation prefill against the reference's, on the same
numpy inputs.

* ``quantize_rows``: bit-identical to the reference's (zero rows get
  scale 0, bf16 input, row-local scales);
* the plain versions of B6 (``lowrank_matmul_qa``) and B7
  (``branched_matmul_qa``): bit-identical to the reference's oracles,
  within 1e-5 normalised (f32) of its Pallas kernels in interpret mode,
  and 0 differing int8 values in every requantized intermediate;
* dispatch: ``kernel_for`` picks the qa kernels on int8 plans only (fp8
  plans keep the weight-only kernels, mixed plans the dequantized plain
  chain), as the reference's does; the serve path never runs them on
  decode; ``plan_qa_eligible`` / ``plan_act_stream_bytes`` equal the
  reference's (fp8 quirk included);
* the engine's act-quant checks and its chunked == whole-prefill
  exactness.

The greedy streams against the reference engine are in
``tests/test_torch_serve_act_quant.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcost
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.lowrank_matmul_qa import quantize_rows as jquantize_rows
from repro.layers import plan as jplan
from repro.quant import quantize_array as jquantize_array
from repro.quant import quantize_tree as jquantize_tree
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.configs.base import LRDConfig, RunConfig
from repro_torch.core import cost_model
from repro_torch.core.surgery import decompose_model
from repro_torch.kernels import ops, ref
from repro_torch.layers import plan as lplan
from repro_torch.models.api import get_model
from repro_torch.quant.quantize import quantize_tree
from repro_torch.serve.engine import Request, ServeEngine
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# quantize_rows
# ---------------------------------------------------------------------------

def _rows_case(name):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 96)).astype(np.float32)
    if name == "zero-rows":
        x[[0, 5, 15]] = 0
    if name == "loud-row":
        x[3] *= 1e4
    if name == "half-ties":      # scale exactly 1: .5 quotients round even
        x[:, :4] = np.array([0.5, -0.5, 1.5, 2.5], np.float32)
        x[:, 4] = 127.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "zero-rows", "loud-row",
                                  "half-ties"])
def test_quantize_rows_bit_identical(case, dtype):
    x = jnp.asarray(_rows_case(case)).astype(dtype)
    want_q, want_s = jquantize_rows(x)
    got_q, got_s = ref.quantize_rows(bridge.to_torch(np.asarray(x), "cpu"))
    assert got_q.dtype == torch.int8 and got_s.shape == (16, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if case == "zero-rows":
        assert float(got_s[0, 0]) == 0.0 and not got_q[0].any()


# ---------------------------------------------------------------------------
# B6 / B7 plain versions vs the reference's oracle and Pallas kernel
# ---------------------------------------------------------------------------

def _factor(rng, *shape):
    q, s = jquantize_array(jnp.asarray(rng.standard_normal(shape) * 0.05,
                                       jnp.float32))
    return np.asarray(q), np.asarray(s)


def _qa_case(kind, m, c, r, s, n, dtype, seed=0):
    """numpy x (one all-zero row) and int8 factors quantized by the
    reference."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, c)) * 0.1).astype(np.float32)
    x[m // 2] = 0
    x = np.asarray(jnp.asarray(x).astype(dtype))
    if kind == "lowrank":
        facs = [_factor(rng, c, r), _factor(rng, r, s)]
    else:
        facs = [_factor(rng, n, c, r), _factor(rng, n, r, r),
                _factor(rng, n, r, s)]
    return (x, *[a for pair in facs for a in pair])


def _intermediates(args, qrows, dot, n):
    """The requantized int8 intermediates of the chain, per branch."""
    x, factors = args[0], args[1:]
    xq, xs = qrows(x)
    out = []
    for i in range(n):
        aq, a_s = xq, xs
        for j in range(0, len(factors) - 2, 2):
            wq, ws = factors[j], factors[j + 1]
            if n > 1:
                wq, ws = wq[i], ws[i]
            aq, a_s = qrows(dot(aq, wq) * a_s * ws)
            out.append(np.asarray(aq))
    return out


QA_CASES = [("lowrank", 37, 256, 64, 96, 1), ("lowrank", 8, 128, 16, 384, 1),
            ("branched", 37, 256, 32, 96, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,m,c,r,s,n", QA_CASES)
def test_qa_plain_matches_reference(kind, m, c, r, s, n, dtype):
    args = _qa_case(kind, m, c, r, s, n, dtype)
    name = f"{kind}_matmul_qa"
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(getattr(jref, name + "_ref")(*jargs), np.float32)
    pallas = np.asarray(getattr(jops, name)(*jargs, force_kernel=True),
                        np.float32)
    targs = bridge.to_torch(list_tree(args), "cpu")
    got = getattr(ref, name + "_ref")(*targs.values())
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, s)
    got = got.to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)          # same folds
    assert not got[m // 2].any()                      # the zero row
    scale = np.abs(want).max()
    tol = 1e-5 if dtype == "float32" else 2 ** -7     # one bf16 rounding
    assert np.abs(got - pallas).max() <= tol * scale
    # every requantized intermediate: 0 differing int8 values
    jh = _intermediates(jargs, jquantize_rows,
                        lambda a, b: jnp.matmul(
                            a, b, preferred_element_type=jnp.int32)
                        .astype(jnp.float32), n)
    th = _intermediates(list(targs.values()), ref.quantize_rows,
                        ref._int_dot, n)
    assert len(th) == len(jh) == (1 if kind == "lowrank" else 2 * n)
    for a, b in zip(th, jh):
        assert int((a != b).sum()) == 0


def list_tree(args):
    return {str(i): a for i, a in enumerate(args)}


def test_int_dot_is_exact_at_full_width():
    """A row of 8192 values of 127 against 127s: 132,128,768 exactly (an
    int8 product would wrap, an f32 sum would round)."""
    a = torch.full((2, 8192), 127, dtype=torch.int8)
    b = torch.full((8192, 3), 127, dtype=torch.int8)
    b[:, 1] = -127
    got = ref._int_dot(a, b)
    assert got.dtype == torch.float32
    assert got[0].tolist() == [float(np.float32(8192 * 127 * 127)),
                               float(np.float32(-8192 * 127 * 127)),
                               float(np.float32(8192 * 127 * 127))]


def test_qa_ops_flatten_leading_dims():
    args = _qa_case("lowrank", 48, 128, 32, 64, 1, "float32")
    targs = [_t(a) for a in args]
    x3 = targs[0].reshape(2, 24, 128)
    got = ops.lowrank_matmul_qa(x3, *targs[1:])
    assert got.shape == (2, 24, 64)
    assert torch.equal(got.reshape(48, 64),
                       ops.lowrank_matmul_qa(targs[0], *targs[1:]))


# ---------------------------------------------------------------------------
# dispatch and the cost model's activation stream
# ---------------------------------------------------------------------------

def _tree(kind, mode, targets=None):
    """A reference linear subtree, quantized by the reference, as numpy."""
    rng = np.random.default_rng(1)
    shapes = ({"w0": (128, 32), "w1": (32, 64)} if kind == "lowrank" else
              {"u": (4, 128, 16), "xc": (4, 16, 16), "v": (4, 16, 64)})
    p = {k: jnp.asarray(rng.standard_normal(s) * 0.1, jnp.float32)
         for k, s in shapes.items()}
    if mode != "none":
        kw = {"targets": targets} if targets else {}
        p = jquantize_tree(p, mode, **kw)
    return {k: np.asarray(v) for k, v in p.items()}


DISPATCH = [  # (kind, quant mode, targets, act_quantize, port's kernel)
    ("lowrank", "int8", None, True, "lowrank_qa"),
    ("branched", "int8", None, True, "branched_qa"),
    ("lowrank", "int8", None, False, "lowrank_q"),
    ("branched", "int8", None, False, "branched_q"),
    ("lowrank", "fp8", None, True, "lowrank_q"),
    ("branched", "fp8", None, True, "branched_q"),
    ("lowrank", "none", None, True, "lowrank"),
    ("lowrank", "int8", ("w0",), True, "lowrank"),     # mixed: plain chain
]


@pytest.mark.parametrize("kind,mode,targets,aq,want", DISPATCH)
def test_kernel_for_matches_reference(kind, mode, targets, aq, want):
    p = _tree(kind, mode, targets)
    plan = lplan.build_plan(bridge.to_torch(p, "cpu"))
    jp = jplan.build_plan({k: jnp.asarray(v) for k, v in p.items()})
    assert plan.kernel_for((256, 128), act_quantize=aq) == want
    # the reference names the same kernel; a mixed plan it runs on its
    # dequantizing jnp path (None), which the port's plain chain repeats
    jwant = None if targets else want
    assert jp.kernel_for((256, 128), True, act_quantize=aq) == jwant
    assert cost_model.plan_qa_eligible(plan, aq) \
        == jcost.plan_qa_eligible(jp, aq)
    for act_bytes in (2, 4):
        assert cost_model.plan_act_stream_bytes(
            plan, act_bytes=act_bytes, act_quantize=aq) \
            == jcost.plan_act_stream_bytes(jp, act_bytes=act_bytes,
                                           act_quantize=aq)


def test_qa_eligible_says_yes_for_fp8_as_the_reference_does():
    """The reference's quirk, kept: eligibility tests the value width,
    dispatch the dtype."""
    plan = lplan.build_plan(bridge.to_torch(_tree("lowrank", "fp8"), "cpu"))
    assert cost_model.plan_qa_eligible(plan, True)
    assert plan.kernel_for((8, 128), act_quantize=True) == "lowrank_q"


@pytest.mark.parametrize("kind", ["lowrank", "branched"])
def test_apply_linear_act_quant_close_to_weight_only(kind):
    from repro_torch.layers.param import apply_linear
    p = bridge.to_torch(_tree(kind, "int8"), "cpu")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, 40, 128)).astype(np.float32) * 0.1)
    y_wq = apply_linear(p, x)
    y_qa = apply_linear(p, x, act_quantize=True)
    assert y_qa.shape == y_wq.shape and y_qa.dtype == y_wq.dtype
    assert float((y_qa - y_wq).norm() / y_wq.norm()) <= 5e-2
    dense = bridge.to_torch(_tree(kind, "none"), "cpu")
    assert torch.equal(apply_linear(dense, x, act_quantize=True),
                       apply_linear(dense, x))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

LONG = tuple((i * 7 + 3) % 50 + 1 for i in range(21))


@pytest.fixture(scope="module")
def serve_setup():
    cfg = dataclasses.replace(registry.get("llama3.2-1b").smoke,
                              dtype="float32")
    lrd = LRDConfig(enabled=True, rank_mode="aligned", rank_align=8,
                    min_dim=32, branches=2)
    params, axes = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    params, _, _ = decompose_model(params, axes, lrd)
    return RunConfig(model=cfg, lrd=lrd), params


def _engine(run, params, **kw):
    kw = {"slots": 2, "max_seq": 64, "quantize": "int8",
          "act_quantize": "int8", "device": "cpu", **kw}
    return ServeEngine(run, params, **kw)


def _serve(eng, prompts, n=6):
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(r.status == "finished" for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("kvq", [None, "int8"])
def test_chunked_equals_whole_with_act_quant(serve_setup, kvq):
    """Per-row scales see the same rows whether the prompt arrives whole
    or in chunks: greedy streams are identical."""
    run, params = serve_setup
    whole = _serve(_engine(run, params, admission="blocking",
                           kv_quantize=kvq), [LONG, (4, 5, 6)])
    chunked = _serve(_engine(run, params, prefill_chunk=8, kv_quantize=kvq),
                     [LONG, (4, 5, 6)])
    assert chunked == whole


def test_qa_kernels_run_on_prefill_segments_only(serve_setup, monkeypatch):
    run, params = serve_setup
    calls = {"lowrank": 0, "branched": 0}
    for kind in calls:
        fn = getattr(ops, f"{kind}_matmul_qa")

        def counted(*a, _fn=fn, _kind=kind):
            calls[_kind] += 1
            return _fn(*a)
        monkeypatch.setattr(ops, f"{kind}_matmul_qa", counted)
    eng = _engine(run, params, prefill_chunk=8)
    step, by_kind = eng.runner.step, {}

    def segment(tokens, positions, seg_kind, **kw):
        before = dict(calls)
        out = step(tokens, positions, seg_kind, **kw)
        by_kind.setdefault(seg_kind, []).append(
            sum(calls.values()) - sum(before.values()))
        return out
    eng.runner.step = segment
    _serve(eng, [LONG, (4, 5, 6)])
    layers = run.model.num_layers
    assert set(by_kind["decode"]) == {0}
    # k, v SVD pairs and q, o, gate, up, down branched in every layer
    assert set(by_kind["prefill_chunk"]) == {7 * layers}
    assert eng.runner.prefill_act_quantize


@pytest.mark.parametrize("kw,field", [
    (dict(quantize="none"), "needs quantize='int8'"),
    (dict(quantize="fp8"), "needs quantize='int8'"),
    (dict(act_quantize="fp8"), "want 'int8' or 'none'"),
])
def test_act_quant_configuration_errors(serve_setup, kw, field):
    run, params = serve_setup
    with pytest.raises(ValueError, match=field):
        _engine(run, params, **kw)


def test_config_knob_enables_act_quant(serve_setup):
    run, params = serve_setup
    run_q = dataclasses.replace(run, lrd=dataclasses.replace(
        run.lrd, quantize="int8", act_quantize="int8"))
    eng = ServeEngine(run_q, params, slots=1, max_seq=64, device="cpu")
    assert eng.act_quantize == "int8" and eng.runner.prefill_act_quantize
