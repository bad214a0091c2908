"""The port's cost model and hardware spec against the reference's.

Every cost-model function, given a spec of the reference's TPU fields,
returns the reference's float exactly (``==``) over a grid of shapes
holding llama3.2-1b's and DeepSeek-V2's linears; the plan-driven timers
take the same trees built in both packages.  The cost-model cases of
``tests/test_plan.py`` (``plan_layer_time``, ``peak_flops``) replay on
the port at both specs, and the measured timer runs on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hw_specs as jhw
from repro.configs import registry as jreg
from repro.core import cost_model as jcm
from repro.layers import cache as jcache
from repro.layers import plan as jplan
from repro.quant import quantize_tree as jquantize_tree
from repro.quant.sparse import sparsify_tree as jsparsify_tree
from repro_torch.analysis import hw_specs as hw
from repro_torch.configs import registry as treg
from repro_torch.core import cost_model as cm
from repro_torch.layers import cache as tcache
from repro_torch.layers import plan as tplan
from repro_torch.quant.quantize import quantize_tree
from repro_torch.quant.sparse import sparsify_tree
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

#: the reference's TPU spec, rebuilt from its fields in the port's class
TPU = hw.HardwareSpec(**dataclasses.asdict(jhw.TPU_V5E))
SPECS = {"h100": hw.H100, "tpu-fields": TPU}

#: (C, S) of llama3.2-1b's linears (q/o, k/v, gate/up, down) and of
#: DeepSeek-V2's (q_a, q_b, kv_a, kv_b, o, gate/up, down, unembed), with
#: a ragged pair
SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
          (5120, 1536), (1536, 24576), (5120, 576), (512, 32768),
          (16384, 5120), (5120, 12288), (12288, 5120), (5120, 102400),
          (300, 700)]
MS = (1, 8, 37, 64, 4096)


def _ranks(c, s):
    r0 = max(1, c * s // (2 * (c + s)))
    return sorted({1, 8, 127, 128, 129, 191, 192, r0, r0 // 4})


def test_h100_spec_is_the_data_sheet():
    """The port's default card: NVIDIA's H100 SXM constants."""
    assert hw.DEFAULT is hw.H100
    assert hw.H100.peak_flops(2) == 989e12
    assert hw.H100.peak_flops(1) == 1979e12
    assert hw.H100.peak_flops_f32 == 67e12
    assert hw.H100.hbm_bandwidth == 3.35e12
    assert (hw.H100.mxu_dim, hw.H100.sublanes) == (128, 8)
    from repro_torch.kernels import branched_matmul, build
    assert hw.H100.mxu_dim == branched_matmul.BN
    assert hw.H100.vmem_bytes == build.SMEM_LIMIT


@pytest.mark.parametrize("dim", [0, 1, 7, 8, 9, 127, 128, 129, 191, 4096])
def test_padding_matches_reference(dim):
    assert hw.mxu_padded(dim, TPU) == jhw.mxu_padded(dim, jhw.TPU_V5E)
    assert hw.sublane_padded(dim, TPU) == jhw.sublane_padded(dim,
                                                            jhw.TPU_V5E)


@pytest.mark.parametrize("c,s", SHAPES)
def test_formula_timers_equal_reference(c, s):
    """matmul / dense / lowrank / branched / conv / tucker2 and the model
    timers, float for float, at every m and a spread of ranks."""
    J, kw, jkw = jhw.TPU_V5E, dict(spec=TPU), dict(spec=jhw.TPU_V5E)
    for m in MS:
        assert cm.matmul_time(m, c, s, **kw) == jcm.matmul_time(m, c, s,
                                                                **jkw)
        assert cm.matmul_time(m, c, s, dtype_bytes=1, **kw) \
            == jcm.matmul_time(m, c, s, dtype_bytes=1, **jkw)
        assert cm.dense_layer_time(m, c, s, **kw) \
            == jcm.dense_layer_time(m, c, s, **jkw)
        assert cm.make_dense_time(m, c, s, **kw) \
            == jcm.make_dense_time(m, c, s, **jkw)
        assert cm.make_dense_time(m, c, s, kind="tucker", k=3, **kw) \
            == jcm.make_dense_time(m, c, s, kind="tucker", k=3, **jkw)
        timer = cm.make_model_timer(m, c, s, **kw)
        jtimer = jcm.make_model_timer(m, c, s, **jkw)
        tk = cm.make_model_timer(m, c, s, kind="tucker", k=3, **kw)
        jtk = jcm.make_model_timer(m, c, s, kind="tucker", k=3, spec=J)
        for r in _ranks(c, s):
            assert cm.lowrank_layer_time(m, c, s, r, **kw) \
                == jcm.lowrank_layer_time(m, c, s, r, **jkw)
            assert timer(r) == jtimer(r)
            assert tk(r) == jtk(r)
            for n in (1, 2, 4):
                assert cm.branched_layer_time(m, c, s, r, r, n, **kw) \
                    == jcm.branched_layer_time(m, c, s, r, r, n, **jkw)
            assert cm.conv_time(7, c, s, 3, **kw) \
                == jcm.conv_time(7, c, s, 3, **jkw)
            assert cm.tucker2_time(7, c, s, 3, r, r // 2 + 1, **kw) \
                == jcm.tucker2_time(7, c, s, 3, r, r // 2 + 1, **jkw)


def test_model_timer_refuses_unknown_kind():
    with pytest.raises(ValueError):
        cm.make_model_timer(8, 64, 64, kind="cp")


def _factors(rng, kind, c, r, s, n=4):
    if kind == "dense":
        return {"w": rng.standard_normal((c, s)).astype(np.float32)}
    if kind == "lowrank":
        return {"w0": rng.standard_normal((c, r)).astype(np.float32),
                "w1": rng.standard_normal((r, s)).astype(np.float32)}
    return {"u": rng.standard_normal((n, c, r)).astype(np.float32),
            "xc": rng.standard_normal((n, r, r)).astype(np.float32),
            "v": rng.standard_normal((n, r, s)).astype(np.float32)}


def _both(tree, dtype, mode):
    """The tree in both packages: cast to ``dtype``, then quantized
    (``int8`` / ``fp8``) or 2:4-packed in int8 (``sp-int8``)."""
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype))
         for k, v in tree.items()}
    j = {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}
    if mode in ("int8", "fp8"):
        t, j = quantize_tree(t, mode), jquantize_tree(j, mode)
    elif mode == "sp-int8":
        t, j = sparsify_tree(t, "2:4", "int8"), jsparsify_tree(j, "2:4",
                                                               "int8")
    return tplan.build_plan(t), jplan.build_plan(j)


PLAN_CASES = [("dense", "none"), ("lowrank", "none"), ("branched", "none"),
              ("lowrank", "int8"), ("branched", "int8"), ("lowrank", "fp8"),
              ("branched", "fp8"), ("lowrank", "sp-int8"),
              ("branched", "sp-int8")]


@pytest.mark.parametrize("kind,mode", PLAN_CASES)
@pytest.mark.parametrize("c,r,s", [(64, 24, 96), (256, 191, 128)])
def test_plan_timers_equal_reference(kind, mode, c, r, s):
    """plan_layer_time (act bytes, act-quant, KV bytes), the qa mirror
    and the activation stream, float for float on the same trees."""
    rng = np.random.default_rng(c + r + s)
    tree = _factors(rng, kind, c, r, s)
    for dtype in ("float32", "bfloat16"):
        tp, jp = _both(tree, dtype, mode)
        assert tp.weight_bytes == jp.weight_bytes
        for qa in (False, True):
            assert cm.plan_qa_eligible(tp, qa) == jcm.plan_qa_eligible(jp,
                                                                       qa)
            for ab in (1, 2, 4):
                assert cm.plan_act_stream_bytes(tp, act_bytes=ab,
                                                act_quantize=qa) \
                    == jcm.plan_act_stream_bytes(jp, act_bytes=ab,
                                                 act_quantize=qa)
                for m in MS:
                    for kv in (0, 1 << 20):
                        assert cm.plan_layer_time(
                            tp, m, act_bytes=ab, kv_bytes=kv,
                            act_quantize=qa, spec=TPU) \
                            == jcm.plan_layer_time(
                                jp, m, act_bytes=ab, kv_bytes=kv,
                                act_quantize=qa, spec=jhw.TPU_V5E)


@pytest.mark.parametrize("c,r,s,kind", [(2048, 191, 512, "lowrank"),
                                        (2048, 384, 2048, "lowrank"),
                                        (2048, 192, 8192, "branched"),
                                        (16384, 480, 5120, "branched")])
def test_plan_timer_at_served_shapes_equals_reference(c, r, s, kind):
    """bf16 plans at the searched llama ranks and DeepSeek-V2's o (zero
    factors: a plan reads shapes and dtypes only)."""
    n = 4 if kind == "branched" else 1
    shapes = ({"w0": (c, r), "w1": (r, s)} if kind == "lowrank" else
              {"u": (n, c, r), "xc": (n, r, r), "v": (n, r, s)})
    tp = tplan.build_plan({k: torch.zeros(v, dtype=torch.bfloat16)
                           for k, v in shapes.items()})
    jp = jplan.build_plan({k: jnp.zeros(v, jnp.bfloat16)
                           for k, v in shapes.items()})
    for m in MS:
        assert cm.plan_layer_time(tp, m, spec=TPU) \
            == jcm.plan_layer_time(jp, m, spec=jhw.TPU_V5E)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b"])
@pytest.mark.parametrize("kvq", [None, "int8"])
def test_cache_plan_kv_bytes_equal_reference(arch, kvq):
    """Per-step KV bytes of the port's cache plan of the full config (the
    ``kv_bytes`` input of ``plan_layer_time``) against the reference's
    ``plan_kv_bytes``, slot and (GQA) paged pools."""
    jcfg, tcfg = jreg.get(arch).full, treg.get(arch).full
    geoms = [(None, None)]
    if not tcfg.mla:
        geoms.append((tcache.PagedGeometry(16, 512, 8, 64),
                      jcache.PagedGeometry(16, 512, 8, 64)))
    for tg, jg in geoms:
        tpl = tcache.build_cache_plan(tcfg, torch.bfloat16, kvq, tg)
        jpl = jcache.build_cache_plan(jcfg, jnp.bfloat16, kvq, jg)
        for slots, seq in ((1, 64), (8, 1024)):
            assert tpl.bytes_per_step(slots, seq) \
                == jcm.plan_kv_bytes(jpl, slots, seq)


# -- the cost-model cases of tests/test_plan.py, on the port ----------------

def _lowrank_plan(seed, c, r, s, mode=None):
    rng = np.random.default_rng(seed)
    p = {"w0": torch.from_numpy(
             rng.standard_normal((c, r)).astype(np.float32) * 0.1),
         "w1": torch.from_numpy(
             rng.standard_normal((r, s)).astype(np.float32) * 0.1)}
    return tplan.build_plan(quantize_tree(p) if mode else p)


@pytest.mark.parametrize("spec", list(SPECS.values()), ids=list(SPECS))
def test_plan_layer_time_quant_aware(spec):
    t_f32 = cm.plan_layer_time(_lowrank_plan(0, 2048, 256, 2048), 1,
                               spec=spec)
    t_int8 = cm.plan_layer_time(_lowrank_plan(0, 2048, 256, 2048, "int8"),
                                1, spec=spec)
    assert t_int8 < t_f32         # decode (m=1) is weight-stream-bound


@pytest.mark.parametrize("spec,r", [(TPU, 256), (hw.H100, 1024)],
                         ids=list(SPECS)[::-1])
def test_plan_layer_time_act_quant_mxu_rate(spec, r):
    """At a compute-bound prefill m, an int8 plan with act_quantize runs
    at the int8 x int8 rate; bf16 / f32 plans ignore the flag.  (The
    reference's rank 256 at the TPU's fields; on the H100, whose 1,979
    TOP/s against 3.35 TB/s leave the int8 rows of a rank-256 pair
    stream-bound at any m, rank 1,024.)"""
    qplan = _lowrank_plan(1, 2048, r, 2048, "int8")
    m = 1 << 15
    t_wq = cm.plan_layer_time(qplan, m, spec=spec)
    t_qa = cm.plan_layer_time(qplan, m, act_quantize=True, spec=spec)
    assert t_qa == pytest.approx(t_wq / spec.int8_mxu_mult)
    fplan = _lowrank_plan(1, 2048, r, 2048)
    assert cm.plan_layer_time(fplan, m, act_quantize=True, spec=spec) \
        == cm.plan_layer_time(fplan, m, spec=spec)


@pytest.mark.parametrize("spec", list(SPECS.values()), ids=list(SPECS))
def test_plan_layer_time_act_quant_narrows_stream(spec):
    qplan = _lowrank_plan(2, 4096, 64, 4096, "int8")
    m = 4096                      # act stream rivals weight stream
    t_wq = cm.plan_layer_time(qplan, m, act_bytes=4, spec=spec)
    t_qa = cm.plan_layer_time(qplan, m, act_bytes=4, act_quantize=True,
                              spec=spec)
    assert t_qa < t_wq


@pytest.mark.parametrize("spec", list(SPECS.values()), ids=list(SPECS))
def test_peak_flops_dtype_aware(spec):
    assert spec.peak_flops(1) == spec.peak_flops_bf16 * spec.int8_mxu_mult
    assert spec.peak_flops(2) == spec.peak_flops_bf16
    assert spec.peak_flops(4) == spec.peak_flops_bf16


# -- the measured timer ----------------------------------------------------

def test_measured_timer_on_cpu_returns_seconds_and_caches():
    timer = cm.make_measured_timer(16, 64, 48, device="cpu", iters=2)
    t8 = timer(8)
    assert t8 > 0 and np.isfinite(t8)
    assert timer(8) == t8                      # cached, not re-timed
    assert timer.cache_info().hits == 1
    assert timer(16) > 0
    bf = cm.make_measured_timer(16, 64, 48, dtype=torch.bfloat16,
                                device="cpu", iters=1)
    assert bf(8) > 0
    assert cm.measured_dense_time(16, 64, 48, device="cpu", iters=2) > 0

