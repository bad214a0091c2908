"""Card-only checks of the CUDA kernels (marker ``gpu``; each test skips
itself when no CUDA card is present).  Run them on the card with

    python3 -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_gpu.py

They repeat ``chip_smoke.py``'s kernel-vs-plain comparisons at the main
path's shapes and tolerances, and check that the serve path on a CUDA
tensor goes through the kernels.
"""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(g, *shape, scale=1.0, dtype):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _norm_err(y, want):
    d = (y.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", chip_smoke.M_CASES)
@pytest.mark.parametrize("label", list(chip_smoke.LOWRANK_SHAPES))
def test_lowrank_kernel_matches_plain(cuda, label, m, dtype):
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import ref
    c, r, s = chip_smoke.LOWRANK_SHAPES[label]
    dt = getattr(torch, dtype)
    x = _rnd(cuda, m, c, dtype=dt)
    w0 = _rnd(cuda, c, r, scale=c ** -0.5, dtype=dt)
    w1 = _rnd(cuda, r, s, scale=r ** -0.5, dtype=dt)
    n0 = lk.launches
    y = lk.lowrank_matmul(x, w0, w1)
    assert lk.launches == n0 + 1
    assert _norm_err(y, ref.lowrank_matmul_ref(x, w0, w1)) \
        <= chip_smoke.KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", chip_smoke.M_CASES)
@pytest.mark.parametrize("label", list(chip_smoke.BRANCHED_SHAPES))
def test_branched_kernel_matches_plain(cuda, label, m, dtype):
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import ref
    n, c, r, s = chip_smoke.BRANCHED_SHAPES[label]
    dt = getattr(torch, dtype)
    x = _rnd(cuda, m, c, dtype=dt)
    u = _rnd(cuda, n, c, r, scale=c ** -0.5, dtype=dt)
    xc = _rnd(cuda, n, r, r, scale=r ** -0.5, dtype=dt)
    v = _rnd(cuda, n, r, s, scale=r ** -0.5, dtype=dt)
    y = bk.branched_matmul(x, u, xc, v)
    assert _norm_err(y, ref.branched_matmul_ref(x, u, xc, v)) \
        <= chip_smoke.KERNEL_TOL[dtype]


@pytest.mark.parametrize("m,c,r,s,n", [(1, 33, 5, 70, 3), (9, 200, 17, 129,
                                                            1)])
def test_ragged_everything(cuda, m, c, r, s, n):
    from repro_torch.kernels import ops, ref
    x = _rnd(cuda, m, c, dtype=torch.float32)
    w0 = _rnd(cuda, c, r, dtype=torch.float32)
    w1 = _rnd(cuda, r, s, dtype=torch.float32)
    assert _norm_err(ops.lowrank_matmul(x, w0, w1),
                     ref.lowrank_matmul_ref(x, w0, w1)) <= 1e-5
    u = _rnd(cuda, n, c, r, dtype=torch.float32)
    xc = _rnd(cuda, n, r, r, dtype=torch.float32)
    v = _rnd(cuda, n, r, s, dtype=torch.float32)
    assert _norm_err(ops.branched_matmul(x, u, xc, v),
                     ref.branched_matmul_ref(x, u, xc, v)) <= 1e-5


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_serve_path_launches_kernels_and_matches_cpu(cuda, quantize):
    """The engine on the card goes through the path's kernels (bf16
    chains, or the quantized chains and the int8-KV attention) and
    emits the CPU's greedy tokens."""
    import importlib
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig, RunConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import Request, ServeEngine
    import dataclasses
    names = (("lowrank_matmul", "branched_matmul") if quantize == "none"
             else ("lowrank_matmul_q", "branched_matmul_q",
                   "decode_attention_q"))
    mods = [importlib.import_module(f"repro_torch.kernels.{n}")
            for n in names]
    cfg = dataclasses.replace(registry.get("llama3.2-1b").smoke,
                              dtype="float32")
    params, axes = get_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0))
    lrd = LRDConfig(enabled=True, rank_mode="aligned", rank_align=8,
                    min_dim=32, branches=2)
    params, _, _ = decompose_model(params, axes, lrd)
    def move(t, dev):
        return ({k: move(v, dev) for k, v in t.items()}
                if isinstance(t, dict) else t.to(dev))
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(RunConfig(model=cfg, lrd=lrd), move(params, dev),
                          slots=2, max_seq=64, prefill_chunk=8,
                          quantize=quantize, kv_quantize=quantize,
                          device=dev)
        for m in mods:
            m.launches = 0
        reqs = [Request(uid=i, prompt=list(range(3 + 5 * i, 14 + 7 * i)),
                        max_new_tokens=4) for i in range(3)]
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done()
        outs[dev] = [r.output for r in reqs]
        counts = [m.launches for m in mods]
        assert all(counts) if dev == "cuda" else not any(counts)
    # f32 kernels vs f32 plain versions differ by summation order only
    assert outs["cuda"] == outs["cpu"]


def _quantized(g, *shape, mode):
    from repro_torch.quant.quantize import quantize_array
    return quantize_array(_rnd(g, *shape, scale=shape[-2] ** -0.5,
                               dtype=torch.float32), mode)


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", chip_smoke.M_CASES)
@pytest.mark.parametrize("label", list(chip_smoke.LOWRANK_SHAPES))
def test_lowrank_q_kernel_matches_plain(cuda, label, m, dtype, mode):
    from repro_torch.kernels import lowrank_matmul_q as lqk
    from repro_torch.kernels import ref
    c, r, s = chip_smoke.LOWRANK_SHAPES[label]
    x = _rnd(cuda, m, c, dtype=getattr(torch, dtype))
    args = (x, *_quantized(cuda, c, r, mode=mode),
            *_quantized(cuda, r, s, mode=mode))
    n0 = lqk.launches
    y = lqk.lowrank_matmul_q(*args)
    assert lqk.launches == n0 + 1
    assert _norm_err(y, ref.lowrank_matmul_q_ref(*args)) \
        <= chip_smoke.KERNEL_TOL[dtype]


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", chip_smoke.M_CASES)
@pytest.mark.parametrize("label", list(chip_smoke.BRANCHED_SHAPES))
def test_branched_q_kernel_matches_plain(cuda, label, m, dtype, mode):
    from repro_torch.kernels import branched_matmul_q as bqk
    from repro_torch.kernels import ref
    n, c, r, s = chip_smoke.BRANCHED_SHAPES[label]
    x = _rnd(cuda, m, c, dtype=getattr(torch, dtype))
    args = (x, *_quantized(cuda, n, c, r, mode=mode),
            *_quantized(cuda, n, r, r, mode=mode),
            *_quantized(cuda, n, r, s, mode=mode))
    y = bqk.branched_matmul_q(*args)
    assert _norm_err(y, ref.branched_matmul_q_ref(*args)) \
        <= chip_smoke.KERNEL_TOL[dtype]


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
@pytest.mark.parametrize("m,c,r,s,n", [(1, 33, 5, 70, 3),
                                       (9, 200, 17, 129, 1)])
def test_ragged_everything_quantized(cuda, m, c, r, s, n, mode):
    from repro_torch.kernels import ops, ref
    x = _rnd(cuda, m, c, dtype=torch.float32)
    lr = (*_quantized(cuda, c, r, mode=mode),
          *_quantized(cuda, r, s, mode=mode))
    assert _norm_err(ops.lowrank_matmul_q(x, *lr),
                     ref.lowrank_matmul_q_ref(x, *lr)) <= 1e-5
    br = (*_quantized(cuda, n, c, r, mode=mode),
          *_quantized(cuda, n, r, r, mode=mode),
          *_quantized(cuda, n, r, s, mode=mode))
    assert _norm_err(ops.branched_matmul_q(x, *br),
                     ref.branched_matmul_q_ref(x, *br)) <= 1e-5


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,kh,g,d,softcap,idle", [
    (8, 1024, 8, 4, 64, 0.0, 0),      # the served pool
    (8, 1000, 8, 4, 64, 30.0, 3),     # ragged S, softcap, idle slots
    (3, 70, 2, 2, 16, 0.0, 1),        # the smoke model's heads
    (2, 129, 1, 8, 128, 5.0, 0),      # wide heads, G * D = 1024
])
def test_decode_attention_q_kernel_matches_plain(cuda, b, s, kh, g, d,
                                                 softcap, idle, dtype):
    from repro_torch.kernels import decode_attention_q as dak
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.kv import quantize_kv_prefill
    q = _rnd(cuda, b, 1, kh * g, d, dtype=getattr(torch, dtype))
    k_q, k_s = quantize_kv_prefill(_rnd(cuda, b, s, kh, d,
                                        dtype=torch.float32))
    v_q, v_s = quantize_kv_prefill(_rnd(cuda, b, s, kh, d,
                                        dtype=torch.float32))
    pos = torch.arange(b, device="cuda", dtype=torch.int32) * (s // b)
    pos[0] = s - 1
    if idle:
        pos[-idle:] = -1
    n0 = dak.launches
    y = ops.decode_attention_q(q, k_q, k_s, v_q, v_s, pos, softcap=softcap)
    assert dak.launches == n0 + 1
    want = ref.decode_attention_q_ref(q, k_q, k_s, v_q, v_s, pos,
                                      softcap=softcap)
    assert torch.isfinite(y.float()).all()
    assert _norm_err(y, want) <= chip_smoke.KERNEL_TOL[dtype]
