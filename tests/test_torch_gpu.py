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


@pytest.mark.parametrize("m,c,r,s,n", [(1, 33, 5, 70, 3), (9, 200, 17, 129,
                                                            1)])
def test_ragged_branched_bf16(cuda, m, c, r, s, n):
    """The bf16 split-phase kernel at ragged shapes: rows whose stride is
    not a multiple of 16 bytes and column tiles past the last column take
    the masked scalar staging path."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import ref
    dt = torch.bfloat16
    x = _rnd(cuda, m, c, dtype=dt)
    u = _rnd(cuda, n, c, r, scale=c ** -0.5, dtype=dt)
    xc = _rnd(cuda, n, r, r, scale=r ** -0.5, dtype=dt)
    v = _rnd(cuda, n, r, s, scale=r ** -0.5, dtype=dt)
    n0 = bk.launches
    y = bk.branched_matmul(x, u, xc, v)
    assert bk.launches == n0 + 1
    assert _norm_err(y, ref.branched_matmul_ref(x, u, xc, v)) \
        <= chip_smoke.KERNEL_TOL["bfloat16"]


@pytest.mark.parametrize("m", [72, 512])
@pytest.mark.parametrize("label", [*chip_smoke.BRANCHED_SHAPES, "ds o"])
def test_branched_bf16_row_blocks_same_bits(cuda, label, m):
    """M past one 64-row block: the split-phase kernel loops over row
    blocks; two calls on the same inputs give the same bits (no atomics),
    one launch each."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import ref
    n, c, r, s = {**chip_smoke.BRANCHED_SHAPES,
                  **chip_smoke.DEEPSEEK_BRANCHED_SHAPES}[label]
    dt = torch.bfloat16
    x = _rnd(cuda, m, c, dtype=dt)
    u = _rnd(cuda, n, c, r, scale=c ** -0.5, dtype=dt)
    xc = _rnd(cuda, n, r, r, scale=r ** -0.5, dtype=dt)
    v = _rnd(cuda, n, r, s, scale=r ** -0.5, dtype=dt)
    n0 = bk.launches
    y = bk.branched_matmul(x, u, xc, v)
    assert bk.launches == n0 + 1
    y2 = bk.branched_matmul(x, u, xc, v)
    assert bk.launches == n0 + 2
    assert torch.equal(y, y2)
    assert _norm_err(y, ref.branched_matmul_ref(x, u, xc, v)) \
        <= chip_smoke.KERNEL_TOL["bfloat16"]


def test_branched_mma_smem_and_grid(cuda):
    """The C side's shared memory equals the wrapper's count, under the
    opt-in limit, and the persistent grid holds at least one CTA per SM."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import build
    lib = build.load()
    assert lib.lrk_branched_mma_smem() == bk.mma_smem_bytes() \
        <= build.SMEM_LIMIT
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows in (1, 16, 32, 64):
        assert lib.lrk_branched_mma_grid(rows) >= sms


@pytest.mark.parametrize("m", [8, 72])
def test_branched_phase_timer(cuda, m):
    """The split-phase kernel's phase timer: one counted launch, three
    non-negative phase times per 64-row block."""
    from repro_torch.kernels import branched_matmul as bk
    n, c, r, s = chip_smoke.BRANCHED_SHAPES["q,o"]
    dt = torch.bfloat16
    args = (_rnd(cuda, m, c, dtype=dt), _rnd(cuda, n, c, r, dtype=dt),
            _rnd(cuda, n, r, r, dtype=dt), _rnd(cuda, n, r, s, dtype=dt))
    n0 = bk.launches
    us = bk.branched_matmul_phase_us(*args)
    assert bk.launches == n0 + 1
    assert len(us) == 3 * -(-m // 64) and min(us) >= 0 and sum(us) > 0


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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", chip_smoke.QA_M_CASES)
@pytest.mark.parametrize("label", list(chip_smoke.LOWRANK_SHAPES))
def test_lowrank_qa_kernel_matches_plain(cuda, label, m, dtype):
    """B6 at every main-path shape, one all-zero row: the folds and
    roundings are the plain version's, so the outputs are bit-equal."""
    from repro_torch.kernels import lowrank_matmul_qa as lak
    from repro_torch.kernels import ref
    c, r, s = chip_smoke.LOWRANK_SHAPES[label]
    x = _rnd(cuda, m, c, dtype=getattr(torch, dtype))
    x[m // 2] = 0
    args = (x, *_quantized(cuda, c, r, mode="int8"),
            *_quantized(cuda, r, s, mode="int8"))
    n0 = lak.launches
    y = lak.lowrank_matmul_qa(*args)
    assert lak.launches == n0 + 1
    want = ref.lowrank_matmul_qa_ref(*args)
    assert _norm_err(y, want) <= chip_smoke.KERNEL_TOL[dtype]
    assert (y[m // 2] == 0).all()
    assert int((y.float() != want.float()).sum()) == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", chip_smoke.QA_M_CASES)
@pytest.mark.parametrize("label", list(chip_smoke.BRANCHED_SHAPES))
def test_branched_qa_kernel_matches_plain(cuda, label, m, dtype):
    from repro_torch.kernels import branched_matmul_qa as bak
    from repro_torch.kernels import ref
    n, c, r, s = chip_smoke.BRANCHED_SHAPES[label]
    x = _rnd(cuda, m, c, dtype=getattr(torch, dtype))
    x[m // 2] = 0
    args = (x, *_quantized(cuda, n, c, r, mode="int8"),
            *_quantized(cuda, n, r, r, mode="int8"),
            *_quantized(cuda, n, r, s, mode="int8"))
    n0 = bak.launches
    y = bak.branched_matmul_qa(*args)
    assert bak.launches == n0 + 1
    want = ref.branched_matmul_qa_ref(*args)
    assert _norm_err(y, want) <= chip_smoke.KERNEL_TOL[dtype]
    assert (y[m // 2] == 0).all()
    assert int((y.float() != want.float()).sum()) == 0


@pytest.mark.parametrize("m,c,r,s,n", [(1, 33, 5, 70, 3), (9, 200, 17, 129,
                                                            1)])
def test_ragged_everything_qa(cuda, m, c, r, s, n):
    from repro_torch.kernels import ops, ref
    x = _rnd(cuda, m, c, dtype=torch.float32)
    lr = (*_quantized(cuda, c, r, mode="int8"),
          *_quantized(cuda, r, s, mode="int8"))
    assert torch.equal(ops.lowrank_matmul_qa(x, *lr),
                       ref.lowrank_matmul_qa_ref(x, *lr))
    br = (*_quantized(cuda, n, c, r, mode="int8"),
          *_quantized(cuda, n, r, r, mode="int8"),
          *_quantized(cuda, n, r, s, mode="int8"))
    assert torch.equal(ops.branched_matmul_qa(x, *br),
                       ref.branched_matmul_qa_ref(x, *br))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", [
    *chip_smoke.PAGED_CASES.values(),
    dict(b=3, kh=2, g=2, d=16, bs=4, nblk=5, nb=16, idle=1, softcap=0.0),
    dict(b=2, kh=1, g=8, d=128, bs=128, nblk=3, nb=6, idle=0, softcap=5.0),
    dict(b=2, kh=2, g=4, d=64, bs=3, nblk=40, nb=80, idle=0, softcap=0.0),
], ids=["served", "softcap30", "smoke", "wide-block", "odd-block"])
def test_paged_attention_kernels_match_plain(cuda, case, dtype, quant):
    """B8 / B9 against their plain versions: shuffled tables, ragged
    positions, an idle slot (the plain version's uniform average), block
    sizes below, at and above one staged pass."""
    from repro_torch.kernels import decode_attention_paged as dpk
    from repro_torch.kernels import ops, ref
    name = "decode_attention_paged" + ("_q" if quant else "")
    counter = "launches_q" if quant else "launches"
    q, pool, tables, pos = chip_smoke.paged_inputs(case, dtype, quant, cuda)
    n0 = getattr(dpk, counter)
    y = getattr(ops, name)(q, *pool, tables, pos, softcap=case["softcap"])
    assert getattr(dpk, counter) == n0 + 1
    want = getattr(ref, name + "_ref")(q, *pool, tables, pos,
                                       softcap=case["softcap"])
    assert torch.isfinite(y.float()).all()
    assert _norm_err(y, want) <= chip_smoke.KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", [
    *chip_smoke.LATENT_CASES.values(),
    dict(b=3, s=70, h=4, lora=16, rope=8, idle=1),
    dict(b=2, s=129, h=20, lora=64, rope=16, idle=0),
    dict(b=1, s=5, h=1, lora=1024, rope=4, idle=0),
], ids=["served", "idle-slot", "ragged-S", "smoke", "partial-group",
        "wide-latent"])
def test_decode_attention_latent_q_kernel_matches_plain(cuda, case, dtype):
    """B10 against its plain version: the served latent pool with ragged
    positions, an idle slot (the plain version's uniform average), a
    ragged S, the smoke widths, a last head group of 4 of 8 heads and a
    latent of 1024."""
    from repro_torch.kernels import decode_attention_latent_q as dlk
    from repro_torch.kernels import ops, ref

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return _rnd(cuda, *shape, scale=scale, dtype=dtype)
    args = chip_smoke.latent_inputs(case, dtype, rnd)
    scale = 1.0 / (128 + case["rope"]) ** 0.5
    n0 = dlk.launches
    y = ops.decode_attention_latent_q(*args, scale=scale)
    assert dlk.launches == n0 + 1
    want = ref.decode_attention_latent_q_ref(*args, scale=scale)
    assert y.shape == want.shape and torch.isfinite(y.float()).all()
    assert _norm_err(y, want) <= chip_smoke.KERNEL_TOL[dtype]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", chip_smoke.DEEPSEEK_M_CASES)
@pytest.mark.parametrize("label", list(chip_smoke.DEEPSEEK_BRANCHED_SHAPES))
def test_branched_kernels_at_deepseek_shapes(cuda, label, m, dtype):
    """B2, B4 (int8 factors) and B12 (int8 packs) at DeepSeek-V2's wide
    branch ranks stay within tolerance, one launch per call.  In f32 B4 and
    B12 launch the cluster kernel at 8 rows (the 32-row block does not fit
    shared memory at M = 64) and B2 the f32 form; in bf16 the split-phase
    kernel, whose shared memory does not depend on the ranks; each gives
    the same bits on a second call."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import branched_matmul_q as bqk
    from repro_torch.kernels import branched_matmul_sq as bsk
    from repro_torch.kernels import ref
    n, c, r, s = chip_smoke.DEEPSEEK_BRANCHED_SHAPES[label]
    dt = getattr(torch, dtype)
    x = _rnd(cuda, m, c, dtype=dt)
    u = _rnd(cuda, n, c, r, scale=c ** -0.5, dtype=dt)
    xc = _rnd(cuda, n, r, r, scale=r ** -0.5, dtype=dt)
    v = _rnd(cuda, n, r, s, scale=r ** -0.5, dtype=dt)
    n0 = bk.launches
    y = bk.branched_matmul(x, u, xc, v)
    assert bk.launches == n0 + 1
    assert _norm_err(y, ref.branched_matmul_ref(x, u, xc, v)) \
        <= chip_smoke.KERNEL_TOL[dtype]
    assert torch.equal(y, bk.branched_matmul(x, u, xc, v))
    del u, xc, v
    args = (x, *_quantized(cuda, n, c, r, mode="int8"),
            *_quantized(cuda, n, r, r, mode="int8"),
            *_quantized(cuda, n, r, s, mode="int8"))
    n0 = bqk.launches
    y = bqk.branched_matmul_q(*args)
    assert bqk.launches == n0 + 1
    assert _norm_err(y, ref.branched_matmul_q_ref(*args)) \
        <= chip_smoke.KERNEL_TOL[dtype]
    assert torch.equal(y, bqk.branched_matmul_q(*args))
    args = (x, *_packed(cuda, n, c, r, mode="int8"), *args[3:5],
            *_packed(cuda, n, r, s, mode="int8"))
    n0 = bsk.launches
    y = bsk.branched_matmul_sq(*args)
    assert bsk.launches == n0 + 1
    assert _norm_err(y, ref.branched_matmul_sq_ref(*args)) \
        <= chip_smoke.KERNEL_TOL[dtype]
    assert torch.equal(y, bsk.branched_matmul_sq(*args))


@pytest.mark.parametrize("m", chip_smoke.VLM_F32_M)
@pytest.mark.parametrize("label", list(chip_smoke.VLM_F32_SHAPES))
def test_f32_branched_kernels_at_vlm_ranks(cuda, label, m):
    """f32 B2 and B4 (int8 factors) at the VLM's per-branch ranks 768 /
    960, where the cluster chain's 8-row block does not fit shared memory:
    B4's cluster kernel launches at 4-row blocks and B2 runs the f32 form,
    once a call, within the f32 tolerance of the plain versions, and give
    the same bits on a second call."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import branched_matmul_q as bqk
    from repro_torch.kernels import build
    from repro_torch.kernels import ref
    n, c, r, s = chip_smoke.VLM_F32_SHAPES[label]
    lib = build.load()
    bm, _ = build.chain_bm(m, lambda bm: lib.lrk_branched_smem(0, bm, n, r,
                                                               r),
                           build.chain_heights(torch.float32))
    assert bm == 4
    dt = torch.float32
    x = _rnd(cuda, m, c, dtype=dt)
    u = _rnd(cuda, n, c, r, scale=c ** -0.5, dtype=dt)
    xc = _rnd(cuda, n, r, r, scale=r ** -0.5, dtype=dt)
    v = _rnd(cuda, n, r, s, scale=r ** -0.5, dtype=dt)
    n0 = bk.launches
    y = bk.branched_matmul(x, u, xc, v)
    assert bk.launches == n0 + 1
    assert _norm_err(y, ref.branched_matmul_ref(x, u, xc, v)) \
        <= chip_smoke.KERNEL_TOL["float32"]
    assert torch.equal(y, bk.branched_matmul(x, u, xc, v))
    del u, xc, v
    args = (x, *_quantized(cuda, n, c, r, mode="int8"),
            *_quantized(cuda, n, r, r, mode="int8"),
            *_quantized(cuda, n, r, s, mode="int8"))
    n0 = bqk.launches
    y = bqk.branched_matmul_q(*args)
    assert bqk.launches == n0 + 1
    assert _norm_err(y, ref.branched_matmul_q_ref(*args)) \
        <= chip_smoke.KERNEL_TOL["float32"]
    assert torch.equal(y, bqk.branched_matmul_q(*args))


@pytest.mark.parametrize("kind", ["branched_matmul", "branched_matmul_q"])
def test_f32_branched_kernel_refuses_past_the_4_row_block(cuda, kind):
    """At per-branch ranks (1600, 1600), where the cluster kernel's 4-row
    block does not fit shared memory: f32 B2 and f32 B4 run the f32 form,
    whose shared memory is fixed by its tile (one counted launch, within
    f32's tolerance of the plain version); the cluster kernel, B4's
    yardstick, still refuses the shapes, naming them, with nothing
    launched."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import branched_matmul_q as bqk
    from repro_torch.kernels import ref
    dt = torch.float32
    n, c, r, s = 4, 256, 1600, 256
    x = _rnd(cuda, 8, c, dtype=dt)
    if kind == "branched_matmul":
        u = _rnd(cuda, n, c, r, scale=c ** -0.5, dtype=dt)
        xc = _rnd(cuda, n, r, r, scale=r ** -0.5, dtype=dt)
        v = _rnd(cuda, n, r, s, scale=r ** -0.5, dtype=dt)
        n0 = bk.launches
        y = bk.branched_matmul(x, u, xc, v)
        assert bk.launches == n0 + 1
        assert _norm_err(y, ref.branched_matmul_ref(x, u, xc, v)) \
            <= chip_smoke.KERNEL_TOL["float32"]
        return
    args = (x, *_quantized(cuda, n, c, r, mode="int8"),
            *_quantized(cuda, n, r, r, mode="int8"),
            *_quantized(cuda, n, r, s, mode="int8"))
    n0 = bqk.launches
    y = bqk.branched_matmul_q(*args)
    assert bqk.launches == n0 + 1
    assert _norm_err(y, ref.branched_matmul_q_ref(*args)) \
        <= chip_smoke.KERNEL_TOL["float32"]
    assert torch.equal(y, bqk.branched_matmul_q(*args))
    with pytest.raises(ValueError, match=r"ranks \(1600, 1600\).*4 rows"):
        bqk.cluster_branched_matmul_q(*args)
    assert bqk.launches == n0 + 2


@pytest.mark.parametrize("kv_quantize", ["none", "int8"])
def test_mla_serve_path_launches_kernels_and_matches_cpu(cuda, kv_quantize):
    """DeepSeek-V2's smoke MLA stack (f32, no experts, branched) served on
    the card goes through B2 (or B4 and the latent attention over the
    int8 latent pool) and emits the CPU's greedy tokens."""
    import dataclasses
    import importlib
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig, RunConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import Request, ServeEngine
    quant = kv_quantize == "int8"
    names = (("branched_matmul_q", "decode_attention_latent_q") if quant
             else ("branched_matmul",))
    mods = [importlib.import_module(f"repro_torch.kernels.{n}")
            for n in names]
    cfg = dataclasses.replace(registry.get("deepseek-v2-236b").smoke,
                              family="dense", moe_num_experts=0,
                              moe_first_dense=0, dtype="float32")
    params, axes = get_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0))
    lrd = LRDConfig(enabled=True, rank_mode="aligned", rank_align=4,
                    min_dim=16, branches=2)
    params, _, _ = decompose_model(params, axes, lrd)

    def move(t, dev):
        return ({k: move(v, dev) for k, v in t.items()}
                if isinstance(t, dict) else t.to(dev))
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(RunConfig(model=cfg, lrd=lrd), move(params, dev),
                          slots=2, max_seq=64, prefill_chunk=8,
                          quantize=kv_quantize, kv_quantize=kv_quantize,
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
    assert outs["cuda"] == outs["cpu"]


def _packed(g, *shape, mode, top_rows=True):
    """A factor 2:4-packed as the engine packs it, (sp, idx, scale); with
    ``top_rows`` every other group keeps its top positions, 2 and 3."""
    from repro_torch.quant.sparse import sparsify_array
    w = _rnd(g, *shape, scale=shape[-2] ** -0.5, dtype=torch.float32)
    if top_rows:
        rows = torch.arange(shape[-2], device="cuda")
        w[..., ((rows // 4) % 2 == 0) & (rows % 4 < 2), :] *= 0.125
    return sparsify_array(w, mode=mode)


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", chip_smoke.M_CASES)
@pytest.mark.parametrize("label", list(chip_smoke.SPARSE_LOWRANK))
def test_lowrank_sq_kernel_matches_plain(cuda, label, m, dtype, mode):
    from repro_torch.kernels import lowrank_matmul_sq as lsk
    from repro_torch.kernels import ref
    c, r, s = chip_smoke.LOWRANK_SHAPES[label]
    x = _rnd(cuda, m, c, dtype=getattr(torch, dtype))
    args = (x, *_packed(cuda, c, r, mode=mode),
            *_packed(cuda, r, s, mode=mode))
    n0 = lsk.launches
    y = lsk.lowrank_matmul_sq(*args)
    assert lsk.launches == n0 + 1
    assert _norm_err(y, ref.lowrank_matmul_sq_ref(*args)) \
        <= chip_smoke.KERNEL_TOL[dtype]


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", chip_smoke.M_CASES)
@pytest.mark.parametrize("label", list(chip_smoke.BRANCHED_SHAPES)
                         + list(chip_smoke.DEEPSEEK_BRANCHED_SHAPES))
def test_branched_sq_kernel_matches_plain(cuda, label, m, dtype, mode):
    from repro_torch.kernels import branched_matmul_sq as bsk
    from repro_torch.kernels import ref
    n, c, r, s = {**chip_smoke.BRANCHED_SHAPES,
                  **chip_smoke.DEEPSEEK_BRANCHED_SHAPES}[label]
    x = _rnd(cuda, m, c, dtype=getattr(torch, dtype))
    args = (x, *_packed(cuda, n, c, r, mode=mode),
            *_quantized(cuda, n, r, r, mode=mode),
            *_packed(cuda, n, r, s, mode=mode))
    n0 = bsk.launches
    y = bsk.branched_matmul_sq(*args)
    assert bsk.launches == n0 + 1
    assert _norm_err(y, ref.branched_matmul_sq_ref(*args)) \
        <= chip_smoke.KERNEL_TOL[dtype]


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
@pytest.mark.parametrize("m,c,r,s,n", [(1, 36, 8, 70, 3),
                                       (9, 200, 20, 129, 1)])
def test_ragged_everything_sparse(cuda, m, c, r, s, n, mode):
    from repro_torch.kernels import ops, ref
    x = _rnd(cuda, m, c, dtype=torch.float32)
    lr = (*_packed(cuda, c, r, mode=mode), *_packed(cuda, r, s, mode=mode))
    assert _norm_err(ops.lowrank_matmul_sq(x, *lr),
                     ref.lowrank_matmul_sq_ref(x, *lr)) <= 1e-5
    br = (*_packed(cuda, n, c, r, mode=mode),
          *_quantized(cuda, n, r, r, mode=mode),
          *_packed(cuda, n, r, s, mode=mode))
    assert _norm_err(ops.branched_matmul_sq(x, *br),
                     ref.branched_matmul_sq_ref(x, *br)) <= 1e-5


def test_sq_wrappers_refuse_a_wrong_group_size(cuda):
    """A pack whose groups do not cover the input width (C != 4 * G), or
    index rows of another group count, raise before any launch."""
    from repro_torch.kernels import branched_matmul_sq as bsk
    from repro_torch.kernels import lowrank_matmul_sq as lsk
    w0 = _packed(cuda, 32, 16, mode="int8")
    w1 = _packed(cuda, 16, 48, mode="int8")
    n0 = lsk.launches
    with pytest.raises(ValueError, match="groups of 4"):
        lsk.lowrank_matmul_sq(_rnd(cuda, 4, 30, dtype=torch.float32), *w0,
                              *w1)
    with pytest.raises(ValueError, match="_idx"):
        lsk.lowrank_matmul_sq(_rnd(cuda, 4, 32, dtype=torch.float32),
                              w0[0], w0[1][:, :4].contiguous(), w0[2], *w1)
    assert lsk.launches == n0
    u = _packed(cuda, 2, 32, 8, mode="int8")
    xc = _quantized(cuda, 2, 8, 12, mode="int8")       # r2 = 12
    v = _packed(cuda, 2, 8, 48, mode="int8")            # groups over 8
    n0 = bsk.launches
    with pytest.raises(ValueError, match="groups of 4"):
        bsk.branched_matmul_sq(_rnd(cuda, 4, 32, dtype=torch.float32), *u,
                               *xc, *v)
    assert bsk.launches == n0


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
def test_plan_execute_launches_the_sparse_kernels(cuda, mode):
    """A 2:4 tree's plans on the card launch B11 / B12 once per call and
    nothing else, and agree with the same plans on the CPU."""
    from repro_torch.kernels import branched_matmul_q as bqk
    from repro_torch.kernels import branched_matmul_sq as bsk
    from repro_torch.kernels import lowrank_matmul_q as lqk
    from repro_torch.kernels import lowrank_matmul_sq as lsk
    from repro_torch.layers.param import apply_linear
    from repro_torch.quant.quantize import quantize_tree
    from repro_torch.quant.sparse import sparsify_tree
    trees = {"lowrank": {"w0": _rnd(cuda, 64, 16, dtype=torch.float32),
                         "w1": _rnd(cuda, 16, 96, dtype=torch.float32)},
             "branched": {"u": _rnd(cuda, 2, 64, 8, dtype=torch.float32),
                          "xc": _rnd(cuda, 2, 8, 8, dtype=torch.float32),
                          "v": _rnd(cuda, 2, 8, 96, dtype=torch.float32)}}
    x = _rnd(cuda, 2, 5, 64, dtype=torch.float32)
    for kind, tree in trees.items():
        p = quantize_tree(sparsify_tree(tree, mode=mode), mode)
        mods = (lsk, lqk) if kind == "lowrank" else (bsk, bqk)
        n0 = [mod.launches for mod in mods]
        y = apply_linear(p, x)
        assert [mod.launches - k for mod, k in zip(mods, n0)] == [1, 0]
        p_cpu = {k: t.cpu() for k, t in p.items()}
        assert _norm_err(y.cpu(), apply_linear(p_cpu, x.cpu())) <= 1e-5


# --- bf16 B4 / B12 on the split-phase kernel -------------------------------

_Q_SHAPES = {**chip_smoke.BRANCHED_SHAPES,
             **chip_smoke.DEEPSEEK_BRANCHED_SHAPES,
             "ragged r=5": (3, 33, 5, 70), "ragged r=17": (1, 200, 17, 129)}
_SQ_SHAPES = {**chip_smoke.BRANCHED_SHAPES,
              **chip_smoke.DEEPSEEK_BRANCHED_SHAPES,
              "ragged r=8": (3, 32, 8, 70), "ragged r=20": (2, 200, 20, 129)}


def _q_args(g, x, n, c, r, s, mode):
    return (x, *_quantized(g, n, c, r, mode=mode),
            *_quantized(g, n, r, r, mode=mode),
            *_quantized(g, n, r, s, mode=mode))


def _sq_args(g, x, n, c, r, s, mode):
    return (x, *_packed(g, n, c, r, mode=mode),
            *_quantized(g, n, r, r, mode=mode),
            *_packed(g, n, r, s, mode=mode))


def _dense_factors(kind, args):
    """The bf16 factors the split-phase kernel stages: dequantized, or
    expanded from the packs, beforehand."""
    from repro_torch.quant.sparse import expand_sparse
    dq = lambda q, sc: (q.float() * sc).to(torch.bfloat16)  # noqa: E731
    if kind == "q":
        return dq(*args[1:3]), dq(*args[3:5]), dq(*args[5:7])
    return (expand_sparse(*args[1:4], dtype=torch.bfloat16),
            dq(*args[4:6]), expand_sparse(*args[6:9], dtype=torch.bfloat16))


def _kind(kind):
    from repro_torch.kernels import branched_matmul_q as bqk
    from repro_torch.kernels import branched_matmul_sq as bsk
    from repro_torch.kernels import ref
    if kind == "q":
        return bqk, bqk.branched_matmul_q, ref.branched_matmul_q_ref, _q_args
    return (bsk, bsk.branched_matmul_sq, ref.branched_matmul_sq_ref,
            _sq_args)


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
@pytest.mark.parametrize("m", chip_smoke.M_CASES)
@pytest.mark.parametrize("kind,label", [("q", k) for k in _Q_SHAPES]
                         + [("sq", k) for k in _SQ_SHAPES])
def test_split_q_sq_bf16_matches_plain_and_b2(cuda, kind, label, m, mode):
    """bf16 B4 / B12 run the split-phase kernel: within KERNEL_TOL of the
    plain version, one launch per call, the same bits on a second call,
    and bit-equal to bf16 B2's split-phase kernel on the factors
    dequantized (or expanded) beforehand -- the views stage exactly those
    bf16 values and the work split is the same."""
    from repro_torch.kernels import branched_matmul as bk
    mod, fn, plain, make = _kind(kind)
    n, c, r, s = (_Q_SHAPES if kind == "q" else _SQ_SHAPES)[label]
    x = _rnd(cuda, m, c, dtype=torch.bfloat16)
    args = make(cuda, x, n, c, r, s, mode)
    n0 = mod.launches
    y = fn(*args)
    assert mod.launches == n0 + 1
    assert torch.equal(y, fn(*args))
    assert _norm_err(y, plain(*args)) <= chip_smoke.KERNEL_TOL["bfloat16"]
    assert torch.equal(y, bk.branched_matmul(x, *_dense_factors(kind, args)))


@pytest.mark.parametrize("kind", ["q", "sq"])
@pytest.mark.parametrize("m", [72, 512])
@pytest.mark.parametrize("label", [*chip_smoke.BRANCHED_SHAPES, "ds o"])
def test_split_q_sq_row_blocks_same_bits(cuda, label, m, kind):
    """M past one 64-row block: the kernel loops over row blocks; two
    calls give the same bits, one launch each."""
    mod, fn, plain, make = _kind(kind)
    n, c, r, s = {**chip_smoke.BRANCHED_SHAPES,
                  **chip_smoke.DEEPSEEK_BRANCHED_SHAPES}[label]
    args = make(cuda, _rnd(cuda, m, c, dtype=torch.bfloat16), n, c, r, s,
                "int8")
    n0 = mod.launches
    y = fn(*args)
    y2 = fn(*args)
    assert mod.launches == n0 + 2
    assert torch.equal(y, y2)
    assert _norm_err(y, plain(*args)) <= chip_smoke.KERNEL_TOL["bfloat16"]


@pytest.mark.parametrize("kind", ["q", "sq"])
def test_split_q_sq_f32_runs_the_cluster_kernel(cuda, kind):
    """f32 B12 keeps the cluster kernel: bit-equal to the yardstick entry
    that launches it.  f32 B4 runs the f32 form: bit-equal to f32 B2 on
    the factors dequantized beforehand, within f32's tolerance of the
    cluster kernel.  Both within f32's tolerance of the plain version."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import ref
    mod, fn, plain, make = _kind(kind)
    n, c, r, s = chip_smoke.BRANCHED_SHAPES["gate,up"]
    args = make(cuda, _rnd(cuda, 37, c, dtype=torch.float32), n, c, r, s,
                "int8")
    cluster = getattr(mod, f"cluster_branched_matmul_{kind}")
    n0 = mod.launches
    y = fn(*args)
    tol = chip_smoke.KERNEL_TOL["float32"]
    if kind == "q":
        assert torch.equal(y, bk.branched_matmul(args[0], *(
            ref._dq(q, sc, torch.float32)
            for q, sc in zip(args[1::2], args[2::2]))))
        assert _norm_err(y, cluster(*args)) <= tol
    else:
        assert torch.equal(y, cluster(*args))
    assert mod.launches == n0 + 1
    assert _norm_err(y, plain(*args)) <= tol


def test_split_q_sq_smem_and_grid(cuda):
    """The C side's shared memory equals the wrapper's count, under the
    opt-in limit; every instantiation's persistent grid holds at least
    one CTA per SM."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import build
    lib = build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind in ("q", "sq"):
        smem = getattr(lib, f"lrk_branched_{kind}_mma_smem")()
        assert smem == bk.mma_smem_bytes(kind) <= build.SMEM_LIMIT
        grid = getattr(lib, f"lrk_branched_{kind}_mma_grid")
        for qtype in (0, 1):
            for rows in (1, 16, 32, 64):
                assert grid(qtype, rows) >= sms


@pytest.mark.parametrize("kind", ["q", "sq"])
@pytest.mark.parametrize("m", [8, 72])
def test_split_q_sq_phase_timer(cuda, kind, m):
    """The phase timer of B4 / B12: one counted launch, three
    non-negative phase times per 64-row block."""
    mod, _, _, make = _kind(kind)
    n, c, r, s = chip_smoke.BRANCHED_SHAPES["q,o"]
    args = make(cuda, _rnd(cuda, m, c, dtype=torch.bfloat16), n, c, r, s,
                "int8")
    n0 = mod.launches
    us = getattr(mod, f"branched_matmul_{kind}_phase_us")(*args)
    assert mod.launches == n0 + 1
    assert len(us) == 3 * -(-m // 64) and min(us) >= 0 and sum(us) > 0


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
def test_split_sq_nan_meets_only_pruned_rows(cuda, mode):
    """A NaN in an x column whose u rows are all pruned still reaches y,
    as in the reference's dense dot: the pruned rows are explicit zeros
    in the product (NaN * 0 = NaN)."""
    from repro_torch.kernels import branched_matmul_sq as bsk
    from repro_torch.kernels import ref
    n, c, r, s = chip_smoke.BRANCHED_SHAPES["q,o"]
    x = _rnd(cuda, 8, c, dtype=torch.bfloat16)
    args = list(_sq_args(cuda, x, n, c, r, s, mode))
    u_idx = args[2]
    # group 5 keeps rows 1 and 3 in every branch, so row 20 is pruned
    u_idx[:, 0, 5] = 1
    u_idx[:, 1, 5] = 3
    x[3, 20] = float("nan")
    y = bsk.branched_matmul_sq(*args)
    want = ref.branched_matmul_sq_ref(*args)
    assert torch.isnan(want[3]).all() and torch.isnan(y[3]).all()
    keep = torch.arange(8, device="cuda") != 3
    assert torch.isfinite(y[keep]).all()
    assert _norm_err(y[keep], want[keep]) \
        <= chip_smoke.KERNEL_TOL["bfloat16"]


_PAGED_IDS = ["served", "softcap30", "smoke", "wide-block", "odd-block"]
_PAGED_SPLIT_CASES = [
    *chip_smoke.PAGED_CASES.values(),
    dict(b=3, kh=2, g=2, d=16, bs=4, nblk=5, nb=16, idle=1, softcap=0.0),
    dict(b=2, kh=1, g=8, d=128, bs=128, nblk=3, nb=6, idle=0, softcap=5.0),
    dict(b=2, kh=2, g=4, d=64, bs=3, nblk=40, nb=80, idle=0, softcap=0.0)]
_LATENT_IDS = ["served", "idle-slot", "ragged-S", "smoke", "partial-group",
               "wide-latent"]
_LATENT_SPLIT_CASES = [
    *chip_smoke.LATENT_CASES.values(),
    dict(b=3, s=70, h=4, lora=16, rope=8, idle=1),
    dict(b=2, s=129, h=20, lora=64, rope=16, idle=0),
    dict(b=1, s=5, h=1, lora=1024, rope=4, idle=0)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", _PAGED_SPLIT_CASES, ids=_PAGED_IDS)
def test_paged_q_split_same_bits_prev_and_one_split(cuda, case, dtype):
    """B9's split kernel gives the same bits on a second call, stays
    within tolerance of the earlier kernel and of itself forced to one
    split, one counted launch per call (the earlier kernel uncounted)."""
    from repro_torch.kernels import decode_attention_paged as dpk
    q, pool, tables, pos = chip_smoke.paged_inputs(case, dtype, True, cuda)
    b, kh, g, d = case["b"], case["kh"], case["g"], case["d"]
    args = (q.reshape(b, kh, g, d), *pool, tables, pos)
    kw = {"softcap": case["softcap"]}
    n0 = dpk.launches_q
    y = dpk.decode_attention_paged_q(*args, **kw)
    assert torch.equal(y, dpk.decode_attention_paged_q(*args, **kw))
    one = dpk.decode_attention_paged_q_split(*args, **kw, splits=1)
    assert dpk.launches_q == n0 + 3
    old = dpk.prev_decode_attention_paged_q(*args, **kw)
    assert dpk.launches_q == n0 + 3
    tol = chip_smoke.KERNEL_TOL[dtype]
    assert _norm_err(y, old) <= tol and _norm_err(one, y) <= tol


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", _LATENT_SPLIT_CASES, ids=_LATENT_IDS)
def test_latent_q_split_same_bits_prev_and_one_split(cuda, case, dtype):
    """B10's split kernel gives the same bits on a second call, stays
    within tolerance of the earlier kernel and of itself forced to one
    split, one counted launch per call (the earlier kernel uncounted)."""
    from repro_torch.kernels import decode_attention_latent_q as dlk

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return _rnd(cuda, *shape, scale=scale, dtype=dtype)
    q_lat, q_rope, *rest = chip_smoke.latent_inputs(case, dtype, rnd)
    args = (q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous(), *rest)
    scale = 1.0 / (128 + case["rope"]) ** 0.5
    n0 = dlk.launches
    y = dlk.decode_attention_latent_q(*args, scale=scale)
    assert torch.equal(y, dlk.decode_attention_latent_q(*args, scale=scale))
    one = dlk.decode_attention_latent_q_split(*args, scale=scale, splits=1)
    assert dlk.launches == n0 + 3
    old = dlk.prev_decode_attention_latent_q(*args, scale=scale)
    assert dlk.launches == n0 + 3
    tol = chip_smoke.KERNEL_TOL[dtype]
    assert _norm_err(y, old) <= tol and _norm_err(one, y) <= tol


def test_split_attention_smem_matches_the_wrappers(cuda):
    """The C side's shared memory of B10's split kernel equals the
    wrapper's count at every geometry the card tests plan, and B9's split
    kernel takes every paged case."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention_latent_q as dlk
    lib = build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in _LATENT_SPLIT_CASES:
        sp = dlk.latent_split(c["b"], c["h"], c["s"], c["lora"], c["rope"],
                              sms)
        assert int(lib.lrk_decode_attention_latent_q_smem(
            c["lora"], c["rope"], sp.bs, sp.mt)) == \
            dlk.latent_smem(c["lora"], c["rope"], sp.bs, sp.mt)
    from repro_torch.kernels import decode_attention_paged as dpk
    for c in _PAGED_SPLIT_CASES:
        span = dpk.paged_split(c["b"], c["kh"], c["nblk"], sms).span
        assert lib.lrk_decode_attention_paged_split_fits(
            c["g"], c["d"], c["bs"], 1, 1, span)


# --- bf16 B11 on the two-phase split kernel --------------------------------

#: lowrank pairs (C, R, S) of B11's split kernel: llama's k/v SVD pair,
#: DeepSeek-V2-width pairs (d_model 5120 into ranks of 512 and 256 out to
#: q_lora 1536 and kv_lora + rope 576), and ragged ones (C, R multiples of
#: 4 but not of the stage depth 32; S past a 128-column tile)
_LOWRANK_SQ_SHAPES = {
    **{k: chip_smoke.LOWRANK_SHAPES[k] for k in chip_smoke.SPARSE_LOWRANK},
    "ds q": (5120, 512, 1536), "ds kv": (5120, 256, 576),
    "ragged C=36": (36, 20, 70), "ragged R=8": (200, 8, 129)}


def _lowrank_sq_args(g, m, label, mode, dtype=torch.bfloat16):
    c, r, s = _LOWRANK_SQ_SHAPES[label]
    return (_rnd(g, m, c, dtype=dtype), *_packed(g, c, r, mode=mode),
            *_packed(g, r, s, mode=mode))


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
@pytest.mark.parametrize("m", chip_smoke.M_CASES)
@pytest.mark.parametrize("label", list(_LOWRANK_SQ_SHAPES))
def test_split_lowrank_sq_bf16_matches_plain_and_cluster(cuda, label, m,
                                                         mode):
    """bf16 B11 runs the two-phase split kernel: one launch per call, the
    same bits on a second call, within KERNEL_TOL of the plain version and
    of the cluster kernel (the earlier design, uncounted)."""
    from repro_torch.kernels import lowrank_matmul_sq as lsk
    from repro_torch.kernels import ref
    args = _lowrank_sq_args(cuda, m, label, mode)
    n0 = lsk.launches
    y = lsk.lowrank_matmul_sq(*args)
    assert lsk.launches == n0 + 1
    assert torch.equal(y, lsk.lowrank_matmul_sq(*args))
    old = lsk.cluster_lowrank_matmul_sq(*args)
    assert lsk.launches == n0 + 2
    tol = chip_smoke.KERNEL_TOL["bfloat16"]
    assert _norm_err(y, ref.lowrank_matmul_sq_ref(*args)) <= tol
    assert _norm_err(y, old) <= tol


@pytest.mark.parametrize("m", [72, 512])
def test_split_lowrank_sq_row_blocks_same_bits(cuda, m):
    """M past one 64-row block: the kernel loops over row blocks; two
    calls give the same bits, one launch each."""
    from repro_torch.kernels import lowrank_matmul_sq as lsk
    from repro_torch.kernels import ref
    args = _lowrank_sq_args(cuda, m, "k,v", "int8")
    n0 = lsk.launches
    y = lsk.lowrank_matmul_sq(*args)
    assert torch.equal(y, lsk.lowrank_matmul_sq(*args))
    assert lsk.launches == n0 + 2
    assert _norm_err(y, ref.lowrank_matmul_sq_ref(*args)) \
        <= chip_smoke.KERNEL_TOL["bfloat16"]


def test_split_lowrank_sq_f32_runs_the_cluster_kernel(cuda):
    """f32 x keeps the cluster kernel: bit-equal to the yardstick entry
    that launches it, one counted launch, within f32's tolerance."""
    from repro_torch.kernels import lowrank_matmul_sq as lsk
    from repro_torch.kernels import ref
    args = _lowrank_sq_args(cuda, 37, "k,v", "int8", dtype=torch.float32)
    n0 = lsk.launches
    y = lsk.lowrank_matmul_sq(*args)
    assert lsk.launches == n0 + 1
    assert torch.equal(y, lsk.cluster_lowrank_matmul_sq(*args))
    assert _norm_err(y, ref.lowrank_matmul_sq_ref(*args)) \
        <= chip_smoke.KERNEL_TOL["float32"]


def test_split_lowrank_sq_smem_and_grid(cuda):
    """The C side's shared memory of the two-phase kernel equals the
    wrapper's count, under the opt-in limit; its persistent grid holds at
    least one CTA per SM at every row tile count."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import build
    lib = build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert lib.lrk_lowrank_sq_mma_smem() == bk.mma_smem_bytes("lowrank_sq") \
        <= build.SMEM_LIMIT
    for qtype in (0, 1):
        for rows in (1, 16, 32, 64):
            assert lib.lrk_lowrank_sq_mma_grid(qtype, rows) >= sms


@pytest.mark.parametrize("items", [None, 8, 64])
@pytest.mark.parametrize("m", [8, 72])
def test_split_lowrank_sq_phase_timer(cuda, m, items):
    """B11's phase timer: one counted launch, two non-negative phase
    times per 64-row block, at the default plan and at coarser and finer
    K slices."""
    from repro_torch.kernels import lowrank_matmul_sq as lsk
    args = _lowrank_sq_args(cuda, m, "k,v", "int8")
    n0 = lsk.launches
    us = lsk.lowrank_matmul_sq_phase_us(*args, items=items)
    assert lsk.launches == n0 + 1
    assert len(us) == 2 * -(-m // 64) and min(us) >= 0 and sum(us) > 0


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
def test_split_lowrank_sq_nan_meets_only_pruned_rows(cuda, mode):
    """A NaN in an x column whose w0 row is pruned still reaches y, as in
    the reference's dense dot: pruned rows are explicit zeros in the
    product (NaN * 0 = NaN)."""
    from repro_torch.kernels import lowrank_matmul_sq as lsk
    from repro_torch.kernels import ref
    args = list(_lowrank_sq_args(cuda, 8, "k,v", mode))
    # group 5 keeps rows 1 and 3, so row 20 is pruned
    args[2][0, 5] = 1
    args[2][1, 5] = 3
    args[0][3, 20] = float("nan")
    y = lsk.lowrank_matmul_sq(*args)
    want = ref.lowrank_matmul_sq_ref(*args)
    assert torch.isnan(want[3]).all() and torch.isnan(y[3]).all()
    keep = torch.arange(8, device="cuda") != 3
    assert torch.isfinite(y[keep]).all()
    assert _norm_err(y[keep], want[keep]) \
        <= chip_smoke.KERNEL_TOL["bfloat16"]


# --- B8 on the sequence-split kernel ---------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", _PAGED_SPLIT_CASES, ids=_PAGED_IDS)
def test_paged_split_same_bits_prev_and_one_split(cuda, case, dtype):
    """B8's split kernel on bf16 and f32 pools gives the same bits on a
    second call, stays within tolerance of the earlier kernel and of
    itself forced to one split, one counted launch per call (the earlier
    kernel uncounted)."""
    from repro_torch.kernels import decode_attention_paged as dpk
    q, pool, tables, pos = chip_smoke.paged_inputs(case, dtype, False, cuda)
    b, kh, g, d = case["b"], case["kh"], case["g"], case["d"]
    args = (q.reshape(b, kh, g, d), *pool, tables, pos)
    kw = {"softcap": case["softcap"]}
    n0 = dpk.launches
    y = dpk.decode_attention_paged(*args, **kw)
    assert torch.equal(y, dpk.decode_attention_paged(*args, **kw))
    one = dpk.decode_attention_paged_split(*args, **kw, splits=1)
    assert dpk.launches == n0 + 3
    old = dpk.prev_decode_attention_paged(*args, **kw)
    assert dpk.launches == n0 + 3
    tol = chip_smoke.KERNEL_TOL[dtype]
    assert _norm_err(y, old) <= tol and _norm_err(one, y) <= tol


def test_paged_split_smem_matches_the_wrapper(cuda):
    """The C side's shared memory of the split kernel equals the
    wrapper's count (``split_smem``) on int8, bf16 and f32 pools at every
    paged case's planned span, and the kernel takes each plan."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention_paged as dpk
    lib = build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in _PAGED_SPLIT_CASES:
        for esize in (1, 2, 4):
            fit = (c["g"], c["d"], c["bs"], esize, esize == 1)
            span = dpk.paged_split(c["b"], c["kh"], c["nblk"], sms,
                                   fit=fit).span
            assert int(lib.lrk_decode_attention_paged_split_smem(
                *fit[:4], int(fit[4]), span)) == dpk.split_smem(*fit, span)
            assert lib.lrk_decode_attention_paged_split_fits(
                *fit[:4], int(fit[4]), span)


def test_paged_split_wide_f32_pool_refuses_a_long_table(cuda):
    """An f32 pool of D 256 fits one pass a split: a table of 256 entries
    of 16 positions needs more than MAX_SPLITS splits, so the wrapper
    raises before any launch; at 128 entries it plans 32 splits and runs."""
    from repro_torch.kernels import decode_attention_paged as dpk
    from repro_torch.kernels import ref
    case = dict(b=1, kh=1, g=2, d=256, bs=16, nblk=256, nb=256, idle=0,
                softcap=0.0)
    q, pool, tables, pos = chip_smoke.paged_inputs(case, "float32", False,
                                                   cuda)
    args = (q.reshape(1, 1, 2, 256), *pool, tables, pos)
    n0 = dpk.launches
    with pytest.raises(ValueError, match="no span"):
        dpk.decode_attention_paged(*args)
    assert dpk.launches == n0
    short = (args[0], *pool, tables[:, :128].contiguous(),
             torch.clamp(pos, max=128 * 16 - 1))
    y = dpk.decode_attention_paged(*short)
    assert dpk.launches == n0 + 1
    want = ref.decode_attention_paged_ref(q, *pool, *short[3:])
    assert _norm_err(y.reshape(want.shape), want) \
        <= chip_smoke.KERNEL_TOL["float32"]


@pytest.mark.parametrize("m", [8, 72])
def test_split_lowrank_sq_plans_change_no_bit(cuda, m):
    """The CTA cap moves items between CTAs but not the order partials
    are summed in: the whole persistent grid, one CTA and the default cap
    give the same bits; one counted launch each."""
    from repro_torch.kernels import lowrank_matmul_sq as lsk
    args = _lowrank_sq_args(cuda, m, "k,v", "int8")
    n0 = lsk.launches
    y = lsk.lowrank_matmul_sq(*args)
    for ctas in (0, 1, 7):
        assert torch.equal(y, lsk.lowrank_matmul_sq_split(*args, ctas=ctas))
    assert lsk.launches == n0 + 4


# --- bf16 B1 / B3 on the two-phase split kernel ----------------------------

#: the factors of a lowrank row: bf16 (B1), int8 or e4m3 with scales (B3)
_LOWRANK_KINDS = ("bf16",) + chip_smoke.QMODES
#: decode, ragged, chunk, past one 64-row block, a long prompt
_LOWRANK_M = (8, 37, 64, 72, 512)


def _lowrank_kernel(kind):
    """The wrapper module and entry of a lowrank row's kernel."""
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import lowrank_matmul_q as lqk
    return (lk, "lowrank_matmul") if kind == "bf16" else \
        (lqk, "lowrank_matmul_q")


def _lowrank_args(g, kind, m, c, r, s, dtype=torch.bfloat16):
    x = _rnd(g, m, c, dtype=dtype)
    if kind == "bf16":
        return (x, _rnd(g, c, r, scale=c ** -0.5, dtype=dtype),
                _rnd(g, r, s, scale=r ** -0.5, dtype=dtype))
    return (x, *_quantized(g, c, r, mode=kind),
            *_quantized(g, r, s, mode=kind))


@pytest.mark.parametrize("kind", _LOWRANK_KINDS)
@pytest.mark.parametrize("m", _LOWRANK_M)
@pytest.mark.parametrize("label", list(chip_smoke.LOWRANK_SHAPES))
def test_split_lowrank_bf16_matches_plain_and_cluster(cuda, label, m,
                                                      kind):
    """bf16 B1 / B3 run the two-phase split kernel at every served SVD
    pair: one counted launch per call, the same bits on a second call,
    within KERNEL_TOL of the plain version and of the cluster kernel (the
    earlier design, uncounted)."""
    from repro_torch.kernels import ref
    mod, name = _lowrank_kernel(kind)
    args = _lowrank_args(cuda, kind, m, *chip_smoke.LOWRANK_SHAPES[label])
    n0 = mod.launches
    y = getattr(mod, name)(*args)
    assert mod.launches == n0 + 1
    assert torch.equal(y, getattr(mod, name)(*args))
    old = getattr(mod, "cluster_" + name)(*args)
    assert mod.launches == n0 + 2
    tol = chip_smoke.KERNEL_TOL["bfloat16"]
    assert _norm_err(y, getattr(ref, name + "_ref")(*args)) <= tol
    assert _norm_err(y, old) <= tol


@pytest.mark.parametrize("kind", _LOWRANK_KINDS)
def test_split_lowrank_f32_runs_the_cluster_kernel(cuda, kind):
    """f32 B1 and f32 B3 (int8 / e4m3 factors) run the f32 form: the same
    bits on a second call, within f32's tolerance of the cluster kernel
    (the earlier design, uncounted); B3's bits are f32 B1's on the factors
    dequantized beforehand.  One counted launch each, within f32's
    tolerance of the plain version."""
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import ref
    mod, name = _lowrank_kernel(kind)
    args = _lowrank_args(cuda, kind, 37, *chip_smoke.LOWRANK_SHAPES["k,v"],
                         dtype=torch.float32)
    n0 = mod.launches
    y = getattr(mod, name)(*args)
    assert mod.launches == n0 + 1
    tol = chip_smoke.KERNEL_TOL["float32"]
    old = getattr(mod, "cluster_" + name)(*args)
    assert torch.equal(y, getattr(mod, name)(*args))
    assert _norm_err(y, old) <= tol
    if kind != "bf16":
        x, w0q, w0s, w1q, w1s = args
        assert torch.equal(y, lk.lowrank_matmul(
            x, ref._dq(w0q, w0s, x.dtype), ref._dq(w1q, w1s, x.dtype)))
    assert _norm_err(y, getattr(ref, name + "_ref")(*args)) <= tol


def test_split_lowrank_smem_and_grid(cuda):
    """The C side's shared memory of B1's and B3's two-phase kernels
    equals the wrapper's count, under the opt-in limit; each persistent
    grid holds at least one CTA per SM at every row tile count."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import build
    lib = build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert lib.lrk_lowrank_mma_smem() == bk.mma_smem_bytes("lowrank_bf16") \
        <= build.SMEM_LIMIT
    assert lib.lrk_lowrank_q_mma_smem() == bk.mma_smem_bytes("lowrank_q") \
        <= build.SMEM_LIMIT
    for rows in (1, 16, 32, 64):
        assert lib.lrk_lowrank_mma_grid(rows) >= sms
        for qtype in (0, 1):
            assert lib.lrk_lowrank_q_mma_grid(qtype, rows) >= sms


@pytest.mark.parametrize("kind", _LOWRANK_KINDS)
@pytest.mark.parametrize("m", [8, 72])
def test_split_lowrank_phase_timer(cuda, m, kind):
    """The phase timer of bf16 B1 / B3: one counted launch, two positive
    phase times per 64-row block."""
    mod, name = _lowrank_kernel(kind)
    args = _lowrank_args(cuda, kind, m, *chip_smoke.LOWRANK_SHAPES["k,v"])
    n0 = mod.launches
    us = getattr(mod, name + "_phase_us")(*args)
    assert mod.launches == n0 + 1
    assert len(us) == 2 * -(-m // 64) and min(us) > 0


@pytest.mark.parametrize("kind", _LOWRANK_KINDS)
@pytest.mark.parametrize("label", ["k,v", "gate,up (branches=1)"])
def test_split_lowrank_plans_change_no_bit(cuda, label, kind):
    """The CTA cap moves items between CTAs but not the order partials
    are summed in: the whole persistent grid, one CTA, seven and the
    default give the same bits.  Another K slicing sums other partials,
    so it is held within KERNEL_TOL instead.  One counted launch each."""
    mod, name = _lowrank_kernel(kind)
    split = getattr(mod, name + "_split")
    args = _lowrank_args(cuda, kind, 8, *chip_smoke.LOWRANK_SHAPES[label])
    n0 = mod.launches
    y = getattr(mod, name)(*args)
    for ctas in (0, 1, 7):
        assert torch.equal(y, split(*args, ctas=ctas))
    for items in (8, (264, 4)):
        assert _norm_err(split(*args, items=items), y) \
            <= chip_smoke.KERNEL_TOL["bfloat16"]
    assert mod.launches == n0 + 6


@pytest.mark.parametrize("kind", _LOWRANK_KINDS)
@pytest.mark.parametrize("m,c,r,s", [(1, 33, 5, 70), (9, 200, 17, 129)])
def test_ragged_lowrank_bf16(cuda, m, c, r, s, kind):
    """bf16 B1 / B3 at test_ragged_everything's shapes: rows whose stride
    is not a multiple of 16 bytes and column tiles past the last column
    take the masked scalar staging path."""
    from repro_torch.kernels import ref
    mod, name = _lowrank_kernel(kind)
    args = _lowrank_args(cuda, kind, m, c, r, s)
    n0 = mod.launches
    y = getattr(mod, name)(*args)
    assert mod.launches == n0 + 1
    assert _norm_err(y, getattr(ref, name + "_ref")(*args)) \
        <= chip_smoke.KERNEL_TOL["bfloat16"]


@pytest.mark.parametrize("kind", _LOWRANK_KINDS)
def test_split_lowrank_nan_reaches_y(cuda, kind):
    """A NaN in x reaches its row of y, as in the reference's dot, and no
    other row."""
    from repro_torch.kernels import ref
    mod, name = _lowrank_kernel(kind)
    args = _lowrank_args(cuda, kind, 8, *chip_smoke.LOWRANK_SHAPES["k,v"])
    args[0][3, 20] = float("nan")
    y = getattr(mod, name)(*args)
    want = getattr(ref, name + "_ref")(*args)
    assert torch.isnan(want[3]).all() and torch.isnan(y[3]).all()
    keep = torch.arange(8, device="cuda") != 3
    assert torch.isfinite(y[keep]).all()
    assert _norm_err(y[keep], want[keep]) \
        <= chip_smoke.KERNEL_TOL["bfloat16"]


@pytest.mark.parametrize("kind", _LOWRANK_KINDS)
def test_split_lowrank_refuses_empty_factors(cuda, kind):
    """bf16 B1 / B3 take no empty factors, as B11: no surgery makes a
    rank under 8, so nothing on the serve path has one."""
    mod, name = _lowrank_kernel(kind)
    x = _rnd(cuda, 8, 64, dtype=torch.bfloat16)
    if kind == "bf16":
        args = (x, torch.zeros(64, 0, dtype=x.dtype, device="cuda"),
                torch.zeros(0, 96, dtype=x.dtype, device="cuda"))
    else:
        qt = torch.int8 if kind == "int8" else torch.float8_e4m3fn
        args = (x, torch.zeros(64, 0, dtype=qt, device="cuda"),
                torch.zeros(1, 0, device="cuda"),
                torch.zeros(0, 96, dtype=qt, device="cuda"),
                torch.zeros(1, 96, device="cuda"))
    n0 = mod.launches
    with pytest.raises(ValueError, match="empty factors"):
        getattr(mod, name)(*args)
    assert mod.launches == n0


# --- B5 on the split kernel's slot view ------------------------------------

def _slot_args(g, case, dtype):
    """chip_smoke's B5 inputs: q (B,KH,G,D), the int8 slot pool quantized
    as the engine's prefill quantizes it, ragged positions, idle slots."""
    from repro_torch.quant.kv import quantize_kv_prefill
    b, s, kh, gg, d = (case[k] for k in ("b", "s", "kh", "g", "d"))
    q = _rnd(g, b, kh, gg, d, dtype=getattr(torch, dtype))
    k_q, k_s = quantize_kv_prefill(_rnd(g, b, s, kh, d, dtype=torch.float32))
    v_q, v_s = quantize_kv_prefill(_rnd(g, b, s, kh, d, dtype=torch.float32))
    pos = torch.randint(s // 2, s, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    if case["idle"]:
        pos[b - case["idle"]:] = -1
    pos[0] = s - 1
    return q, k_q, k_s, v_q, v_s, pos


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("label", list(chip_smoke.ATTN_CASES))
def test_slot_split_matches_plain_prev_and_one_split(cuda, label, dtype):
    """B5 on the split kernel at chip_smoke's cases (the served pool, a
    ragged S with idle slots, a softcap): within tolerance of the plain
    version, of the earlier kernel and of itself forced to one split; a
    second call gives the same bits; one counted launch per call, the
    earlier kernel uncounted."""
    from repro_torch.kernels import decode_attention_q as dak
    from repro_torch.kernels import ref
    case = chip_smoke.ATTN_CASES[label]
    args = _slot_args(cuda, case, dtype)
    kw = {"softcap": case["softcap"]}
    n0 = dak.launches
    y = dak.decode_attention_q(*args, **kw)
    assert torch.equal(y, dak.decode_attention_q(*args, **kw))
    one = dak.decode_attention_q_split(*args, **kw, splits=1)
    assert dak.launches == n0 + 3
    old = dak.prev_decode_attention_q(*args, **kw)
    assert dak.launches == n0 + 3
    b, kh, g, d = args[0].shape
    want = ref.decode_attention_q_ref(args[0].reshape(b, 1, kh * g, d),
                                      *args[1:], **kw)
    tol = chip_smoke.KERNEL_TOL[dtype]
    assert torch.isfinite(y.float()).all()
    assert _norm_err(y.reshape(want.shape), want) <= tol
    assert _norm_err(y, old) <= tol and _norm_err(one, y) <= tol


def test_slot_split_smem_matches_the_wrapper(cuda):
    """The C side takes B5's planned span at every chip_smoke case, with
    the shared memory the wrapper counts."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention_paged as dpk
    from repro_torch.kernels import decode_attention_q as dak
    lib = build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for c in chip_smoke.ATTN_CASES.values():
        fit = (c["g"], c["d"], dak.SLOT_ENTRY, 1, False)
        span = dak.slot_split(c["b"], c["kh"], c["s"], sms, g=c["g"],
                              d=c["d"]).span
        assert lib.lrk_decode_attention_paged_split_fits(*fit[:4], 0, span)
        assert int(lib.lrk_decode_attention_paged_split_smem(
            *fit[:4], 0, span)) == dpk.split_smem(*fit, span)


# --- B7 on the split-phase s8 kernel ---------------------------------------

def _qa_args(g, m, label, dtype):
    n, c, r, s = chip_smoke.BRANCHED_SHAPES[label]
    x = _rnd(g, m, c, dtype=getattr(torch, dtype))
    x[m // 2] = 0
    return (x, *_quantized(g, n, c, r, mode="int8"),
            *_quantized(g, n, r, r, mode="int8"),
            *_quantized(g, n, r, s, mode="int8"))


def _differing(a, b):
    return int((a.float() != b.float()).sum())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [8, 37, 64, 512])
@pytest.mark.parametrize("label", list(chip_smoke.BRANCHED_SHAPES))
def test_split_qa_bit_equal_to_plain_and_cluster(cuda, label, m, dtype):
    """B7's split-phase s8 kernel equals the plain version and the
    earlier cluster kernel bit for bit (an all-zero row exactly 0), and a
    second call gives the same bits; one counted launch per call, the
    cluster kernel uncounted."""
    from repro_torch.kernels import branched_matmul_qa as bak
    from repro_torch.kernels import ref
    args = _qa_args(cuda, m, label, dtype)
    n0 = bak.launches
    y = bak.branched_matmul_qa(*args)
    assert torch.equal(y, bak.branched_matmul_qa(*args))
    assert bak.launches == n0 + 2
    old = bak.cluster_branched_matmul_qa(*args)
    assert bak.launches == n0 + 2
    assert _differing(y, ref.branched_matmul_qa_ref(*args)) == 0
    assert _differing(y, old) == 0
    assert (y[m // 2] == 0).all()


@pytest.mark.parametrize("items", [1, 32, 132, 1000])
def test_split_qa_plans_change_no_bit(cuda, items):
    """int32 partials add up exactly: every plan gives the default's
    bits, at a ragged chunk crossing a row block."""
    from repro_torch.kernels import branched_matmul_qa as bak
    args = _qa_args(cuda, 72, "gate,up", "bfloat16")
    assert torch.equal(bak.branched_matmul_qa_split(*args, items=items),
                       bak.branched_matmul_qa(*args))


@pytest.mark.parametrize("m,c,r1,r2,s,n", [(1, 33, 5, 7, 70, 3),
                                           (9, 200, 17, 64, 129, 1),
                                           (70, 130, 96, 40, 300, 2)])
def test_ragged_split_qa(cuda, m, c, r1, r2, s, n):
    """Ragged sizes (rows, ranks and widths that are not whole stages,
    tiles or 16-byte rows) on both activation types: bit-equal."""
    from repro_torch.kernels import ops, ref
    for dt in (torch.float32, torch.bfloat16):
        x = _rnd(cuda, m, c, dtype=dt)
        br = (*_quantized(cuda, n, c, r1, mode="int8"),
              *_quantized(cuda, n, r1, r2, mode="int8"),
              *_quantized(cuda, n, r2, s, mode="int8"))
        assert _differing(ops.branched_matmul_qa(x, *br),
                          ref.branched_matmul_qa_ref(x, *br)) == 0


def test_split_qa_smem_and_grid(cuda):
    """The C side's shared memory equals the wrapper's count, under the
    opt-in limit; both activation types' persistent grids hold at least
    one CTA per SM."""
    from repro_torch.kernels import branched_matmul_qa as bak
    from repro_torch.kernels import build
    lib = build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert lib.lrk_branched_qa_mma_smem() == bak.QA_SMEM <= build.SMEM_LIMIT
    for dtype in (0, 1):
        for rows in (1, 16, 32, 64):
            assert lib.lrk_branched_qa_mma_grid(dtype, rows) >= sms


def test_split_qa_refuses_past_the_shared_memory_gate(cuda, monkeypatch):
    """The wrapper raises, and launches nothing, where the tile's shared
    memory is past the opt-in limit (here a limit one byte under it)."""
    from repro_torch.kernels import branched_matmul_qa as bak
    from repro_torch.kernels import build
    args = _qa_args(cuda, 8, "q,o", "bfloat16")
    monkeypatch.setattr(build, "SMEM_LIMIT", bak.QA_SMEM - 1)
    n0 = bak.launches
    with pytest.raises(ValueError, match="shared memory"):
        bak.branched_matmul_qa(*args)
    assert bak.launches == n0


@pytest.mark.parametrize("m", [8, 72])
def test_split_qa_phase_timer(cuda, m):
    """B7's phase timer: one counted launch, phase 0 and six
    non-negative times per 64-row block (each product phase's items and
    the pass that sums them)."""
    from repro_torch.kernels import branched_matmul_qa as bak
    args = _qa_args(cuda, m, "q,o", "bfloat16")
    n0 = bak.launches
    us = bak.branched_matmul_qa_phase_us(*args)
    assert bak.launches == n0 + 1
    assert len(us) == 1 + 6 * -(-m // 64) and min(us) >= 0 and sum(us) > 0


# --- B6 on the split-phase s8 kernel, in two phases ------------------------

def _lowrank_qa_args(g, m, label, dtype, zero_product=False):
    """chip_smoke's B6 inputs at a LOWRANK_SHAPES pair: an all-zero row
    (m // 2) and, with ``zero_product``, a last row non-zero only on the
    input channels whose w0 rows are zero (its product exactly 0)."""
    c, r, s = chip_smoke.LOWRANK_SHAPES[label]
    x = _rnd(g, m, c, dtype=getattr(torch, dtype))
    x[m // 2] = 0
    w0q, w0s = _quantized(g, c, r, mode="int8")
    if zero_product:
        w0q[:8] = 0
        x[m - 1] = 0
        x[m - 1, :8] = 1
    return (x, w0q, w0s, *_quantized(g, r, s, mode="int8"))


#: B6 plans besides the default: (items, ctas) of lowrank_qa_split -- one
#: K slice in both phases, in phase 2 only, in phase 1 only, fine slices,
#: fewer phase-1 items, the whole grid, small CTA caps
_QA_LOWRANK_PLANS = [(1, None), ((None, 1), None), ((1, None), None),
                     (1000, None), ((64, 1), None), (None, 0), (None, 7),
                     ((3, 2), 0), ((1, 1), 7)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [8, 37, 64, 512])
@pytest.mark.parametrize("label", list(chip_smoke.LOWRANK_SHAPES))
def test_split_lowrank_qa_bit_equal_to_plain_and_cluster(cuda, label, m,
                                                         dtype):
    """B6's split-phase s8 kernel equals the plain version and the
    earlier cluster kernel bit for bit (an all-zero row exactly 0), and a
    second call gives the same bits; one counted launch per call, the
    cluster kernel uncounted."""
    from repro_torch.kernels import lowrank_matmul_qa as lak
    from repro_torch.kernels import ref
    args = _lowrank_qa_args(cuda, m, label, dtype)
    n0 = lak.launches
    y = lak.lowrank_matmul_qa(*args)
    assert torch.equal(y, lak.lowrank_matmul_qa(*args))
    assert lak.launches == n0 + 2
    old = lak.cluster_lowrank_matmul_qa(*args)
    assert lak.launches == n0 + 2
    assert _differing(y, ref.lowrank_matmul_qa_ref(*args)) == 0
    assert _differing(y, old) == 0
    assert (y[m // 2] == 0).all()


@pytest.mark.parametrize("items,ctas", _QA_LOWRANK_PLANS)
@pytest.mark.parametrize("label", ["k,v", "q,o (branches=1)"])
def test_split_lowrank_qa_plans_change_no_bit(cuda, label, items, ctas):
    """int32 partials add up exactly: every plan and CTA cap gives the
    default's bits, at a ragged chunk crossing a row block."""
    from repro_torch.kernels import lowrank_matmul_qa as lak
    args = _lowrank_qa_args(cuda, 72, label, "bfloat16")
    assert torch.equal(lak.lowrank_matmul_qa_split(*args, items=items,
                                                   ctas=ctas),
                       lak.lowrank_matmul_qa(*args))


@pytest.mark.parametrize("items", [None, 1, (None, 1)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_split_lowrank_qa_zero_and_zero_product_rows(cuda, dtype, items):
    """A zero row and a non-zero row whose product is exactly 0 give the
    plain version's bits (exactly 0: the fold starts at the term itself,
    not at 0 + term), at plans of one and of several K slices."""
    from repro_torch.kernels import lowrank_matmul_qa as lak
    from repro_torch.kernels import ref
    args = _lowrank_qa_args(cuda, 64, "k,v", dtype, zero_product=True)
    y = lak.lowrank_matmul_qa_split(*args, items=items)
    assert _differing(y, ref.lowrank_matmul_qa_ref(*args)) == 0
    assert (y[32] == 0).all() and (y[63] == 0).all()
    assert not (args[0][63] == 0).all()


@pytest.mark.parametrize("m,c,r,s", [(1, 33, 5, 70), (9, 200, 17, 129),
                                     (70, 130, 96, 300), (3, 72, 136, 8)])
def test_ragged_split_lowrank_qa(cuda, m, c, r, s):
    """Ragged sizes (rows, ranks and widths that are not whole stages,
    tiles or 16-byte rows) on both activation types, at the default plan,
    in one K slice a phase and with few phase-1 items: bit-equal."""
    from repro_torch.kernels import lowrank_matmul_qa as lak
    from repro_torch.kernels import ref
    for dt in (torch.float32, torch.bfloat16):
        x = _rnd(cuda, m, c, dtype=dt)
        lr = (*_quantized(cuda, c, r, mode="int8"),
              *_quantized(cuda, r, s, mode="int8"))
        want = ref.lowrank_matmul_qa_ref(x, *lr)
        for items in (None, 1, (2, None)):
            assert _differing(lak.lowrank_matmul_qa_split(x, *lr,
                                                          items=items),
                              want) == 0


def test_split_lowrank_qa_smem_and_grid(cuda):
    """The C side's shared memory equals the wrapper's count (B7's tile),
    under the opt-in limit; both activation types' persistent grids hold
    at least one CTA per SM."""
    from repro_torch.kernels import branched_matmul_qa as bak
    from repro_torch.kernels import build
    lib = build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert lib.lrk_lowrank_qa_mma_smem() == bak.QA_SMEM <= build.SMEM_LIMIT
    for dtype in (0, 1):
        for rows in (1, 16, 32, 64):
            assert lib.lrk_lowrank_qa_mma_grid(dtype, rows) >= sms


def test_split_lowrank_qa_refuses_past_the_shared_memory_gate(cuda,
                                                              monkeypatch):
    """The wrapper raises, and launches nothing, where the tile's shared
    memory is past the opt-in limit (here a limit one byte under it)."""
    from repro_torch.kernels import branched_matmul_qa as bak
    from repro_torch.kernels import build
    from repro_torch.kernels import lowrank_matmul_qa as lak
    args = _lowrank_qa_args(cuda, 8, "k,v", "bfloat16")
    monkeypatch.setattr(build, "SMEM_LIMIT", bak.QA_SMEM - 1)
    n0 = lak.launches
    with pytest.raises(ValueError, match="shared memory"):
        lak.lowrank_matmul_qa(*args)
    assert lak.launches == n0


@pytest.mark.parametrize("items", [None, 1])
@pytest.mark.parametrize("m", [8, 72])
def test_split_lowrank_qa_phase_timer(cuda, m, items):
    """B6's phase timer: one counted launch, phase 0 and four
    non-negative times per 64-row block (phase 1's items, the
    requantization, phase 2's items, the fold), on the default plan and
    in one K slice a phase."""
    from repro_torch.kernels import lowrank_matmul_qa as lak
    args = _lowrank_qa_args(cuda, m, "k,v", "bfloat16")
    n0 = lak.launches
    us = lak.lowrank_matmul_qa_phase_us(*args, items=items)
    assert lak.launches == n0 + 1
    assert len(us) == 1 + 4 * -(-m // 64) and min(us) >= 0 and sum(us) > 0


def test_split_lowrank_qa_refuses_empty_factors(cuda):
    """B6 takes no empty factors, as B7 and bf16 B1 / B3 (the plain
    version raises on them too: a row absmax over no values); no surgery
    makes a rank under 8, so nothing on the serve path has one."""
    from repro_torch.kernels import lowrank_matmul_qa as lak
    x = _rnd(cuda, 8, 64, dtype=torch.bfloat16)
    for c, r in ((64, 0), (0, 32)):
        args = (x[:, :c].contiguous(),
                torch.zeros(c, r, dtype=torch.int8, device="cuda"),
                torch.zeros(1, r, device="cuda"),
                torch.zeros(r, 96, dtype=torch.int8, device="cuda"),
                torch.zeros(1, 96, device="cuda"))
        n0 = lak.launches
        with pytest.raises(ValueError, match="empty factors"):
            lak.lowrank_matmul_qa(*args)
        assert lak.launches == n0


# --- the searched ranks (Algorithm 1 on the H100 spec) ----------------------

@pytest.mark.parametrize("m", _LOWRANK_M)
@pytest.mark.parametrize("label", list(chip_smoke.SEARCH_LOWRANK_SHAPES))
def test_split_lowrank_at_searched_ranks(cuda, label, m):
    """bf16 B1 at the ranks the search gives llama3.2-1b (191: rows of w0
    382 B long, most off a 16-byte boundary, a last chunk of 7 values;
    384) and at 191's aligned neighbour: within KERNEL_TOL of the plain
    version, one counted launch, the same bits on a second call."""
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import ref
    args = _lowrank_args(cuda, "bf16", m,
                         *chip_smoke.SEARCH_LOWRANK_SHAPES[label])
    n0 = lk.launches
    y = lk.lowrank_matmul(*args)
    assert lk.launches == n0 + 1
    assert torch.equal(y, lk.lowrank_matmul(*args))
    assert _norm_err(y, ref.lowrank_matmul_ref(*args)) \
        <= chip_smoke.KERNEL_TOL["bfloat16"]


@pytest.mark.parametrize("cold", [True, False], ids=["cold", "warm"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_measured_timer_on_cuda(cuda, dtype, cold):
    """The measured timer of Algorithm 1 on the card: finite, positive
    seconds per rank (CUDA events), cached per rank; the dense time
    too; the cold timer's L2 flush leaves its input as it was."""
    from repro_torch.core import cost_model as cm
    dt = getattr(torch, dtype)
    timer = cm.make_measured_timer(8, 2048, 512, dtype=dt, cold=cold)
    for r in (191, 192, 128):
        t = timer(r)
        assert 0 < t < 1 and t == timer(r)
    assert timer.cache_info().misses == 3
    assert 0 < cm.measured_dense_time(8, 2048, 512, dtype=dt,
                                      cold=cold) < 1
    x = cm._randn((8, 2048), 0, dt, torch.device("cuda"))
    y = x.clone()
    cm._seconds(lambda: x @ x.T, torch.device("cuda"), 3, x, cold)
    assert torch.equal(x, y)


def _smoke_branched(dev):
    """The f32 smoke llama, decomposed (SVD pairs and branched linears),
    on ``dev``."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig, RunConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.models.api import get_model
    cfg = dataclasses.replace(registry.get("llama3.2-1b").smoke,
                              dtype="float32")
    params, axes = get_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    lrd = LRDConfig(enabled=True, rank_mode="aligned", rank_align=8,
                    min_dim=32, branches=2)
    with torch.no_grad():
        params, _, _ = decompose_model(params, axes, lrd)
    return RunConfig(model=cfg, lrd=lrd), params


def test_kernel_gate_raises_before_any_launch(cuda):
    """A fired kernel_gate on CUDA tensors raises KernelRejected with
    nothing launched and no plain version run; the engine's step raises
    it with every earlier dispatch launched and the gated one not."""
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.faults import FaultInjector
    plain = []
    orig = ref.lowrank_matmul_ref
    ref.lowrank_matmul_ref = lambda *a: plain.append(1) or orig(*a)
    try:
        x = _rnd(cuda, 8, 256, dtype=torch.bfloat16)
        w0 = _rnd(cuda, 256, 64, scale=1 / 16, dtype=torch.bfloat16)
        w1 = _rnd(cuda, 64, 128, scale=1 / 8, dtype=torch.bfloat16)
        n0 = lk.launches
        with ops.fault_gate(FaultInjector(rates={"kernel_gate": 1.0})):
            with pytest.raises(ops.KernelRejected):
                ops.lowrank_matmul(x, w0, w1)
        torch.cuda.synchronize()
        assert lk.launches == n0 and not plain
        ops.lowrank_matmul(x, w0, w1)
        assert lk.launches == n0 + 1 and not plain
    finally:
        ref.lowrank_matmul_ref = orig
    run, params = _smoke_branched("cuda")
    inj = FaultInjector(schedule={"kernel_gate": [5]})
    eng = ServeEngine(run, params, slots=2, max_seq=64, prefill_chunk=8,
                      faults=inj)
    eng.add_request(Request(uid=0, prompt=list(range(3, 20)),
                            max_new_tokens=4))
    before = {k: chip_smoke.launch_count(k) for k in chip_smoke.KERNELS}
    with pytest.raises(ops.KernelRejected):
        eng.step()
    torch.cuda.synchronize()
    after = {k: chip_smoke.launch_count(k) for k in chip_smoke.KERNELS}
    assert sum(after[k] - before[k] for k in after) == 4
    assert ops.set_fault_injector(None) is None


def test_two_replica_router_on_one_card_equals_one_engine(cuda):
    """Two replicas on cuda:0 share the param tensors, hold a pool each
    on the card, and give one engine's greedy streams; the failover of
    replica 0 moves its work to replica 1."""
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.router import ServeRouter
    run, params = _smoke_branched("cuda")
    prompts = [list(range(1 + i, 12 + 3 * i)) for i in range(6)]

    def reqs():
        return [Request(uid=i, prompt=p, max_new_tokens=6,
                        priority=("interactive", "batch")[i % 2])
                for i, p in enumerate(prompts)]
    kw = dict(slots=2, max_seq=64, prefill_chunk=8, kv_layout="paged",
              kv_block_size=16)
    eng = ServeEngine(run, params, **kw)
    one = reqs()
    for r in one:
        eng.add_request(r)
    eng.run_until_done()
    rt = ServeRouter(run, params, replicas=2, devices=["cuda", "cuda"],
                     slo_itl_ms=200.0, **kw)
    a, b = (rep.engine for rep in rt.replicas)
    leaf_a, leaf_b = (e.params["blocks"]["attn"]["k"]["w0"] for e in (a, b))
    assert leaf_a.data_ptr() == leaf_b.data_ptr() and leaf_a.is_cuda
    assert a.pool.cache["blocks"]["k"].is_cuda
    assert a.pool.cache["blocks"]["k"].data_ptr() != \
        b.pool.cache["blocks"]["k"].data_ptr()
    two = reqs()
    for r in two:
        rt.add_request(r)
    rt.step()
    a.step = lambda: (_ for _ in ()).throw(RuntimeError("device lost"))
    rt.run_until_done()
    assert rt.replicas[0].guard.tripped == "step_failures"
    assert [r.status for r in two] == ["finished"] * len(two)
    assert [r.output for r in two] == [r.output for r in one]


# ---------------------------------------------------------------------------
# the other configs' shapes: head dim 128 at GQA groups 1, 3 and 4; B2 at
# mistral-nemo's unembed; the MoE layer on the card
# ---------------------------------------------------------------------------

_WIDE_HEADS = [(16, 1, 128), (8, 3, 128), (8, 4, 128)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kh,g,d", _WIDE_HEADS,
                         ids=["moonshot-G1", "minitron-G3", "G4-D128"])
def test_decode_attention_q_at_wide_heads(cuda, kh, g, d, dtype):
    """B5 over the int8 slot pool at head dim 128 and groups 1, 3, 4 (a
    block of 32, 96 or 128 threads folding G rows), ragged positions and
    an idle slot."""
    from repro_torch.kernels import decode_attention_q as dak
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.kv import quantize_kv_prefill
    b, s = 8, 1024
    q = _rnd(cuda, b, 1, kh * g, d, dtype=getattr(torch, dtype))
    k_q, k_s = quantize_kv_prefill(_rnd(cuda, b, s, kh, d,
                                        dtype=torch.float32))
    v_q, v_s = quantize_kv_prefill(_rnd(cuda, b, s, kh, d,
                                        dtype=torch.float32))
    pos = torch.randint(s // 2, s, (b,), generator=cuda, device="cuda",
                        dtype=torch.int32)
    pos[-1] = -1
    n0 = dak.launches
    y = ops.decode_attention_q(q, k_q, k_s, v_q, v_s, pos)
    assert dak.launches == n0 + 1
    want = ref.decode_attention_q_ref(q, k_q, k_s, v_q, v_s, pos)
    assert torch.isfinite(y.float()).all()
    assert _norm_err(y, want) <= chip_smoke.KERNEL_TOL[dtype]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kh,g,d", _WIDE_HEADS,
                         ids=["moonshot-G1", "minitron-G3", "G4-D128"])
def test_paged_attention_at_wide_heads(cuda, kh, g, d, dtype, quant):
    """B8 / B9 at head dim 128 and groups 1, 3, 4 on the served paged
    pool (shuffled tables, ragged positions, an idle slot)."""
    from repro_torch.kernels import ops, ref
    case = dict(b=8, kh=kh, g=g, d=d, bs=16, nblk=64, nb=512, idle=1,
                softcap=0.0)
    name = "decode_attention_paged" + ("_q" if quant else "")
    q, pool, tables, pos = chip_smoke.paged_inputs(case, dtype, quant, cuda)
    y = getattr(ops, name)(q, *pool, tables, pos)
    want = getattr(ref, name + "_ref")(q, *pool, tables, pos)
    assert torch.isfinite(y.float()).all()
    assert _norm_err(y, want) <= chip_smoke.KERNEL_TOL[dtype]


@pytest.mark.parametrize("m", [8, 64])
def test_branched_kernel_at_nemo_unembed(cuda, m):
    """B2 at per-branch rank 608 and 131,072 output columns (bf16)."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import ref
    n, c, r, s = chip_smoke.WIDE_BRANCHED_SHAPES["nemo unembed"]
    dt = torch.bfloat16
    x = _rnd(cuda, m, c, dtype=dt)
    u = _rnd(cuda, n, c, r, scale=c ** -0.5, dtype=dt)
    xc = _rnd(cuda, n, r, r, scale=r ** -0.5, dtype=dt)
    v = _rnd(cuda, n, r, s, scale=r ** -0.5, dtype=dt)
    n0 = bk.launches
    y = bk.branched_matmul(x, u, xc, v)
    assert bk.launches == n0 + 1
    assert _norm_err(y, ref.branched_matmul_ref(x, u, xc, v)) \
        <= chip_smoke.KERNEL_TOL["bfloat16"]


@pytest.mark.parametrize("groups", [0, 4])
def test_apply_moe_on_the_card_matches_cpu(cuda, groups):
    """One MoE layer of moonshot's smoke widths, decomposed at branches=4
    (the shared experts through the chain kernel on the card), against
    the same layer in f32 on the CPU, on the global and the grouped
    dispatch: in f32 on the card the same routing and the output within
    the f32 kernel tolerance; in bf16, at a capacity no expert overflows,
    the tokens whose k experts are the CPU's within ``CHECK_TOL`` of the
    output's std (a near-tied router score may pick another expert in
    bf16), and at least 90 % of the tokens so."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.layers import moe
    from repro_torch.models.api import get_model
    from repro_torch.models.lm import layer_slice
    cfg = dataclasses.replace(registry.get("moonshot-v1-16b-a3b").smoke,
                              num_layers=1, dtype="float32")
    params, axes = get_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0))
    params, _, _ = decompose_model(params, axes, LRDConfig(
        enabled=True, rank_mode="aligned", rank_align=4, min_dim=16,
        branches=4))
    layer = layer_slice(params["blocks"]["moe"], 0)
    x = torch.randn(2, 32, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    topk, picks = moe._topk, []

    def recorded(gates, k):
        vals, idx = topk(gates, k)
        picks.append(idx.sort(-1).values.cpu())
        return vals, idx
    for dt, factor in ((torch.float32, cfg.moe_capacity_factor),
                       (torch.bfloat16, 8.0)):
        kw = dict(top_k=cfg.moe_top_k, capacity_factor=factor,
                  dispatch_groups=groups)
        picks.clear()
        moe._topk = recorded
        try:
            want, waux = moe.apply_moe(layer, x, **kw)
            n0 = bk.launches
            got, aux = moe.apply_moe(chip_smoke._tree_to(layer, "cuda", dt),
                                     x.to("cuda", dt), **kw)
        finally:
            moe._topk = topk
        assert bk.launches == n0 + 3        # the shared up, gate, down
        assert got.dtype == dt and torch.isfinite(got.float()).all()
        half = len(picks) // 2
        alike = torch.cat([(a == b).all(-1) for a, b in
                           zip(picks[:half], picks[half:])])
        got = got.float().cpu().reshape(-1, cfg.d_model)
        want = want.reshape(-1, cfg.d_model)
        if dt == torch.float32:
            assert bool(alike.all())
            assert _norm_err(got, want) <= chip_smoke.KERNEL_TOL["float32"]
            assert float(aux) == pytest.approx(float(waux), rel=1e-5)
        else:
            assert float(alike.float().mean()) >= 0.9
            rel = ((got[alike] - want[alike]).abs().max()
                   / want.std()).item()
            assert rel <= chip_smoke.CHECK_TOL


def _ssm_layer(dtype):
    """One mamba2 layer at its published widths, decomposed as the serve
    phases decompose it (in_proj / out_proj branched, N = 4), on the CPU
    in f32, and the same layer on the card in ``dtype``."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.models.api import get_model
    from repro_torch.models.lm import layer_slice
    cfg = dataclasses.replace(registry.get("mamba2-2.7b").full,
                              num_layers=1, dtype="float32")
    params, axes = get_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0))
    params, _, _ = decompose_model(params, axes,
                                   LRDConfig(**chip_smoke.LRD, branches=4))
    layer = layer_slice(params["blocks"], 0)
    return cfg, layer, chip_smoke._tree_to(layer, "cuda", dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_layer_and_decode_step_on_the_card(cuda, dtype):
    """A 300-token prefill (past the 256-token chunk, not a multiple of
    it) and 4 decode steps of one full-width mamba2 block on the card,
    in_proj and out_proj through the branched chain kernel, against the
    same block in f32 on the CPU: f32 outputs and states within the f32
    kernel tolerance; bf16 outputs within ``CHECK_TOL`` of the output's
    std, bf16 states within the bf16 kernel tolerance in relative L2
    (the recurrent state is heavy-tailed: its largest error is ~0.9 of
    its std on the CPU's own bf16 run, 0.9 % in L2)."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.layers import ssm
    from repro_torch.models import blocks as B
    dt = getattr(torch, dtype)
    cfg, cpu_layer, card_layer = _ssm_layer(dt)
    dims = ssm.dims_from_config(cfg)
    x = torch.randn(2, 304, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    tol = (chip_smoke.KERNEL_TOL["float32"] if dtype == "float32"
           else chip_smoke.CHECK_TOL)

    def err(got, want):
        got = got.float().cpu()
        if dtype == "float32":
            return _norm_err(got, want)
        return ((got - want).abs().max() / want.std()).item()
    st_cpu = ssm.init_ssm_state(2, dims, torch.float32, "cpu")
    st_gpu = ssm.init_ssm_state(2, dims, dt, "cuda")
    with torch.inference_mode():
        want, _ = B.apply_ssm_block(cpu_layer, x[:, :300], cfg, state=st_cpu)
        n0 = bk.launches
        got, _ = B.apply_ssm_block(card_layer, x[:, :300].to("cuda", dt),
                                   cfg, state=st_gpu)
        assert bk.launches == n0 + 2
        assert err(got, want) <= tol
        for t in range(300, 304):
            want, _ = B.apply_ssm_block(cpu_layer, x[:, t:t + 1], cfg,
                                        state=st_cpu, decode=True)
            got, _ = B.apply_ssm_block(card_layer, x[:, t:t + 1].to(
                "cuda", dt), cfg, state=st_gpu, decode=True)
            assert err(got, want) <= tol, t
    assert bk.launches == n0 + 10
    for k in st_cpu:
        assert st_gpu[k].dtype == dt
        got = st_gpu[k].float().cpu()
        if dtype == "float32":
            assert _norm_err(got, st_cpu[k]) <= tol, k
        else:
            rel = ((got - st_cpu[k]).norm() / st_cpu[k].norm()).item()
            assert rel <= chip_smoke.KERNEL_TOL["bfloat16"], (k, rel)


@pytest.mark.parametrize("m", chip_smoke.RESNET_FC_M)
@pytest.mark.parametrize("label", list(chip_smoke.RESNET_FC))
def test_resnet_fc_chain_kernels_match_plain(cuda, label, m):
    """B1 (f32 cluster kernel) and B3 (f32 activations, int8 factors) at
    the ResNet fc's shapes: an odd rank (335) and S = 1,000, neither a
    multiple of the 128-wide tile."""
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import lowrank_matmul_q as lqk
    from repro_torch.kernels import ref
    from repro_torch.quant.quantize import quantize_array
    c, r, s = chip_smoke.RESNET_FC[label]
    f32 = torch.float32
    x = _rnd(cuda, m, c, dtype=f32)
    w0 = _rnd(cuda, c, r, scale=c ** -0.5, dtype=f32)
    w1 = _rnd(cuda, r, s, scale=r ** -0.5, dtype=f32)
    n0 = lk.launches
    y = lk.lowrank_matmul(x, w0, w1)
    assert lk.launches == n0 + 1
    assert _norm_err(y, ref.lowrank_matmul_ref(x, w0, w1)) \
        <= chip_smoke.KERNEL_TOL["float32"]
    (w0q, w0s), (w1q, w1s) = quantize_array(w0), quantize_array(w1)
    n0 = lqk.launches
    y = lqk.lowrank_matmul_q(x, w0q, w0s, w1q, w1s)
    assert lqk.launches == n0 + 1
    assert _norm_err(y, ref.lowrank_matmul_q_ref(x, w0q, w0s, w1q, w1s)) \
        <= chip_smoke.KERNEL_TOL["float32"]


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kind", ["dense3", "dense7", "svd", "tucker",
                                  "branched2", "branched4", "tucker_int8"])
def test_apply_conv_on_the_card_matches_the_cpu(cuda, kind, stride):
    """Each conv kind on the card (cuDNN, TF32 off) against the same tree
    on the CPU, f32, within CHECK_TOL_F32 of the CPU output's std, on an
    even (56) side."""
    from repro_torch.layers.conv import apply_conv
    from repro_torch.quant.quantize import quantize_tree
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g) * shape[-2] ** -0.5
    c, s = 64, 96
    p = {"dense3": lambda: {"w": rnd(3, 3, c, s)},
         "dense7": lambda: {"w": rnd(7, 7, c, s)},
         "svd": lambda: {"w0": rnd(c, 24), "w1": rnd(24, s)},
         "tucker": lambda: {"tucker_u": rnd(c, 32), "core": rnd(3, 3, 32, 48),
                            "tucker_v": rnd(48, s)},
         "branched2": lambda: {"u": rnd(2, c, 16), "core": rnd(2, 3, 3, 16, 24),
                               "v": rnd(2, 24, s)},
         "branched4": lambda: {"u": rnd(4, c, 8), "core": rnd(4, 3, 3, 8, 12),
                               "v": rnd(4, 12, s)},
         "tucker_int8": lambda: quantize_tree(
             {"tucker_u": rnd(c, 32), "core": rnd(3, 3, 32, 48),
              "tucker_v": rnd(48, s)})}[kind]()
    x = torch.randn((4, 56, 56, c), generator=g)
    want = apply_conv(p, x, stride=stride)
    with torch.no_grad():
        got = apply_conv({k: v.cuda() for k, v in p.items()}, x.cuda(),
                         stride=stride)
    assert got.shape == want.shape
    assert ((got.cpu() - want).abs().max() / want.std()).item() \
        <= chip_smoke.CHECK_TOL_F32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", ["vlm G8 D128"])
def test_decode_attention_q_at_the_vlm_heads(cuda, case, dtype):
    """B5 at llama-3.2-vision's served pool (8 slots of 1,024, 8 KV heads
    of 128, 8 query heads each: G * D at the kernel's 1,024 limit)
    against its plain version."""
    from repro_torch.kernels import decode_attention_q as dak
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.kv import quantize_kv_prefill
    c = chip_smoke.WIDE_ATTN_CASES[case]
    b, s, kh, g, d = c["b"], c["s"], c["kh"], c["g"], c["d"]
    q = _rnd(cuda, b, 1, kh * g, d, dtype=getattr(torch, dtype))
    k_q, k_s = quantize_kv_prefill(_rnd(cuda, b, s, kh, d,
                                        dtype=torch.float32))
    v_q, v_s = quantize_kv_prefill(_rnd(cuda, b, s, kh, d,
                                        dtype=torch.float32))
    pos = torch.arange(b, device="cuda", dtype=torch.int32) * (s // b) + 7
    n0 = dak.launches
    y = ops.decode_attention_q(q, k_q, k_s, v_q, v_s, pos)
    assert dak.launches == n0 + 1
    want = ref.decode_attention_q_ref(q, k_q, k_s, v_q, v_s, pos)
    assert torch.isfinite(y.float()).all()
    assert _norm_err(y, want) <= chip_smoke.KERNEL_TOL[dtype]


#: B1 shapes (C, R, S) of the large-M cases: llama's train k/v, the
#: searched k/v rank 191 (w0's rows are not whole 16-byte granules), the
#: VLM's cross k / v and hubert's
_LARGE_LOWRANK = {**chip_smoke.LOWRANK_SHAPES,
                  **chip_smoke.SEARCH_LOWRANK_SHAPES,
                  **chip_smoke.VLM_LOWRANK_SHAPES,
                  **chip_smoke.HUBERT_LOWRANK_SHAPES}
#: B2 shapes (N, C, r, S): llama's train shapes, hubert's, the VLM's q,o
_LARGE_BRANCHED = {**chip_smoke.BRANCHED_SHAPES,
                   **chip_smoke.HUBERT_BRANCHED_SHAPES,
                   "vlm q,o": chip_smoke.VLM_BRANCHED_SHAPES["vlm q,o"]}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("label,m", [
    ("vlm k,v", chip_smoke.VLM_CROSS_M),
    ("hubert q,k,v,o", chip_smoke.HUBERT_M),
    ("hubert unembed", chip_smoke.HUBERT_M),
    ("k,v", 513), ("k,v", 1024), ("k,v r191", 1024), ("k,v r191", 513),
    ("hubert q,k,v,o", 1601), ("vlm k,v", 2000)])
def test_lowrank_kernels_at_large_m(cuda, label, m, dtype):
    """B1 at the VLM cross k / v's M = 1,601 image tokens, hubert's M =
    2,000 frames, the train step's 1,024 rows, a ragged 513 and the
    searched rank 191 (bf16: the large-M form, one counted launch, held
    to the plain version and to the split-phase form forced), and B3
    with int8 factors beside it, against their plain versions."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import lowrank_matmul_q as lqk
    from repro_torch.kernels import ref
    from repro_torch.quant.quantize import quantize_array
    c, r, s = _LARGE_LOWRANK[label]
    dt = getattr(torch, dtype)
    x = _rnd(cuda, m, c, dtype=dt)
    w0 = _rnd(cuda, c, r, scale=c ** -0.5, dtype=dt)
    w1 = _rnd(cuda, r, s, scale=r ** -0.5, dtype=dt)
    n0 = lk.launches
    y = lk.lowrank_matmul(x, w0, w1)
    assert lk.launches == n0 + 1
    tol = chip_smoke.KERNEL_TOL[dtype]
    assert _norm_err(y, ref.lowrank_matmul_ref(x, w0, w1)) <= tol
    if dtype == "bfloat16":
        assert bk.chain_form(dt, m) == "large_m"
        assert _norm_err(y, lk.split_lowrank_matmul(x, w0, w1)) <= tol
        assert torch.equal(y, lk.lowrank_matmul(x, w0, w1))
        assert lk.launches == n0 + 2
    (w0q, w0s), (w1q, w1s) = quantize_array(w0.float()), \
        quantize_array(w1.float())
    y = lqk.lowrank_matmul_q(x, w0q, w0s, w1q, w1s)
    assert _norm_err(y, ref.lowrank_matmul_q_ref(x, w0q, w0s, w1q, w1s)) \
        <= tol


@pytest.mark.parametrize("label", list(chip_smoke.HUBERT_BRANCHED_SHAPES))
def test_branched_kernel_at_hubert_m(cuda, label):
    """B2 (bf16) at hubert's M = 2,000 frames against its plain
    version."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import ref
    n, c, r, s = chip_smoke.HUBERT_BRANCHED_SHAPES[label]
    bf = torch.bfloat16
    x = _rnd(cuda, chip_smoke.HUBERT_M, c, dtype=bf)
    u = _rnd(cuda, n, c, r, scale=c ** -0.5, dtype=bf)
    xc = _rnd(cuda, n, r, r, scale=r ** -0.5, dtype=bf)
    v = _rnd(cuda, n, r, s, scale=r ** -0.5, dtype=bf)
    y = bk.branched_matmul(x, u, xc, v)
    assert _norm_err(y, ref.branched_matmul_ref(x, u, xc, v)) \
        <= chip_smoke.KERNEL_TOL["bfloat16"]


@pytest.mark.parametrize("m", [513, 1024, 1601, 2000])
@pytest.mark.parametrize("label", list(_LARGE_BRANCHED))
def test_branched_large_m_form_matches_plain_and_split(cuda, label, m):
    """bf16 B2 at M >= LARGE_M takes the large-M form: one counted
    launch, within KERNEL_TOL of the plain version and of the split-phase
    form forced on the same inputs, the same bits on a second call."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import ref
    n, c, r, s = _LARGE_BRANCHED[label]
    bf = torch.bfloat16
    x = _rnd(cuda, m, c, dtype=bf)
    u = _rnd(cuda, n, c, r, scale=c ** -0.5, dtype=bf)
    xc = _rnd(cuda, n, r, r, scale=r ** -0.5, dtype=bf)
    v = _rnd(cuda, n, r, s, scale=r ** -0.5, dtype=bf)
    assert bk.chain_form(bf, m) == "large_m"
    n0 = bk.launches
    y = bk.branched_matmul(x, u, xc, v)
    assert bk.launches == n0 + 1
    tol = chip_smoke.KERNEL_TOL["bfloat16"]
    assert _norm_err(y, ref.branched_matmul_ref(x, u, xc, v)) <= tol
    assert _norm_err(y, bk.split_branched_matmul(x, u, xc, v)) <= tol
    assert torch.equal(y, bk.large_m_branched_matmul(x, u, xc, v))
    assert bk.launches == n0 + 1


def test_large_m_form_refuses_before_launching(cuda):
    """The large-M entries refuse f32 activations and empty factors, and
    a large-M call refuses the split plan's knobs: each raises, and no
    kernel runs (the output buffer of a refused call is never made)."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import lowrank_matmul as lk
    m = bk.LARGE_M
    x32 = _rnd(cuda, m, 64, dtype=torch.float32)
    w0, w1 = (_rnd(cuda, 64, 16, dtype=torch.float32),
              _rnd(cuda, 16, 32, dtype=torch.float32))
    u, xc, v = (_rnd(cuda, 2, 64, 16, dtype=torch.float32),
                _rnd(cuda, 2, 16, 16, dtype=torch.float32),
                _rnd(cuda, 2, 16, 32, dtype=torch.float32))
    n0 = (lk.launches, bk.launches)
    torch.cuda.synchronize()
    with pytest.raises(TypeError):
        lk.large_m_lowrank_matmul(x32, w0, w1)
    with pytest.raises(TypeError):
        bk.large_m_branched_matmul(x32, u, xc, v)
    xb = x32.bfloat16()
    with pytest.raises(ValueError):
        lk.large_m_lowrank_matmul(xb, w0[:, :0].bfloat16().contiguous(),
                                  w1[:0].bfloat16().contiguous())
    with pytest.raises(ValueError):
        lk.lowrank_matmul_split(xb, w0.bfloat16(), w1.bfloat16(), items=8)
    torch.cuda.synchronize()
    assert (lk.launches, bk.launches) == n0


@pytest.mark.parametrize("kv_quantize", [None, "int8"])
def test_vlm_prefill_on_the_card_matches_the_cpu(cuda, kv_quantize):
    """A decomposed VLM (two super blocks at d_model 256, the cross gates
    at 0.5, random image embeddings) prefilled and decoded on the card
    in f32 through the chain kernels (B5 over an int8 pool) against the
    same tree on the CPU, within CHECK_TOL_F32 of the CPU logits' std;
    the image path moves the logits."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import decode_attention_q as dak
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.models.api import get_model
    cfg = dataclasses.replace(
        registry.get("llama-3.2-vision-90b").smoke, num_layers=10,
        d_model=256, num_heads=8, num_kv_heads=2, head_dim=32, d_ff=512,
        num_image_tokens=33, dtype="float32")
    cpu = get_model(cfg, "cpu")
    params, axes = cpu.init(torch.Generator().manual_seed(0))
    params["cross"]["cross_attn"]["gate"].fill_(0.5)
    params, _, _ = decompose_model(params, axes, LRDConfig(
        enabled=True, rank_mode="aligned", rank_align=16, min_dim=64,
        branches=2))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    img = torch.randn((2, 33, 256), generator=g) * 0.2

    def run(model, p, dev, image):
        cache = model.init_cache(2, 16, kv_quantize)
        plan = model.cache_plan(kv_quantize)
        lg, cache = model.prefill(p, {"tokens": toks[:, :10].to(dev),
                                      "image_embeds": image.to(dev)},
                                  cache, cache_plan=plan)
        out = [lg.cpu()]
        for t in (10, 11):
            lg, cache = model.decode_step(
                p, toks[:, t:t + 1].to(dev), torch.full((2,), t,
                                                        device=dev),
                cache, cache_plan=plan)
            out.append(lg.cpu())
        return torch.cat(out, 1)
    card = get_model(cfg, "cuda")
    cp = chip_smoke._tree_to(params, "cuda")
    with torch.inference_mode():
        want = run(cpu, params, "cpu", img)
        n0 = (lk.launches, bk.launches, dak.launches)
        got = run(card, cp, "cuda", img)
        n1 = (lk.launches, bk.launches, dak.launches)
        moved = run(card, chip_smoke.with_gate(cp, 0.0), "cuda", img)
    assert n1[0] > n0[0] and n1[1] > n0[1]
    assert (n1[2] > n0[2]) == (kv_quantize == "int8")
    real = want[..., :cfg.vocab_size]
    err = ((got[..., :cfg.vocab_size] - real).abs().max() / real.std())
    assert err.item() <= chip_smoke.CHECK_TOL_F32
    assert ((moved[..., :cfg.vocab_size] - real).abs().max()
            / real.std()).item() > 10 * chip_smoke.CHECK_TOL_F32


#: B3 rows of the quantized large-M form (bf16): the VLM's cross k / v
#: over the image tokens and at its largest prompt, llama's k,v at a
#: ragged M, the searched rank 191 (ragged rows)
_Q_LARGE_LOWRANK = [("vlm k,v", (8192, 384, 1024), 1601),
                    ("vlm k,v", (8192, 384, 1024), 512),
                    ("k,v", (2048, 128, 512), 513),
                    ("k,v r191", (2048, 191, 512), 256)]
#: B4 rows: zamba2's in_proj,up,gate and the VLM's q,o at a blocking
#: prefill's 512 rows, a ragged one
_Q_LARGE_BRANCHED = [("zamba2 in_proj,up,gate", (4, 2048, 192, 8192), 512),
                     ("vlm q,o", (4, 8192, 512, 8192), 512),
                     ("ragged", (2, 72, 20, 130), 300)]


def _dq_all(args):
    """The quantized call's factors dequantized as the plain version does
    (``ref._dq`` to x's dtype)."""
    from repro_torch.kernels import ref
    x, *rest = args
    return [ref._dq(q, sc, x.dtype) for q, sc in zip(rest[::2], rest[1::2])]


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
@pytest.mark.parametrize("label,shape,m", _Q_LARGE_LOWRANK
                         + _Q_LARGE_BRANCHED)
def test_quantized_chains_take_the_large_m_form(cuda, label, shape, m, mode):
    """bf16 B3 / B4 at M >= LARGE_M_Q run the large-M form on the factors
    the dequantizing pass writes: one counted call, within KERNEL_TOL of
    the plain version and of the split form forced, the same bits on a
    second call, and bit-equal to B1 / B2's large-M form on the factors
    dequantized beforehand."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import branched_matmul_q as bqk
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import lowrank_matmul_q as lqk
    from repro_torch.kernels import ref
    bf = torch.bfloat16
    x = _rnd(cuda, m, shape[-3 if len(shape) == 3 else 1], dtype=bf)
    if len(shape) == 3:
        c, r, s = shape
        args = (x, *_quantized(cuda, c, r, mode=mode),
                *_quantized(cuda, r, s, mode=mode))
        mod, fn, plain = lqk, lqk.lowrank_matmul_q, ref.lowrank_matmul_q_ref
        split, same = lqk.split_lowrank_matmul_q, lk.large_m_lowrank_matmul
    else:
        n, c, r, s = shape
        args = (x, *_quantized(cuda, n, c, r, mode=mode),
                *_quantized(cuda, n, r, r, mode=mode),
                *_quantized(cuda, n, r, s, mode=mode))
        mod, fn, plain = bqk, bqk.branched_matmul_q, \
            ref.branched_matmul_q_ref
        split, same = bqk.split_branched_matmul_q, \
            bk.large_m_branched_matmul
    assert bk.chain_form(bf, m, quantized=True) == "large_m"
    n0 = mod.launches
    y = fn(*args)
    assert mod.launches == n0 + 1
    tol = chip_smoke.KERNEL_TOL["bfloat16"]
    assert _norm_err(y, plain(*args)) <= tol
    assert _norm_err(y, split(*args)) <= tol
    assert torch.equal(y, fn(*args))
    assert torch.equal(y, same(x, *_dq_all(args)))
    assert mod.launches == n0 + 2


#: f32 B3 / B4 rows: llama's shapes at M = 8 / 64, the ResNets' fc rank
#: 335 (rows dequantized first) at M = 32 / 1, the VLM's gate,up at a
#: decode step, ragged ones
_Q_F32_LOWRANK = [("k,v", (2048, 128, 512), 8), ("k,v", (2048, 128, 512), 64),
                  ("fc r335", (2048, 335, 1000), 32),
                  ("fc r335", (2048, 335, 1000), 1),
                  ("ragged", (33, 5, 70), 3)]
_Q_F32_BRANCHED = [("gate,up", (4, 2048, 192, 8192), 8),
                   ("down", (4, 8192, 192, 2048), 64),
                   ("vlm gate,up", (4, 8192, 768, 28672), 8),
                   ("ragged", (3, 33, 5, 70), 9),
                   ("ragged v", (2, 72, 20, 130), 40)]


@pytest.mark.parametrize("mode", chip_smoke.QMODES)
@pytest.mark.parametrize("label,shape,m", _Q_F32_LOWRANK + _Q_F32_BRANCHED)
def test_quantized_chains_take_the_f32_form(cuda, label, shape, m, mode):
    """f32 B3 / B4 run the f32 form on the factors' int8 / e4m3 bytes (or
    their f32 dequantization, where rows are not whole words): one
    counted call, within 1e-4 of the plain version, the same bits on a
    second call, bit-equal to B1 / B2's f32 form on the factors
    dequantized beforehand, and within 1e-4 of the cluster kernel."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import branched_matmul_q as bqk
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import lowrank_matmul_q as lqk
    from repro_torch.kernels import ref
    f32 = torch.float32
    x = _rnd(cuda, m, shape[-3 if len(shape) == 3 else 1], dtype=f32)
    if len(shape) == 3:
        c, r, s = shape
        args = (x, *_quantized(cuda, c, r, mode=mode),
                *_quantized(cuda, r, s, mode=mode))
        mod, fn, plain = lqk, lqk.lowrank_matmul_q, ref.lowrank_matmul_q_ref
        old, same = lqk.cluster_lowrank_matmul_q, lk.lowrank_matmul
    else:
        n, c, r, s = shape
        args = (x, *_quantized(cuda, n, c, r, mode=mode),
                *_quantized(cuda, n, r, r, mode=mode),
                *_quantized(cuda, n, r, s, mode=mode))
        mod, fn, plain = bqk, bqk.branched_matmul_q, \
            ref.branched_matmul_q_ref
        old, same = bqk.cluster_branched_matmul_q, bk.branched_matmul
    assert bk.chain_form(f32, m) == "f32"
    n0 = mod.launches
    y = fn(*args)
    assert mod.launches == n0 + 1
    tol = chip_smoke.KERNEL_TOL["float32"]
    assert _norm_err(y, plain(*args)) <= tol
    assert torch.equal(y, fn(*args))
    assert torch.equal(y, same(x, *_dq_all(args)))
    assert _norm_err(y, old(*args)) <= tol


def test_quantized_forced_forms_refuse_before_launching(cuda):
    """The forced B3 / B4 entries refuse f32 activations and empty
    factors, and a large-M or f32 B3 call refuses the split plan's knobs:
    each raises, and no kernel runs."""
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import branched_matmul_q as bqk
    from repro_torch.kernels import lowrank_matmul_q as lqk
    m = bk.LARGE_M_Q
    x32 = _rnd(cuda, m, 64, dtype=torch.float32)
    lr = (*_quantized(cuda, 64, 16, mode="int8"),
          *_quantized(cuda, 16, 32, mode="int8"))
    br = (*_quantized(cuda, 2, 64, 16, mode="int8"),
          *_quantized(cuda, 2, 16, 16, mode="int8"),
          *_quantized(cuda, 2, 16, 32, mode="int8"))
    n0 = (lqk.launches, bqk.launches)
    torch.cuda.synchronize()
    for fn, args in ((lqk.split_lowrank_matmul_q, lr),
                     (lqk.large_m_lowrank_matmul_q, lr),
                     (bqk.split_branched_matmul_q, br),
                     (bqk.large_m_branched_matmul_q, br)):
        with pytest.raises(TypeError):
            fn(x32, *args)
    xb = x32.bfloat16()
    empty = (lr[0][:, :0].contiguous(), lr[1][:, :0].contiguous(),
             lr[2][:0].contiguous(), lr[3])
    with pytest.raises(ValueError):
        lqk.large_m_lowrank_matmul_q(xb, *empty)
    with pytest.raises(ValueError):
        lqk.lowrank_matmul_q(x32, *empty)
    for x in (xb, x32):
        with pytest.raises(ValueError):
            lqk.lowrank_matmul_q_split(x, *lr, items=8)
    torch.cuda.synchronize()
    assert (lqk.launches, bqk.launches) == n0
