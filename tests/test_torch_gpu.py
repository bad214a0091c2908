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


def test_serve_path_launches_kernels_and_matches_cpu(cuda):
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig, RunConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import Request, ServeEngine
    import dataclasses
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
                          slots=2, max_seq=64, prefill_chunk=8, device=dev)
        lk.launches = bk.launches = 0
        reqs = [Request(uid=i, prompt=list(range(3 + 5 * i, 14 + 7 * i)),
                        max_new_tokens=4) for i in range(3)]
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done()
        outs[dev] = [r.output for r in reqs]
        if dev == "cuda":
            assert lk.launches > 0 and bk.launches > 0
        else:
            assert lk.launches == 0 and bk.launches == 0
    # f32 kernels vs f32 plain versions differ by summation order only
    assert outs["cuda"] == outs["cpu"]
