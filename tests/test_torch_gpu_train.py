"""Card-only checks of the training path (marker ``gpu``; each test skips
itself when no CUDA card is present).  Run them on the card with

    python3 -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_gpu_train.py

The B1 / B2 autograd Functions (kernel forward, explicit backward)
against autograd of the plain versions at the training M, and train
steps of a decomposed, frozen smoke model on the card through the
Functions, held to the same steps on the CPU (the dense llama; the MoE
and SSM families' smoke trees).
"""
import dataclasses
import math
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
@pytest.mark.parametrize("label", ["k,v", *chip_smoke.BRANCHED_SHAPES])
def test_function_grads_match_autograd_of_plain(cuda, label, dtype):
    from repro_torch.kernels import autograd as kgrad
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import ref
    dt = getattr(torch, dtype)
    m = chip_smoke.TRAIN_M
    if label == "k,v":
        c, r, s = chip_smoke.LOWRANK_SHAPES[label]
        args = (_rnd(cuda, m, c, dtype=dt),
                _rnd(cuda, c, r, scale=c ** -0.5, dtype=dt),
                _rnd(cuda, r, s, scale=r ** -0.5, dtype=dt))
        fn, plain, mod = kgrad.LowrankMatmul, ref.lowrank_matmul_ref, lk
    else:
        n, c, r, s = chip_smoke.BRANCHED_SHAPES[label]
        args = (_rnd(cuda, m, c, dtype=dt),
                _rnd(cuda, n, c, r, scale=c ** -0.5, dtype=dt),
                _rnd(cuda, n, r, r, scale=r ** -0.5, dtype=dt),
                _rnd(cuda, n, r, s, scale=r ** -0.5, dtype=dt))
        fn, plain, mod = kgrad.BranchedMatmul, ref.branched_matmul_ref, bk
    # bf16 at the training M runs the large-M form, f32 the f32 form
    assert bk.chain_form(dt, m) == ("large_m" if dtype == "bfloat16"
                                    else "f32")
    g = _rnd(cuda, m, s, dtype=dt)
    ins = [a.clone().requires_grad_(True) for a in args]
    n0 = mod.launches
    y = fn.apply(*ins)
    assert mod.launches == n0 + 1
    got = torch.autograd.grad(y, ins, g)
    assert mod.launches == n0 + 1          # the backward launches nothing
    pins = [a.clone().requires_grad_(True) for a in args]
    want_y = plain(*pins)
    want = torch.autograd.grad(want_y, pins, g)
    tol = chip_smoke.KERNEL_TOL[dtype]
    assert _norm_err(y, want_y) <= tol
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _norm_err(a, b) <= tol


def _smoke_run(freeze: bool, dtype: str):
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig, ParallelConfig, RunConfig
    cfg = dataclasses.replace(registry.get("llama3.2-1b").smoke, dtype=dtype)
    lrd = LRDConfig(enabled=True, rank_mode="aligned", rank_align=8,
                    min_dim=32, branches=2, freeze=freeze)
    return RunConfig(model=cfg, lrd=lrd, parallel=ParallelConfig())


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_steps_go_through_the_functions_and_match_cpu(cuda, remat):
    """Three f32 steps of a frozen, decomposed smoke model on the card
    launch 2 B1 + 5 B2 forwards per layer a step (twice under remat
    "full") and give the CPU's losses and parameters (f32 kernels and
    plain versions differ by summation order only)."""
    from repro_torch.core import freezing
    from repro_torch.core.surgery import decompose_model
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.models.api import get_model
    from repro_torch.train import steps
    from repro_torch.train.data import ByteTextLM
    from repro_torch.train.optim import OptimConfig
    run = _smoke_run(True, "float32")
    run = run.replace(parallel=dataclasses.replace(run.parallel,
                                                   remat=remat))
    with torch.no_grad():
        base, axes = get_model(run.model, "cpu").init(
            torch.Generator().manual_seed(0))
        base, _, _ = decompose_model(base, axes, run.lrd)

    def move(t, dev):
        return ({k: move(v, dev) for k, v in t.items()}
                if isinstance(t, dict) else t.detach().to(dev).clone())
    data = ByteTextLM(run.model, batch=2, seq_len=32)
    ocfg = OptimConfig(peak_lr=1e-2, warmup_steps=1, total_steps=3)
    out = {}
    for dev in ("cpu", "cuda"):
        model = get_model(run.model, dev)
        params = freezing.set_requires_grad(move(base, dev), freeze=True)
        state = steps.init_opt_state(model, run, params, ocfg)
        step = steps.make_train_step(model, run, ocfg)
        lk.launches = bk.launches = 0
        losses = []
        for i in range(3):
            batch = {"tokens": torch.as_tensor(data.batch(i)["tokens"],
                                               device=dev)}
            params, state, met = step(params, state, batch)
            losses.append(float(met["loss"]))
        out[dev] = (losses, params, (lk.launches, bk.launches))
    L = run.model.num_layers
    mult = 2 if remat == "full" else 1
    assert out["cuda"][2] == (3 * mult * 2 * L, 3 * mult * 5 * L)
    assert out["cpu"][2] == (0, 0)
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert a == pytest.approx(b, rel=1e-4)

    def leaves(t):
        return ([x for v in t.values() for x in leaves(v)]
                if isinstance(t, dict) else [t])
    for a, b in zip(leaves(out["cuda"][1]), leaves(out["cpu"][1])):
        assert _norm_err(a.cpu(), b) <= 1e-3


def test_train_loop_runs_on_the_card_by_default(cuda):
    from repro_torch.train.data import ByteTextLM
    from repro_torch.train.loop import train
    from repro_torch.train.optim import OptimConfig
    run = _smoke_run(True, "bfloat16")
    r = train(run, ByteTextLM(run.model, batch=4, seq_len=64), num_steps=12,
              optim_cfg=OptimConfig(peak_lr=3e-3, warmup_steps=2,
                                    total_steps=12), log_every=0,
              log_fn=lambda s: None)
    assert r.metrics["loss"].device.type == "cuda"
    assert r.losses[-1] < r.losses[0]


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mamba2-2.7b"])
def test_moe_and_ssm_train_steps_on_the_card_match_cpu(cuda, arch):
    """Two f32 steps of a frozen, branched smoke tree of the MoE and the
    SSM family on the card (B1 / B2 forwards through the Functions, the
    expert products and the SSD scan plain torch) give the CPU's losses
    and parameters, launching exactly :func:`chip_smoke.train_launches`
    a step."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig, ParallelConfig, RunConfig
    from repro_torch.core import freezing
    from repro_torch.core.surgery import decompose_model
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.models.api import get_model
    from repro_torch.train import steps
    from repro_torch.train.data import ByteTextLM
    from repro_torch.train.optim import OptimConfig
    cfg = dataclasses.replace(registry.get(arch).smoke, dtype="float32")
    run = RunConfig(model=cfg, parallel=ParallelConfig(), lrd=LRDConfig(
        enabled=True, rank_mode="aligned", rank_align=4, min_dim=16,
        branches=4, freeze=True))
    with torch.no_grad():
        base, axes = get_model(cfg, "cpu").init(
            torch.Generator().manual_seed(0))
        base, _, rep = decompose_model(base, axes, run.lrd)
    seq = 64
    want = chip_smoke.train_launches(get_model(cfg, "cpu"), rep, seq)
    assert want.get("branched_matmul", 0) > 0

    def move(t, dev):
        return ({k: move(v, dev) for k, v in t.items()}
                if isinstance(t, dict) else t.detach().to(dev).clone())
    data = ByteTextLM(cfg, batch=2, seq_len=seq)
    ocfg = OptimConfig(peak_lr=1e-2, warmup_steps=1, total_steps=2)
    out = {}
    for dev in ("cpu", "cuda"):
        model = get_model(cfg, dev)
        params = freezing.set_requires_grad(move(base, dev), freeze=True)
        state = steps.init_opt_state(model, run, params, ocfg)
        step = steps.make_train_step(model, run, ocfg)
        losses, counts = [], []
        for i in range(2):
            lk.launches = bk.launches = 0
            batch = {"tokens": torch.as_tensor(data.batch(i)["tokens"],
                                               device=dev)}
            params, state, met = step(params, state, batch)
            losses.append(float(met["loss"]))
            counts.append({k: n for k, n in (
                ("lowrank_matmul", lk.launches),
                ("branched_matmul", bk.launches)) if n})
        out[dev] = (losses, params, counts)
    assert out["cuda"][2] == [want, want]
    assert out["cpu"][2] == [{}, {}]
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert math.isfinite(a) and a == pytest.approx(b, rel=1e-4)

    def leaves(t):
        return ([x for v in t.values() for x in leaves(v)]
                if isinstance(t, dict) else [t])
    for a, b in zip(leaves(out["cuda"][1]), leaves(out["cpu"][1])):
        assert _norm_err(a.cpu(), b) <= 1e-3
