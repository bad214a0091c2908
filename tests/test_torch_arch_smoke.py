"""The port's per-architecture smoke tests (the twin of
``tests/test_arch_smoke.py``, on the CPU): the reduced config of each
family runs a forward and train steps (finite losses, a loss that
falls), survives LRD surgery (a smaller tree that still runs), and its
prefill / decode equal the forward; the registry holds the 10 assigned
archs, the 40 shape cells skip as assigned, and the ResNet counts match
the paper's Table 1."""
import dataclasses

import pytest
import torch

from _torch_parity import torch_threads
from repro_torch.configs import registry
from repro_torch.configs.base import (SHAPES, LRDConfig, RunConfig,
                                      ShapeConfig, applicable_shapes,
                                      skip_reason)
from repro_torch.core import freezing
from repro_torch.core.surgery import decompose_model
from repro_torch.models.api import get_model, synth_inputs
from repro_torch.train import steps as steps_mod
from repro_torch.train.optim import OptimConfig

SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")
ASSIGNED = registry.assigned_names()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _init(cfg, seed: int = 0):
    return get_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))


def _batch(cfg, seed: int = 1):
    return synth_inputs(cfg, SMOKE_SHAPE, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", ASSIGNED + ["resnet50"])
def test_forward_loss_no_nan(arch):
    cfg = registry.get(arch).smoke
    m = get_model(cfg, "cpu")
    params, _ = _init(cfg)
    with torch.no_grad():
        loss, _ = m.loss(params, _batch(cfg))
    assert loss.shape == ()
    assert torch.isfinite(loss)
    assert float(loss) > 0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_improves_loss(arch):
    entry = registry.get(arch)
    cfg = entry.smoke
    run = RunConfig(model=cfg,
                    parallel=dataclasses.replace(entry.parallel("train"),
                                                 seq_shard=False,
                                                 fsdp=False, remat="none"))
    m = get_model(cfg, "cpu")
    params, _ = _init(cfg)
    freezing.set_requires_grad(params, freeze=False)
    opt_cfg = OptimConfig(peak_lr=3e-3, warmup_steps=1, total_steps=6)
    opt = steps_mod.init_opt_state(m, run, params, opt_cfg)
    step = steps_mod.make_train_step(m, run, opt_cfg)
    batch = _batch(cfg)
    losses = []
    for _ in range(4):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        assert torch.isfinite(metrics["loss"])
    assert losses[-1] < losses[0]     # memorizes the repeated batch


@pytest.mark.parametrize("arch", ASSIGNED)
def test_lrd_surgery_runs_and_shrinks(arch):
    """The paper's technique applies to every assigned arch and the
    decomposed model still runs."""
    cfg = registry.get(arch).smoke
    params, axes = _init(cfg)
    lrd = LRDConfig(enabled=True, compression=2.0, rank_mode="ratio",
                    min_dim=32)
    with torch.no_grad():
        p2, _, report = decompose_model(params, axes, lrd)
        assert report.params_after <= report.params_before
        assert len(report.decomposed) > 0, "no layer decomposed"
        loss, _ = get_model(cfg, "cpu").loss(p2, _batch(cfg))
    assert torch.isfinite(loss)


@pytest.mark.parametrize("arch", [a for a in ASSIGNED
                                  if registry.get(a).smoke.has_decode])
def test_prefill_decode_matches_forward(arch):
    cfg = registry.get(arch).smoke
    if cfg.moe_num_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    m = get_model(cfg, "cpu")
    params, _ = _init(cfg)
    b, s = 2, 32
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 3), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :s]}
    if cfg.family == "vlm":
        batch["image_embeds"] = (torch.randn(
            (b, cfg.num_image_tokens, cfg.d_model),
            generator=torch.Generator().manual_seed(4)) * 0.2).to(m.dtype)
    with torch.no_grad():
        full, _ = m.forward(params, dict(batch, tokens=toks))
        logits_full = m.logits(params, full).float()
        cache = m.init_cache(b, s + 3)
        lg, cache = m.prefill(params, batch, cache)
        errs = [float((lg[:, 0].float() - logits_full[:, s - 1]).abs()
                      .max())]
        for t in range(s, s + 2):
            lg, cache = m.decode_step(params, toks[:, t:t + 1],
                                      torch.full((b,), t, dtype=torch.int32),
                                      cache)
            errs.append(float((lg[:, 0].float() - logits_full[:, t]).abs()
                              .max()))
    scale = float(logits_full.abs().max()) + 1e-6
    assert max(errs) / scale < 0.05, errs


def test_registry_complete():
    assert len(ASSIGNED) == 10
    for arch in ASSIGNED:
        e = registry.get(arch)
        assert e.full.name and e.smoke.num_layers <= 8


def test_shape_cells_spec():
    """40 assigned cells: skips recorded exactly per the assignment."""
    total = live = 0
    for arch in ASSIGNED:
        cfg = registry.get(arch).full
        for shape in SHAPES.values():
            total += 1
            if skip_reason(cfg, shape) is None:
                live += 1
                assert shape in applicable_shapes(cfg)
    assert total == 40
    # encoder: -2 (no decode); 7 full-attention archs: -1 (long_500k)
    assert live == 40 - 2 - 7


@pytest.mark.parametrize("arch", ["resnet50", "resnet101", "resnet152"])
def test_resnet_param_counts_match_paper_table1(arch):
    """Paper Table 1: 25.56M / 44.55M / 60.19M."""
    cfg = registry.get(arch).full
    want = {"resnet50": 25.56e6, "resnet101": 44.55e6,
            "resnet152": 60.19e6}[arch]
    assert abs(cfg.param_count() - want) / want < 0.005
