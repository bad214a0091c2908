"""The port's step counter against the reference's ``analyze_hlo`` on
the dry run's kinds of step (``tests/test_torch_dryrun_cells.py`` runs
the dry run's cells themselves).

FLOP parity: the reference lowers each step under ``jax.jit`` on
``jax.eval_shape`` trees; the port counts the same step under
``FakeTensorMode`` with ``StepCounter``.  Two families differ by an
exact amount, ROADMAP C: the decomposed tree's value-and-grad (the
port's explicit backward recomputes the chains' rank intermediates,
which XLA keeps), mamba2 (the SSD scan's einsums, and XLA's folding of
products against the zero initial state) and the smoke ResNet (XLA
drops conv taps that read only padding)."""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.analysis.roofline import analyze_hlo
from repro.configs import registry as jreg
from repro.configs.base import LRDConfig as JLRD
from repro.core.surgery import decompose_model as jdecompose
from repro.models.api import get_model as jget_model
from repro_torch.analysis.roofline import StepCounter
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.core import freezing
from repro_torch.core.surgery import decompose_model as tdecompose
from repro_torch.models.api import get_model as tget_model
from repro_torch.train.steps import value_and_grad
from repro_torch.tree import paths

B, S = 2, 32
BRANCHED = dict(enabled=True, rank_mode="ratio", rank_align=8, branches=2,
                min_dim=32)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_flops(fn, *sds) -> float:
    return analyze_hlo(jax.jit(fn).lower(*sds).compile().as_text(), 1).flops


def reference_flops(arch: str, lrd: dict | None, smoke: bool = True
                    ) -> dict[str, float]:
    """The reference's HLO FLOPs of forward + logits, value-and-grad of
    the loss and one slot-pool decode step (f32) at B x S."""
    entry = jreg.get(arch)
    cfg = dataclasses.replace(entry.smoke if smoke else entry.full,
                              dtype="float32")
    model = jget_model(cfg)

    def init(key):
        p, a = model.init(key)
        if lrd:
            p, a, _ = jdecompose(p, a, JLRD(**lrd))
        return p
    p = jax.eval_shape(init, jax.random.PRNGKey(0))
    if cfg.family == "resnet":
        x = jax.ShapeDtypeStruct((B, cfg.img_size, cfg.img_size, 3),
                                 jnp.float32)
        return {"forward": _jax_flops(model.forward, p, x)}
    toks = jax.ShapeDtypeStruct((B, S), jnp.int32)
    out = {
        "forward": _jax_flops(
            lambda q, t: model.logits(q, model.forward(q, {"tokens": t})[0]),
            p, toks),
        "grad": _jax_flops(
            lambda q, t: jax.value_and_grad(
                lambda r: model.loss(r, {"tokens": t})[0])(q), p, toks)}
    out["decode"] = _jax_flops(
        model.decode_step, p, jax.ShapeDtypeStruct((B, 1), jnp.int32),
        jax.ShapeDtypeStruct((B,), jnp.int32), model.cache_spec(B, S))
    return out


def port_flops(arch: str, lrd: dict | None, smoke: bool = True
               ) -> tuple[dict[str, float], dict]:
    """The port's counted FLOPs of the same three steps (fake CPU
    tensors), and its tree's leaf shapes."""
    entry = treg.get(arch)
    cfg = dataclasses.replace(entry.smoke if smoke else entry.full,
                              dtype="float32")
    out = {}
    with FakeTensorMode():
        model = tget_model(cfg, "cpu")
        with torch.no_grad():
            p, a = model.init(torch.Generator().manual_seed(0))
            if lrd:
                p, a, _ = tdecompose(p, a, TLRD(**lrd))
        shapes = {k: tuple(t.shape) for k, t in paths(p)}
        if cfg.family == "resnet":
            x = torch.zeros(B, cfg.img_size, cfg.img_size, 3)
            with torch.no_grad(), StepCounter() as c:
                model.forward(p, x)
            return {"forward": c.costs.flops}, shapes
        toks = torch.zeros(B, S, dtype=torch.int32)
        with torch.no_grad(), StepCounter() as c:
            model.logits(p, model.forward(p, {"tokens": toks})[0])
        out["forward"] = c.costs.flops
        freezing.set_requires_grad(p, freeze=False)
        with StepCounter() as c:
            value_and_grad(lambda q, b: model.loss(q, b), p,
                           {"tokens": toks})
        out["grad"] = c.costs.flops
        freezing.set_requires_grad(p, freeze=True)
        with torch.no_grad(), StepCounter() as c:
            model.decode_step(p, torch.zeros(B, 1, dtype=torch.int32),
                              torch.zeros(B, dtype=torch.int32),
                              model.init_cache(B, S))
        out["decode"] = c.costs.flops
    return out, shapes


def chain_recompute_flops(shapes: dict, m: int) -> int:
    """The FLOPs the port's explicit chain backward spends recomputing
    the rank intermediates that XLA keeps from the forward: x @ w0 of a
    low-rank pair, x @ u and (x @ u) @ xc of a branched linear, at ``m``
    rows, every layer of a stack."""
    total = 0
    for key, shape in shapes.items():
        if key[-1] == "w0":
            *lead, c, r = shape
            total += 2 * m * c * r * (lead[0] if lead else 1)
        elif key[-1] == "u":
            n, c, r1 = shape[-3:]
            r2 = shapes[key[:-1] + ("xc",)][-1]
            layers = shape[0] if len(shape) == 4 else 1
            total += 2 * m * n * (c * r1 + r1 * r2) * layers
    return total


@pytest.mark.parametrize("arch,tree", [
    ("llama3.2-1b", "dense"), ("llama3.2-1b", "branched"),
    ("moonshot-v1-16b-a3b", "dense")])
def test_counted_flops_equal_the_reference(arch, tree):
    lrd = BRANCHED if tree == "branched" else None
    want = reference_flops(arch, lrd)
    got, shapes = port_flops(arch, lrd)
    assert got["forward"] == want["forward"]
    assert got["decode"] == want["decode"]
    assert got["grad"] - want["grad"] == chain_recompute_flops(shapes, B * S)
    if tree == "branched":
        assert chain_recompute_flops(shapes, B * S) > 0


def test_mamba2_differs_by_the_scans_products():
    cfg = treg.get("mamba2-2.7b").smoke
    want = reference_flops("mamba2-2.7b", None)
    got, _ = port_flops("mamba2-2.7b", None)
    d_inner, nh = cfg.d_inner, cfg.resolved_ssm_heads
    n, q, layers = cfg.ssm_state, min(cfg.ssm_chunk, S), cfg.num_layers
    assert S <= cfg.ssm_chunk           # one chunk: its state starts at 0
    inter = 2 * B * q * d_inner * n     # C_i . (the state before)
    scale = 2 * B * q * nh * n          # one of the einsums' scale products
    assert got["decode"] == want["decode"]
    assert got["forward"] - want["forward"] == layers * inter
    assert got["grad"] - want["grad"] == -layers * (inter + 4 * scale)


@pytest.mark.parametrize("smoke", [False, True])
def test_resnet50_forward_against_the_reference(smoke):
    want = reference_flops("resnet50", None, smoke=smoke)
    got, _ = port_flops("resnet50", None, smoke=smoke)
    if not smoke:
        assert got["forward"] == want["forward"]
        return
    # 32 x 32 images: the last stage's strided 3 x 3 conv maps 2 x 2 onto
    # 1 x 1, and XLA drops the 5 of its 9 taps that read only padding
    cfg = treg.get("resnet50").smoke
    mid = cfg.resnet_width * 8
    assert cfg.img_size // 32 == 1
    assert got["forward"] - want["forward"] == 5 * 2 * B * mid * mid
