"""The encoder family (hubert-xlarge) against the reference on the CPU, at
its smoke widths: the config field for field, forward logits over frame
embeddings (layer norms, bidirectional attention, the gelu MLP, the
vocabulary of 64 padded to 128) on the dense, SVD and SVD+branched trees,
``frontend_proj`` (``frontend_dim`` other than ``d_model``), the loss
against ``batch["labels"]`` and every gradient against
``jax.value_and_grad``; bidirectionality; the inputs of ``synth_inputs``
and ``SyntheticLM``; ``make_forward_step``, the encoder's entry point;
and the refusals where the reference refuses (no cache, no decode step,
no serve engine).

One tree built by the port is bridged into the reference.  Tolerance
(f32): logits within 1e-4 of the largest reference logit, the loss within
1e-5 relative, a gradient leaf within 1e-4 of its largest element."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (TREE_LRD, copy_tree, flat, smoke_cfg, to_jax,
                           torch_threads)
from repro.configs import registry as jreg
from repro.configs.base import LRDConfig as JLRD
from repro.core.surgery import decompose_model as jdecompose
from repro.models.api import get_model as jget_model
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LRDConfig, RunConfig, ShapeConfig
from repro_torch.core import freezing
from repro_torch.core.surgery import decompose_model
from repro_torch.models.api import get_model, synth_inputs
from repro_torch.models.blocks import BlockOpts
from repro_torch.train.steps import make_forward_step, value_and_grad

HUBERT = "hubert-xlarge"
TREES = ["dense", "svd", "branched"]
TOL = 1e-4
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), \
        err / max(np.abs(want).max(), 1e-30)


def cfg(side: str, **kw):
    return smoke_cfg(HUBERT, side, **kw)


@functools.lru_cache(maxsize=None)
def enc_tree(tree: str, frontend_dim: int = 64):
    """(params, axes) of a smoke encoder tree built by the port (CPU,
    seed 0), decomposed with :data:`TREE_LRD`."""
    params, axes = get_model(cfg("torch", frontend_dim=frontend_dim),
                             "cpu").init(torch.Generator().manual_seed(0))
    if TREE_LRD[tree] is not None:
        params, axes, _ = decompose_model(params, axes,
                                          LRDConfig(**TREE_LRD[tree]))
    return params, axes


def _inputs(b=2, s=24, dim=64, seed=0):
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((b, s, dim)) * 0.2).astype(np.float32)
    labels = rng.integers(0, cfg("torch").vocab_size, (b, s)).astype(
        np.int32)
    return ({"frames": jnp.asarray(frames), "labels": jnp.asarray(labels)},
            {"frames": torch.from_numpy(frames),
             "labels": torch.from_numpy(labels)})


def test_config_mirrors_reference():
    for which in ("full", "smoke"):
        j = getattr(jreg.get(HUBERT), which)
        t = getattr(treg.get(HUBERT), which)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (which, f.name)
        for prop in ("resolved_head_dim", "has_decode", "subquadratic"):
            assert getattr(t, prop) == getattr(j, prop), (which, prop)
    full = treg.get(HUBERT).full
    assert (full.num_layers, full.d_model, full.num_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size, full.act,
            full.has_decode) == (48, 1280, 16, 80, 5120, 504, "gelu", False)
    assert get_model(full, "cpu").padded_vocab == 512


@pytest.mark.parametrize("tree", TREES)
def test_forward_logits_match_reference(tree):
    params = enc_tree(tree)[0]
    jb, tb = _inputs()
    jm = jget_model(cfg("jax"))
    jp = to_jax(params)
    want = jm.logits(jp, jm.forward(jp, jb)[0])
    tm = get_model(cfg("torch"), "cpu")
    assert "embed" not in params and "frontend_proj" not in params
    with torch.no_grad():
        tx, aux = tm.forward(params, tb)
        got = tm.logits(params, tx)
    assert float(aux) == 0.0
    assert np.all(np.asarray(want)[..., 64:] == -1e30)
    _close(got, want)


def test_frontend_proj_matches_reference():
    """``frontend_dim`` 96 != ``d_model`` 64: the frames go through
    ``frontend_proj`` (skipped by surgery on both sides: no target
    label)."""
    params, axes = enc_tree("dense", 96)
    assert tuple(params["frontend_proj"]["w"].shape) == (96, 64)
    jb, tb = _inputs(dim=96, seed=1)
    jm = jget_model(cfg("jax", frontend_dim=96))
    jp = to_jax(params)
    want = jm.logits(jp, jm.forward(jp, jb)[0])
    tm = get_model(cfg("torch", frontend_dim=96), "cpu")
    with torch.no_grad():
        _close(tm.logits(params, tm.forward(params, tb)[0]), want)
    lrd = TREE_LRD["branched"]
    _, _, trep = decompose_model(params, axes, LRDConfig(**lrd))
    _, _, jrep = jdecompose(jp, axes, JLRD(**lrd))
    got = sorted((d.path, d.label, d.kind, d.rank, tuple(d.shape))
                 for d in trep.decisions)
    assert got == sorted((d.path, d.label, d.kind, d.rank, tuple(d.shape))
                         for d in jrep.decisions)
    assert {d.path: d.kind for d in trep.decisions}["frontend_proj"] == \
        "skip"


@pytest.mark.parametrize("tree,freeze", [("dense", False),
                                         ("branched", True)])
def test_loss_and_grads_match_reference(tree, freeze):
    """The cross-entropy against ``labels`` at every position (no shift,
    no masked position) and every gradient, layer norms' biases
    included."""
    from repro.models.blocks import BlockOpts as JBlockOpts
    jb, tb = _inputs(seed=2)
    tp = copy_tree(enc_tree(tree)[0])
    jp = to_jax(tp)
    jm = jget_model(cfg("jax"))
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jm.loss(p, jb, opts=JBlockOpts(freeze_factors=freeze)),
        has_aux=True)(jp)
    tm = get_model(cfg("torch"), "cpu")
    tl, taux, tg = value_and_grad(
        lambda p, b: tm.loss(p, b, opts=BlockOpts(freeze)),
        freezing.set_requires_grad(tp, freeze=freeze), tb)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_TOL)
    assert float(taux["tokens"]) == float(jaux["tokens"]) == 48.0
    jg, tg = flat(jax.tree.map(np.asarray, jg)), flat(tg)
    assert set(jg) == set(tg)
    assert bool([k for k, g in tg.items() if g is None]) == freeze
    for k, g in tg.items():
        if g is not None:
            _close(g, jg[k])
    assert float(tg["final_norm/bias"].abs().max()) > 0


def test_attention_is_bidirectional():
    """Changing the last frame changes position 0's output (a causal
    stack could not); the registered decoder stays causal."""
    params = enc_tree("dense")[0]
    _, tb = _inputs()
    tm = get_model(cfg("torch"), "cpu")
    moved = dict(tb, frames=tb["frames"].clone())
    moved["frames"][:, -1] = torch.randn(
        moved["frames"][:, -1].shape, generator=torch.Generator()
        .manual_seed(5))
    with torch.no_grad():
        a, _ = tm.forward(params, tb)
        b, _ = tm.forward(params, moved)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4
    dense = smoke_cfg("llama3.2-1b", "torch")
    dm = get_model(dense, "cpu")
    dp, _ = dm.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, 200, (1, 9), generator=torch.Generator()
                         .manual_seed(1))
    toks2 = toks.clone()
    toks2[0, -1] = (toks2[0, -1] + 1) % 200
    with torch.no_grad():
        assert torch.equal(dm.forward(dp, {"tokens": toks})[0][:, 0],
                           dm.forward(dp, {"tokens": toks2})[0][:, 0])


def test_inputs_and_forward_step():
    """``synth_inputs`` (and ``SyntheticLM`` through it) give frames of
    ``frontend_dim`` and labels below the vocabulary, in the reference's
    shapes; ``make_forward_step`` returns the padded-vocab logits of
    ``forward`` + ``logits``."""
    from repro.models.api import input_specs
    from repro_torch.train.data import SyntheticLM
    shape = ShapeConfig("t", 24, 2, "train")
    for c in (cfg("torch"), cfg("torch", frontend_dim=96)):
        b = synth_inputs(c, shape, torch.Generator().manual_seed(0))
        spec = input_specs(dataclasses.replace(
            jreg.get(HUBERT).smoke, frontend_dim=c.frontend_dim), shape)
        assert {k: tuple(v.shape) for k, v in b.items()} == \
            {k: tuple(v.shape) for k, v in spec.items()}
        assert b["frames"].dtype == torch.float32
        assert int(b["labels"].max()) < c.vocab_size
    batch = SyntheticLM(cfg("torch"), shape, seed=3).batch(0)
    assert set(batch) == {"frames", "labels"}
    tm = get_model(cfg("torch"), "cpu")
    params = enc_tree("svd")[0]
    run = RunConfig(model=cfg("torch"))
    got = make_forward_step(tm, run)(params, batch)
    with torch.no_grad():
        want = tm.logits(params, tm.forward(params, batch)[0])
    assert tuple(got.shape) == (2, 24, tm.padded_vocab)
    assert torch.equal(got, want)


def test_no_cache_no_decode_no_engine():
    """As the reference: ``decode_step`` raises ``ValueError``, so does
    ``init_cache``; no KV plans; the serve engine refuses the config."""
    from repro_torch.serve.engine import ServeEngine
    tm = get_model(cfg("torch"), "cpu")
    params = enc_tree("dense")[0]
    with pytest.raises(ValueError, match="no decode step"):
        tm.decode_step(params, torch.zeros((1, 1), dtype=torch.long),
                       torch.zeros((1,), dtype=torch.long), None)
    with pytest.raises(ValueError, match="no KV cache"):
        tm.init_cache(1, 8)
    assert tm.cache_plans() == []
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(RunConfig(model=cfg("torch")), params, device="cpu")
