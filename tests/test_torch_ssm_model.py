"""The SSM and hybrid families (mamba2-2.7b, zamba2-1.2b with its shared
attention block) against the reference on the CPU, at their smoke
widths: the configs and registry entries field for field, forward
logits, prefill + decode against the forward (the port's replay of
``tests/test_arch_smoke.py::test_prefill_decode_matches_forward``) and
against the reference's prefill and decode, and the surgery decisions and
the decomposed tree's logits (the loss and gradients:
``test_torch_ssm_train.py``).

One tree built by the port is bridged into the reference.  Tolerance
(f32): logits within 1e-4 of the largest reference logit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CFG_LRD, flat, smoke_cfg, smoke_port_tree,
                           to_jax, torch_threads)
from repro.configs import registry as jreg
from repro.configs.base import LRDConfig as JLRD
from repro.core.surgery import decompose_model as jdecompose
from repro.models.api import get_model as jget_model
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LRDConfig
from repro_torch.core.surgery import decompose_model
from repro_torch.models.api import get_model

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
TREES = ["dense", "svd", "branched"]
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _close(got, want, tol=LOGIT_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), \
        err / np.abs(want).max()


def _toks(b=2, s=45, seed=0):
    """45 tokens: past the smoke chunk (32), not a multiple of it."""
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_config_mirrors_reference(name):
    for which in ("full", "smoke"):
        j = getattr(jreg.get(name), which)
        t = getattr(treg.get(name), which)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (which, f.name)
        for prop in ("d_inner", "resolved_ssm_heads", "attention_free",
                     "subquadratic", "has_decode", "resolved_head_dim"):
            assert getattr(t, prop) == getattr(j, prop), (which, prop)
    assert treg.get(name).notes


def test_published_widths():
    m, z = treg.get("mamba2-2.7b").full, treg.get("zamba2-1.2b").full
    assert (m.d_inner, m.resolved_ssm_heads, m.ssm_state, m.ssm_chunk,
            m.vocab_size) == (5120, 80, 128, 256, 50280)
    assert (z.d_inner, z.resolved_ssm_heads, z.ssm_state, z.num_heads,
            z.num_kv_heads, z.resolved_head_dim, z.d_ff) == (
        4096, 64, 64, 32, 32, 64, 8192)
    assert m.attention_free and not z.attention_free
    assert m.tie_embeddings and z.tie_embeddings


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("tree", TREES)
def test_forward_logits_match_reference(name, tree):
    params = smoke_port_tree(name, tree)[0]
    toks = _toks()
    jm = jget_model(smoke_cfg(name, "jax"))
    jp = to_jax(params)
    jx, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    want = jm.logits(jp, jx)
    tm = get_model(smoke_cfg(name, "torch"), "cpu")
    with torch.no_grad():
        tx, aux = tm.forward(params, {"tokens": torch.from_numpy(toks)})
        got = tm.logits(params, tx)
    assert float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("tree", ["dense", "branched"])
def test_prefill_decode_match_reference(name, tree):
    """Prefill of 41 tokens (past the smoke chunk) and 4 decode steps,
    both sides from the same tree; the hybrid's shared block reads and
    writes one KV entry per group."""
    params = smoke_port_tree(name, tree)[0]
    toks = _toks()
    s, b = 41, 2
    jm = jget_model(smoke_cfg(name, "jax"))
    jp = to_jax(params)
    tm = get_model(smoke_cfg(name, "torch"), "cpu")
    jc = jm.init_cache(b, toks.shape[1])
    tc = tm.init_cache(b, toks.shape[1])
    assert set(tc) == set(jc)
    for top in tc:
        assert {k: tuple(v.shape) for k, v in tc[top].items()} == \
            {k: tuple(v.shape) for k, v in jc[top].items()}, top
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jc)
    with torch.inference_mode():
        tl, tc = tm.prefill(params, {"tokens": torch.from_numpy(
            toks[:, :s])}, tc)
        _close(tl, jl)
        for t in range(s, toks.shape[1]):
            pos = np.full((b,), t, np.int32)
            jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]),
                                    jnp.asarray(pos), jc)
            tl, tc = tm.decode_step(params, torch.from_numpy(
                toks[:, t:t + 1]), torch.from_numpy(pos), tc)
            _close(tl, jl)
    for k, v in flat(tc).items():
        _close(v, flat(jax.tree.map(np.asarray, jc))[k])


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_matches_forward(name):
    """The reference's arch smoke test replayed on the port: the
    registered (bf16) smoke config, B 2, a 32-token prefill and 2 decode
    steps against the full forward's logits, within 5 % of the largest."""
    cfg = treg.get(name).smoke
    m = get_model(cfg, "cpu")
    params, _ = m.init(torch.Generator().manual_seed(0))
    b, s = 2, 32
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s + 3)))
    with torch.inference_mode():
        full, _ = m.forward(params, {"tokens": toks})
        logits_full = m.logits(params, full)
        cache = m.init_cache(b, s + 3)
        lg, cache = m.prefill(params, {"tokens": toks[:, :s]}, cache)
        errs = [float((lg[:, 0] - logits_full[:, s - 1]).abs().max())]
        for t in range(s, s + 2):
            lg, cache = m.decode_step(params, toks[:, t:t + 1],
                                      torch.full((b,), t), cache)
            errs.append(float((lg[:, 0] - logits_full[:, t]).abs().max()))
    scale = float(logits_full.abs().max()) + 1e-6
    assert max(errs) / scale < 0.05, errs


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("tree", ["svd", "branched"])
def test_surgery_matches_reference(name, tree):
    """The same decisions (path, label, kind, rank, sizes) on both sides:
    ``ssm_in`` / ``ssm_out`` decomposed batched over the stack, bc_proj
    and dt_proj skipped (label not targeted), the hybrid's shared block
    decomposed once at its unstacked paths."""
    dense, axes = smoke_port_tree(name, "dense")
    lrd = CFG_LRD[tree]
    _, _, trep = decompose_model(dense, axes, LRDConfig(**lrd))
    _, _, jrep = jdecompose(to_jax(dense), axes, JLRD(**lrd))
    got = sorted((d.path, d.label, d.kind, d.rank, tuple(d.shape),
                  d.params_after) for d in trep.decisions)
    assert got == sorted((d.path, d.label, d.kind, d.rank, tuple(d.shape),
                          d.params_after) for d in jrep.decisions)
    by = {d.path: d for d in trep.decisions}
    assert by["blocks/ssm/in_proj"].label == "ssm_in"
    assert by["blocks/ssm/out_proj"].label == "ssm_out"
    assert by["blocks/ssm/in_proj"].kind not in ("skip", "org")
    assert by["blocks/ssm/bc_proj"].kind == "skip"
    if name == "zamba2-1.2b":
        d = by["shared_attn/attn/q"]
        assert d.label == "attn_q" and len(d.shape) == 2
        u = smoke_port_tree(name, tree)[0]["shared_attn"]["mlp"]["up"]
        assert next(iter(u.values())).dim() == (3 if tree == "branched"
                                                else 2)


def test_chunk_prefill_is_refused():
    """Recurrent state has no chunk offset: the chunk entry raises (the
    engine prefills these families whole)."""
    tm = get_model(smoke_cfg("mamba2-2.7b", "torch"), "cpu")
    params = smoke_port_tree("mamba2-2.7b", "dense")[0]
    cache = tm.init_cache(1, 16)
    with pytest.raises(ValueError, match="whole prompts"):
        tm.prefill_chunk(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                         cache, start_pos=4, prompt_len=8)
    assert tm.cache_plans() == []
    zm = get_model(smoke_cfg("zamba2-1.2b", "torch"), "cpu")
    assert len(zm.cache_plans()) == zm.n_groups == 2
