"""The dense configs the port registers beside llama3.2-1b (granite-8b,
mistral-nemo-12b, minitron-4b with the gelu MLP) against the reference
on the CPU: the configs field for field, gelu against ``jax.nn.gelu``,
prefill and decode logits of their smoke trees (dense, SVD, branched;
one tree built by the port and bridged into the reference) within 1e-5
of the largest logit, and the port's engine's greedy streams equal to
the reference engine's on a slot and a paged pool.

The smoke widths keep each config's shape: granite and mistral-nemo a
GQA group of 2, minitron a group of 3 (3 query heads over 1 KV head)
and no gate projection."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import smoke_cfg, smoke_port_tree, to_jax, torch_threads
from repro.configs import registry as jreg
from repro.configs.base import ParallelConfig
from repro.configs.base import RunConfig as JRun
from repro.models.api import get_model as jget_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs import registry as treg
from repro_torch.configs.base import RunConfig
from repro_torch.layers.mlp import gelu
from repro_torch.models.api import get_model
from repro_torch.serve.engine import Request, ServeEngine

DENSE = ["granite-8b", "mistral-nemo-12b", "minitron-4b"]
TREES = ["dense", "svd", "branched"]
#: max |port - reference| / max |reference|, f32 on both sides
TOL = 1e-5
S_MAX = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * np.abs(want).max(), err / np.abs(want).max()


@pytest.mark.parametrize("name", [*DENSE, "moonshot-v1-16b-a3b"])
def test_config_mirrors_reference(name):
    for which in ("full", "smoke"):
        j = getattr(jreg.get(name), which)
        t = getattr(treg.get(name), which)
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), (which, f.name)
        assert t.resolved_head_dim == j.resolved_head_dim
        assert t.resolved_moe_d_ff == j.resolved_moe_d_ff


def test_published_widths():
    """The shapes this slice brings to the card: head dim 128 at GQA
    groups of 4 (granite, mistral-nemo), 3 (minitron) and 1 (moonshot);
    mistral-nemo's q 4,096 wide at d_model 5,120."""
    got = {n: (treg.get(n).full.resolved_head_dim,
               treg.get(n).full.num_heads // treg.get(n).full.num_kv_heads)
           for n in [*DENSE, "moonshot-v1-16b-a3b"]}
    assert got == {"granite-8b": (128, 4), "mistral-nemo-12b": (128, 4),
                   "minitron-4b": (128, 3), "moonshot-v1-16b-a3b": (128, 1)}
    nemo = treg.get("mistral-nemo-12b").full
    assert nemo.num_heads * nemo.resolved_head_dim == 4096 != nemo.d_model
    assert treg.get("minitron-4b").full.act == "gelu"


def test_gelu_is_the_reference_tanh_form():
    x = np.concatenate([np.random.default_rng(0).standard_normal(4096) * 4,
                        [0.0, -0.0, 1e-8, -30.0, 30.0, 3.0, -3.0]]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-6)
    # the exact erf form is another function
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_gelu_mlp_has_no_gate():
    params, _ = smoke_port_tree("minitron-4b", "dense")
    assert set(params["blocks"]["mlp"]) == {"up", "down"}
    params, _ = smoke_port_tree("granite-8b", "dense")
    assert set(params["blocks"]["mlp"]) == {"up", "gate", "down"}


def _toks(n, seed=0, b=1):
    return np.random.default_rng(seed).integers(1, 250, (b, n)).astype(
        np.int32)


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_logits_match_reference(name, tree):
    tp = smoke_port_tree(name, tree)[0]
    jp = to_jax(tp)
    jm = jget_model(smoke_cfg(name, "jax"))
    tm = get_model(smoke_cfg(name, "torch"), "cpu")
    toks = _toks(11, b=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(2, S_MAX))
    tc = tm.init_cache(2, S_MAX)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                            tc)
    _close(tl, jl)
    _close(tc["blocks"]["k"], jc["blocks"]["k"])
    pos = np.array([11, 11], np.int32)
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, torch.from_numpy(nxt).long(),
                                    torch.from_numpy(pos).long(), tc)
        _close(tl, jl)
        pos = pos + 1


# ---------------------------------------------------------------------------
# engine streams
# ---------------------------------------------------------------------------

N_NEW = 5
KW = dict(slots=2, max_seq=64, prefill_chunk=8)
LONG = [(i * 7 + 3) % 50 + 1 for i in range(21)]


def _prompts():
    rng = np.random.default_rng(1)
    return [LONG, *(rng.integers(1, 60, n).tolist() for n in (4, 13, 9))]


def _serve(eng, request):
    reqs = [request(uid=i, prompt=list(p), max_new_tokens=N_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(r.status == "finished" and len(r.output) == N_NEW
               for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("name,tree,layout,kv_quantize", [
    ("minitron-4b", "branched", "slot", "int8"),
    ("granite-8b", "svd", "paged", None),
])
def test_streams_match_reference_engine(name, tree, layout, kv_quantize):
    tp = smoke_port_tree(name, tree)[0]
    kw = dict(KW, kv_quantize=kv_quantize, kv_layout=layout,
              kv_block_size=8 if layout == "paged" else None)
    jeng = JEngine(JRun(model=smoke_cfg(name, "jax"),
                        parallel=ParallelConfig()), to_jax(tp), **kw)
    want = _serve(jeng, JRequest)
    eng = ServeEngine(RunConfig(model=smoke_cfg(name, "torch")), tp,
                      device="cpu", **kw)
    assert eng.admission == jeng.admission == "continuous"
    assert _serve(eng, Request) == want
    for k in ("weight_bytes", "kv_bytes_per_step", "kv_cache_family"):
        assert eng.plan_summary[k] == jeng.plan_summary[k], k
