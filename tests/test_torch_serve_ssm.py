"""The port's ServeEngine on the SSM and hybrid families against the
reference engine's (f32, one smoke tree built by the port and bridged
into both): greedy streams identical for the dense, decomposed, int8
factors + int8 KV and 2:4-packed trees over two slots (prompts of 3 or
more tokens, one longer than the smoke chunk, admissions landing while
the other slot decodes); blocking admission by default, continuous
admission and the paged pool refused; ``kv_bytes_per_step`` 0 for the
attention-free mamba2 and the reference's for zamba2; the pool's
invariants after every step (``debug=True``).  The port's departure for
prompts of 1 or 2 tokens: ``test_torch_ssm_short_prompts.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import smoke_cfg, smoke_port_tree, to_jax, torch_threads
from repro.configs.base import ParallelConfig
from repro.configs.base import RunConfig as JRun
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs.base import RunConfig
from repro_torch.quant.quantize import quantize_tree
from repro_torch.quant.sparse import sparsify_tree
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
N_NEW = 4
KW = dict(slots=2, max_seq=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _prompts():
    """Three prompts of 3 or more tokens; 40 is past the smoke chunk."""
    rng = np.random.default_rng(5)
    return [rng.integers(1, 250, n).tolist() for n in (3, 40, 6)]


def _serve(eng, request, prompt_list=None):
    reqs = [request(uid=i, prompt=list(p), max_new_tokens=N_NEW)
            for i, p in enumerate(prompt_list or _prompts())]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(r.status == "finished" and len(r.output) == N_NEW
               for r in reqs)
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _packed_for_jax(name: str, tree: str) -> dict:
    """The engine's 2:4 int8 load pipeline run by the port, bridged into
    the reference's arrays (the reference engine then has nothing left to
    pack)."""
    params = sparsify_tree(smoke_port_tree(name, tree)[0], "2:4",
                           mode="int8")
    return jax.tree.map(jnp.asarray, bridge.to_numpy(
        quantize_tree(params, "int8")))


def _engine(name, tree, **kw):
    return ServeEngine(RunConfig(model=smoke_cfg(name, "torch")),
                       smoke_port_tree(name, tree)[0], device="cpu",
                       debug=True, **{**KW, **kw})


@pytest.mark.parametrize("name,tree,flags", [
    ("mamba2-2.7b", "dense", {}),
    ("mamba2-2.7b", "branched", {}),
    ("mamba2-2.7b", "branched", dict(quantize="int8", kv_quantize="int8")),
    ("zamba2-1.2b", "dense", {}),
    ("zamba2-1.2b", "svd", {}),
    ("zamba2-1.2b", "branched", dict(quantize="int8", kv_quantize="int8")),
])
def test_streams_match_reference_engine(name, tree, flags):
    jeng = JEngine(JRun(model=smoke_cfg(name, "jax"),
                        parallel=ParallelConfig()),
                   to_jax(smoke_port_tree(name, tree)[0]), **KW, **flags)
    want = _serve(jeng, JRequest)
    eng = _engine(name, tree, **flags)
    assert eng.admission == jeng.admission == "blocking"
    assert _serve(eng, Request) == want
    for k in ("weight_bytes", "quant_bytes", "kv_bytes_per_step"):
        assert eng.plan_summary[k] == jeng.plan_summary[k], k
    assert (eng.plan_summary.get("kv_cache_family")
            == jeng.plan_summary.get("kv_cache_family"))
    assert eng.pool.bytes_per_token == jeng.pool.bytes_per_token
    assert eng.pool.check_integrity()
    want_keys = {"blocks", "shared"} if name == ARCHS[1] else {"blocks"}
    assert set(eng.pool.cache) == want_keys
    if name == ARCHS[0]:
        assert eng.plan_summary["kv_bytes_per_step"] == 0
        assert "kv_cache_family" not in eng.plan_summary
    else:
        assert eng.plan_summary["kv_bytes_per_step"] > 0


@pytest.mark.parametrize("name", ARCHS)
def test_sparse_streams_match_reference_engine(name):
    """The branched tree 2:4-packed in int8 over the int8 KV pool."""
    flags = dict(quantize="int8", sparsify="2:4", kv_quantize="int8")
    jeng = JEngine(JRun(model=smoke_cfg(name, "jax"),
                        parallel=ParallelConfig()),
                   _packed_for_jax(name, "branched"), **KW, **flags)
    eng = _engine(name, "branched", **flags)
    assert _serve(eng, Request) == _serve(jeng, JRequest)
    assert eng.plan_summary["sparse"] == jeng.plan_summary["sparse"] > 0


@pytest.mark.parametrize("name", ARCHS)
def test_admission_and_layout_refusals(name):
    """Blocking is the default and the only admission; the paged pool
    needs continuous admission, so it is refused too (as the
    reference's engine refuses both)."""
    assert _engine(name, "dense").admission == "blocking"
    with pytest.raises(ValueError, match="blocking"):
        _engine(name, "dense", admission="continuous")
    with pytest.raises(ValueError, match="continuous admission"):
        _engine(name, "dense", kv_layout="paged")


def test_recurrent_pool_slot_fallbacks():
    """Without per-token bytes the byte budget gates nothing: admission
    always fits, no stream is a pressure victim, and the capacity is 0
    (the router counts streams instead)."""
    eng = _engine("mamba2-2.7b", "dense", kv_byte_budget=1)
    pool = eng.pool
    assert pool.bytes_per_token == 0 and pool.capacity_bytes() == 1
    pool.allocate(0, 40)
    assert pool.can_admit(10_000) and pool.pressure_victims() == []
    assert _engine("mamba2-2.7b", "dense").pool.capacity_bytes() == 0
    # every leaf of the state pool carries the layer and slot axes
    for name, leaf in pool.cache["blocks"].items():
        assert leaf.shape[:2] == (2, KW["slots"]), name
