"""The port's ServeEngine on the MoE family against the reference
engine's (f32, one tree built by the port and bridged into both):
moonshot's and DeepSeek-V2's smoke trees (DeepSeek's with its unstacked
dense first block and MLA) admit blocking by default and refuse
continuous admission and the paged pool; greedy streams are identical
over the full-width and the int8 slot pool, dense and decomposed, every
slot row decoding each step (idle slots take expert capacity too); the
slot pool lands the ``first`` cache entry as the reference's pool does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import smoke_cfg, smoke_port_tree, to_jax, torch_threads
from repro.configs.base import ParallelConfig
from repro.configs.base import RunConfig as JRun
from repro.models.api import get_model as jget_model
from repro.serve import pool as jpool
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import RunConfig
from repro_torch.models.api import get_model
from repro_torch.serve import pool
from repro_torch.serve.engine import Request, ServeEngine

N_NEW = 5
KW = dict(slots=2, max_seq=48)
MOE = ["moonshot-v1-16b-a3b", "deepseek-v2-236b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(1, 200, n).tolist() for n in (21, 4, 13, 9)]


def _serve(eng, request):
    reqs = [request(uid=i, prompt=list(p), max_new_tokens=N_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(r.status == "finished" and len(r.output) == N_NEW
               for r in reqs)
    return [r.output for r in reqs]


def _engine(name, tree, **kw):
    return ServeEngine(RunConfig(model=smoke_cfg(name, "torch")),
                       smoke_port_tree(name, tree)[0], device="cpu",
                       **{**KW, **kw})


@pytest.mark.parametrize("name,tree,kv_quantize", [
    ("moonshot-v1-16b-a3b", "svd", None),
    ("deepseek-v2-236b", "branched", "int8"),
])
def test_streams_match_reference_engine(name, tree, kv_quantize):
    """Four prompts over two slots: admissions land while the other slot
    decodes, and a slot idles at the end."""
    jeng = JEngine(JRun(model=smoke_cfg(name, "jax"),
                        parallel=ParallelConfig()),
                   to_jax(smoke_port_tree(name, tree)[0]),
                   kv_quantize=kv_quantize, **KW)
    want = _serve(jeng, JRequest)
    eng = _engine(name, tree, kv_quantize=kv_quantize)
    assert eng.admission == jeng.admission == "blocking"
    assert _serve(eng, Request) == want
    for k in ("weight_bytes", "kv_bytes_per_step", "kv_cache_family"):
        assert eng.plan_summary[k] == jeng.plan_summary[k], k
    assert eng.pool.bytes_per_token == jeng.pool.bytes_per_token
    want_keys = {"blocks", "first"} if name == MOE[1] else {"blocks"}
    assert set(eng.pool.cache) == want_keys


@pytest.mark.parametrize("name", MOE)
def test_blocking_by_default_and_continuous_refused(name):
    assert _engine(name, "dense").admission == "blocking"
    assert _engine(name, "dense", admission="blocking").admission == \
        "blocking"
    with pytest.raises(ValueError, match="chunked admission"):
        _engine(name, "dense", admission="continuous")


@pytest.mark.parametrize("name", MOE)
def test_paged_pool_refused(name):
    with pytest.raises(ValueError, match="paged"):
        _engine(name, "dense", kv_layout="paged", kv_block_size=8)


def test_first_entry_lands_as_in_reference_pool():
    """DeepSeek-V2's cache ``{"first", "blocks"}``: one prompt's staging
    cache (full precision, so the int8 pool quantizes it at insert)
    lands in slot 1 of both pools, the unstacked first layer's latents
    and scales with it, position for position; the rows past the prompt
    stay zero, and the ``block_scale`` fault takes the first scale leaf
    in tree order, as the reference's does."""
    name, n, kv_quantize = "deepseek-v2-236b", 11, "int8"
    tp = smoke_port_tree(name, "branched")[0]
    toks = np.random.default_rng(3).integers(1, 200, (1, n)).astype(
        np.int32)
    jm = jget_model(smoke_cfg(name, "jax"))
    _, jstaged = jm.prefill(to_jax(tp), {"tokens": jnp.asarray(toks)},
                            jm.init_cache(1, KW["max_seq"]))
    tm = get_model(smoke_cfg(name, "torch"), "cpu")
    with torch.inference_mode():
        _, staged = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                               tm.init_cache(1, KW["max_seq"]))
        jp = jpool.KVPoolManager(jm, 2, KW["max_seq"],
                                 kv_quantize=kv_quantize)
        jp.insert(jstaged, 1, n, from_full_precision=True)
        tpool = pool.KVPoolManager(tm, 2, KW["max_seq"],
                                   kv_quantize=kv_quantize)
        tpool.insert(staged, 1, n)
    assert set(tpool.cache) == set(jp.cache) == {"first", "blocks"}
    for top in ("first", "blocks"):
        assert set(tpool.cache[top]) == set(jp.cache[top])
        for leaf, got in tpool.cache[top].items():
            want = np.asarray(jp.cache[top][leaf], np.float64)
            got = got.to(torch.float64).numpy()
            assert got.shape == want.shape, (top, leaf)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{top}/{leaf}")
    first = tpool.cache["first"]["ckv_q"]
    assert first.shape[0] == 2                  # no layer axis
    assert torch.count_nonzero(first[1, :n]) > 0
    assert torch.count_nonzero(first[1, n:]) == 0
    assert torch.count_nonzero(first[0]) == 0
    want = jpool._corrupt_scale_leaf(jp.cache, 1)
    with torch.inference_mode():
        pool._corrupt_scale(tpool.cache, 1)
    for top in ("first", "blocks"):
        for leaf, got in tpool.cache[top].items():
            np.testing.assert_array_equal(
                np.isinf(got.numpy()), np.isinf(np.asarray(
                    want[top][leaf])), err_msg=f"{top}/{leaf}")


@pytest.mark.parametrize("kv_quantize", [None, "int8"])
def test_paged_pool_walks_the_first_entry(kv_quantize):
    """The paged pool's walks cover every top-level cache entry: a GQA
    MoE stack with an unstacked first block (moonshot's smoke widths,
    ``moe_first_dense=1``) lands a staged prompt in its blocks and
    gathers it back position for position, the first block's leaves
    (no layer axis) and the stack's alike; its block-table rows follow
    the slot's table."""
    cfg = smoke_cfg("moonshot-v1-16b-a3b", "torch", moe_first_dense=1)
    model = get_model(cfg, "cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    n, bs = 21, 8
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, 200, (1, n))).long()
    with torch.inference_mode():
        p = pool.PagedKVPoolManager(model, 2, KW["max_seq"],
                                    kv_quantize=kv_quantize, block_size=bs)
        assert set(p.cache) == {"first", "blocks"}
        assert p.cache["first"]["block_tables"].shape == (2, 6)
        _, staged = model.prefill(params, {"tokens": toks},
                                  model.init_cache(1, KW["max_seq"]))
        p.allocate(1, n, tokens=toks[0].tolist())
        p.insert(staged, 1, n)
        for top in ("first", "blocks"):
            rows = p.cache[top]["block_tables"]
            row = rows[1] if top == "first" else rows[:, 1]
            assert (row[..., :3] == torch.tensor(p.tables[1][:3])).all()
        back = p.gather_prefix(model.init_cache(1, KW["max_seq"]), 1, n)
    for top in ("first", "blocks"):
        for name in ("k", "v"):
            got, want = back[top][name], staged[top][name]
            lead = got.ndim - 4
            sl = (slice(None),) * lead + (0, slice(None, n))
            if kv_quantize is None:
                assert torch.equal(got[sl], want[sl]), (top, name)
            else:     # one int8 step of the block's scale at most
                err = (got[sl] - want[sl]).abs().max()
                assert err <= want[sl].abs().max() / 127 + 1e-6, (top, name)
            assert torch.count_nonzero(got[(slice(None),) * lead
                                           + (0, slice(n, None))]) == 0
