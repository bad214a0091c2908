"""The port's ServeEngine on the VLM family against the reference engine's
(f32, one tree built by the port, cross gates at 0.5, bridged into both):
llama-3.2-vision's smoke trees at 5 and 10 layers admit blocking with
bucketed (right-padded) prompts and refuse continuous admission and the
paged pool; greedy streams are identical over the full-width and the
int8 slot pool, dense and decomposed; ``kv_bytes_per_step`` counts the
image K/V as the reference's does; and a staged cache lands in the pool
as in the reference's pool: ``cross_kv`` whole and unmasked, in the model
dtype over the int8 pool too (leaves within 1e-4 of the largest
reference value).

Both engines prefill every request with zero image embeddings (the
reference engine's stub image), so the streams hold the text path; the
image path is held through ``LMModel`` in ``test_torch_vlm.py`` and by
the pool case here (random embeddings)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TREE_LRD, smoke_cfg, to_jax, torch_threads
from repro.configs.base import ParallelConfig
from repro.configs.base import RunConfig as JRun
from repro.models.api import get_model as jget_model
from repro.serve import pool as jpool
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import LRDConfig, RunConfig
from repro_torch.core.surgery import decompose_model
from repro_torch.models.api import get_model
from repro_torch.serve import pool
from repro_torch.serve.engine import Request, ServeEngine

VLM = "llama-3.2-vision-90b"
#: the pool leaves within this of their largest reference value (f32)
TOL = 1e-4
N_NEW = 5
KW = dict(slots=2, max_seq=48)
_TREES: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def tree(layers: int, name: str):
    """A smoke VLM tree of the port (seed 0, cross gates 0.5), decomposed
    with ``TREE_LRD[name]``."""
    key = (layers, name)
    if key not in _TREES:
        params, axes = get_model(smoke_cfg(VLM, "torch", num_layers=layers),
                                 "cpu").init(torch.Generator().manual_seed(0))
        params["cross"]["cross_attn"]["gate"].fill_(0.5)
        if TREE_LRD[name] is not None:
            params, _, _ = decompose_model(params, axes,
                                           LRDConfig(**TREE_LRD[name]))
        _TREES[key] = params
    return _TREES[key]


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(1, 250, n).tolist() for n in (21, 4, 13, 9)]


def _serve(eng, request):
    reqs = [request(uid=i, prompt=list(p), max_new_tokens=N_NEW)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(r.status == "finished" and len(r.output) == N_NEW
               for r in reqs)
    return [r.output for r in reqs]


def _engine(layers, name, **kw):
    return ServeEngine(RunConfig(model=smoke_cfg(VLM, "torch",
                                                 num_layers=layers)),
                       tree(layers, name), device="cpu", **{**KW, **kw})


@pytest.mark.parametrize("layers,name,kv_quantize", [
    (5, "dense", None), (10, "svd", None), (5, "branched", "int8"),
    (10, "dense", "int8"),
])
def test_streams_match_reference_engine(layers, name, kv_quantize):
    """Four prompts over two slots: admissions land while the other slot
    decodes, and a slot idles at the end."""
    jeng = JEngine(JRun(model=smoke_cfg(VLM, "jax", num_layers=layers),
                        parallel=ParallelConfig()),
                   to_jax(tree(layers, name)), kv_quantize=kv_quantize, **KW)
    want = _serve(jeng, JRequest)
    eng = _engine(layers, name, kv_quantize=kv_quantize)
    assert eng.admission == jeng.admission == "blocking"
    assert _serve(eng, Request) == want
    for k in ("weight_bytes", "kv_bytes_per_step", "kv_cache_family"):
        assert eng.plan_summary[k] == jeng.plan_summary[k], k
    assert eng.pool.bytes_per_token == jeng.pool.bytes_per_token
    assert eng.pool.kv_bytes_per_step == jeng.pool.kv_bytes_per_step
    cross = sum(t.numel() * t.element_size()
                for t in eng.pool.cache["cross_kv"].values())
    assert cross > 0 and eng.pool.kv_bytes_per_step > cross
    assert set(eng.pool.cache) == {"self", "cross_kv"}
    assert eng.pool.cache["cross_kv"]["k"].dtype == torch.float32


def test_blocking_bucketed_and_the_refusals():
    """Blocking admission by default, prompts bucketed as the reference
    buckets them (the VLM is a bucket family), continuous admission and
    the paged pool refused."""
    eng = _engine(5, "dense")
    jeng = JEngine(JRun(model=smoke_cfg(VLM, "jax"),
                        parallel=ParallelConfig()),
                   to_jax(tree(5, "dense")), **KW)
    assert eng.admission == "blocking"
    lengths = [1, 4, 13, 21, 40]
    assert [eng._bucket_len(n) for n in lengths] == \
        [jeng._bucket_len(n) for n in lengths] != lengths
    with pytest.raises(ValueError, match="chunked admission"):
        _engine(5, "dense", admission="continuous")
    with pytest.raises(ValueError, match="paged"):
        _engine(5, "dense", kv_layout="paged", kv_block_size=8)


@pytest.mark.parametrize("kv_quantize", [None, "int8"])
def test_staged_cache_lands_as_in_reference_pool(kv_quantize):
    """One prompt prefilled with random image embeddings into a staging
    cache of the pool's family lands in slot 1 of both pools (10 layers:
    two super blocks): the self blocks' K/V past the prompt stay zero,
    the image K/V lands whole (no sequence mask over its 17 image
    positions) and in the model dtype over the int8 pool."""
    layers, n = 10, 7
    tp = tree(layers, "branched")
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 250, (1, 16)).astype(np.int32)
    toks[0, n:] = 0
    img = (rng.standard_normal((1, 17, 64)) * 0.2).astype(np.float32)
    jm = jget_model(smoke_cfg(VLM, "jax", num_layers=layers))
    _, jstaged = jm.prefill(
        to_jax(tp), {"tokens": jnp.asarray(toks),
                     "image_embeds": jnp.asarray(img)},
        jm.init_cache(1, KW["max_seq"], kv_quantize=kv_quantize),
        last_pos=jnp.asarray(n - 1, jnp.int32))
    tm = get_model(smoke_cfg(VLM, "torch", num_layers=layers), "cpu")
    with torch.inference_mode():
        _, staged = tm.prefill(
            tp, {"tokens": torch.from_numpy(toks).long(),
                 "image_embeds": torch.from_numpy(img)},
            tm.init_cache(1, KW["max_seq"], kv_quantize),
            last_pos=n - 1, cache_plan=tm.cache_plan(kv_quantize))
        jp = jpool.KVPoolManager(jm, 2, KW["max_seq"],
                                 kv_quantize=kv_quantize)
        jp.insert(jstaged, 1, n)
        tpool = pool.KVPoolManager(tm, 2, KW["max_seq"],
                                   kv_quantize=kv_quantize)
        tpool.insert(staged, 1, n)
    assert set(tpool.cache) == set(jp.cache) == {"self", "cross_kv"}
    for top in tpool.cache:
        assert set(tpool.cache[top]) == set(jp.cache[top])
        for leaf, got in tpool.cache[top].items():
            want = np.asarray(jp.cache[top][leaf], np.float64)
            got = got.to(torch.float64).numpy()
            assert got.shape == want.shape, (top, leaf)
            err = np.abs(got - want).max()
            assert err <= TOL * max(np.abs(want).max(), 1e-30), (top, leaf)
    ck = tpool.cache["cross_kv"]["k"]
    assert ck.dtype == torch.float32 and tuple(ck.shape) == (2, 2, 17, 2, 16)
    assert bool((ck[:, 1].abs().amax(dim=(-2, -1)) > 0).all())
    assert torch.count_nonzero(ck[:, 0]) == 0
    sk = tpool.cache["self"]["k_q" if kv_quantize else "k"]
    assert torch.count_nonzero(sk[:, :, 1, n:]) == 0
    assert torch.count_nonzero(sk[:, :, 1, :n]) > 0
