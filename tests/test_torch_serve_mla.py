"""The port's ServeEngine on dense MLA stacks vs the reference engine's
(f32, one tree bridged to both): greedy token streams identical over the
``mla_latent`` and ``mla_latent_int8`` pools, in continuous (chunked)
and blocking admission, for the dense tree, an SVD+branched tree and
int8 factors; ``plan_summary`` and the pool's bytes equal the
reference's.  Then the port alone: chunked equals whole, continuous is
the default, the int8 engine equals a greedy loop over whole prefills,
and a paged pool is refused."""
import pytest
import torch

from _torch_parity import mla_cfg, mla_port_tree, mla_tree_for_jax, prompts
from repro.configs.base import ParallelConfig
from repro.configs.base import RunConfig as JRun
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import RunConfig
from repro_torch.serve.engine import Request, ServeEngine
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

N_NEW = 5
KW = dict(slots=2, max_seq=64, prefill_chunk=8)
#: the reference cache-plan tests' long prompt (21 tokens: three chunks)
LONG = [(i * 7 + 3) % 50 + 1 for i in range(21)]


def _prompts() -> list[list[int]]:
    return [LONG, *prompts(lengths=(4, 13), vocab=60)]


def _serve(eng, prompt_list, n=N_NEW, request=Request):
    reqs = [request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, p in enumerate(prompt_list)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(r.status == "finished" and len(r.output) == n for r in reqs)
    return [r.output for r in reqs]


def _port_engine(cfg_name, tree, **kw):
    return ServeEngine(RunConfig(model=mla_cfg(cfg_name, "torch")),
                       mla_port_tree(cfg_name, tree), device="cpu",
                       **{**KW, **kw})


@pytest.mark.parametrize("cfg_name,tree,quantize,kv_quantize", [
    ("deepseek-smoke", "dense", "none", None),
    ("deepseek-smoke", "svd+branched", "none", "int8"),
    ("deepseek-smoke", "branched", "int8", "int8"),
    ("mla-tiny", "dense", "none", "int8"),
    ("mla-tiny", "svd+branched", "none", None),
])
def test_streams_match_reference_engine(cfg_name, tree, quantize,
                                        kv_quantize):
    jeng = JEngine(JRun(model=mla_cfg(cfg_name, "jax"),
                        parallel=ParallelConfig()),
                   mla_tree_for_jax(cfg_name, tree), quantize=quantize,
                   kv_quantize=kv_quantize, **KW)
    assert jeng.admission == "continuous"
    want = _serve(jeng, _prompts(), request=JRequest)
    family = "mla_latent_int8" if kv_quantize else "mla_latent"
    for admission in ("continuous", "blocking"):
        eng = _port_engine(cfg_name, tree, admission=admission,
                           quantize=quantize, kv_quantize=kv_quantize)
        assert _serve(eng, _prompts()) == want, admission
        for k in ("weight_bytes", "quant_bytes", "kv_bytes_per_step",
                  "kv_cache_family"):
            assert eng.plan_summary[k] == jeng.plan_summary[k], k
        assert eng.plan_summary["kv_cache_family"] == family
        assert eng.pool.bytes_per_token == jeng.pool.bytes_per_token
        assert eng.pool.kv_bytes_per_step == sum(
            p.bytes_per_step(KW["slots"], KW["max_seq"])
            for p in eng.pool.plans)
    blocks = eng.pool.cache["blocks"]
    if kv_quantize:
        assert blocks["ckv_q"].dtype == blocks["krope_q"].dtype == torch.int8
        assert blocks["ckv_scale"].shape == (2, KW["slots"],
                                             mla_cfg(cfg_name,
                                                     "torch").kv_lora_rank)
    else:
        assert set(blocks) == {"ckv", "krope"}
    if quantize == "int8":
        assert eng.plan_summary["quant_bytes"] > 0


@pytest.mark.parametrize("kv_quantize", [None, "int8"])
def test_chunked_equals_whole_and_continuous_is_default(kv_quantize):
    whole = _port_engine("mla-tiny", "dense", admission="blocking",
                         kv_quantize=kv_quantize)
    chunked = _port_engine("mla-tiny", "dense", kv_quantize=kv_quantize)
    assert chunked.admission == "continuous"
    assert _serve(chunked, _prompts()) == _serve(whole, _prompts())
    # chunking happened: the 21-token prompt prefilled 8 tokens at a time
    assert max(s["prefill_tokens"] for s in chunked.stats) <= 8 + 2


def test_int8_engine_equals_greedy_loop_over_whole_prefills():
    """The int8 engine (int8 factors, int8 latent pool, chunked) emits
    what a greedy loop of whole prefills of the same factors over the
    growing sequence picks, at full precision and with no cache reuse."""
    cfg = mla_cfg("mla-tiny", "torch")
    eng = _port_engine("mla-tiny", "branched", quantize="int8",
                       kv_quantize="int8")
    (out,) = _serve(eng, [LONG])
    model, params = eng.model, eng.params
    toks = list(LONG)
    with torch.inference_mode():
        for _ in range(N_NEW):
            logits, _ = model.prefill(
                params, {"tokens": torch.tensor([toks])},
                model.init_cache(1, len(toks)))
            toks.append(int(logits[0, -1, :cfg.vocab_size].argmax()))
    assert out == toks[len(LONG):]


def test_paged_pool_refused_for_mla():
    with pytest.raises(ValueError, match="paged"):
        _port_engine("mla-tiny", "dense", kv_layout="paged",
                     kv_block_size=8)
