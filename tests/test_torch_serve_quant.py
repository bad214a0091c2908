"""The port's quantized serve path vs the reference engine's on the
bridged SVD+branched smoke tree (f32): ``ServeEngine(quantize=...,
kv_quantize="int8")`` gives greedy token streams identical to the JAX
engine with the same flags, for int8 and fp8 factors, in continuous
(chunked) and blocking admission alike; ``plan_summary`` reports the
reference's bytes."""
import pytest
import torch

from _torch_parity import jax_cfg, jax_tree, prompts, torch_cfg, torch_tree
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

N_NEW = 6
KW = dict(slots=4, max_seq=64, prefill_chunk=8, kv_quantize="int8")


@pytest.mark.parametrize("quantize", ["int8", "fp8"])
def test_quantized_streams_match_reference_engine(quantize):
    jeng = JEngine(JRun(model=jax_cfg(), parallel=ParallelConfig()),
                   jax_tree("branched")[0], quantize=quantize, **KW)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=N_NEW)
             for i, p in enumerate(prompts())]
    for r in jreqs:
        jeng.add_request(r)
    jeng.run_until_done()
    assert any(len(p) > KW["prefill_chunk"] for p in prompts())
    want = [r.output for r in jreqs]
    assert all(len(o) == N_NEW for o in want)
    for admission in ("continuous", "blocking"):
        eng = ServeEngine(RunConfig(model=torch_cfg()), torch_tree("branched"),
                          device="cpu", admission=admission,
                          quantize=quantize, **KW)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=N_NEW)
                for i, p in enumerate(prompts())]
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done()
        assert all(r.status == "finished" for r in reqs)
        assert [r.output for r in reqs] == want, admission
        for k in ("quant_bytes", "weight_bytes", "kv_bytes_per_step",
                  "kv_cache_family"):
            assert eng.plan_summary[k] == jeng.plan_summary[k], k
        assert eng.plan_summary["kv_cache_family"] == "gqa_int8"
        assert eng.plan_summary["quant_bytes"] > 0
        assert eng.pool.cache["blocks"]["k_q"].dtype == torch.int8
