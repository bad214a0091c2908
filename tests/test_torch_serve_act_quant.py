"""The port's act-quant serve path vs the reference engine's, on one
SVD+branched smoke tree (f32, built by the port and bridged into the
reference): ``ServeEngine(quantize="int8", act_quantize="int8")`` gives
greedy token streams identical to the JAX engine with the same flags —
over a slot pool with full-width KV, and over a paged int8 pool with
shared-prefix twins, concurrent identical prompts (adoptions) and a
preemption under a block byte budget that resumes deterministically.

The reference runs its Pallas kernels here (``use_pallas=True``, in
interpret mode on the CPU): without them it has no act-quant path (its
dispatch falls back to the dequantized chain).  Its online-softmax decode
attention differs from the port's plain versions in the last bits only.
"""
import pytest

from _torch_parity import jax_cfg, port_tree, port_tree_for_jax, torch_cfg
from repro.configs.base import LRDConfig as JLRD
from repro.configs.base import ParallelConfig
from repro.configs.base import RunConfig as JRun
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import LRDConfig, RunConfig
from repro_torch.serve.engine import Request, ServeEngine
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

SHARED = [(i * 5 + 2) % 60 + 1 for i in range(33)]     # 2 full blocks
ROBUST = [(i * 7 + 14) % 50 + 1 for i in range(21)]

#: mode: (engine flags, prompts, new tokens, slots, budget in blocks)
MODES = {
    "slot-pool": (dict(), [SHARED + [40], SHARED + [41], ROBUST, [4, 5, 6]],
                  6, 2, None),
    "paged-int8-shared": (dict(kv_quantize="int8", kv_layout="paged"),
                          [SHARED + [40], SHARED, SHARED, ROBUST], 6, 3,
                          None),
    "paged-int8-preempt": (dict(kv_quantize="int8", kv_layout="paged"),
                           [ROBUST[:15], [9, 8, 7]], 20, 2, 3),
}


def _serve(eng, prompts, n, request):
    reqs = [request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(r.status == "finished" for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_act_quant_streams_match_reference_engine(mode):
    flags, prompts, n, slots, budget = MODES[mode]
    kw = dict(slots=slots, max_seq=64, prefill_chunk=8, quantize="int8",
              act_quantize="int8", **flags)
    jeng = JEngine(JRun(model=jax_cfg(), lrd=JLRD(use_pallas=True),
                        parallel=ParallelConfig()),
                   port_tree_for_jax("branched"), **kw)
    eng = ServeEngine(RunConfig(model=torch_cfg(), lrd=LRDConfig()),
                      port_tree("branched"), device="cpu", **kw)
    if budget:
        jeng.pool.byte_budget = eng.pool.byte_budget = \
            budget * eng.pool.bytes_per_block
    want = _serve(jeng, prompts, n, JRequest)
    assert _serve(eng, prompts, n, Request) == want
    assert eng.runner.prefill_act_quantize
    for k in ("quant_bytes", "weight_bytes", "kv_bytes_per_step",
              "kv_cache_family", "kv_layout"):
        assert eng.plan_summary[k] == jeng.plan_summary[k], k
    if flags.get("kv_layout") == "paged":
        assert eng.pool.prefix_stats() == jeng.pool.prefix_stats()
        assert eng.pool.used_bytes() == 0
        eng.pool.check_integrity()
    if mode == "paged-int8-shared":
        st = eng.pool.prefix_stats()
        assert st["prefix_block_hits"] > 0 or st["adopted_blocks"] > 0
    if mode == "paged-int8-preempt":
        assert eng.scheduler.preemptions > 0
        free = ServeEngine(RunConfig(model=torch_cfg()),
                           port_tree("branched"), device="cpu", **kw)
        assert _serve(free, prompts, n, Request) == want
