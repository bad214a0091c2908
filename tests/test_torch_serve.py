"""The port's ServeEngine vs the reference's on bridged smoke trees (f32):
greedy token streams identical for the dense, SVD and SVD+branched
trees; continuous and blocking admission agree; every request
finishes."""

import numpy as np
import pytest
import torch

from _torch_parity import jax_cfg, jax_tree, prompts, torch_cfg, torch_tree
from repro.configs.base import ParallelConfig
from repro.configs.base import RunConfig as JRun
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.configs.base import RunConfig
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.guard import sample_and_flag
from repro_torch.serve.scheduler import Scheduler
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

N_NEW = 6
KW = dict(slots=4, max_seq=64, prefill_chunk=8)


def _serve_port(tree, admission="continuous", reqs=None, **kw):
    eng = ServeEngine(RunConfig(model=torch_cfg()), tree, device="cpu",
                      admission=admission, **{**KW, **kw})
    reqs = reqs or [Request(uid=i, prompt=p, max_new_tokens=N_NEW)
                    for i, p in enumerate(prompts())]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(r.done and r.status == "finished" for r in reqs)
    return eng, [r.output for r in reqs]


@pytest.mark.parametrize("name", ["dense", "svd", "branched"])
def test_greedy_streams_match_reference_engine(name):
    jeng = JEngine(JRun(model=jax_cfg(), parallel=ParallelConfig()),
                   jax_tree(name)[0], **KW)
    jreqs = [JRequest(uid=i, prompt=p, max_new_tokens=N_NEW)
             for i, p in enumerate(prompts())]
    for r in jreqs:
        jeng.add_request(r)
    jeng.run_until_done()
    assert any(len(p) > KW["prefill_chunk"] for p in prompts())
    _, cont = _serve_port(torch_tree(name))
    _, block = _serve_port(torch_tree(name), admission="blocking")
    assert cont == [r.output for r in jreqs]
    assert block == cont
    assert all(len(o) == N_NEW for o in cont)


def test_preemption_under_byte_budget_keeps_greedy_streams():
    tree = torch_tree("branched")
    _, free = _serve_port(tree)
    eng, tight = _serve_port(tree, kv_byte_budget=40 * 2 * 2 * 16 * 4 * 2)
    assert eng.scheduler.preemptions > 0
    assert tight == free


def test_throughput_keys_and_counts():
    eng, outs = _serve_port(torch_tree("svd"))
    tp = eng.throughput()
    for k in ("tokens_per_s", "steps", "mean_batch", "decode_seconds",
              "prefill_seconds", "prefill_tokens", "decode_step_ms_mean",
              "preemptions", "ttft_mean_s", "status_counts", "latency"):
        assert k in tp, k
    assert tp["status_counts"] == {"finished": len(outs)}
    assert tp["prefill_tokens"] == sum(len(p) for p in prompts())
    assert eng.plan_summary["kv_cache_family"] == "gqa_f32"
    cfg = torch_cfg()
    assert eng.plan_summary["kv_bytes_per_step"] == (
        cfg.num_layers * KW["slots"] * KW["max_seq"] * 2
        * cfg.num_kv_heads * cfg.resolved_head_dim * 4)


def test_temperature_sampling_is_seeded_and_flags_nonfinite_rows():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    logits[2, 7] = float("nan")
    temps = torch.tensor([0.0, 0.8, 0.8, 0.0])
    t1, bad = sample_and_flag(logits, temps, g1)
    t2, _ = sample_and_flag(logits, temps, g2)
    assert torch.equal(t1, t2)
    assert bad.tolist() == [False, False, True, False]
    assert int(t1[0]) == int(torch.argmax(logits[0]))
    # the temperature draw follows softmax(logits / T)
    g = torch.Generator().manual_seed(0)
    row = torch.tensor([[0.0, 1.0, 2.0]])
    draws = [int(sample_and_flag(row, torch.tensor([1.0]), g)[0])
             for _ in range(3000)]
    freq = np.bincount(draws, minlength=3) / len(draws)
    np.testing.assert_allclose(freq, torch.softmax(row[0], 0).numpy(),
                               atol=0.04)


def test_mixed_temperature_requests_finish():
    reqs = [Request(uid=i, prompt=p, max_new_tokens=N_NEW,
                    temperature=0.0 if i % 2 else 0.8)
            for i, p in enumerate(prompts())]
    _, outs = _serve_port(torch_tree("branched"), reqs=reqs)
    assert all(len(o) == N_NEW for o in outs)
    assert all(0 <= t < torch_cfg().vocab_size for o in outs for t in o)


def test_chunk_plan_is_fifo_and_budgeted():
    s = Scheduler(2, prefill_chunk=8, step_token_budget=10)

    class Pool:
        def free_slots(self):
            return [0, 1]

        def can_admit(self, n, tokens=None):
            return True

        def allocate(self, slot, n, tokens=None):
            return 0                      # no pooled prefix
    for i, n in enumerate((20, 5)):
        s.submit(Request(uid=i, prompt=[1] * n))
    started = s.admit(Pool())
    assert [ps.slot for ps in started] == [0, 1]
    plan = s.chunk_plan(n_live=0)
    assert [(ps.req.uid, c) for ps, c in plan] == [(0, 8)]   # runt waits
    assert [(ps.req.uid, c) for ps, c in s.chunk_plan(n_live=2)] == [(0, 8)]


def test_engine_refuses_params_on_another_device():
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(RunConfig(model=torch_cfg()), torch_tree("dense"),
                    device="meta")
