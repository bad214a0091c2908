"""The reference's quarantine and chaos-matrix tests
(``tests/test_serve_faults.py``) replayed on the port's engine and on the
reference engine over one smoke tree: per-request status and output,
the engines' counters and ``inj.report()`` for every point equal.  The
chaos spec is the reference's without ``kernel_gate`` (the port's gate
raises where the reference's falls back; ``test_torch_serve_faults.py``
covers it)."""
import pytest

from _torch_parity import torch_threads
from _torch_serve_replay import LAYOUTS, LONG, drained, replay, serve


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(1):
        yield


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------

def nan_decode(side, layout):
    prompts = ([9, 10, 11, 12], [20, 21, 22])
    clean = serve(side, side.engine(kv_layout=layout), prompts, 8)
    inj = side.FaultInjector(schedule={"nan_logits": [3]},
                             params={"nan_logits": {"seg": "decode",
                                                    "slot": 0}})
    eng = side.engine(kv_layout=layout, faults=inj)
    reqs = serve(side, eng, prompts, 8)
    victim, neighbour = reqs
    assert victim.status == "failed" and len(victim.output) < 8
    assert victim.output == clean[0].output[:len(victim.output)]
    assert neighbour.output == clean[1].output
    return {"report": inj.report(), **drained(side, eng, reqs)}


def nan_prefill(side):
    inj = side.FaultInjector(schedule={"nan_logits": [1]},
                             params={"nan_logits": {"seg": "prefill_chunk"}})
    eng = side.engine(faults=inj)
    reqs = serve(side, eng, [[3, 4, 5]], 4)
    return {"report": inj.report(), **drained(side, eng, reqs)}


def corrupted_scale(side, layout):
    inj = side.FaultInjector(schedule={"block_scale": [1]})
    eng = side.engine(kv_layout=layout, kv_quantize="int8", faults=inj)
    reqs = serve(side, eng, [[9, 10, 11, 12], [20, 21, 22]], 8)
    return {"report": inj.report(), **drained(side, eng, reqs)}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_nan_decode_quarantines_victim_neighbour_untouched(layout):
    rec = replay(nan_decode, layout)
    assert rec["quarantined"] == 1
    assert rec["report"]["nan_logits"]["fired"] == 1


def test_nan_prefill_quarantines_before_first_token():
    rec = replay(nan_prefill)
    assert rec["requests"] == [(0, "failed", [])]
    assert rec["quarantined"] == 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_corrupted_scale_block_trips_watchdog(layout):
    rec = replay(corrupted_scale, layout)
    assert rec["report"]["block_scale"]["fired"] == 1
    assert [r[1] for r in rec["requests"]] == ["failed", "finished"]
    assert len(rec["requests"][1][2]) == 8 and rec["quarantined"] == 1


# ---------------------------------------------------------------------------
# the chaos matrix: layout x KV dtype
# ---------------------------------------------------------------------------

def chaos(side, layout, kv_mode):
    inj = side.FaultInjector(
        seed=3,
        rates={"pool_alloc": 0.1, "radix_match": 0.5, "nan_logits": 0.05,
               "block_scale": 0.25},
        params={"nan_logits": {"seg": "decode", "slot": 0}},
        max_fires={"pool_alloc": 6, "nan_logits": 2, "block_scale": 2})
    eng = side.engine(kv_layout=layout, kv_quantize=kv_mode, faults=inj,
                      prefill_chunk=8, stall_steps=16)
    prompts = [LONG, LONG[:13], (2, 3, 4, 5), list(LONG), (9,) * 10,
               (4, 5, 6)]
    reqs = [side.Request(uid=i, prompt=list(p), max_new_tokens=6,
                         max_preemptions=4) for i, p in enumerate(prompts)]
    reqs[4].deadline_s = 0.0
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    rec = drained(side, eng, reqs)
    counts = eng.throughput()["status_counts"]
    assert sum(counts.values()) == len(reqs)
    assert counts.get("deadline_exceeded", 0) >= 1
    assert inj.calls["pool_alloc"] > 0 and inj.calls["nan_logits"] > 0
    if layout == "paged":
        assert inj.calls["radix_match"] > 0
    if kv_mode == "int8":
        assert inj.calls["block_scale"] > 0
    if inj.fired["nan_logits"] or inj.fired["block_scale"]:
        assert eng.quarantined >= 1
    return {"report": inj.report(), "counts": counts, **rec}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kv_mode", [None, "int8"])
def test_chaos_matrix_equals_reference(layout, kv_mode):
    rec = replay(chaos, layout, kv_mode)
    assert set(rec["report"]) == {"pool_alloc", "radix_match",
                                  "nan_logits", "block_scale"}
