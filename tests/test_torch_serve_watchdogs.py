"""The reference's degradation, watchdog and mixed-load tests
(``tests/test_serve_faults.py``: the load shedder engaging and
recovering, the no-progress stall, ``max_steps``, the straggler
detector, survivors of a run with a cancel and an expiry equal to the
clean run) replayed on the port's engine and on the reference engine
over one smoke tree: statuses, outputs and counters equal."""
import pytest

from _torch_parity import torch_threads
from _torch_serve_replay import LONG, drained, replay, requests, serve
from repro_torch.train.fault_tolerance import StragglerDetector


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(1):
        yield


def degradation_engages_and_recovers(side):
    probe = side.engine()
    budget = probe.pool.bytes_per_token * 20
    eng = side.engine(kv_byte_budget=budget)
    reqs = [side.Request(uid=i, prompt=[i + 2] * 8, max_new_tokens=16)
            for i in range(4)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    tp = eng.throughput()
    idle = 0
    for _ in range(2 * eng.shedder.policy.window):
        if not eng.shedder.engaged:
            break
        eng.step()
        idle += 1
    assert not eng.shedder.engaged
    assert eng.scheduler.step_token_budget == eng.step_token_budget
    return {"shed": {k: tp[k] for k in ("shed_steps", "degradation_engages",
                                        "degradation_recoveries")},
            "idle_steps": idle, **drained(side, eng, reqs)}


def degradation_disabled(side):
    eng = side.engine(degradation=False)
    req = side.Request(uid=0, prompt=[3, 4], max_new_tokens=2)
    eng.add_request(req)
    eng.run_until_done()
    assert eng.shedder is None and "shed_steps" not in eng.throughput()
    return drained(side, eng, [req])


def stall_fails_survivors(side):
    inj = side.FaultInjector(rates={"pool_alloc": 1.0})
    eng = side.engine(faults=inj, stall_steps=4, degradation=False)
    reqs = requests(side, [[3, 4, 5]] * 2)
    for r in reqs:
        eng.add_request(r)
    done = eng.run_until_done()
    return {"done": len(done), "counts": eng.throughput()["status_counts"],
            "report": inj.report(), **drained(side, eng, reqs)}


def max_steps_exhaustion(side):
    eng = side.engine()
    req = side.Request(uid=0, prompt=[3, 4, 5], max_new_tokens=32)
    eng.add_request(req)
    with pytest.raises(RuntimeError, match="steps exhausted"):
        eng.run_until_done(max_steps=3)
    eng.run_until_done()
    return drained(side, eng, [req])


def test_degradation_engages_and_recovers():
    rec = replay(degradation_engages_and_recovers)
    assert rec["shed"]["degradation_engages"] >= 1
    assert rec["shed"]["shed_steps"] >= 1
    assert {r[1] for r in rec["requests"]} <= {"finished", "dropped"}


def test_degradation_disabled():
    replay(degradation_disabled)


def test_stall_fails_survivors_instead_of_hanging():
    rec = replay(stall_fails_survivors)
    assert rec["done"] == 2 and rec["counts"] == {"failed": 2}
    assert rec["admit_failures"] >= 4


def test_max_steps_exhaustion_raises():
    assert replay(max_steps_exhaustion)["requests"][0][1] == "finished"


def slow_step_straggler(side):
    eng = side.engine()
    eng.add_request(side.Request(uid=0, prompt=[3, 4], max_new_tokens=6))
    eng.run_until_done()              # warm every path first
    eng.stragglers = StragglerDetector()
    eng.runner.faults = side.FaultInjector(
        schedule={"slow_step": [5]}, params={"slow_step": {"seconds": 0.5}})
    req = side.Request(uid=1, prompt=[5, 6], max_new_tokens=8)
    eng.add_request(req)
    eng.run_until_done()
    tp = eng.throughput()
    assert tp["slow_steps"] >= 1 and tp["step_ewma_s"] > 0
    assert any(s["straggler"] for s in eng.stats)
    return {"report": eng.runner.faults.report(),
            **drained(side, eng, [req])}


def test_slow_step_trips_straggler_detector():
    rec = replay(slow_step_straggler)
    assert rec["report"] == {"slow_step": {"calls": 8, "fired": 1}}


# ---------------------------------------------------------------------------
# mixed load: survivors equal the clean run
# ---------------------------------------------------------------------------

MIXED = [list(LONG), list(LONG[:17]) + [33, 34], [2, 3, 4, 5], [7] * 9,
         [11, 12], [13, 14, 15, 16], [17] * 6, [19, 20, 21], [23, 24],
         [25, 26, 27]]


def mixed_load(side):
    clean = serve(side, side.engine(kv_layout="paged", prefill_chunk=8),
                   MIXED, 6)
    assert all(r.status == "finished" for r in clean)
    eng = side.engine(kv_layout="paged", prefill_chunk=8)
    reqs = [side.Request(uid=i, prompt=list(p), max_new_tokens=6)
            for i, p in enumerate(MIXED)]
    reqs[3].deadline_s = 0.0
    for r in reqs:
        eng.add_request(r)
    for _ in range(64):
        eng.step()
        if reqs[7].output:
            break
    assert eng.cancel(7)
    eng.run_until_done()
    assert reqs[7].output == clean[7].output[:len(reqs[7].output)]
    for i in set(range(10)) - {3, 7}:
        assert reqs[i].status == "finished"
        assert reqs[i].output == clean[i].output, i
    return drained(side, eng, reqs)


def test_survivor_streams_identical_to_clean_run():
    rec = replay(mixed_load)
    assert rec["requests"][3][1:] == ("deadline_exceeded", [])
    assert rec["requests"][7][1] == "cancelled"


def float_factors_int8_slot_pool(side):
    """``serve_faults``' pairing on the card: full-width factors over an
    int8 slot pool (B1 / B2 / B5 there), greedy."""
    eng = side.engine(kv_quantize="int8", slots=4, prefill_chunk=8)
    reqs = serve(side, eng, MIXED[:6], 6)
    return drained(side, eng, reqs)


def test_float_factors_over_int8_slot_pool_equal_reference():
    rec = replay(float_factors_int8_slot_pool)
    assert all(r[1] == "finished" and len(r[2]) == 6
               for r in rec["requests"])
