"""The reference's lifecycle tests (``tests/test_serve_faults.py``:
cancel from every state, deadlines and queue age, the preemption budget)
replayed on the port's engine and on the reference engine over one
smoke tree: every request's status and output, the block counts and the
engine's counters equal."""
import pytest

from _torch_parity import torch_threads
from _torch_serve_replay import LAYOUTS, LONG, drained, replay, requests


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(1):
        yield


def _blocks(pool):
    return (pool.blocks.used_blocks(), list(pool.blocks.ref),
            sorted(pool.blocks.cold))


# ---------------------------------------------------------------------------
# cancel from every state
# ---------------------------------------------------------------------------

def cancel_waiting(side, layout):
    eng = side.engine(kv_layout=layout)
    reqs = requests(side, [[3, 4, 5]] * 2)
    for r in reqs:
        eng.add_request(r)
    assert eng.cancel(1)
    eng.run_until_done()
    assert reqs[1].status == "cancelled" and not reqs[1].output
    return drained(side, eng, reqs)


def cancel_unknown_or_terminal(side):
    eng = side.engine()
    req = side.Request(uid=0, prompt=[3, 4, 5], max_new_tokens=2)
    eng.add_request(req)
    first = eng.cancel(99)
    eng.run_until_done()
    return {"unknown": first, "terminal": eng.cancel(0),
            **drained(side, eng, [req])}


def cancel_mid_prefill(side):
    eng = side.engine(kv_layout="paged", prefill_chunk=8)
    req = side.Request(uid=0, prompt=list(LONG), max_new_tokens=4)
    eng.add_request(req)
    eng.step()                        # admitted, chunk 1 of 3
    assert eng.scheduler.prefilling
    held = _blocks(eng.pool)
    assert eng.cancel(0) and req.status == "cancelled"
    after = _blocks(eng.pool)
    assert after[0] == 0 and not any(after[1])
    return {"held": held, "after": after, **drained(side, eng, [req])}


def cancel_mid_decode(side, layout):
    eng = side.engine(kv_layout=layout)
    req = side.Request(uid=0, prompt=[5, 6, 7, 8], max_new_tokens=16)
    eng.add_request(req)
    for _ in range(6):
        eng.step()
        if req.output:
            break
    assert req.output and not req.done
    assert eng.cancel(0) and req.status == "cancelled"
    return drained(side, eng, [req])


def cancel_preempted_in_queue(side):
    eng = side.engine()
    req = side.Request(uid=0, prompt=[5, 6, 7], max_new_tokens=16)
    eng.add_request(req)
    for _ in range(4):
        eng.step()
        if req.output:
            break
    eng.scheduler.preempt(0)
    eng.pool.release(0)
    assert eng.scheduler.waiting and req.preemptions == 1
    assert eng.cancel(0) and req.status == "cancelled"
    return drained(side, eng, [req])


def cancel_cow_shared(side):
    eng = side.engine(kv_layout="paged", prefill_chunk=8)
    base = list(LONG) + [31] * 11     # 32 tokens = 2 full blocks
    first = side.Request(uid=0, prompt=base, max_new_tokens=4)
    eng.add_request(first)
    eng.run_until_done()
    pool = eng.pool
    cold0 = _blocks(pool)
    assert cold0[2]                   # the prefix went cold, published
    twin = side.Request(uid=1, prompt=list(base), max_new_tokens=4)
    eng.add_request(twin)
    eng.step()                        # admit: radix match + fresh blocks
    ps = next(p for p in eng.scheduler.prefilling if p.req.uid == 1)
    shared = (ps.written, pool._shared[ps.slot], len(pool.tables[ps.slot]),
              _blocks(pool))
    assert ps.written >= pool.block_size
    assert eng.cancel(1) and twin.status == "cancelled"
    assert _blocks(pool) == cold0     # the shares went back cold
    return {"cold": cold0, "shared": shared,
            **drained(side, eng, [first, twin])}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cancel_waiting(layout):
    replay(cancel_waiting, layout)


def test_cancel_unknown_or_terminal_returns_false():
    rec = replay(cancel_unknown_or_terminal)
    assert rec["unknown"] is False and rec["terminal"] is False


def test_cancel_mid_prefill_frees_blocks():
    assert replay(cancel_mid_prefill)["held"][0] > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cancel_active_mid_decode(layout):
    replay(cancel_mid_decode, layout)


def test_cancel_preempted_in_queue():
    replay(cancel_preempted_in_queue)


def test_cancel_cow_shared_releases_exact_blocks():
    rec = replay(cancel_cow_shared)
    assert rec["shared"][1] >= 1


# ---------------------------------------------------------------------------
# deadlines, queue age, the preemption budget
# ---------------------------------------------------------------------------

def deadline_in_queue(side):
    eng = side.engine()
    reqs = [side.Request(uid=0, prompt=[3, 4], max_new_tokens=4,
                         deadline_s=0.0),
            side.Request(uid=1, prompt=[5, 6], max_new_tokens=4)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    return drained(side, eng, reqs)


def queue_age_counts_only_queue_time(side):
    eng = side.engine()
    req = side.Request(uid=0, prompt=[3, 4, 5], max_new_tokens=6,
                       max_queue_s=30.0)
    eng.add_request(req)
    for _ in range(3):
        eng.step()
    assert req.output
    req.submit_time -= 100.0          # "queued" long ago
    eng.run_until_done()
    return drained(side, eng, [req])


def deadline_mid_flight(side, layout):
    eng = side.engine(kv_layout=layout, prefill_chunk=8)
    reqs = [side.Request(uid=0, prompt=[3, 4, 5], max_new_tokens=32,
                         deadline_s=30.0),
            side.Request(uid=1, prompt=list(LONG), max_new_tokens=8,
                         deadline_s=30.0)]
    for r in reqs:
        eng.add_request(r)
    eng.step()
    assert eng.scheduler.prefilling
    for r in reqs:
        r.submit_time -= 100.0
    eng.run_until_done()
    return drained(side, eng, reqs)


def preempt_within_budget(side, budget):
    eng = side.engine()
    req = side.Request(uid=0, prompt=[5, 6, 7], max_new_tokens=8,
                       max_preemptions=budget)
    eng.add_request(req)
    for _ in range(4):
        eng.step()
        if req.output:
            break
    eng.scheduler.preempt(0)
    eng.pool.release(0)
    requeued = bool(eng.scheduler.waiting)
    eng.run_until_done()
    return {"requeued": requeued, "preempted": req.preemptions,
            **drained(side, eng, [req])}


def pressure_storm(side):
    probe = side.engine()
    budget = probe.pool.bytes_per_token * 12
    eng = side.engine(kv_byte_budget=budget, degradation=False)
    reqs = [side.Request(uid=0, prompt=[3, 4, 5], max_new_tokens=16),
            side.Request(uid=1, prompt=[6, 7, 8], max_new_tokens=16,
                         max_preemptions=0)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    return drained(side, eng, reqs)


def test_deadline_expires_in_queue():
    rec = replay(deadline_in_queue)
    assert rec["requests"][0][1:] == ("deadline_exceeded", [])
    assert rec["requests"][1][1] == "finished"
    assert rec["deadline_expired"] == 1


def test_max_queue_s_only_counts_queue_time():
    assert replay(queue_age_counts_only_queue_time)["requests"][0][1] == \
        "finished"


@pytest.mark.parametrize("layout", LAYOUTS)
def test_deadline_expires_mid_flight(layout):
    rec = replay(deadline_mid_flight, layout)
    assert [r[1] for r in rec["requests"]] == ["deadline_exceeded"] * 2
    assert rec["deadline_expired"] == 2


@pytest.mark.parametrize("budget,status", [(2, "finished"), (0, "dropped")])
def test_preemption_budget(budget, status):
    rec = replay(preempt_within_budget, budget)
    assert rec["requests"][0][1] == status
    assert rec["requeued"] == (status == "finished")


def test_pressure_storm_drops_over_budget_stream():
    rec = replay(pressure_storm)
    assert [r[1] for r in rec["requests"]] == ["finished", "dropped"]
    assert len(rec["requests"][0][2]) == 16
