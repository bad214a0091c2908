"""The reference's router tests (``tests/test_serve_router.py``)
replayed on the port's ServeRouter and on the reference's over one smoke
tree: routing, prefix affinity, the SLO gate, failover, the
``throughput()`` key sets, and greedy streams equal across 1 and 2
replicas and to the reference router's.  Placement uses explicit
``devices`` (the CPU; the card test is in ``test_torch_gpu.py``), and
``examples_torch/serve_lm.py`` runs with two replicas and the injector."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

from _torch_parity import torch_threads
from _torch_serve_replay import PORT, REF, replay
from repro_torch.serve.scheduler import PRIORITIES
from repro_torch.tree import leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10], [11, 12, 13], [14, 15]]


@pytest.fixture(autouse=True)
def _threads():
    with torch_threads(1):
        yield


def _reqs(side, prompts, n=6, priority=None):
    return [side.Request(uid=i, prompt=list(p), max_new_tokens=n,
                         priority=priority or PRIORITIES[i % 2])
            for i, p in enumerate(prompts)]


def _streams(reqs):
    return {r.uid: (r.status, list(r.output)) for r in reqs}


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def routing(side):
    aware = side.router()
    for r in _reqs(side, PROMPTS[:4], priority="interactive"):
        aware.add_request(r)
    blind = side.router(priority_aware=False)
    for r in _reqs(side, PROMPTS[:4]):
        blind.add_request(r)
    with pytest.raises(ValueError, match="priority"):
        aware.add_request(side.Request(uid=9, prompt=[1],
                                       priority="realtime"))
    return {"aware": [dict(rep.routed) for rep in aware.replicas],
            "blind": [dict(rep.routed) for rep in blind.replicas]}


def test_least_pressure_and_round_robin_routing():
    rec = replay(routing)
    assert sorted(d["interactive"] for d in rec["aware"]) == [2, 2]
    assert [sum(d.values()) for d in rec["blind"]] == [2, 2]


def slo_gate(side):
    rt = side.router(slo_itl_ms=50.0)
    for r in _reqs(side, PROMPTS[:4], priority="interactive"):
        rt.add_request(r)
    held = side.Request(uid=9, prompt=[7, 8], max_new_tokens=4,
                        priority="batch")
    rt.add_request(held)
    first = [r.uid for r in rt.held]
    done = rt.run_until_done()
    assert held in done and held.status == "finished"
    return {"held": first, "after": rt.throughput()["held_batch"],
            "streams": _streams(done)}


def test_slo_gate_holds_batch_until_tail_measured():
    rec = replay(slo_gate)
    assert rec["held"] == [9] and rec["after"] == 0


def pressure_cap(side):
    rt = side.router(slo_itl_ms=50.0, batch_pressure_cap=0.5)
    free, gated = rt.replicas
    rt._submit(free, side.Request(uid=0, prompt=[1] * 50, max_new_tokens=8,
                                  priority="batch"))
    rt._submit(gated, side.Request(uid=1, prompt=[2, 3], max_new_tokens=4,
                                   priority="interactive"))
    probe = side.Request(uid=2, prompt=[4] * 8, max_new_tokens=8,
                         priority="batch")
    out = (rt._projected(free, probe), rt._projected(gated, probe),
           rt._pick(probe))
    return {"projected": out[:2], "picked": out[2],
            "done": sorted(r.uid for r in rt.run_until_done())}


def test_batch_pressure_cap_balances_held_drain():
    rec = replay(pressure_cap)
    assert rec["projected"][0] > 0.5 >= rec["projected"][1]
    assert rec["picked"] is None and rec["done"] == [0, 1]


def prefix_affinity(side):
    rt = side.router(kv_layout="paged", kv_block_size=16)
    shared = list(range(1, 21))
    first = side.Request(uid=0, prompt=shared + [30], max_new_tokens=4)
    rt.add_request(first)
    rt.run_until_done()
    warm = [rep.index for rep in rt.replicas
            if rep.engine.pool.prefix_affinity(shared) > 0]
    before = rt.replicas[warm[0]].routed["interactive"]
    rt.add_request(side.Request(uid=1, prompt=shared + [31],
                                max_new_tokens=4))
    return {"warm": warm,
            "routed": rt.replicas[warm[0]].routed["interactive"] - before}


def test_prefix_affinity_routes_to_warm_replica():
    rec = replay(prefix_affinity)
    assert len(rec["warm"]) == 1 and rec["routed"] == 1


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------

def failover(side, after_rounds):
    rt = side.router()
    reqs = _reqs(side, PROMPTS[:4], n=4, priority="interactive")
    for r in reqs:
        rt.add_request(r)
    for _ in range(after_rounds):
        rt.step()
    victim = rt.replicas[0]
    in_flight = victim.engine.scheduler.busy()
    victim.engine.step = lambda: (_ for _ in ()).throw(
        RuntimeError("injected device loss"))
    done = rt.run_until_done()
    assert victim.guard.tripped == "step_failures" and victim.evacuated
    assert {r.uid for r in done} == {r.uid for r in reqs}
    return {"in_flight": in_flight, "streams": _streams(reqs),
            "routed": [dict(rep.routed) for rep in rt.replicas]}


@pytest.mark.parametrize("after_rounds", [0, 2])
def test_failed_replica_work_finishes_elsewhere(after_rounds):
    rec = replay(failover, after_rounds)
    assert all(s == "finished" for s, _ in rec["streams"].values())
    assert rec["in_flight"]
    single = PORT.engine(debug=False)
    reqs = _reqs(PORT, PROMPTS[:4], n=4, priority="interactive")
    for r in reqs:
        single.add_request(r)
    single.run_until_done()
    assert _streams(reqs) == rec["streams"]


# ---------------------------------------------------------------------------
# stats and determinism
# ---------------------------------------------------------------------------

def test_throughput_key_sets_contain_the_references():
    keys = {}
    for side in (PORT, REF):
        rt = side.router(slo_itl_ms=50.0)
        empty = rt.throughput()
        for r in _reqs(side, PROMPTS[:4], n=4):
            rt.add_request(r)
        rt.run_until_done()
        full = rt.throughput()
        assert set(empty) == set(full)
        for e, f in zip(empty["per_replica"], full["per_replica"]):
            assert set(e) == set(f)
        keys[side.name] = (set(full), set(full["per_replica"][0]),
                           set(full["per_class"]),
                           set(full["per_class"]["batch"]),
                           set(rt.replicas[0].engine.throughput()))
    for mine, theirs in zip(keys["port"], keys["reference"]):
        assert mine >= theirs, theirs - mine
    assert {"decode_step_ms_mean", "latency"} <= keys["port"][4]
    for k in ("deadline_expired", "per_class", "slow_steps", "step_ewma_s"):
        assert k in keys["port"][4]


def test_service_time_itl_samples():
    eng = PORT.engine(debug=False)
    reqs = _reqs(PORT, PROMPTS[:2], n=5, priority="interactive")
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    ring = eng.class_itl["interactive"]
    assert len(ring) == sum(len(r.output) for r in reqs) - len(reqs)
    assert all(g >= 0.0 for g in ring) and max(ring) <= eng.service_s
    for r in reqs:
        key, mark = r.service_mark
        assert key == id(eng) and 0.0 < mark <= eng.service_s
    assert eng.class_stats("interactive")["itl_samples"] == len(ring)


def streams_by_replicas(side):
    outs = {}
    for n in (1, 2):
        rt = side.router(replicas=n, slo_itl_ms=50.0)
        reqs = _reqs(side, PROMPTS)
        for r in reqs:
            rt.add_request(r)
        rt.run_until_done()
        outs[n] = _streams(reqs)
    assert outs[1] == outs[2]
    return outs[2]


def test_streams_equal_across_replica_counts_and_reference_router():
    rec = replay(streams_by_replicas)
    assert all(s == "finished" and len(o) == 6 for s, o in rec.values())
    eng = PORT.engine(debug=False)
    reqs = _reqs(PORT, PROMPTS)
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert _streams(reqs) == rec


def test_replicas_on_one_device_share_the_tree():
    rt = PORT.router(devices=["cpu", "cpu"], quantize="int8",
                     kv_quantize="int8")
    a, b = (rep.engine for rep in rt.replicas)
    assert a.device == b.device == rt.replicas[0].engine.device
    assert "w0_q" in a.params["blocks"]["attn"]["k"]     # quantized once
    assert all(x is y for x, y in zip(leaves(a.params), leaves(b.params)))
    assert a.pool is not b.pool
    assert a.pool.cache["blocks"]["k_q"].data_ptr() != \
        b.pool.cache["blocks"]["k_q"].data_ptr()
    with pytest.raises(ValueError, match="devices="):
        PORT.router(device="cpu")


def test_serve_lm_example_replicas_and_injector():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / "serve_lm.py"),
         "--device", "cpu", "--replicas", "2", "--inject",
         "--kv-layout", "paged"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    statuses = re.findall(r"^req (\d+): status=(\w+)", out.stdout, re.M)
    assert [int(u) for u, _ in statuses] == list(range(6))
    assert all(s in PORT.STATUSES for _, s in statuses)
    assert re.findall(r"pool bytes after drain \(replica \d\): (\d+)",
                      out.stdout) == ["0", "0"]
    assert "fault report (replica 1)" in out.stdout
