"""Units of the port's serve hardening against the reference's (pure
Python on both sides, no model on the reference's): FaultInjector
decisions, ClassedQueue, the class-ordered chunk plan, LoadShedder,
SLOTracker and ReplicaGuard; the watchdog sampler; the slot and paged
integrity oracles; and the port's ``kernel_gate`` (a raise, no fallback;
a per-step hook)."""
import pytest
import torch

from _torch_parity import port_tree, prompts, torch_cfg
from repro.serve import faults as jfaults
from repro.serve import guard as jguard
from repro.serve import router as jrouter
from repro.serve import scheduler as jsched
from repro_torch.configs.base import RunConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models.api import get_model
from repro_torch.serve import faults, guard, router, scheduler
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.pool import (IntegrityError, KVPoolManager,
                                    PagedKVPoolManager)

SPEC = dict(seed=3,
            rates={"pool_alloc": 0.3, "radix_match": 0.5, "nan_logits": 0.1,
                   "kernel_gate": 0.2},
            schedule={"block_scale": [2, 5], "slow_step": [1]},
            params={"nan_logits": {"seg": "decode", "slot": 1}},
            max_fires={"pool_alloc": 7, "radix_match": 100})


def _draws(inj, order):
    return [inj.fire(p) for p in order]


def _order(n=400):
    pts = faults.INJECTION_POINTS
    return [pts[(i * 7 + i // 3) % len(pts)] for i in range(n)]


# ---------------------------------------------------------------------------
# FaultInjector: the reference's decisions, draw for draw
# ---------------------------------------------------------------------------

def test_injection_points_are_the_references():
    assert faults.INJECTION_POINTS == jfaults.INJECTION_POINTS


@pytest.mark.parametrize("tag", [None, "replica0", "replica1"])
def test_decisions_equal_reference_for_one_spec(tag):
    mine, theirs = faults.FaultInjector(**SPEC), jfaults.FaultInjector(**SPEC)
    if tag is not None:
        mine, theirs = mine.split(tag), theirs.split(tag)
    order = _order()
    assert _draws(mine, order) == _draws(theirs, order)
    assert mine.report() == theirs.report()
    assert mine.calls == theirs.calls and mine.fired == theirs.fired
    assert mine.fired["pool_alloc"] == 7          # max_fires caps
    assert mine.param("nan_logits", "slot") == 1


def test_split_streams_are_independent_and_leave_the_parent():
    spec = dict(seed=3, rates={"pool_alloc": 0.5},
                max_fires={"pool_alloc": 100})
    parent = faults.FaultInjector(**spec)
    base = _draws(faults.FaultInjector(**spec), ["pool_alloc"] * 32)
    s0 = _draws(parent.split("replica0"), ["pool_alloc"] * 32)
    s1 = _draws(parent.split("replica1"), ["pool_alloc"] * 32)
    assert s0 != s1
    assert parent.fired["pool_alloc"] == 0
    assert _draws(parent, ["pool_alloc"] * 32) == base


def test_unknown_point_and_null_injector():
    with pytest.raises(ValueError):
        faults.FaultInjector(rates={"bogus": 1.0})
    with pytest.raises(ValueError):
        faults.FaultInjector().fire("bogus")
    assert not faults.NULL_INJECTOR.active
    assert not faults.NULL_INJECTOR.fire("pool_alloc")
    assert faults.NULL_INJECTOR.calls["pool_alloc"] == 0


# ---------------------------------------------------------------------------
# ClassedQueue, chunk_plan, LoadShedder, SLOTracker, ReplicaGuard
# ---------------------------------------------------------------------------

def test_statuses_and_priorities_are_the_references():
    assert scheduler.STATUSES == jsched.STATUSES
    assert scheduler.PRIORITIES == jsched.PRIORITIES


@pytest.mark.parametrize("aware", [True, False])
def test_classed_queue_orders_as_reference(aware):
    ops_seq = [("append", 0, "batch"), ("append", 1, "interactive"),
               ("append", 2, "batch"), ("appendleft", 3, "batch"),
               ("append", 4, "interactive"), ("pop",), ("remove", 2),
               ("append", 5, "interactive"), ("pop",)]
    out = []
    for mod in (scheduler, jsched):
        q, reqs, seen = mod.ClassedQueue(aware=aware), {}, []
        for op in ops_seq:
            if op[0] in ("append", "appendleft"):
                reqs[op[1]] = mod.Request(uid=op[1], prompt=[1],
                                          priority=op[2])
                getattr(q, op[0])(reqs[op[1]])
            elif op[0] == "pop":
                seen.append(q.popleft().uid)
            else:
                q.remove(reqs[op[1]])
        out.append((seen, [r.uid for r in q], q[0].uid, len(q),
                    q.count("interactive"), q.count("batch"), bool(q)))
    assert out[0] == out[1]


CHUNK_CASES = [
    # (streams (uid, prompt length, priority, written), active priorities,
    #  n_live, kwargs)
    ([(0, 16, "batch", 0), (1, 16, "interactive", 0)], [], 0, {}),
    ([(0, 32, "interactive", 0), (1, 32, "batch", 0)], ["interactive"], 1,
     dict(batch_share=0.25)),
    ([(0, 16, "interactive", 0), (1, 16, "interactive", 0),
      (2, 24, "interactive", 0)], [], 0, dict(step_token_budget=20)),
    ([(0, 11, "interactive", 8)], [], 0, {}),
    ([(0, 16, "batch", 0)], [], 0, dict(batch_share=0.0)),
    ([(0, 40, "batch", 0), (1, 9, "batch", 0), (2, 30, "interactive", 16)],
     ["batch", "interactive"], 2, dict(batch_share=0.5)),
]


@pytest.mark.parametrize("aware", [True, False])
@pytest.mark.parametrize("case", range(len(CHUNK_CASES)))
def test_chunk_plan_equals_reference(case, aware):
    streams, active, n_live, kw = CHUNK_CASES[case]
    kw = {"prefill_chunk": 8, "step_token_budget": 24, **kw}
    plans = []
    for mod in (scheduler, jsched):
        s = mod.Scheduler(2, priority_aware=aware, **kw)
        for uid, n, pri, written in streams:
            req = mod.Request(uid=uid, prompt=list(range(1, n + 1)),
                              priority=pri)
            s.prefilling.append(mod.PrefillStream(req=req, slot=0,
                                                  tokens=req.prompt,
                                                  written=written))
        s.active = [mod.Request(uid=100 + i, prompt=[1], priority=p)
                    for i, p in enumerate(active)] + [None] * 2
        s.active = s.active[:2]
        plans.append([(ps.req.uid, c) for ps, c in s.chunk_plan(n_live)])
    assert plans[0] == plans[1]
    assert plans[0] or not streams


def test_load_shedder_hysteresis_equals_reference():
    kw = dict(window=8, engage=0.5, disengage=0.125, budget_factor=0.5,
              min_engaged_steps=4)
    mine = scheduler.LoadShedder(scheduler.DegradationPolicy(**kw), 16)
    theirs = jsched.LoadShedder(jsched.DegradationPolicy(**kw), 16)
    bits = [True] * 4 + [False] * 14 + [True] + [False] * 3 + [True] * 6
    trace = [(mine.observe(b), mine.budget) for b in bits]
    assert trace == [(theirs.observe(b), theirs.budget) for b in bits]
    assert (mine.engage_count, mine.recover_count) == \
        (theirs.engage_count, theirs.recover_count) == (2, 1)
    assert scheduler.DegradationPolicy() == scheduler.DegradationPolicy(
        **vars(jsched.DegradationPolicy()))


def test_slo_tracker_equals_reference():
    pol = dict(slo_itl_ms=10.0, headroom=0.5, min_samples=4)
    mine = router.SLOTracker(router.SLOPolicy(**pol))
    theirs = jrouter.SLOTracker(jrouter.SLOPolicy(**pol))
    seq = [(20.0, 2), (20.0, 8), (7.0, 8), (4.0, 8), (3.0, 8), (12.0, 9),
           (1.0, 3)]
    got = [(mine.observe(*x), mine.batch_ok(*x)) for x in seq]
    assert got == [(theirs.observe(*x), theirs.batch_ok(*x)) for x in seq]
    assert mine.breaches == theirs.breaches == 2
    mine.idle_reset()
    assert not mine.engaged and mine.breaches == 2


class _Eng:
    quarantined = 0


@pytest.mark.parametrize("mod", [guard, jguard], ids=["port", "reference"])
def test_replica_guard_trips_once(mod):
    g, eng = mod.ReplicaGuard(), _Eng()
    assert g.healthy(eng)
    g.record_failure(RuntimeError("device lost"))
    assert not g.healthy(eng) and g.tripped == "step_failures"
    g2 = mod.ReplicaGuard(mod.ReplicaGuardPolicy(max_quarantined=2))
    eng.quarantined = 2
    assert not g2.healthy(eng) and g2.tripped == "quarantined_streams"
    eng.quarantined = 0
    assert not g2.healthy(eng)              # stays tripped


@pytest.mark.parametrize("poison", [float("nan"), float("inf"),
                                    -float("inf")])
def test_poisoned_row_flagged_neighbours_untouched(poison):
    logits = torch.randn(4, 32, generator=torch.Generator().manual_seed(3))
    temps = torch.tensor([0.0, 0.7, 0.0, 1.3])
    clean, _ = guard.sample_and_flag(logits, temps,
                                     torch.Generator().manual_seed(11))
    bad_logits = logits.clone()
    bad_logits[2, 5] = poison
    toks, bad = guard.sample_and_flag(bad_logits, temps,
                                      torch.Generator().manual_seed(11))
    assert bad.tolist() == [False, False, True, False]
    assert guard.nonfinite_rows(bad_logits).tolist() == bad.tolist()
    for row in (0, 1, 3):
        assert int(toks[row]) == int(clean[row])
    assert 0 <= int(toks[2]) < logits.shape[-1]


# ---------------------------------------------------------------------------
# Integrity oracles
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    return get_model(torch_cfg(), "cpu")


def test_slot_pool_oracle_catches_corruption(model):
    pool = KVPoolManager(model, 2, 64)
    assert pool.check_integrity()
    pool.allocate(0, 5, tokens=[1, 2, 3, 4, 5])
    pool.positions[0] = 5
    assert pool.check_integrity()
    pool.lengths[1] = 7
    with pytest.raises(IntegrityError, match="free slot 1"):
        pool.check_integrity()
    pool.lengths[1] = 0
    pool.positions[0] = 65
    with pytest.raises(IntegrityError, match="position 65 out of"):
        pool.check_integrity()
    pool.positions[0] = 5
    pool.allocate(1, 3)
    pool.tickets[1] = pool.tickets[0]
    with pytest.raises(IntegrityError, match="duplicate admission"):
        pool.check_integrity()


def test_paged_pool_oracle_catches_refcount_drift_and_leaks(model):
    pool = PagedKVPoolManager(model, 2, 64, block_size=16)
    toks = list(range(1, 20))
    pool.allocate(0, len(toks), tokens=toks)
    assert pool.check_integrity()
    pool.blocks.ref[pool.tables[0][0]] += 1
    with pytest.raises(IntegrityError, match="refcount mismatch"):
        pool.check_integrity()
    pool.blocks.ref[pool.tables[0][0]] -= 1
    pool.tables[0].append(pool.blocks.free[0])
    with pytest.raises(IntegrityError):
        pool.check_integrity()


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_pool_capacity_and_affinity(model, layout):
    if layout == "slot":
        pool = KVPoolManager(model, 2, 64)
        assert pool.capacity_bytes() == 2 * 64 * pool.bytes_per_token
        assert pool.prefix_affinity(list(range(1, 40))) == 0
        return
    pool = PagedKVPoolManager(model, 2, 64, block_size=16)
    assert pool.capacity_bytes() == pool.num_blocks * pool.bytes_per_block
    toks = list(range(1, 40))
    assert pool.prefix_affinity(toks) == 0
    pool.allocate(0, len(toks), tokens=toks)
    pool.positions[0] = 32
    pool.release(0)                          # publishes two full blocks
    assert pool.prefix_affinity(toks) == 32
    assert pool.prefix_affinity(toks[:20]) == 16


# ---------------------------------------------------------------------------
# kernel_gate: a raise before dispatch, a per-step hook
# ---------------------------------------------------------------------------

def _lowrank_args():
    g = torch.Generator().manual_seed(0)
    return (torch.randn(4, 32, generator=g), torch.randn(32, 8, generator=g),
            torch.randn(8, 16, generator=g))


def test_fired_gate_raises_before_the_plain_version(monkeypatch):
    ran = []
    monkeypatch.setattr(kref, "lowrank_matmul_ref",
                        lambda *a: ran.append(1) or torch.zeros(4, 16))
    with ops.fault_gate(faults.FaultInjector(rates={"kernel_gate": 1.0})):
        with pytest.raises(ops.KernelRejected) as e:
            ops.lowrank_matmul(*_lowrank_args())
    assert e.value.kernel == "lowrank_matmul" and not ran
    assert isinstance(e.value, RuntimeError)
    ops.lowrank_matmul(*_lowrank_args())     # cleared: inert
    assert ran == [1]


def test_gate_restores_the_previous_injector_on_exit():
    outer = faults.FaultInjector(rates={"kernel_gate": 0.0})
    with ops.fault_gate(outer):
        with pytest.raises(ops.KernelRejected):
            with ops.fault_gate(faults.FaultInjector(
                    schedule={"kernel_gate": [1]})):
                ops.branched_matmul(torch.zeros(2, 8), torch.zeros(2, 8, 4),
                                    torch.zeros(2, 4, 4),
                                    torch.zeros(2, 4, 8))
        ops.lowrank_matmul(*_lowrank_args())
    assert outer.calls["kernel_gate"] == 1
    assert ops.set_fault_injector(None) is None


def _engine(inj, **kw):
    return ServeEngine(RunConfig(model=torch_cfg()), port_tree("branched"),
                       device="cpu", slots=2, max_seq=64, prefill_chunk=8,
                       faults=inj, **kw)


def _serve(eng, lo=0, hi=3):
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts()[lo:hi])]
    for r in reqs:
        eng.add_request(r)
    return reqs


def test_engine_step_raises_and_the_gate_is_uninstalled():
    inj = faults.FaultInjector(schedule={"kernel_gate": [3]})
    eng = _engine(inj)
    _serve(eng)
    with pytest.raises(ops.KernelRejected):
        eng.run_until_done()
    assert inj.report() == {"kernel_gate": {"calls": 3, "fired": 1}}
    ops.lowrank_matmul(*_lowrank_args())     # the hook left with the step
    assert inj.calls["kernel_gate"] == 3


def test_two_engines_do_not_charge_each_others_injector():
    def fresh():
        return _engine(faults.FaultInjector(rates={"kernel_gate": 0.0}))
    alone = []
    for lo, hi in ((0, 3), (3, 6)):
        eng = fresh()
        _serve(eng, lo, hi)
        eng.run_until_done()
        alone.append(eng.faults.calls["kernel_gate"])
    a, b = fresh(), fresh()
    _serve(a, 0, 3)
    _serve(b, 3, 6)
    while a.scheduler.busy() or b.scheduler.busy():
        for e in (a, b):
            if e.scheduler.busy():
                e.step()
    assert [a.faults.calls["kernel_gate"],
            b.faults.calls["kernel_gate"]] == alone
    assert min(alone) > 0


def test_router_contains_a_rejected_kernel():
    rt = router.ServeRouter(RunConfig(model=torch_cfg()),
                            port_tree("branched"), devices=["cpu"],
                            slots=2, max_seq=64, prefill_chunk=8)
    rt.replicas[0].engine.faults = faults.FaultInjector(
        schedule={"kernel_gate": [2]})
    reqs = [Request(uid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(prompts()[:4])]
    for r in reqs:
        rt.add_request(r)
    rt.run_until_done()
    victim = rt.replicas[0]
    assert victim.guard.tripped == "step_failures" and victim.evacuated
    assert isinstance(victim.guard.last_error, ops.KernelRejected)
    assert all(r.status == "finished" for r in reqs)
    assert ops.set_fault_injector(None) is None
