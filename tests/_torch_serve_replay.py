"""Replays of the reference's serve-hardening tests on both packages: a
scenario is a function of a :class:`Side` (one package's engine, request,
injector and router types) that drives an engine and returns a record;
the tests hold the port's record equal to the reference engine's on the
same smoke tree (f32, ``branched``: SVD pairs and branched linears)."""
from __future__ import annotations

import dataclasses
import functools

from _torch_parity import jax_cfg, port_tree, port_tree_for_jax, torch_cfg
from repro.configs.base import ParallelConfig
from repro.configs.base import RunConfig as JRun
from repro.serve import engine as jengine
from repro.serve import faults as jfaults
from repro.serve import router as jrouter
from repro.serve import scheduler as jsched
from repro_torch.configs.base import RunConfig
from repro_torch.serve import engine as tengine
from repro_torch.serve import faults as tfaults
from repro_torch.serve import router as trouter
from repro_torch.serve import scheduler as tsched

TREE = "branched"
#: the reference tests' prompt of 21 tokens (three chunks of 8)
LONG = tuple((i * 7 + 3) % 50 + 1 for i in range(21))
LAYOUTS = ("slot", "paged")


@functools.lru_cache(maxsize=None)
def _jax_params():
    return port_tree_for_jax(TREE)


@dataclasses.dataclass
class Side:
    name: str
    Request: type
    FaultInjector: type
    STATUSES: tuple

    def engine(self, **kw):
        """An engine as the reference tests' ``_engine`` builds it: 2
        slots, max_seq 64, the integrity oracle every step."""
        kw.setdefault("slots", 2)
        kw.setdefault("max_seq", 64)
        kw.setdefault("debug", True)
        if kw.get("kv_layout") == "paged":
            kw.setdefault("kv_block_size", 16)
        if self.name == "port":
            return tengine.ServeEngine(RunConfig(model=torch_cfg()),
                                       port_tree(TREE), device="cpu", **kw)
        return jengine.ServeEngine(
            JRun(model=jax_cfg(), parallel=ParallelConfig()),
            _jax_params(), **kw)

    def router(self, **kw):
        kw.setdefault("replicas", 2)
        kw.setdefault("slots", 2)
        kw.setdefault("max_seq", 64)
        if self.name == "port":
            kw.setdefault("devices", ["cpu"])
            return trouter.ServeRouter(RunConfig(model=torch_cfg()),
                                       port_tree(TREE), **kw)
        return jrouter.ServeRouter(
            JRun(model=jax_cfg(), parallel=ParallelConfig()),
            _jax_params(), **kw)


PORT = Side("port", tsched.Request, tfaults.FaultInjector, tsched.STATUSES)
REF = Side("reference", jsched.Request, jfaults.FaultInjector,
           jsched.STATUSES)


def drained(side: Side, eng, reqs) -> dict:
    """The terminal-consistency contract of every chaos run, and the
    run's record: each request's status and output, the engine's
    hardening counters."""
    for r in reqs:
        assert r.done and r.status in side.STATUSES, (side.name, r.uid,
                                                      r.status)
    assert eng.pool.used_bytes() == 0
    assert eng.pool.check_integrity()
    assert not eng.scheduler.busy()
    return {"requests": [(r.uid, r.status, list(r.output)) for r in reqs],
            "quarantined": eng.quarantined,
            "deadline_expired": eng.deadline_expired,
            "preemptions": eng.scheduler.preemptions,
            "admit_failures": eng.scheduler.admit_failures}


def replay(scenario, *args, **kw) -> dict:
    """The scenario's record on both packages; asserts them equal."""
    mine = scenario(PORT, *args, **kw)
    theirs = scenario(REF, *args, **kw)
    assert mine == theirs
    return mine


def requests(side: Side, prompts, n: int = 4, **kw) -> list:
    """One greedy request of ``n`` new tokens a prompt, uids in order."""
    return [side.Request(uid=i, prompt=list(p), max_new_tokens=n, **kw)
            for i, p in enumerate(prompts)]


def serve(side: Side, eng, prompts, n: int, **kw) -> list:
    """Serve :func:`requests` to the end; returns them."""
    reqs = requests(side, prompts, n, **kw)
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    return reqs
