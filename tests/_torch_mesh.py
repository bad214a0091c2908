"""Two-rank runs of the port on the CPU for the mesh tests.

:func:`run_ranks` spawns the ranks (``torch.multiprocessing``); each joins
a gloo group through a ``FileStore`` in a temporary directory (no port is
opened, nothing leaves the machine), runs one scenario of this module
with one torch thread and writes what it measured with ``torch.save``.
This module imports torch and ``repro_torch`` only, so the spawned ranks
never import JAX.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.configs.base import LRDConfig, ParallelConfig, RunConfig
from repro_torch.core import freezing
from repro_torch.core.surgery import decompose_model
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import get_model
from repro_torch.parallel import placement
from repro_torch.parallel import sharding as shd
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import optim, steps
from repro_torch.train.data import ByteTextLM
from repro_torch.train.loop import train
from repro_torch.tree import map_with_path, paths

#: the smoke trees of the train cases: the test files' LRD (branches=2
#: at rank_align 8, so some linears branch and the rest take SVD pairs)
TRAIN_LRD = dict(enabled=True, rank_mode="aligned", rank_align=8,
                 min_dim=32, branches=2)
OCFG = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
BATCH, SEQ = 4, 16
STEPS = 2
AXES3 = ("pod", "data", "model")


def run_ranks(scenario: str, payload, world: int = 2) -> list:
    """``scenario(payload)`` on ``world`` spawned ranks; each rank's
    result, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world, tmp, scenario, payload), nprocs=world,
                 join=True)
        return [torch.load(os.path.join(tmp, f"out{r}.pt"),
                           weights_only=False) for r in range(world)]


def _rank(rank: int, world: int, tmp: str, scenario: str, payload) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        out = globals()[scenario](payload)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def f32_cfg():
    return dataclasses.replace(registry.get("llama3.2-1b").smoke,
                               dtype="float32")


def train_run(freeze: bool, **parallel) -> RunConfig:
    return RunConfig(model=f32_cfg(), lrd=LRDConfig(freeze=freeze,
                                                    **TRAIN_LRD),
                     parallel=ParallelConfig(**parallel))


def smoke_tree(run: RunConfig):
    """(params, axes): the port's f32 smoke llama, seed 0, decomposed by
    ``run.lrd``, requires_grad set by its freeze."""
    model = get_model(run.model, "cpu")
    params, axes = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        params, axes, _ = decompose_model(params, axes, run.lrd)
    freezing.set_requires_grad(params, freeze=run.lrd.freeze)
    return params, axes


def batches() -> list[dict]:
    data = ByteTextLM(f32_cfg(), batch=BATCH, seq_len=SEQ)
    return [{"tokens": torch.from_numpy(data.batch(i)["tokens"])}
            for i in range(STEPS)]


def steps_of(run: RunConfig, mesh=None) -> dict:
    """:data:`STEPS` train steps of the smoke tree, placed on ``mesh``
    where given: the losses, the whole params after them, this rank's
    stored bytes and the bytes its placements imply."""
    model = get_model(run.model, "cpu")
    params, axes = smoke_tree(run)
    whole_bytes = sum(t.numel() * t.element_size() for _, t in paths(params))
    implied = None
    if mesh is not None:
        shardings = shd.make_param_shardings(mesh, params, axes, run.parallel)
        sizes = shd.mesh_shape(mesh)
        implied = 0
        for (_, t), (_, s) in zip(paths(params), paths(shardings)):
            split = 1
            for entry in s.spec:
                for ax in (entry if isinstance(entry, tuple)
                           else (entry,) if entry else ()):
                    split *= sizes[ax]
            implied += t.numel() // split * t.element_size()
        params = placement.place(params, shardings)
    ocfg = optim.OptimConfig(**OCFG)
    state = steps.init_opt_state(model, run, params, ocfg)
    step = steps.make_train_step(model, run, ocfg, mesh)
    losses = []
    for b in batches():
        params, state, met = step(params, state, b)
        losses.append(float(met["loss"]))
    stored = (placement.shard_bytes(params) if mesh is not None
              else whole_bytes)
    whole = placement.whole(params) if mesh is not None else params
    return {"losses": losses, "params": _detached(whole),
            "stored_bytes": stored, "implied_bytes": implied,
            "whole_bytes": whole_bytes}


def _detached(tree):
    return map_with_path(lambda _, t: t.detach().clone(), tree)


# ---------------------------------------------------------------------------
# scenarios (run on every rank)
# ---------------------------------------------------------------------------

def train_cases(payload: dict) -> dict:
    """(a) data parallel on (1, 2, 1); (b) (1, 1, 2) under FSDP with the
    vocab sharded; (c) multi-pod EF-PowerSGD on (2, 1, 1), from the
    error-feedback Qs in ``payload["q"]``; (d) a checkpoint written on a
    (1, 2, 1) FSDP mesh, resumed."""
    out = {}
    out["dp"] = steps_of(train_run(True),
                         make_mesh((1, 2, 1), AXES3))
    out["fsdp"] = steps_of(train_run(True, fsdp=True, shard_vocab=True),
                           make_mesh((1, 1, 2), AXES3))
    out["pod"] = pod_sync(payload["q"])
    out["ckpt"] = resumed(payload["ckpt_dir"])
    return out


def pod_sync(qs: dict) -> dict:
    """One multi-pod EF-PowerSGD sync on (2, 1, 1): this pod's gradients
    before it, the synced gradients and the new EF state."""
    run = train_run(False, multi_pod=True, grad_compression_rank=2)
    mesh = make_mesh((2, 1, 1), AXES3)
    model = get_model(run.model, "cpu")
    params, axes = smoke_tree(run)
    params = placement.place(params, shd.make_param_shardings(
        mesh, params, axes, run.parallel))
    state = steps.init_opt_state(model, run, params,
                                 optim.OptimConfig(**OCFG))
    for path, q in qs.items():
        node = state["ef"]
        for k in path.split("/"):
            node = node[k]
        node["q"] = torch.from_numpy(q)
    batch = batches()[0]
    loss_fn = steps.make_loss_fn(model, run)
    _, _, local = steps.value_and_grad(
        lambda t, b: loss_fn(placement.like(t, params), b),
        placement.shards(params), placement.local_rows(batch, mesh))
    loss, _, synced, ef = steps.make_synced_grads(model, run, mesh)(
        params, state, batch)
    return {"local": _detached(local), "synced": _detached(synced),
            "ef": _detached(ef), "loss": float(loss),
            "pod": mesh.get_local_rank("pod")}


def resumed(ckpt_dir: str) -> dict:
    """``train()`` on a (1, 2, 1) FSDP mesh: 3 steps straight, then 2
    steps with a checkpoint each and a third after a resume."""
    run = train_run(True, fsdp=True)
    mesh = make_mesh((1, 2, 1), AXES3)
    data = ByteTextLM(run.model, batch=BATCH, seq_len=SEQ)
    kw = dict(optim_cfg=optim.OptimConfig(**OCFG), mesh=mesh, log_every=0,
              device="cpu", log_fn=lambda _: None)
    straight = train(run, data, num_steps=3, **kw)
    first = train(run, data, num_steps=2, ckpt_dir=ckpt_dir, ckpt_every=1,
                  **kw)
    again = train(run, data, num_steps=3, ckpt_dir=ckpt_dir, ckpt_every=1,
                  **kw)
    return {"straight": straight.losses, "first": first.losses,
            "again": again.losses, "resumed_from": again.resumed_from,
            "shard_bytes": again.stats["param_shard_bytes"]}


def serve_case(payload: dict) -> dict:
    """The bridged quantized tree placed on a (1, 2) ("data", "model")
    mesh and served by the port's engine on the CPU."""
    mesh = make_mesh((1, 2), ("data", "model"))
    params = bridge.to_torch(payload["params"], "cpu")
    run = RunConfig(model=payload["cfg"], lrd=LRDConfig(),
                    parallel=ParallelConfig())
    shardings = shd.make_param_shardings(mesh, params, payload["axes"],
                                         run.parallel)
    placed = placement.place(params, shardings)
    del params
    eng = ServeEngine(run, placed, device="cpu", **payload["engine"])
    reqs = [Request(uid=i, prompt=p, max_new_tokens=payload["new"])
            for i, p in enumerate(payload["prompts"])]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    specs = {"/".join(p): s.spec for p, s in paths(shardings)}
    return {"outputs": [r.output for r in reqs],
            "status": [r.status for r in reqs],
            "plan_summary": eng.plan_summary, "specs": specs,
            "shard_bytes": placement.shard_bytes(placed),
            "local_shapes": {"/".join(p): tuple(v.local.shape)
                             for p, v in paths(placed)}}


def q_paths(ef_tree) -> dict[str, np.ndarray]:
    """``{path: q}`` of an EF state tree (numpy)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict) and "err" in node:
            if "q" in node:
                out["/".join(prefix)] = np.asarray(node["q"],
                                                   dtype=np.float32)
            return
        for k, v in node.items():
            walk(v, (*prefix, k))
    walk(ef_tree, ())
    return out
