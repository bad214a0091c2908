"""The training loop: model + surgery + freezing, checkpoints, fault
tolerance.

``train()`` is the entry the examples and tests use.  It:

1. builds the model on ``device`` from ``run.seed``, runs LRD surgery and
   applies the §2.2 freeze (``core/freezing.py``),
2. auto-resumes from the latest valid checkpoint (``resume=True``),
3. steps the data pipeline with an explicit cursor,
4. checkpoints asynchronously every ``ckpt_every`` (atomic commits),
5. honours preemption (checkpoint now, exit), tracks stragglers,
6. optionally crashes on cue (``fault_hook``) for the restart tests.

``params`` (the port's addition) starts from a tree the caller built
(already decomposed, on ``device``; updated in place) instead of step
1's init and surgery.  It runs on the card unless the caller passes
``device="cpu"``.  Every step ends in a host read of the loss, so a
step's host time is the card's time for it.

With a ``mesh`` (a ``DeviceMesh`` over ``pod`` / ``data`` / ``model``,
every rank calling with the same arguments) the tree is placed by
``make_param_shardings`` (reference ``train/loop.py:64-68``): each rank
keeps its shards of the parameters, of their AdamW moments and of their
EF-PowerSGD error buffers; a caller's ``params`` comes placed already.
A checkpoint is written from the gathered tree by
rank 0 and placed again on restore.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import RunConfig
from repro_torch.core import freezing
from repro_torch.models.api import get_model
from repro_torch.parallel import placement
from repro_torch.parallel.sharding import (install_activation_rules,
                                          make_param_shardings)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import steps as steps_mod
from repro_torch.train.data import DataState
from repro_torch.train.fault_tolerance import (PreemptionHandler,
                                               StragglerDetector)
from repro_torch.train.optim import OptimConfig, optimizer_state_bytes
from repro_torch.tree import tree_map

PyTree = Any


@dataclasses.dataclass
class TrainResult:
    step: int
    metrics: dict
    losses: list[float]
    straggler_report: dict
    resumed_from: int | None = None
    #: the port's own accounting: ``step_seconds`` (host time of each
    #: step, ending in the loss read), ``trainable_params`` /
    #: ``frozen_params`` (by the optimizer mask), ``optimizer_state_bytes``
    stats: dict = dataclasses.field(default_factory=dict)


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _per_param(fn: Callable, state: PyTree, params: PyTree) -> PyTree:
    """``fn(tensor, placed param)`` on every shard of ``state`` laid out
    as its parameter (an AdamW moment, an EF error buffer); empty
    buffers (frozen leaves, uncompressed ones) and the whole Qs stay."""
    def node(p, n):
        if isinstance(n, dict):
            return {k: fn(v, p) if k == "err" and v.numel() else v
                    for k, v in n.items()}
        return fn(n, p) if n.numel() else n
    return tree_map(node, params, state)


def _opt_map(fn: Callable, opt_state: dict, params: PyTree) -> dict:
    """:func:`_per_param` over the moments and the EF state."""
    adam = opt_state["adam"]
    out = {"adam": {"step": adam["step"],
                    "m": _per_param(fn, adam["m"], params),
                    "v": _per_param(fn, adam["v"], params)}}
    if "ef" in opt_state:
        out["ef"] = _per_param(fn, opt_state["ef"], params)
    return out


def _whole_leaf(t: torch.Tensor, p) -> torch.Tensor:
    return placement.whole(placement.like(t, p))


def _shard_leaf(t: torch.Tensor, p) -> torch.Tensor:
    return placement.shard_of(t, p.spec, p.mesh)


def train(run: RunConfig, data, *, num_steps: int,
          optim_cfg: OptimConfig | None = None, mesh=None,
          ckpt_dir: str | None = None, ckpt_every: int = 0,
          resume: bool = True, log_every: int = 10,
          decompose: bool = True,
          fault_hook: Callable[[int], None] | None = None,
          preemption: PreemptionHandler | None = None,
          log_fn: Callable[[str], None] = print,
          device: str | torch.device = "cuda",
          params: PyTree | None = None) -> TrainResult:
    device = torch.device(device)
    model = get_model(run.model, device)
    optim_cfg = optim_cfg or OptimConfig(total_steps=num_steps)
    freeze = run.lrd.freeze and run.lrd.enabled

    # ---- init params (+ LRD surgery, + freezing) --------------------------
    axes = None
    with torch.no_grad():
        if params is None:
            params, axes = model.init(
                torch.Generator(device=device).manual_seed(run.seed))
            if decompose and run.lrd.enabled:
                from repro_torch.core.surgery import decompose_model
                params, axes, report = decompose_model(params, axes,
                                                       run.lrd)
                log_fn(f"[lrd] {report.summary()}")

    # ---- shardings ---------------------------------------------------------
    if mesh is not None:
        install_activation_rules(mesh, run.parallel)
        if not placement.is_placed(params):
            if axes is None:
                raise ValueError("with a mesh, params= comes placed "
                                 "(parallel/placement.py::place)")
            params = placement.place(params, make_param_shardings(
                mesh, params, axes, run.parallel))
    tensors = placement.shards(params) if mesh is not None else params
    freezing.set_requires_grad(tensors, freeze=freeze)
    opt_state = steps_mod.init_opt_state(model, run, params, optim_cfg)
    data_state = DataState()
    mask = freezing.trainable_mask(tensors, enabled=freeze)

    def whole_tree():
        """The params and the optimizer state whole (every rank gathers;
        as they are without a mesh)."""
        if mesh is None:
            return params, opt_state
        return (placement.whole(params),
                _opt_map(_whole_leaf, opt_state, params))

    # ---- resume ------------------------------------------------------------
    resumed_from = None
    if ckpt_dir and resume:
        w_params, w_opt = whole_tree()
        template = {"params": w_params, "opt": w_opt,
                    "data": data_state.to_dict()}
        got = ckpt.restore_latest(ckpt_dir, template)
        if got is not None:
            tree, manifest = got
            if mesh is None:
                params, opt_state = tree["params"], tree["opt"]
            else:                      # placed again, as before the restore
                opt_state = _opt_map(_shard_leaf, tree["opt"], params)
                params = placement.like(
                    tree_map(_shard_leaf, tree["params"], params), params)
                tensors = placement.shards(params)
                freezing.set_requires_grad(tensors, freeze=freeze)
            data_state = DataState.from_dict(tree["data"])
            resumed_from = manifest["step"]
            log_fn(f"[resume] step {resumed_from}")
        del w_params, w_opt, template

    train_step = steps_mod.make_train_step(model, run, optim_cfg, mesh)
    saving = bool(ckpt_dir and ckpt_every)
    writer = (ckpt.AsyncCheckpointer(ckpt_dir)
              if saving and (mesh is None or dist.get_rank() == 0) else None)
    detector = StragglerDetector()
    losses: list[float] = []
    step_seconds: list[float] = []
    metrics: dict = {}
    stream = data.stream(data_state)

    start = int(opt_state["adam"]["step"])
    step = start
    try:
        for step in range(start, num_steps):
            if fault_hook is not None:
                fault_hook(step)
            batch, data_state = next(stream)
            batch = _on(batch, device)
            detector.start()
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
            step_seconds.append(time.perf_counter() - t0)
            detector.stop(step)
            losses.append(loss)
            if log_every and (step % log_every == 0 or step == num_steps - 1):
                log_fn(f"[train] step={step + 1} loss={loss:.4f} "
                       f"lr={float(metrics['lr']):.2e}")
            done = step + 1
            want_ckpt = saving and (done % ckpt_every == 0
                                    or done == num_steps)
            if preemption is not None and preemption.preempted:
                log_fn(f"[preempt] checkpointing at step {done} and exiting")
                want_ckpt = saving
            if want_ckpt:
                w_params, w_opt = whole_tree()
                if writer is not None:
                    writer.save(done, {"params": w_params, "opt": w_opt,
                                       "data": data_state.to_dict()},
                                meta={"loss": loss})
                del w_params, w_opt
            if preemption is not None and preemption.preempted:
                break
    finally:
        if writer:
            writer.close()
        if mesh is not None:
            dist.barrier()         # rank 0's checkpoint is on disk

    counted = placement.meta_view(params) if mesh is not None else params
    stats = {"step_seconds": step_seconds,
             "trainable_params": freezing.trainable_param_count(counted,
                                                                mask),
             "frozen_params": freezing.frozen_param_count(counted, mask),
             "optimizer_state_bytes": optimizer_state_bytes(opt_state)}
    if mesh is not None:
        stats["param_shard_bytes"] = placement.shard_bytes(params)
    return TrainResult(step=step + 1, metrics=metrics, losses=losses,
                       straggler_report=detector.report(),
                       resumed_from=resumed_from, stats=stats)
