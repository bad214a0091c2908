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

It runs on the card unless the caller passes ``device="cpu"``.  Every
step ends in a host read of the loss, so a step's host time is the
card's time for it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.core import freezing
from repro_torch.models.api import get_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import steps as steps_mod
from repro_torch.train.data import DataState
from repro_torch.train.fault_tolerance import (PreemptionHandler,
                                               StragglerDetector)
from repro_torch.train.optim import OptimConfig, optimizer_state_bytes

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


def train(run: RunConfig, data, *, num_steps: int,
          optim_cfg: OptimConfig | None = None, mesh=None,
          ckpt_dir: str | None = None, ckpt_every: int = 0,
          resume: bool = True, log_every: int = 10,
          decompose: bool = True,
          fault_hook: Callable[[int], None] | None = None,
          preemption: PreemptionHandler | None = None,
          log_fn: Callable[[str], None] = print,
          device: str | torch.device = "cuda") -> TrainResult:
    steps_mod._no_mesh(mesh)
    device = torch.device(device)
    model = get_model(run.model, device)
    optim_cfg = optim_cfg or OptimConfig(total_steps=num_steps)
    freeze = run.lrd.freeze and run.lrd.enabled

    # ---- init params (+ LRD surgery, + freezing) --------------------------
    with torch.no_grad():
        params, axes = model.init(
            torch.Generator(device=device).manual_seed(run.seed))
        if decompose and run.lrd.enabled:
            from repro_torch.core.surgery import decompose_model
            params, axes, report = decompose_model(params, axes, run.lrd)
            log_fn(f"[lrd] {report.summary()}")
    freezing.set_requires_grad(params, freeze=freeze)
    opt_state = steps_mod.init_opt_state(model, run, params, optim_cfg)
    data_state = DataState()
    mask = freezing.trainable_mask(params, enabled=freeze)

    # ---- resume ------------------------------------------------------------
    resumed_from = None
    if ckpt_dir and resume:
        template = {"params": params, "opt": opt_state,
                    "data": data_state.to_dict()}
        got = ckpt.restore_latest(ckpt_dir, template)
        if got is not None:
            tree, manifest = got
            params, opt_state = tree["params"], tree["opt"]
            data_state = DataState.from_dict(tree["data"])
            resumed_from = manifest["step"]
            log_fn(f"[resume] step {resumed_from}")

    train_step = steps_mod.make_train_step(model, run, optim_cfg)
    writer = ckpt.AsyncCheckpointer(ckpt_dir) if (ckpt_dir and ckpt_every) \
        else None
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
            want_ckpt = writer and (done % ckpt_every == 0
                                    or done == num_steps)
            if preemption is not None and preemption.preempted:
                log_fn(f"[preempt] checkpointing at step {done} and exiting")
                want_ckpt = writer is not None
            if want_ckpt:
                writer.save(done, {"params": params, "opt": opt_state,
                                   "data": data_state.to_dict()},
                            meta={"loss": loss})
            if preemption is not None and preemption.preempted:
                break
    finally:
        if writer:
            writer.close()

    stats = {"step_seconds": step_seconds,
             "trainable_params": freezing.trainable_param_count(params, mask),
             "frozen_params": freezing.frozen_param_count(params, mask),
             "optimizer_state_bytes": optimizer_state_bytes(opt_state)}
    return TrainResult(step=step + 1, metrics=metrics, losses=losses,
                       straggler_report=detector.report(),
                       resumed_from=resumed_from, stats=stats)
