"""Multi-pod dry run: trace every (arch x shape x mesh) cell at full width
on a fake process group, without a card.

The reference lowers and compiles each cell for 512 placeholder host
devices and reads XLA's memory analysis and HLO.  The port has neither:
rank 0 of a fake process group (``torch.testing._internal.distributed.
fake_pg``) of the production mesh's size (256, or 512 with
``--multi-pod``) builds ``launch/mesh.py::make_production_mesh`` and runs
the cell under ``FakeTensorMode`` with fake CPU tensors: init and surgery
at full width, ``make_param_shardings`` and placement, then one call of
the step -- ``make_train_step(..., mesh)`` for ``train``, the prefill
step (the forward step for an encoder) for ``prefill``, the decode step
for ``decode`` -- counted by :class:`repro_torch.analysis.roofline.
StepCounter` and watched by ``MemTracker``.  No value is computed, no
collective moves a byte and the card is never touched: every tensor is
made on ``"cpu"``, so a kernel entry point takes its plain version.

Worker mode (one cell)::

    python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod] [--rank-mode ratio|aligned|none] \\
        [--branches N] [--freeze] [--shard-rank] [--out cell.json]

Sweep mode (all cells, a subprocess per cell, resumable)::

    python -m repro_torch.launch.dryrun --sweep \\
        --out-dir results/dryrun_torch [--multi-pod] [--jobs 4]

Each cell records the counter's per-device FLOPs, HBM bytes and
collective bytes (by kind, and what the kernel entry points were
charged), the roofline terms and bottleneck, peak bytes per device
(``MemTracker``) against the card's HBM, the surgery summary, the
sharding notes, the step's trace time (``trace_s``; the reference's
``lower_s`` / ``compile_s``) and whether CUDA was initialised.

The activations split over ``(pod, data)`` only, and every rank gathers
each block's leaves at use (``parallel/placement.py``): the counted
FLOPs per device are those of this rank's rows through the whole model.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.hw_specs import DEFAULT as HW
from repro_torch.configs import registry
from repro_torch.configs.base import (LRDConfig, RunConfig, SHAPES,
                                      applicable_shapes, skip_reason)

#: where every tensor of a cell lives (fake): never the card
DEVICE = "cpu"
#: sharding notes kept per cell
NOTES_KEPT = 20


def build_lrd(args) -> LRDConfig:
    if args.rank_mode == "none":
        return LRDConfig(enabled=False)
    return LRDConfig(enabled=True, compression=args.compression,
                     rank_mode=args.rank_mode, branches=args.branches,
                     freeze=args.freeze, rank_align=args.rank_align)


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks, this process rank 0, for the
    block (collectives return at once and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_name(multi_pod: bool) -> str:
    return "multi_pod" if multi_pod else "single_pod"


def _local_rows(spec, sharding, data_size: int) -> tuple[int, ...]:
    """This rank's shape of an input split (or not) by ``sharding``."""
    if sharding.spec and sharding.spec[0] is not None:
        return (spec.shape[0] // data_size, *spec.shape[1:])
    return tuple(spec.shape)


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def model_flops(cfg, shape) -> float:
    """The step's useful FLOPs over the global batch (the reference's
    ``dryrun.py:183-192``): 6 N a training token, 2 N a prefill token,
    2 N a decoded token."""
    if shape.kind == "train":
        return cfg.flops_per_token() * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return cfg.flops_per_token() / 3.0 * shape.global_batch \
            * shape.seq_len
    return cfg.flops_per_token() / 3.0 * shape.global_batch


def _trace(cfg, shape, run: RunConfig, mesh, notes: list[str]) -> dict:
    """Build one cell's placed tree, inputs and state (fake tensors: the
    caller holds the fake mode) and count one call of its step."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.core import freezing
    from repro_torch.models.api import get_model, input_specs
    from repro_torch.parallel import placement
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import steps as steps_mod
    from repro_torch.train.optim import OptimConfig
    from repro_torch.tree import leaves
    lrd, parallel = run.lrd, run.parallel
    model = get_model(cfg, DEVICE)
    surgery = None
    with torch.no_grad():
        params, axes = model.init(torch.Generator(DEVICE).manual_seed(0))
        if lrd.enabled:
            from repro_torch.core.surgery import decompose_model
            params, axes, report = decompose_model(params, axes, lrd,
                                                   m_tokens=shape.seq_len)
            surgery = report.summary()
        placed = placement.place(params, shd.make_param_shardings(
            mesh, params, axes, parallel, notes))
    del params
    specs = input_specs(cfg, shape)
    in_shd = shd.input_shardings(mesh, specs, parallel)
    data_size = shd._data_size(mesh)

    def inputs(local: bool) -> dict:
        return {k: torch.zeros(_local_rows(s, in_shd[k], data_size)
                               if local else s.shape, dtype=s.dtype,
                               device=DEVICE)
                for k, s in specs.items()}
    held = list(leaves(placement.shards(placed)))
    if shape.kind == "train":
        freezing.set_requires_grad(placement.shards(placed),
                                   freeze=lrd.freeze and lrd.enabled)
        opt_state = steps_mod.init_opt_state(model, run, placed,
                                             OptimConfig())
        step = steps_mod.make_train_step(model, run, OptimConfig(), mesh)
        batch = inputs(local=False)        # the step takes its own rows
        args = (placed, opt_state, batch)
        held += [t for t in leaves(opt_state) if isinstance(t, torch.Tensor)]
    else:
        batch = inputs(local=True)
        b_local = next(iter(batch.values())).shape[0]
        if shape.kind == "prefill" and not cfg.has_decode:
            step = steps_mod.make_forward_step(model, run)
            args = (placed, batch)
        else:
            cache = model.init_cache(b_local, shape.seq_len)
            held += list(leaves(cache))
            if shape.kind == "prefill":
                step = steps_mod.make_prefill_step(model, run)
                args = (placed, batch, cache)
            else:
                step = steps_mod.make_decode_step(model, run)
                args = (placed, batch["tokens"], batch["positions"], cache)
    held += list(batch.values())
    tracker = MemTracker()
    tracker.track_external(*held)
    t0 = time.time()
    with tracker, rl.StepCounter() as counter:
        step(*args)
    trace_s = time.time() - t0
    peak = max(v["Total"] for v in
               tracker.get_tracker_snapshot("peak").values())
    return {"costs": counter.costs, "surgery": surgery, "trace_s": trace_s,
            "argument_bytes": _storage_bytes(held), "peak_bytes": peak}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             lrd: LRDConfig, shard_rank: bool = False,
             seq_shard: bool | None = None,
             remat: str | None = None,
             moe_groups: int | None = None,
             fsdp: bool | None = None,
             grad_accum: int | None = None) -> dict:
    """Trace one cell on a fake process group of the production mesh's
    size (none may be initialised already) and return its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding as shd

    t_start = time.time()
    entry = registry.get(arch)
    cfg = entry.full
    if moe_groups is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch_groups=moe_groups)
    shape = SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name,
            "mesh": _mesh_name(multi_pod)}
    reason = skip_reason(cfg, shape)
    if reason:
        return {**head, "status": "skip", "reason": reason}

    parallel = entry.parallel(shape.kind)
    parallel = dataclasses.replace(
        parallel, multi_pod=multi_pod, shard_rank=shard_rank,
        **({"seq_shard": seq_shard} if seq_shard is not None else {}),
        **({"fsdp": fsdp} if fsdp is not None else {}),
        **({"grad_accum": grad_accum} if grad_accum is not None else {}),
        **({"remat": remat} if remat is not None else {}))
    run = RunConfig(model=cfg, lrd=lrd, parallel=parallel)
    n_devices = 512 if multi_pod else 256
    notes: list[str] = []
    with fake_world(n_devices):
        # the mesh reads its rank map: it is made outside the fake mode
        mesh = make_production_mesh(multi_pod=multi_pod)
        shd.install_activation_rules(mesh, parallel)
        try:
            with FakeTensorMode():
                traced = _trace(cfg, shape, run, mesh, notes)
        finally:
            shd.clear_activation_rules()
    costs = traced["costs"]
    roof = rl.roofline(costs, n_devices=n_devices,
                       model_flops_global=model_flops(cfg, shape), spec=HW)
    return {
        **head, "status": "ok", "n_devices": n_devices,
        "trace_s": round(traced["trace_s"], 2),
        "memory": {"argument_bytes": traced["argument_bytes"],
                   "peak_bytes": traced["peak_bytes"],
                   "fits_hbm": traced["peak_bytes"] < HW.hbm_bytes},
        "costs": {
            "flops_per_device": costs.flops,
            "hbm_bytes_per_device": costs.hbm_bytes,
            "collective_bytes_per_device": costs.collective_bytes,
            "collective_detail": costs.collective_detail,
            "collective_groups": costs.collective_groups,
            "kernel_detail": {k: {"calls": n, "flops": f, "bytes": b}
                              for k, (n, f, b)
                              in costs.kernel_detail.items()},
        },
        "roofline": {
            "compute_s": roof.compute_s,
            "memory_s": roof.memory_s,
            "collective_s": roof.collective_s,
            "step_s": roof.step_s,
            "bottleneck": roof.bottleneck,
            "model_flops_per_device": roof.model_flops,
            "useful_flops_ratio": roof.useful_ratio,
            "roofline_fraction": roof.roofline_fraction,
        },
        "surgery": traced["surgery"],
        "sharding_notes": notes[:NOTES_KEPT],
        "total_s": round(time.time() - t_start, 2),
        "cuda_initialized": torch.cuda.is_initialized(),
    }


# ---------------------------------------------------------------------------
# The sweep: every cell in its own process
# ---------------------------------------------------------------------------

def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in registry.assigned_names():
        cfg = registry.get(arch).full
        for shape in applicable_shapes(cfg):
            cells.append((arch, shape.name))
        for shape in SHAPES.values():
            if skip_reason(cfg, shape):
                cells.append((arch, shape.name))   # recorded as skip
    return cells


def sweep(args) -> int:
    os.makedirs(args.out_dir, exist_ok=True)
    cells = all_cells()
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    jobs: list[tuple[str, str, bool, str]] = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
            if args.tag_suffix:
                tag += f"__{args.tag_suffix}"
            out = os.path.join(args.out_dir, tag + ".json")
            if os.path.exists(out) and not args.force:
                continue
            jobs.append((arch, shape, mp, out))
    print(f"[sweep] {len(jobs)} cells to run "
          f"({len(cells) * len(meshes)} total)")
    running: list[tuple[subprocess.Popen, str]] = []
    failed = 0

    def drain(block: bool):
        nonlocal failed
        done = []
        for proc, out in running:
            if proc.poll() is None and not block:
                continue
            proc.wait()
            done.append((proc, out))
            ok = proc.returncode == 0 and os.path.exists(out)
            status = "?"
            if ok:
                with open(out) as f:
                    status = json.load(f).get("status")
            else:
                failed += 1
            print(f"[sweep] {out}: rc={proc.returncode} status={status}",
                  flush=True)
        for d in done:
            running.remove(d)

    for arch, shape, mp, out in jobs:
        while len(running) >= args.jobs:
            drain(block=False)
            time.sleep(1)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", out,
               "--rank-mode", args.rank_mode,
               "--compression", str(args.compression),
               "--rank-align", str(args.rank_align),
               "--branches", str(args.branches)]
        if mp:
            cmd.append("--multi-pod")
        if args.freeze:
            cmd.append("--freeze")
        if args.shard_rank:
            cmd.append("--shard-rank")
        env = dict(os.environ)
        env["PYTHONPATH"] = env.get("PYTHONPATH", "src")
        proc = subprocess.Popen(cmd, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE)
        running.append((proc, out))
        print(f"[sweep] launched {out}", flush=True)
    while running:
        drain(block=True)
    return failed


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--rank-mode", default="ratio",
                    choices=["none", "ratio", "aligned", "search"])
    ap.add_argument("--compression", type=float, default=2.0)
    ap.add_argument("--rank-align", type=int, default=128)
    ap.add_argument("--branches", type=int, default=1)
    ap.add_argument("--freeze", action="store_true")
    ap.add_argument("--shard-rank", action="store_true")
    ap.add_argument("--seq-shard", type=int, default=-1,
                    help="-1 keep arch default; 0/1 override")
    ap.add_argument("--moe-groups", type=int, default=-1,
                    help="-1 keep config; N = hierarchical dispatch groups")
    ap.add_argument("--fsdp", type=int, default=-1,
                    help="-1 keep config; 0/1 override")
    ap.add_argument("--grad-accum", type=int, default=-1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--tag-suffix", default="")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.sweep:
        sys.exit(1 if sweep(args) else 0)

    try:
        result = run_cell(
            args.arch, args.shape, multi_pod=args.multi_pod,
            lrd=build_lrd(args), shard_rank=args.shard_rank,
            seq_shard=None if args.seq_shard < 0 else bool(args.seq_shard),
            remat=args.remat,
            moe_groups=None if args.moe_groups < 0 else args.moe_groups,
            fsdp=None if args.fsdp < 0 else bool(args.fsdp),
            grad_accum=None if args.grad_accum < 0 else args.grad_accum)
    except Exception:
        result = {"arch": args.arch, "shape": args.shape,
                  "mesh": _mesh_name(args.multi_pod),
                  "status": "error", "error": traceback.format_exc(),
                  "cuda_initialized": torch.cuda.is_initialized()}
    out = json.dumps(result, indent=2, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    print(out if len(out) < 8000 else out[:8000])
    if result["status"] == "error":
        sys.exit(1)


if __name__ == "__main__":
    main()
