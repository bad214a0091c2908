"""Serve an LRD-compressed LM with continuous batching on the PyTorch
port.  The twin of ``examples/serve_lm.py``, with the same flags.

    PYTHONPATH=src python examples_torch/serve_lm.py [--device cpu]
        [--kv-layout {slot,paged}] [--replicas N]
        [--priority {interactive,batch}] [--deadline-s S] [--inject]

It serves on the CUDA card by default, on the CPU with ``--device cpu``.
``--kv-layout paged`` serves from the paged KV pool (blocks behind
per-slot tables and a radix prefix cache): the two requests below that
share a prompt prefix store its blocks once.  ``--replicas N`` (N > 1)
serves through the :class:`repro_torch.serve.router.ServeRouter` (N
replicas on the one device: least-KV-pressure routing, priority classes,
SLO-aware batch admission).  ``--priority`` tags every request with one
class (default: alternate).  ``--deadline-s`` gives every request a
wall-clock deadline (``deadline_exceeded`` when it passes).  ``--inject``
turns on the seeded fault injector (allocation failures and NaN logits):
every request still ends with an explicit status and the pool drains.
"""
import argparse

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import LRDConfig, ParallelConfig, RunConfig
from repro_torch.core.surgery import decompose_model
from repro_torch.models.api import get_model
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--kv-layout", choices=["slot", "paged"],
                    default="slot",
                    help="KV pool memory layout (paged = block tables + "
                         "copy-on-write prefix sharing)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline; expired "
                         "requests end with status=deadline_exceeded")
    ap.add_argument("--inject", action="store_true",
                    help="enable the seeded fault injector (allocation "
                         "failures + NaN logits)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="N > 1 serves through the ServeRouter")
    ap.add_argument("--priority", choices=["interactive", "batch"],
                    default=None,
                    help="priority class of every request (default: "
                         "alternate between the two)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = registry.get("llama3.2-1b").smoke
    model = get_model(cfg, device)
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))

    # compress with the paper's technique before serving
    lrd = LRDConfig(enabled=True, compression=2.0, rank_mode="aligned",
                    rank_align=32, min_dim=48)
    with torch.no_grad():
        params, _, report = decompose_model(params, axes, lrd)
    print(f"serving a {report.summary()['param_ratio']:.0%}-size model")

    run = RunConfig(model=cfg, lrd=lrd, parallel=ParallelConfig())
    faults = None
    if args.inject:
        from repro_torch.serve.faults import FaultInjector
        faults = FaultInjector(
            seed=7,
            rates={"pool_alloc": 0.1, "nan_logits": 0.05},
            params={"nan_logits": {"seg": "decode", "slot": 0}},
            max_fires={"pool_alloc": 3, "nan_logits": 1})
    if args.replicas > 1:
        from repro_torch.serve.router import ServeRouter
        eng = ServeRouter(run, params, replicas=args.replicas,
                          devices=[device], slots=4, max_seq=128,
                          kv_layout=args.kv_layout, faults=faults)
    else:
        eng = ServeEngine(run, params, slots=4, max_seq=128,
                          kv_layout=args.kv_layout, faults=faults,
                          device=device)

    shared = list(range(1, 20))   # > one KV block: paged requests share it
    prompts = [shared + [30], shared + [31, 32], [6, 7, 8, 9], [10],
               [11, 12], [13, 14, 15]]
    classes = ["interactive", "batch"]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=16,
                    temperature=0.0 if i % 2 == 0 else 0.8,
                    deadline_s=args.deadline_s,
                    priority=args.priority or classes[i % 2])
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    for r in reqs:
        print(f"req {r.uid}: status={r.status} class={r.priority} "
              f"prompt={r.prompt} -> {r.output}")
    print("throughput:", eng.throughput())
    engines = ([rep.engine for rep in eng.replicas] if args.replicas > 1
               else [eng])
    if args.replicas > 1:
        for pri in classes:
            print(f"class {pri}:", eng.class_stats(pri))
    for i, e in enumerate(engines):
        tag = f" (replica {i})" if args.replicas > 1 else ""
        if args.inject:
            print(f"fault report{tag}:", e.faults.report())
        if args.kv_layout == "paged":
            print(f"prefix cache{tag}:", e.pool.prefix_stats())
        print(f"pool bytes after drain{tag}: {e.pool.used_bytes()}")


if __name__ == "__main__":
    main()
