"""Serving launcher (the twin of the reference's ``launch/serve.py``):
init (and decompose) a model, or restore it from a training checkpoint,
and serve a batch of synthetic requests through the continuous-batching
engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --smoke [--ckpt-dir DIR] [--requests 8] [--max-new 32] [--cpu]

It serves on the card; ``--cpu`` serves on the CPU.  Init draws from a
``torch.Generator`` seeded 0 and the prompts from a second one seeded 7,
where the reference splits ``PRNGKey(0)`` and ``PRNGKey(7)``: the same
lengths (3-8 tokens) and range, other values.  An encoder-only arch has
nothing to serve and is refused.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import LRDConfig, RunConfig
from repro_torch.core.surgery import decompose_model
from repro_torch.models.api import get_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import checkpoint as ckpt


def main(argv: list[str] | None = None) -> ServeEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.names())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--lrd", default="aligned",
                    choices=["none", "ratio", "aligned", "search"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from a training checkpoint")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    entry = registry.get(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    if not cfg.has_decode:
        raise SystemExit(f"{args.arch} is encoder-only: nothing to serve")
    model = get_model(cfg, device)
    with torch.no_grad():
        params, axes = model.init(
            torch.Generator(device=device).manual_seed(0))
        lrd = LRDConfig()
        if args.lrd != "none":
            lrd = LRDConfig(enabled=True, rank_mode=args.lrd,
                            min_dim=32 if args.smoke else 256)
            params, _, rep = decompose_model(params, axes, lrd)
            print(f"[lrd] {rep.summary()}")
    if args.ckpt_dir:
        got = ckpt.restore_latest(args.ckpt_dir, {"params": params})
        if got:
            params = got[0]["params"]
            print(f"[restore] step {got[1]['step']}")

    run = RunConfig(model=cfg, lrd=lrd, parallel=entry.parallel("decode"))
    eng = ServeEngine(run, params, slots=args.slots, max_seq=args.max_seq,
                      device=device)
    g = torch.Generator().manual_seed(7)
    for i in range(args.requests):
        n = 3 + int(torch.randint(0, 6, (), generator=g))
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
        eng.add_request(Request(uid=i, prompt=prompt,
                                max_new_tokens=args.max_new,
                                temperature=args.temperature))
    eng.run_until_done()
    print(f"[throughput] {eng.throughput()}")
    return eng


if __name__ == "__main__":
    main()
