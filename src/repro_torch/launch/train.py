"""Training launcher (the twin of the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        [--smoke] [--steps N] [--lrd ratio|aligned|search|none] \
        [--compression 2.0] [--freeze] [--branches N] \
        [--ckpt-dir DIR] [--batch B] [--seq S] [--cpu]

It trains on the card; ``--cpu`` trains on the CPU (where the smoke
configs are the trainable ones).  The data follow the family, as the
reference's launcher chooses them: ``SyntheticImages`` for a ResNet,
``SyntheticLM`` on a ``ShapeConfig`` for the encoder, ``ByteTextLM``
otherwise, and for the VLM ``ByteTextLM`` with the random image
embeddings of ``models/api.py::synth_inputs`` beside its tokens (the
reference feeds the VLM ``ByteTextLM`` alone, and its loss then reads a
missing ``image_embeds``).  Init draws from a ``torch.Generator`` seeded
with the run's seed, where the reference splits ``PRNGKey(seed)``.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import registry
from repro_torch.configs.base import LRDConfig, RunConfig, ShapeConfig
from repro_torch.train.data import (ByteTextLM, SyntheticImages, SyntheticLM,
                                    WithImageEmbeds)
from repro_torch.train.fault_tolerance import (PreemptionHandler,
                                               run_with_restart)
from repro_torch.train.loop import train
from repro_torch.train.optim import OptimConfig


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.names())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lrd", default="aligned",
                    choices=["none", "ratio", "aligned", "search"])
    ap.add_argument("--compression", type=float, default=2.0)
    ap.add_argument("--freeze", action="store_true")
    ap.add_argument("--branches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    entry = registry.get(args.arch)
    cfg = entry.smoke if args.smoke else entry.full
    lrd = (LRDConfig() if args.lrd == "none" else
           LRDConfig(enabled=True, rank_mode=args.lrd,
                     compression=args.compression, freeze=args.freeze,
                     branches=args.branches,
                     min_dim=32 if args.smoke else 256))
    parallel = entry.parallel("train")
    if args.smoke:
        parallel = dataclasses.replace(parallel, fsdp=False,
                                       seq_shard=False, remat="none")
    run = RunConfig(model=cfg, lrd=lrd, parallel=parallel)

    if cfg.family == "resnet":
        data = SyntheticImages(cfg, batch=args.batch)
    elif cfg.family == "encoder":
        data = SyntheticLM(cfg, ShapeConfig("t", args.seq, args.batch,
                                            "train"))
    else:
        data = ByteTextLM(cfg, batch=args.batch, seq_len=args.seq,
                          path=args.corpus)
        if cfg.family == "vlm":
            data = WithImageEmbeds(data, cfg)
    ocfg = OptimConfig(peak_lr=args.lr, warmup_steps=max(1, args.steps // 10),
                       total_steps=args.steps)

    def attempt(i: int):
        with PreemptionHandler() as p:
            r = train(run, data, num_steps=args.steps, optim_cfg=ocfg,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      preemption=p, log_every=10, device=device)
        return {"result": r}

    out = run_with_restart(attempt, max_restarts=args.max_restarts)
    r = out["result"]
    print(f"[done] step={r.step} loss={r.losses[-1]:.4f} "
          f"restarts={out['restarts']} "
          f"stragglers={r.straggler_report['stragglers']}")
    return out


if __name__ == "__main__":
    main()
