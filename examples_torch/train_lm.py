"""End-to-end training on the PyTorch port: train a ~100M-param LM for a
few hundred steps with the full stack — LRD surgery, masked AdamW,
checkpoints with auto-resume, straggler detection, preemption handling.
The twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 200] [--dense] [--cpu]

Checkpoints go to ``--ckpt-dir`` (default ``build/train_lm`` in the
checkout, which git ignores).
"""
import argparse
from pathlib import Path

from repro_torch.configs.base import (LRDConfig, ModelConfig, ParallelConfig,
                                      RunConfig)
from repro_torch.train.data import ByteTextLM
from repro_torch.train.fault_tolerance import PreemptionHandler
from repro_torch.train.loop import train
from repro_torch.train.optim import OptimConfig

# ~100M params: 10L x 640d x 2560ff, byte-level vocab
CFG = ModelConfig(name="lm100m", family="dense", num_layers=10,
                  d_model=640, num_heads=10, num_kv_heads=5, head_dim=64,
                  d_ff=2560, vocab_size=256, dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--dense", action="store_true",
                    help="skip LRD (dense baseline)")
    ap.add_argument("--ckpt-dir", default=str(
        Path(__file__).resolve().parents[1] / "build" / "train_lm"))
    ap.add_argument("--corpus", default=None, help="path to a text file")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    lrd = LRDConfig() if args.dense else LRDConfig(
        enabled=True, compression=2.0, rank_mode="aligned", rank_align=64,
        min_dim=256, freeze=True)
    run = RunConfig(model=CFG, lrd=lrd,
                    parallel=ParallelConfig(remat="none"))
    data = ByteTextLM(CFG, batch=args.batch, seq_len=args.seq,
                      path=args.corpus)
    with PreemptionHandler() as p:
        result = train(run, data, num_steps=args.steps,
                       optim_cfg=OptimConfig(peak_lr=1e-3, warmup_steps=20,
                                             total_steps=args.steps),
                       ckpt_dir=args.ckpt_dir, ckpt_every=50,
                       preemption=p, log_every=20,
                       device="cpu" if args.cpu else "cuda")
    print(f"done at step {result.step}; final loss "
          f"{result.losses[-1]:.4f}; trainable "
          f"{result.stats['trainable_params'] / 1e6:.1f}M, frozen "
          f"{result.stats['frozen_params'] / 1e6:.1f}M; stragglers: "
          f"{result.straggler_report['stragglers']}")
    return result


if __name__ == "__main__":
    main()
