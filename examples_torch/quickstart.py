"""Quickstart on the PyTorch port: decompose a small LM with the paper's
technique, fine-tune it briefly with the factors frozen, and watch the
loss fall.  The twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py          # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --cpu    # on the CPU
"""
import argparse

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import (LRDConfig, ParallelConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.core.surgery import decompose_model
from repro_torch.models.api import get_model
from repro_torch.train.data import ByteTextLM
from repro_torch.train.loop import train
from repro_torch.train.optim import OptimConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    cfg = registry.get("llama3.2-1b").smoke
    shape = ShapeConfig("quick", 64, 4, "train")

    # 1) the dense model
    model = get_model(cfg, device)
    params, axes = model.init(torch.Generator(device=device).manual_seed(0))
    n_dense = sum(v.numel() for v in _leaves(params))

    # 2) the paper's technique: truncated-SVD surgery at 2x compression,
    #    ranks aligned to hardware tiles (§2.1), factors frozen (§2.2)
    lrd = LRDConfig(enabled=True, compression=2.0, rank_mode="aligned",
                    rank_align=32, min_dim=48, freeze=True)
    with torch.no_grad():
        dec, _, report = decompose_model(params, axes, lrd)
    n_dec = sum(v.numel() for v in _leaves(dec))
    print(f"params: dense {n_dense:,} -> decomposed {n_dec:,} "
          f"({n_dec / n_dense:.2%})")
    for d in report.decisions[:6]:
        print(f"  {d.path:28s} {d.kind:5s} rank={d.rank} "
              f"{d.params_before:>9,d} -> {d.params_after:,d}")

    # 3) fine-tune the decomposed model (only the live factors train) on
    #    byte-level text (learnable structure, unlike random tokens)
    run = RunConfig(model=cfg, lrd=lrd, parallel=ParallelConfig(remat="none"))
    data = ByteTextLM(cfg, batch=shape.global_batch, seq_len=shape.seq_len)
    result = train(run, data, num_steps=30,
                   optim_cfg=OptimConfig(peak_lr=3e-3, warmup_steps=5,
                                         total_steps=30),
                   log_every=10, device=device)
    print(f"loss: {result.losses[0]:.3f} -> {result.losses[-1]:.3f} "
          f"(fine-tuning recovers the decomposition error); trainable "
          f"{result.stats['trainable_params']:,}, frozen "
          f"{result.stats['frozen_params']:,}")
    if not result.losses[-1] < result.losses[0]:
        raise SystemExit("the loss did not fall")
    return result


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    main()
