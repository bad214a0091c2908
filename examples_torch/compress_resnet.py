"""The paper's full pipeline end to end on a ResNet, on the PyTorch port:
decompose with each of the four acceleration techniques, fine-tune
briefly, report the Table-3-style comparison.  The twin of
``examples/compress_resnet.py``.

    PYTHONPATH=src python examples_torch/compress_resnet.py [--full]
        [--device cpu] [--steps N]

It runs on the card by default (``--device cpu`` for the CPU); the fc of
the SVD-pair variants runs the B1 chain kernel there.  The default config
is the smoke ResNet; ``--full`` takes resnet50, where the
``layer_branching`` variant (``branches=2`` on every target) branches
eight 1x1 convs: their branched ``{u, xc, v}`` subtrees have no conv
path, and its fine-tune stops at ``apply_conv``'s ValueError naming the
first of them (the reference stops there too, at a ``KeyError: 'core'``;
ROADMAP §C).
"""
import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import LRDConfig, RunConfig
from repro_torch.core import freezing
from repro_torch.core.surgery import decompose_model
from repro_torch.models.resnet import ResNetModel, merge_bottleneck
from repro_torch.train.data import SyntheticImages
from repro_torch.train.optim import OptimConfig
from repro_torch.train.steps import init_opt_state, make_train_step
from repro_torch.tree import leaves, tree_map


def finetune(m, params, data, steps=5, freeze=False):
    """``steps`` masked-AdamW steps on a copy of ``params``; returns the
    tuned copy and the losses."""
    run = RunConfig(model=m.cfg, lrd=LRDConfig(enabled=True, freeze=freeze))
    cfg = OptimConfig(peak_lr=1e-3, warmup_steps=1, total_steps=steps)
    params = tree_map(lambda t: t.detach().clone(), params)
    freezing.set_requires_grad(params, freeze=freeze)
    state = init_opt_state(m, run, params, cfg)
    step = make_train_step(m, run, cfg)
    losses = []
    for i in range(steps):
        batch = {k: v.to(m.device) for k, v in data.batch(i).items()}
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    return params, losses


def variants(params, axes, min_dim=8):
    """The paper's Table 3 rows as (tree, freeze): one surgery each."""
    def lrd(**kw):
        return LRDConfig(**{**dict(enabled=True, compression=2.0,
                                   rank_mode="ratio", min_dim=min_dim), **kw})
    with torch.no_grad():
        vanilla = decompose_model(params, axes, lrd())[0]
        searched = decompose_model(params, axes, lrd(rank_mode="search"))[0]
        cores = decompose_model(params, axes, lrd(targets=("conv",)))[0]
        branched = decompose_model(params, axes, lrd(compression=1.0001,
                                                     branches=2))[0]
    return {"vanilla_lrd": (vanilla, False),
            "optimized_ranks": (searched, False),
            "layer_freezing": (vanilla, True),
            "layer_merging": (merge_bottleneck(cores), False),
            "layer_branching": (branched, False)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="use the resnet50 full config (its layer_branching "
                    "variant stops at the branched-1x1 refusal)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)

    entry = registry.get("resnet50")
    cfg = entry.full if args.full else entry.smoke
    m = ResNetModel(cfg, args.device)
    params, axes = m.init(torch.Generator(device=args.device).manual_seed(0))
    data = SyntheticImages(cfg, batch=4)

    n0 = sum(t.numel() for t in leaves(params))
    print(f"{'variant':18s} {'layers':>6s} {'params':>10s} {'dP%':>7s} "
          f"{'ft loss[0]->[-1]':>18s} {'ft s/step':>9s}")
    _, l0 = finetune(m, params, data, steps=args.steps)
    print(f"{'original':18s} {m.layer_count(params):>6d} {n0:>10,d} "
          f"{0.0:>6.1f}% {l0[0]:>8.3f} -> {l0[-1]:.3f}")
    for name, (tree, freeze) in variants(params, axes).items():
        n = sum(t.numel() for t in leaves(tree))
        t0 = time.perf_counter()
        _, losses = finetune(m, tree, data, steps=args.steps, freeze=freeze)
        dt = (time.perf_counter() - t0) / args.steps
        print(f"{name:18s} {m.layer_count(tree):>6d} {n:>10,d} "
              f"{100 * (n / n0 - 1):>6.1f}% {losses[0]:>8.3f} -> "
              f"{losses[-1]:.3f} {dt:>8.2f}s")


if __name__ == "__main__":
    main()
