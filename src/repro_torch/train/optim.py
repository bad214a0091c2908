"""AdamW with parameter masks — the paper's §2.2 freezing.

Written as plain tensor ops, not ``torch.optim.AdamW``: the reference's
masked update (frozen leaves keep *zero-size* moment buffers and are
left as they are), its global-norm clipping over every gradient and its
decoupled weight decay.  The update runs in f32 on the leaves' device
and writes the parameters and moments in place (a training step keeps
one copy of each); the step count is a 0-d int32 tensor there too, so a
step never waits on the host.  A gradient leaf may be ``None`` (a factor
the forward detached): it counts as zero.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0


def lr_schedule(cfg: OptimConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.peak_lr * warm * frac


def _moment_like(p: torch.Tensor, trainable: bool) -> torch.Tensor:
    if trainable:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return torch.zeros((0,), dtype=torch.float32, device=p.device)


def adamw_init(params: PyTree, mask: PyTree | None = None) -> dict:
    if mask is None:
        mask = tree_map(lambda _: True, params)
    device = leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(_moment_like, params, mask),
            "v": tree_map(_moment_like, params, mask)}


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (``None`` leaves
    count as zero)."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in leaves(tree) if x is not None]
    return torch.sqrt(torch.stack(sq).sum())


@torch.no_grad()
def adamw_update(grads: PyTree, state: dict, params: PyTree,
                 cfg: OptimConfig, mask: PyTree | None = None,
                 gnorm: torch.Tensor | None = None
                 ) -> tuple[PyTree, dict, dict]:
    """Returns ``(params, new_state, metrics)``; the parameters and the
    moments are updated in place.  ``gnorm``: the clip's global norm
    where the caller has it (shards summed over a mesh), else
    :func:`global_norm` of ``grads``."""
    if mask is None:
        mask = tree_map(lambda _: True, params)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(b1, step.to(torch.float32))
    c2 = 1 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, m, v, trainable):
        if not trainable:
            return
        g = (torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             if g is None else g.to(torch.float32) * scale)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        pf = p.to(torch.float32)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)

    tree_map(upd, params, grads, state["m"], state["v"], mask)
    return params, {"step": step, "m": state["m"], "v": state["v"]}, \
        {"lr": lr, "grad_norm": gnorm}


def optimizer_state_bytes(state: dict) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(state))
