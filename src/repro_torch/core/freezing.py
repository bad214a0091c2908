"""Layer freezing — paper §2.2.

The decomposed factors are computed from the teacher's weights, so they
are near-optimal transforms already; freezing all but one factor per
decomposed layer removes their gradient and optimizer-state cost during
fine-tuning while leaving inference untouched.

As in the reference, freezing is realized twice:

* **forward**: :func:`stop_frozen_factors` detaches the frozen factor of
  every decomposed linear (``w0`` of an SVD pair, ``u`` / ``v`` of a
  branched one: the reference's ``lax.stop_gradient`` at the apply seam,
  ``repro/layers/plan.py:206``).  A detached factor does not require
  grad, so the chain kernels' backward (``kernels/autograd.py``) forms no
  cotangent for it.
  :func:`set_requires_grad` gives those factors ``requires_grad=False``
  and every other float leaf ``True``.
* **optimizer**: :func:`trainable_mask` marks the frozen leaves by name,
  so AdamW keeps no moments for them and leaves them as they are
  (``train/optim.py``).

The mask is the reference's, key for key: a leaf is frozen when any key
on its path is in :data:`FROZEN_LEAVES`.  That also freezes every leaf
under an attention ``v`` projection (its path holds the key ``"v"``),
whose factors the forward policy leaves live; the port keeps the
reference's behaviour, so such a leaf gets a gradient (it counts in the
global norm) and no update.
"""
from __future__ import annotations

from typing import Any

from repro_torch.tree import leaves, map_with_path, tree_map

PyTree = Any

# Leaf names considered "teacher-derived transforms" per decomposition kind.
FROZEN_LEAVES = {
    "w0",          # SVD pair: first factor (U sqrt(S))
    "u", "v",      # branched: per-branch outer factors (cores stay live)
    "tucker_u", "tucker_v",  # conv Tucker 1x1 factors
}

#: the factors the forward stops, per kind of linear subtree (the
#: reference's ``_KIND_FROZEN``, ``repro/layers/plan.py:88-94``)
_KIND_FROZEN = {"lowrank": frozenset({"w0"}),
                "branched": frozenset({"u", "v"})}


def trainable_mask(params: PyTree, *, enabled: bool = True) -> PyTree:
    """Boolean tree: True = trainable, False = frozen (paper §2.2)."""
    return map_with_path(
        lambda path, leaf: not (enabled and set(path) & FROZEN_LEAVES),
        params)


def frozen_param_count(params: PyTree, mask: PyTree) -> int:
    return sum(leaves(tree_map(lambda p, m: 0 if m else p.numel(), params,
                               mask)))


def trainable_param_count(params: PyTree, mask: PyTree) -> int:
    return sum(leaves(tree_map(lambda p, m: p.numel() if m else 0, params,
                               mask)))


def _frozen_factors(p: dict) -> frozenset:
    """The factors the forward stops in one linear subtree."""
    from repro_torch.layers.plan import build_plan
    return _KIND_FROZEN.get(build_plan(p).kind, frozenset())


def stop_frozen_factors(params: PyTree) -> PyTree:
    """The tree with the frozen factor of every decomposed linear
    detached (views, no copy): the forward half of the freeze policy."""
    from repro_torch.layers.plan import is_linear_subtree
    if is_linear_subtree(params):
        frozen = _frozen_factors(params)
        return {k: v.detach() if k in frozen else v
                for k, v in params.items()}
    if isinstance(params, dict):
        return {k: stop_frozen_factors(v) for k, v in params.items()}
    return params


def set_requires_grad(params: PyTree, *, freeze: bool) -> PyTree:
    """``requires_grad`` in place on every float leaf, except, with
    ``freeze``, the factors :func:`stop_frozen_factors` detaches; returns
    ``params``."""
    from repro_torch.layers.plan import is_linear_subtree
    if isinstance(params, dict):
        frozen = (_frozen_factors(params)
                  if freeze and is_linear_subtree(params) else frozenset())
        for k, v in params.items():
            if isinstance(v, dict):
                set_requires_grad(v, freeze=freeze)
            else:
                v.requires_grad_(v.is_floating_point() and k not in frozen)
    return params
