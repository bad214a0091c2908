"""Shared fixtures of the port's parity tests: the reference's smoke
model trees (dense, SVD, SVD+branched; f32), built with the JAX package
and bridged into the port as CPU tensors.

f32 model dtype: the parity tests compare whole greedy token streams, so
bf16 near-ties must not decide them.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np

from repro.configs import registry as jreg
from repro.configs.base import LRDConfig as JLRD
from repro.core.surgery import decompose_model as jdecompose
from repro.models.api import get_model as jget_model
from repro_torch import bridge
from repro_torch.configs import registry as treg

#: LRD settings of the three smoke trees.  "branched" mixes SVD pairs
#: (k/v) and branched linears (q/o/gate/up/down) on the smoke widths.
TREE_LRD = {
    "dense": None,
    "svd": dict(enabled=True, rank_mode="ratio", min_dim=32),
    "branched": dict(enabled=True, rank_mode="aligned", rank_align=8,
                     min_dim=32, branches=2),
}


def jax_cfg():
    return dataclasses.replace(jreg.get("llama3.2-1b").smoke,
                               dtype="float32")


def torch_cfg():
    return dataclasses.replace(treg.get("llama3.2-1b").smoke,
                               dtype="float32")


@functools.lru_cache(maxsize=None)
def jax_tree(name: str):
    """(params, axes) of one smoke tree in the reference package."""
    params, axes = jget_model(jax_cfg()).init(jax.random.PRNGKey(0))
    if TREE_LRD[name] is not None:
        params, axes, _ = jdecompose(params, axes, JLRD(**TREE_LRD[name]))
    return params, axes


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def torch_tree(name: str):
    """The same smoke tree bridged into the port (CPU tensors)."""
    return bridge.to_torch(to_numpy(jax_tree(name)[0]), "cpu")


def prompts(seed: int = 0, lengths=(3, 9, 17, 5, 12, 21), vocab: int = 250):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lengths]


def flat(tree, prefix=()):
    """A nested-dict tree as ``{"a/b/c": leaf}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, (*prefix, k)))
        return out
    return {"/".join(prefix): tree}
