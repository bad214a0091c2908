"""Shared fixtures of the port's parity tests: the smoke model trees
(dense, SVD, SVD+branched; f32) on both sides — built with the JAX
package and bridged into the port (:func:`jax_tree` /
:func:`torch_tree`), or built with the port and bridged into the JAX
package (:func:`port_tree` / :func:`port_tree_for_jax`, for the serve
tests whose time the JAX init and surgery would dominate).  Either way
both packages run on one tree.  The 2:4 tests also share bit-for-bit
comparison (:func:`assert_same`) and factor-like weights
(:func:`factor_weights`).

f32 model dtype: the parity tests compare whole greedy token streams, so
bf16 near-ties must not decide them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import numpy as np

from repro.configs import registry as jreg
from repro.configs.base import LRDConfig as JLRD
from repro.core.surgery import decompose_model as jdecompose
from repro.models.api import get_model as jget_model
import jax.numpy as jnp
import torch

from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.core.surgery import decompose_model as tdecompose
from repro_torch.models.api import get_model as tget_model

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


@functools.lru_cache(maxsize=None)
def port_tree(name: str):
    """One smoke tree built by the port (CPU tensors, seed 0): the port's
    init and surgery with :data:`TREE_LRD`."""
    params, axes = tget_model(torch_cfg(), "cpu").init(
        torch.Generator().manual_seed(0))
    if TREE_LRD[name] is not None:
        params, axes, _ = tdecompose(params, axes, TLRD(**TREE_LRD[name]))
    return params


def port_tree_for_jax(name: str):
    """The same tree as the reference package's arrays."""
    return jax.tree.map(jnp.asarray, bridge.to_numpy(port_tree(name)))


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


# ---------------------------------------------------------------------------
# MLA stacks
# ---------------------------------------------------------------------------

#: the reference cache-plan tests' dense MLA stack (``MLA_CFG`` of
#: tests/test_cache_plan.py): no query LoRA (``q_lora_rank = 0``)
MLA_TINY = dict(name="mla-dense-tiny", family="dense", mla=True,
                num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                d_ff=64, vocab_size=64, q_lora_rank=0, kv_lora_rank=16,
                qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
                dtype="float32")
MLA_CFG_NAMES = ("mla-tiny", "deepseek-smoke")

#: LRD of the decomposed MLA trees: o, the FFN and the unembed branched
#: (N = 2) under the default targets; "svd+branched" targets kv_b too,
#: which becomes an SVD pair.  (The reference's absorbed decode reads a
#: decomposed kv_b's plain factors, so it cannot serve that tree with
#: int8 factors; the int8 cases take "branched".)
_MLA_BRANCHED = dict(enabled=True, rank_mode="aligned", rank_align=4,
                     min_dim=16, branches=2)
MLA_LRD = {
    "dense": None,
    "branched": _MLA_BRANCHED,
    "svd+branched": dict(_MLA_BRANCHED,
                         targets=(*TLRD().targets, "mla_kvb")),
}


def mla_cfg(name: str, side: str):
    """One of the MLA test configs (f32) in the reference's (``side`` =
    "jax") or the port's ("torch") ModelConfig: ``mla-tiny``, or
    DeepSeek-V2's smoke config served without experts (``q_lora_rank =
    32``).  ``moe_first_dense`` goes to 0 with the experts: the
    reference's dense-family cache tree holds ``num_layers -
    moe_first_dense`` layers (``repro/models/lm.py:486-487``)."""
    if name == "mla-tiny":
        if side == "jax":
            from repro.configs.base import ModelConfig as JModelConfig
            return JModelConfig(**MLA_TINY)
        from repro_torch.configs.base import ModelConfig as TModelConfig
        return TModelConfig(**MLA_TINY)
    reg = jreg if side == "jax" else treg
    return dataclasses.replace(reg.get("deepseek-v2-236b").smoke,
                               family="dense", moe_num_experts=0,
                               moe_first_dense=0, dtype="float32")


@functools.lru_cache(maxsize=None)
def mla_port_tree(cfg_name: str, tree: str):
    """An MLA tree built by the port (CPU tensors, seed 0), decomposed
    with :data:`MLA_LRD`."""
    params, axes = tget_model(mla_cfg(cfg_name, "torch"), "cpu").init(
        torch.Generator().manual_seed(0))
    if MLA_LRD[tree] is not None:
        params, axes, _ = tdecompose(params, axes, TLRD(**MLA_LRD[tree]))
    return params


def mla_tree_for_jax(cfg_name: str, tree: str):
    """The same MLA tree as the reference package's arrays."""
    return jax.tree.map(jnp.asarray,
                        bridge.to_numpy(mla_port_tree(cfg_name, tree)))


# ---------------------------------------------------------------------------
# 2:4 sparsity
# ---------------------------------------------------------------------------

def raw_bytes(a) -> np.ndarray:
    """Raw bytes of an array or tensor (fp8 / bf16 compared as bytes)."""
    if isinstance(a, torch.Tensor):
        return bridge.tensor_to_array(a).view(np.uint8)
    return np.asarray(a).view(np.uint8)


def assert_same(got, want, msg=""):
    """A port tensor equal to a reference array bit for bit, shape and
    dtype included (``None`` matching ``None``)."""
    if want is None:
        assert got is None, msg
        return
    assert tuple(got.shape) == tuple(want.shape), msg
    assert bridge.tensor_to_array(got).dtype == np.asarray(want).dtype, msg
    np.testing.assert_array_equal(raw_bytes(got), raw_bytes(want),
                                  err_msg=msg)


@functools.lru_cache(maxsize=None)
def port_tree_with_axes(name: str):
    """(params, axes) of one smoke tree built by the port: the trees of
    :func:`port_tree`, with their axes."""
    params, axes = tget_model(torch_cfg(), "cpu").init(
        torch.Generator().manual_seed(0))
    if TREE_LRD[name] is not None:
        params, axes, _ = tdecompose(params, axes, TLRD(**TREE_LRD[name]))
    return params, axes


def to_jax(tree):
    """A port tree as the reference package's arrays."""
    return jax.tree.map(jnp.asarray, bridge.to_numpy(tree))


def factor_weights(seed: int, shape, top_rows: bool = False) -> np.ndarray:
    """Factor-like f32 weights (std ``shape[-2] ** -0.5``); with
    ``top_rows`` rows 0 and 1 of every other group of 4 input rows are
    shrunk, so a 2:4 pack of that group keeps its top positions, 2 and 3."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * shape[-2] ** -0.5
    if top_rows:
        rows = np.arange(shape[-2])
        sel = ((rows // 4) % 2 == 0) & (rows % 4 < 2)
        w[..., sel, :] *= 0.125
    return w


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's CPU intra-op threads set to ``n`` for a block: the smoke
    trees' products are too small to share, and under several test
    workers on one machine the threads only contend."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)
