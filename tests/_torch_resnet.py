"""Shared trees of the port's ResNet parity tests: the smoke ResNet (f32)
built by the reference from ``PRNGKey(0)``, decomposed by the
reference's surgery as the paper's Table 3 rows (its cost model bound to
the port's H100 numbers for the search: its own default is the TPU's),
and bridged into the port, so both packages run on one tree.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hw_specs as jhw
from repro.configs import registry as jreg
from repro.configs.base import LRDConfig as JLRD
from repro.core import cost_model as jcm
from repro.core import surgery as jsurgery
from repro.models import resnet as jresnet
from repro.quant.quantize import quantize_tree as jquantize_tree
from repro_torch import bridge
from repro_torch.analysis import hw_specs as hw
from repro_torch.configs import registry as treg

#: the reference's HardwareSpec carrying the port's H100 numbers
J_H100 = jhw.HardwareSpec(**{
    f.name: getattr(hw.H100, f.name)
    for f in dataclasses.fields(jhw.HardwareSpec)})
#: the reference cost-model functions its surgery calls with the
#: default spec
BOUND = ("make_model_timer", "make_dense_time", "conv_time")

BASE = dict(enabled=True, compression=2.0, rank_mode="ratio", min_dim=8)
#: the LRD of each decomposed Table 3 row (``examples/compress_resnet.py``
#: and ``benchmarks/bench_table3.py``); merging decomposes the 3x3 convs
#: only and then merges; "vanilla_int8" quantizes the vanilla tree
TABLE3 = {
    "vanilla_lrd": BASE,
    "optimized_ranks": dict(BASE, rank_mode="search"),
    "layer_merging": dict(BASE, targets=("conv",)),
    "layer_branching": dict(BASE, compression=1.0001, branches=4,
                            targets=("conv",)),
    "branching_n2": dict(BASE, compression=1.0001, branches=2,
                         targets=("conv",)),
    "aligned": dict(BASE, rank_mode="aligned", rank_align=8),
}
TREES = ("dense", *TABLE3, "vanilla_int8")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port's small CPU ops: the suite runs in
    parallel workers, where a thread pool per worker oversubscribes the
    cores and its spinning threads slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(pkg: str):
    return (jreg if pkg == "jax" else treg).get("resnet50").smoke


@functools.lru_cache(maxsize=None)
def jax_model():
    return jresnet.ResNetModel(cfg("jax"))


@functools.lru_cache(maxsize=None)
def jax_dense():
    """(params, axes) of the reference's smoke ResNet.  The init runs
    under ``jax.jit`` (one compile, where eager dispatch compiles each
    random draw); the axes tree is plain Python, taken while tracing."""
    return traced(jax_model().init, jax.random.PRNGKey(0))


def traced(fn, *args):
    """``fn(*args)`` = (arrays, *python values) run under ``jax.jit`` (one
    compile, where eager dispatch compiles op by op): the python values
    (axes, reports) are taken while tracing."""
    box = {}

    def arrays(*a):
        out = fn(*a)
        box["rest"] = out[1:]
        return out[0]
    return (jax.jit(arrays)(*args), *box["rest"])


def surgery(params, axes, lrd: dict):
    """The reference's ``decompose_model`` with its cost model on the
    H100 numbers: (params, axes, report)."""
    saved = {n: getattr(jcm, n) for n in BOUND}
    try:
        for n, fn in saved.items():
            setattr(jcm, n, functools.partial(fn, spec=J_H100))
        return traced(lambda p: jsurgery.decompose_model(p, axes,
                                                         JLRD(**lrd)),
                      params)
    finally:
        for n, fn in saved.items():
            setattr(jcm, n, fn)


def bound_surgery(lrd: dict):
    """:func:`surgery` of the dense smoke tree."""
    return surgery(*jax_dense(), lrd)


@functools.lru_cache(maxsize=None)
def decomposed(name: str):
    """(params, report) of one Table 3 surgery by the reference."""
    params, _, rep = bound_surgery(TABLE3[name])
    return params, rep


@functools.lru_cache(maxsize=None)
def jax_tree(name: str):
    """One reference tree of :data:`TREES`."""
    if name == "dense":
        return jax_dense()[0]
    if name == "vanilla_int8":
        return jax.jit(jquantize_tree)(jax_tree("vanilla_lrd"))
    params = decomposed(name)[0]
    return jresnet.merge_bottleneck(params) if name == "layer_merging" \
        else params


def torch_tree(name: str):
    """The same tree bridged into the port (CPU tensors, a fresh copy)."""
    return bridge.to_torch(jax.tree.map(np.asarray, jax_tree(name)), "cpu")


@functools.lru_cache(maxsize=None)
def jax_forward():
    return jax.jit(jax_model().forward)


def images(n: int = 2, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"images": (rng.standard_normal((n, 32, 32, 3)) * 0.3
                       ).astype(np.float32),
            "labels": rng.integers(0, 10, n).astype(np.int32)}


def norm_err(got, want) -> float:
    """max |got - want| / max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)
