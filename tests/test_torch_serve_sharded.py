"""The twin of ``tests/test_serve_sharded.py``: a quantized, mixed SVD +
branched smoke llama placed on a ``(1, 2)`` ("data", "model") mesh
serves.

The tree is the reference test's: the reference's init (``PRNGKey(0)``),
surgery (ratio ranks, ``branches=2``, ``rank_align=8``) and int8
quantization with the axes rewrite, bridged to the port; in f32, as every
port-vs-reference engine test here (in bf16 the two engines' greedy
streams part at near ties).  Every leaf
resolves through the port's ``make_param_shardings`` to the reference's
spec; two gloo ranks on the CPU (``_torch_mesh.py``, one spawn) place it
and serve it with the port's engine, each block gathering its leaves at
use.  Their greedy streams are token-identical to the port's engine
without a mesh and to the reference's engine without a mesh (the
reference's own run on the mesh stops at the embedding gather of its
vocab-sharded table: ROADMAP C).
"""
import dataclasses

import jax
import numpy as np
import pytest

import _torch_mesh as tm
from _torch_parity import torch_threads
from repro.configs import registry as jreg
from repro.configs.base import LRDConfig as JLRD
from repro.configs.base import ParallelConfig as JPar
from repro.configs.base import RunConfig as JRun
from repro.core.surgery import decompose_model
from repro.models.api import get_model as jget_model
from repro.parallel import sharding as jshd
from repro.quant import quantize_tree
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig
from repro_torch.serve.engine import Request, ServeEngine

ENGINE = dict(slots=2, max_seq=64)
JCFG = dataclasses.replace(jreg.get("llama3.2-1b").smoke, dtype="float32")
TCFG = dataclasses.replace(registry.get("llama3.2-1b").smoke,
                           dtype="float32")
PROMPTS = [[i + 1, 2, 3] for i in range(3)]
NEW = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def tree():
    """The reference test's quantized mixed tree and its rewritten axes
    (init, surgery and quantization under one ``jax.jit``: eager they take
    ~17 s here)."""
    cfg = JCFG
    lrd = JLRD(enabled=True, rank_mode="ratio", min_dim=32, branches=2,
               rank_align=8)
    box = {}

    def build(key):
        params, axes = jget_model(cfg).init(key)
        params, axes, report = decompose_model(params, axes, lrd)
        box["kinds"] = {d.kind for d in report.decisions}
        params, box["axes"] = quantize_tree(params, "int8", axes=axes)
        return params
    params = jax.jit(build)(jax.random.PRNGKey(0))
    assert {"branched", "svd"} <= box["kinds"], box["kinds"]
    return params, box["axes"]


@pytest.fixture(scope="module")
def streams(tree):
    params, axes = tree
    payload = {"params": jax.tree.map(np.asarray, params), "axes": axes,
               "cfg": TCFG, "engine": ENGINE,
               "prompts": PROMPTS, "new": NEW}
    return tm.run_ranks("serve_case", payload)


def _reference_streams(params) -> list[list[int]]:
    eng = JEngine(JRun(model=JCFG, parallel=JPar()), params, **ENGINE)
    reqs = [JRequest(uid=i, prompt=p, max_new_tokens=NEW)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    return [r.output for r in reqs]


def _port_streams(params) -> tuple[list[list[int]], dict]:
    eng = ServeEngine(RunConfig(model=TCFG),
                      bridge.to_torch(jax.tree.map(np.asarray, params),
                                      "cpu"), device="cpu", **ENGINE)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=NEW)
            for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    return [r.output for r in reqs], eng.plan_summary


def _by_path(tree) -> dict:
    return {"/".join(str(k.key) for k in p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_every_leaf_resolves_to_the_reference_spec(tree, streams):
    """Each rank's specs are the reference's, and each rank holds the
    halves they imply (the model axis of 2 splits some leaves)."""
    params, axes = tree
    mesh = jax.sharding.AbstractMesh((1, 2), ("data", "model"))
    want = {k: tuple(s.spec) for k, s in _by_path(
        jshd.make_param_shardings(mesh, params, axes, JPar())).items()}
    shapes = {k: tuple(np.shape(v)) for k, v in _by_path(params).items()}
    assert any("model" in s for s in want.values())
    for r in streams:
        assert r["specs"] == want
        for k, spec in want.items():
            assert r["local_shapes"][k] == tuple(
                d // 2 if i < len(spec) and spec[i] == "model" else d
                for i, d in enumerate(shapes[k])), k


def test_placed_quantized_tree_serves_on_a_2_rank_mesh(tree, streams):
    params, _ = tree
    want = _reference_streams(params)
    port, summary = _port_streams(params)
    assert all(len(o) == NEW for o in want)
    assert port == want
    for r in streams:
        assert r["status"] == ["finished"] * len(PROMPTS)
        assert r["outputs"] == want
        assert r["plan_summary"]["quantized"] > 0
        assert r["plan_summary"]["by_kind"].get("branched")
        for k in ("quantized", "by_kind", "weight_bytes", "quant_bytes"):
            assert r["plan_summary"][k] == summary[k], k
