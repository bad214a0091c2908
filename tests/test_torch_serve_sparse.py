"""The port's 2:4 serve path vs the reference engine's, on smoke trees built
by the port and bridged into the reference (f32): ``ServeEngine(sparsify=
"2:4")`` gives greedy token streams identical to the JAX engine with the
same flags — int8- and e4m3-packed factors over the int8 slot pool, int8
packs over the paged int8 pool with int8 activation prefill, unquantized
packs, a partial ``sparse_targets``, DeepSeek-V2's smoke MLA stack over
the int8 latent pool, and ``LRDConfig.sparsify`` driving both engines.
``plan_summary`` reports the reference's bytes and sparse count.

The port's engine packs the raw tree at load.  The reference engine gets
the port's packed tree (the packing is the reference's bit for bit,
``tests/test_torch_sparse.py``), so its load pipeline has nothing left
to pack and the file stays quick; ``test_config_knob_drives_engine``
runs the reference's own packing.  The reference runs its Pallas
kernels (interpret mode on the CPU) in the act-quant case, where it has
no act-quant path without them; the other cases take its jnp path,
which computes what the port's plain versions compute.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import pytest

from _torch_parity import (jax_cfg, mla_cfg, mla_port_tree, port_tree,
                           port_tree_for_jax, prompts, torch_cfg)
from repro.configs.base import LRDConfig as JLRD
from repro.configs.base import ParallelConfig
from repro.configs.base import RunConfig as JRun
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import bridge
from repro_torch.configs.base import LRDConfig, RunConfig
from repro_torch.quant.quantize import quantize_tree
from repro_torch.quant.sparse import sparsify_tree
from repro_torch.serve.engine import Request, ServeEngine
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

N_NEW = 5
SHARED = [(i * 5 + 2) % 60 + 1 for i in range(33)]     # 2 full blocks of 16

#: case: (engine flags, LRDConfig fields, reference use_pallas, prompts)
CASES = {
    "int8-slot": (dict(quantize="int8", kv_quantize="int8"), {}, False,
                  None),
    "fp8-slot": (dict(quantize="fp8", kv_quantize="int8"), {}, False, None),
    "int8-paged-act-quant": (
        dict(quantize="int8", kv_quantize="int8", kv_layout="paged",
             act_quantize="int8"), {}, True,
        [SHARED + [40], SHARED]),
    "unquantized": (dict(quantize="none"), {}, False, None),
    "partial-targets": (dict(quantize="int8", kv_quantize="int8"),
                        dict(sparse_targets=("w0", "u")), False, None),
}


def _serve(eng, prompt_list, request):
    reqs = [request(uid=i, prompt=list(p), max_new_tokens=N_NEW)
            for i, p in enumerate(prompt_list)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(r.status == "finished" and len(r.output) == N_NEW
               for r in reqs)
    return [r.output for r in reqs]


@functools.lru_cache(maxsize=None)
def _packed_for_jax(tree: str, quantize: str, targets: tuple) -> dict:
    """The engine's load pipeline run by the port on a smoke tree
    (``tree`` names a :func:`port_tree`, or "deepseek-smoke" the
    branched MLA stack of :func:`mla_port_tree`),
    bridged into the reference's arrays."""
    params = (mla_port_tree("deepseek-smoke", "branched")
              if tree == "deepseek-smoke" else port_tree(tree))
    params = sparsify_tree(params, "2:4", mode=quantize, targets=targets)
    if quantize != "none":
        params = quantize_tree(params, quantize)
    return jax.tree.map(jnp.asarray, bridge.to_numpy(params))


def _check_summary(eng, jeng):
    for k in ("sparse", "quantized", "param_count", "weight_bytes",
              "quant_bytes", "kv_bytes_per_step", "kv_cache_family"):
        assert eng.plan_summary[k] == jeng.plan_summary[k], k
    assert eng.plan_summary["sparse"] > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_streams_match_reference_engine(case):
    flags, lrd, use_pallas, plist = CASES[case]
    plist = plist or prompts(lengths=(3, 17, 5))
    kw = dict(slots=2, max_seq=64, prefill_chunk=8, sparsify="2:4", **flags)
    jeng = JEngine(JRun(model=jax_cfg(), parallel=ParallelConfig(),
                        lrd=JLRD(use_pallas=use_pallas, **lrd)),
                   _packed_for_jax("branched", flags["quantize"],
                                   LRDConfig(**lrd).sparse_targets), **kw)
    eng = ServeEngine(RunConfig(model=torch_cfg(), lrd=LRDConfig(**lrd)),
                      port_tree("branched"), device="cpu", **kw)
    assert _serve(eng, plist, Request) == _serve(jeng, plist, JRequest)
    _check_summary(eng, jeng)
    assert eng.sparsify == "2:4"
    if flags.get("kv_layout") == "paged":
        assert eng.pool.prefix_stats() == jeng.pool.prefix_stats()
        eng.pool.check_integrity()


def test_sparse_mla_stack_matches_reference_engine():
    """DeepSeek-V2's smoke MLA stack, decomposed (o, the FFN and the
    unembed branched), 2:4-packed int8 factors over the int8 latent
    pool."""
    kw = dict(slots=2, max_seq=64, prefill_chunk=8, quantize="int8",
              sparsify="2:4", kv_quantize="int8")
    plist = prompts(lengths=(21, 4), vocab=60)
    jeng = JEngine(JRun(model=mla_cfg("deepseek-smoke", "jax"),
                        parallel=ParallelConfig()),
                   _packed_for_jax("deepseek-smoke", "int8",
                                   LRDConfig().sparse_targets), **kw)
    eng = ServeEngine(RunConfig(model=mla_cfg("deepseek-smoke", "torch")),
                      mla_port_tree("deepseek-smoke", "branched"),
                      device="cpu", **kw)
    assert _serve(eng, plist, Request) == _serve(jeng, plist, JRequest)
    _check_summary(eng, jeng)
    assert eng.plan_summary["kv_cache_family"] == "mla_latent_int8"


def test_config_knob_drives_engine():
    """``LRDConfig(sparsify="2:4", quantize="int8")`` alone packs and
    quantizes at load, in both engines, and serves the same streams."""
    fields = dict(sparsify="2:4", quantize="int8")
    kw = dict(slots=2, max_seq=64, prefill_chunk=8)
    jeng = JEngine(JRun(model=jax_cfg(), parallel=ParallelConfig(),
                        lrd=JLRD(**fields)),
                   port_tree_for_jax("branched"), **kw)
    eng = ServeEngine(RunConfig(model=torch_cfg(), lrd=LRDConfig(**fields)),
                      port_tree("branched"), device="cpu", **kw)
    assert (eng.sparsify, eng.quantize) == ("2:4", "int8")
    plist = prompts(lengths=(6, 11))
    assert _serve(eng, plist, Request) == _serve(jeng, plist, JRequest)
    _check_summary(eng, jeng)
    dense = ServeEngine(RunConfig(model=torch_cfg(), lrd=dataclasses.replace(
        LRDConfig(**fields), sparsify="none")), port_tree("branched"),
        device="cpu", **kw)
    assert dense.plan_summary["sparse"] == 0
    assert eng.plan_summary["weight_bytes"] < \
        dense.plan_summary["weight_bytes"]
