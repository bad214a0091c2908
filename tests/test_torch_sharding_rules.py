"""The port's sharding rules against the reference's.

First a twin of every case of ``tests/test_sharding_rules.py`` (the same
trees, rules and meshes; the port's specs are tuples, the reference's
``PartitionSpec``s compare equal as tuples).  Then, for every registered
architecture, the port's ``make_param_shardings`` gives the reference's
spec for every leaf, and the same replication notes, on a (16, 16), a
(2, 16, 16) and a (1, 2) mesh (abstract: resolution reads axis names and
sizes alone) under the default ``ParallelConfig``, FSDP, and the
registered ``parallel("train")`` / ``parallel("decode")``.  The trees:
the smoke tree dense, decomposed (ratio ranks, ``branches=2``,
``rank_align=8``, ``min_dim=32``) and int8-quantized with the axes
rewrite, and the full-width tree, shapes only (the reference's under
``jax.eval_shape``, the port's on the ``meta`` device).  The MoE
families' decomposed expert banks have no int8 tree: the port refuses to
quantize them (ROADMAP C; the reference's forward raises on one).
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jreg
from repro.configs.base import LRDConfig as JLRD
from repro.configs.base import ParallelConfig as JPar
from repro.core.surgery import decompose_model as jdecompose
from repro.models.api import get_model as jget_model
from repro.parallel import sharding as jshd
from repro.quant import quantize_tree as jquantize
from repro_torch.configs import registry
from repro_torch.configs.base import LRDConfig, ParallelConfig
from repro_torch.core.surgery import decompose_model
from repro_torch.layers.param import (BATCH, BRANCH, EMBED, EXPERTS, FFN,
                                      LAYERS, NONE, QKV, RANK, SEQ, VOCAB)
from repro_torch.models.api import get_model
from repro_torch.parallel import sharding as shd
from repro_torch.quant.quantize import (align_quantized_axes, quantize_tree,
                                        scale_axes)
from repro_torch.tree import paths
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

MESH = shd.AbstractMesh((1, 1), ("data", "model"))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x2": ((1, 2), ("data", "model"))}
LRD = dict(enabled=True, rank_mode="ratio", min_dim=32, branches=2,
           rank_align=8)


def spec_of(mesh, axes, shape, parallel):
    tree_p = {"x": torch.empty(shape, device="meta")}
    s = shd.make_param_shardings(mesh, tree_p, {"x": axes}, parallel)
    return s["x"].spec


class TestParamRules:
    def test_megatron_pattern(self):
        par = ParallelConfig()
        assert spec_of(MESH, (EMBED, FFN), (64, 128), par) == P(None, "model")
        assert spec_of(MESH, (FFN, EMBED), (128, 64), par) == P("model")

    def test_fsdp_2d(self):
        par = ParallelConfig(fsdp=True)
        assert spec_of(MESH, (EMBED, FFN), (64, 128), par) \
            == P("data", "model")

    def test_rank_inherits_fsdp(self):
        par = ParallelConfig(fsdp=True)
        got = spec_of(MESH, (EXPERTS, RANK, FFN), (4, 8, 128), par)
        assert got == P("model", "data")

    def test_rank_replicated_by_default(self):
        assert spec_of(MESH, (EMBED, RANK), (64, 8), ParallelConfig()) == P()

    def test_shard_rank_variant(self):
        par = ParallelConfig(shard_rank=True)
        assert spec_of(MESH, (EMBED, RANK), (64, 8), par) == P(None, "model")
        assert spec_of(MESH, (RANK, FFN), (8, 128), par) == P(None, "model")

    def test_indivisible_replicates_with_note(self):
        class FakeMesh:
            shape = {"data": 16, "model": 16}
        notes = []
        got = shd._spec_for((VOCAB, EMBED), (50280, 64),
                            {VOCAB: "model", EMBED: None}, FakeMesh(), notes,
                            "embed/w")
        assert got == P()
        assert notes and "not divisible" in notes[0]
        jnotes = []
        assert jshd._spec_for((VOCAB, EMBED), (50280, 64),
                              {VOCAB: "model", EMBED: None}, FakeMesh(),
                              jnotes, "embed/w") == got
        assert jnotes == notes

    def test_layer_stack_axis_never_sharded(self):
        got = spec_of(MESH, (LAYERS, EMBED, QKV), (4, 64, 128),
                      ParallelConfig(fsdp=True))
        assert got == P(None, "data", "model")


class TestQuantizedParamRules:
    def _shardings(self, params, axes, par, **quant_kw):
        qp = quantize_tree(params, **quant_kw)
        return qp, shd.make_param_shardings(MESH, qp, axes, par)

    def test_svd_pair_q_inherits_base_spec(self):
        par = ParallelConfig(fsdp=True)
        params = {"up": {"w0": torch.ones(64, 8), "w1": torch.ones(8, 128)}}
        axes = {"up": {"w0": (EMBED, RANK), "w1": (RANK, FFN)}}
        qp, s = self._shardings(params, axes, par)
        assert set(qp["up"]) == {"w0_q", "w0_scale", "w1_q", "w1_scale"}
        base = shd.make_param_shardings(MESH, params, axes, par)
        assert s["up"]["w0_q"].spec == base["up"]["w0"].spec
        assert s["up"]["w1_q"].spec == base["up"]["w1"].spec
        assert s["up"]["w1_scale"].spec == P(None, "model")
        assert s["up"]["w0_scale"].spec == P(None, "data")

    def test_branched_q_inherits_base_spec(self):
        par = ParallelConfig(fsdp=True, shard_rank=True)
        params = {"u": torch.ones(4, 64, 8), "xc": torch.ones(4, 8, 8),
                  "v": torch.ones(4, 8, 128)}
        axes = {"u": (BRANCH, EMBED, RANK), "xc": (BRANCH, RANK, RANK),
                "v": (BRANCH, RANK, FFN)}
        qp, s = self._shardings(params, axes, par)
        base = shd.make_param_shardings(MESH, params, axes, par)
        for k in ("u", "xc", "v"):
            assert s[k + "_q"].spec == base[k].spec, k
        assert s["v_scale"].spec == P(None, None, "model")

    def test_partial_quant_targets_mixed_tree(self):
        par = ParallelConfig(fsdp=True)
        params = {"w0": torch.ones(64, 8), "w1": torch.ones(8, 128)}
        axes = {"w0": (EMBED, RANK), "w1": (RANK, FFN)}
        qp, s = self._shardings(params, axes, par, targets=("w0",))
        assert set(qp) == {"w0_q", "w0_scale", "w1"}
        base = shd.make_param_shardings(MESH, params, axes, par)
        assert s["w0_q"].spec == base["w0"].spec
        assert s["w1"].spec == base["w1"].spec

    def test_quantize_tree_rewrites_axes_tree(self):
        params = {"up": {"w0": torch.ones(64, 8), "w1": torch.ones(8, 128)},
                  "norm": {"scale": torch.ones(64)}}
        axes = {"up": {"w0": (EMBED, RANK), "w1": (RANK, FFN)},
                "norm": {"scale": (EMBED,)}}
        qp, qa = quantize_tree(params, axes=axes)
        assert qa["up"]["w0_q"] == (EMBED, RANK)
        assert qa["up"]["w0_scale"] == (NONE, RANK)
        assert qa["up"]["w1_scale"] == scale_axes((RANK, FFN)) == (NONE, FFN)
        assert qa["norm"]["scale"] == (EMBED,)
        s = shd.make_param_shardings(MESH, qp, qa, ParallelConfig(fsdp=True))
        assert s["up"]["w1_scale"].spec == P(None, "model")

    def test_unresolvable_key_raises(self):
        with pytest.raises(KeyError):
            align_quantized_axes({"mystery": torch.ones(2, 2)},
                                 {"w0": (EMBED, RANK)})

    def test_quantize_tree_missing_axes_entry_raises(self):
        params = {"w0": torch.ones(64, 8), "w1": torch.ones(8, 128)}
        with pytest.raises(KeyError, match="w1"):
            quantize_tree(params, axes={"w0": (EMBED, RANK)})


class TestCacheRules:
    def _pair(self, mesh_shape, names, parallel, shape, batch, seq_len):
        par = ParallelConfig(**parallel)
        got = shd.cache_shardings(shd.AbstractMesh(mesh_shape, names),
                                  {"k": torch.empty(shape, device="meta")},
                                  par, batch=batch, seq_len=seq_len)
        want = jshd.cache_shardings(
            jax.sharding.AbstractMesh(mesh_shape, names),
            {"k": jax.ShapeDtypeStruct(shape, jnp.bfloat16)},
            JPar(**parallel), batch=batch, seq_len=seq_len)
        assert got["k"].spec == tuple(want["k"].spec)
        return got["k"].spec

    def test_kv_cache_seq_over_model(self):
        assert self._pair((1, 1), ("data", "model"), {}, (4, 8, 128, 2, 16),
                          8, 128) == P(None, "data", "model")

    def test_b1_decode_seq_both_axes(self):
        assert self._pair((16, 16), ("data", "model"),
                          {"decode_seq_shard": True}, (2, 1, 512, 2, 16), 1,
                          512) == P(None, None, ("data", "model"))

    def test_ssm_state_heads_over_model(self):
        assert self._pair((1, 1), ("data", "model"), {}, (4, 8, 16, 8, 4),
                          8, 999) == P(None, "data", "model")

    def test_multi_pod_batch_and_seq(self):
        self._pair((2, 16, 16), ("pod", "data", "model"),
                   {"decode_seq_shard": True}, (2, 1, 512, 2, 16), 1, 512)
        self._pair((2, 16, 16), ("pod", "data", "model"), {},
                   (4, 64, 1024, 8, 64), 64, 1024)


class TestActivationRules:
    def test_batch_and_ffn(self):
        rule = shd.activation_resolver(MESH, ParallelConfig())
        assert rule((BATCH, SEQ, FFN), (8, 16, 64)).spec \
            == P("data", None, "model")

    def test_seq_shard_toggle(self):
        on = shd.activation_resolver(MESH, ParallelConfig(seq_shard=True))
        off = shd.activation_resolver(MESH, ParallelConfig())
        assert on((BATCH, SEQ, EMBED), (8, 16, 64)).spec \
            == P("data", "model")
        assert off((BATCH, SEQ, EMBED), (8, 16, 64)).spec == P("data")

    @pytest.mark.parametrize("mesh", list(MESHES))
    def test_resolvers_inputs_and_batch_match_reference(self, mesh):
        sizes, names = MESHES[mesh]
        m, jm = (shd.AbstractMesh(sizes, names),
                 jax.sharding.AbstractMesh(sizes, names))
        cases = [((BATCH, SEQ, FFN), (32, 16, 64)),
                 ((BATCH, SEQ, EMBED), (32, 32, 64)),
                 ((BATCH, SEQ, VOCAB), (3, 16, 256)),
                 ((BATCH, SEQ, QKV), (64, 7, 48))]
        for seq_shard in (False, True):
            rule = shd.activation_resolver(m, ParallelConfig(
                seq_shard=seq_shard))
            jrule = jshd.activation_resolver(jm, JPar(seq_shard=seq_shard))
            for axes, shape in cases:
                got, want = rule(axes, shape), jrule(axes, shape)
                assert (got is None) == (want is None)
                if got is not None:
                    assert got.spec == tuple(want.spec), (axes, shape)
        specs = {"tokens": jax.ShapeDtypeStruct((32, 16), jnp.int32),
                 "odd": jax.ShapeDtypeStruct((3, 16), jnp.int32)}
        got = shd.input_shardings(m, specs, ParallelConfig())
        want = jshd.input_shardings(jm, specs, JPar())
        assert {k: v.spec for k, v in got.items()} \
            == {k: tuple(v.spec) for k, v in want.items()}
        assert shd.batch_sharding(m).spec \
            == tuple(jshd.batch_sharding(jm).spec)


def test_spec_to_dtensor_placements():
    try:
        from torch.distributed.tensor import Replicate, Shard
    except ImportError:
        from torch.distributed._tensor import Replicate, Shard
    m = shd.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.placements(P(None, "data", "model"), m) \
        == [Replicate(), Shard(1), Shard(2)]
    assert shd.placements(P(("pod", "data")), m) \
        == [Shard(0), Shard(0), Replicate()]
    assert shd.placements(P(), m) == [Replicate()] * 3


def test_activation_resolver_is_installed_and_cleared():
    from repro_torch.layers import param as lp
    x = torch.ones(2, 3)
    assert lp.shard_act(x, BATCH, EMBED) is x
    shd.install_activation_rules(MESH, ParallelConfig())
    try:
        assert lp._ACT_RESOLVER is not None
        assert lp.shard_act(x, BATCH, EMBED) is x
    finally:
        shd.clear_activation_rules()
    assert lp._ACT_RESOLVER is None


# ---------------------------------------------------------------------------
# every registered architecture, every leaf
# ---------------------------------------------------------------------------

def _ref_shapes(cfg, lrd: bool, quant: bool):
    """(ShapeDtypeStruct tree, axes) of the reference's tree."""
    box = {}

    def build(key):
        p, a = jget_model(cfg).init(key)
        if lrd:
            p, a, _ = jdecompose(p, a, JLRD(**LRD))
        if quant:
            p, a = jquantize(p, "int8", axes=a)
        box["axes"] = a
        return p
    return jax.eval_shape(build, jax.random.PRNGKey(0)), box["axes"]


def _port_shapes(cfg, lrd: bool, quant: bool):
    p, a = get_model(cfg, "meta").init(None)
    if lrd:
        with torch.no_grad():
            p, a, _ = decompose_model(p, a, LRDConfig(**LRD))
    if quant:
        p, a = quantize_tree(p, "int8", axes=a)
    return p, a


def _specs(tree) -> dict:
    return {"/".join(k): v.spec for k, v in paths(tree)}


def _ref_specs(tree) -> dict:
    return {"/".join(str(k.key) for k in p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _trees(name: str):
    entry, jentry = registry.get(name), jreg.get(name)
    moe = bool(entry.smoke.moe_num_experts)
    kinds = {"dense": (False, False), "decomposed": (True, False)}
    if not moe:
        kinds["int8"] = (True, True)
    out = {f"smoke {k}": (_port_shapes(entry.smoke, *v),
                          _ref_shapes(jentry.smoke, *v))
           for k, v in kinds.items()}
    out["full dense"] = (_port_shapes(entry.full, False, False),
                         _ref_shapes(jentry.full, False, False))
    return out


@pytest.mark.parametrize("name", registry.names())
def test_every_leaf_resolves_as_the_reference(name):
    entry, jentry = registry.get(name), jreg.get(name)
    pars = {"default": (ParallelConfig(), JPar()),
            "fsdp": (ParallelConfig(fsdp=True), JPar(fsdp=True)),
            "train": (entry.parallel("train"), jentry.parallel("train")),
            "decode": (entry.parallel("decode"),
                       jentry.parallel("decode"))}
    for tree, ((p, a), (jp, ja)) in _trees(name).items():
        for mesh, (sizes, names) in MESHES.items():
            m = shd.AbstractMesh(sizes, names)
            jm = jax.sharding.AbstractMesh(sizes, names)
            for par, (tp, jpar) in pars.items():
                notes, jnotes = [], []
                got = _specs(shd.make_param_shardings(m, p, a, tp, notes))
                want = _ref_specs(jshd.make_param_shardings(jm, jp, ja, jpar,
                                                            jnotes))
                where = (name, tree, mesh, par)
                assert got == want, where
                # jax's trees iterate their keys sorted, the port's in
                # insertion order: the same notes, in another order
                assert sorted(notes) == sorted(jnotes), where
