"""The port's paged KV pool against the reference's, on the same inputs.

Replays of ``tests/test_paging.py`` and ``tests/test_pool_lifecycle.py``
as parametrised cases: the host structures (radix trie, refcounted block
pool), the paged cache plans and their decode write (a position past the
table lands in the dummy block; int8 blocks take the running-max update
on the one gathered block, bit-identical), the paged pool manager
(prefix stored once, insert -> gather exact, int8 per-block scales
bit-identical, lifecycle and pressure accounting), the plain versions of
the paged decode attention kernels (within 1e-5 of the reference's
oracles and of its Pallas kernels in interpret mode; the f32 oracle
equal to slot attention bit for bit), and greedy serving: token streams
identical to the reference engine's for paged f32 and int8 pools,
shared-prefix twins, concurrent identical prompts (adoptions) and a
preemption under a block byte budget, and identical to the port's own
slot engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flat, jax_cfg, jax_tree, torch_cfg, torch_tree
from repro.configs.base import ParallelConfig
from repro.configs.base import RunConfig as JRun
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.layers import cache as jcache
from repro.models.api import get_model as jget_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.paging import BlockPool as JBlockPool
from repro.serve.paging import RadixPrefixCache as JRadix
from repro.serve.pool import KVPoolManager as JSlotPool
from repro.serve.pool import PagedKVPoolManager as JPagedPool
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.kernels import ref
from repro_torch.layers import cache as cache_mod
from repro_torch.models.api import get_model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paging import BlockPool, PoolExhausted, RadixPrefixCache
from repro_torch.serve.pool import KVPoolManager, PagedKVPoolManager
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

BS = 16
# prompts of the reference's paging tests: ROBUST keeps int8 noise below
# every greedy margin; SHARED spans two full blocks
ROBUST = tuple((i * 7 + 14) % 50 + 1 for i in range(21))
SHARED = tuple((i * 5 + 2) % 60 + 1 for i in range(33))


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# host structures: the same scripts on both implementations
# ---------------------------------------------------------------------------

def _radix_match(radix, pool):
    rx = radix(4)
    rx.insert(list(range(8)), [10, 11])
    out = [rx.match(list(range(8))), rx.match(list(range(12))),
           rx.match(list(range(4)) + [99] * 4), rx.match([99] * 8),
           rx.match([0, 1, 2])]
    assert out == [[10, 11], [10, 11], [10], [], []]
    return out


def _radix_first_writer(radix, pool):
    rx = radix(4)
    rx.insert(list(range(8)), [10, 11])
    kept = rx.insert(list(range(8)), [20, 21])
    assert kept == [10, 11] and 20 not in rx and 21 not in rx
    return kept


def _radix_forget_leaf(radix, pool):
    rx = radix(4)
    rx.insert(list(range(8)), [10, 11])
    out = [rx.is_leaf(10), rx.is_leaf(11)]
    rx.forget(11)
    out += [11 in rx, rx.is_leaf(10), rx.match(list(range(8)))]
    assert out == [False, True, False, True, [10]]
    return out


def _pool_refcount_states(radix, pool):
    bp = pool(4, 4)
    a = bp.alloc()
    out = [(bp.used_blocks(), bp.free_capacity())]
    bp.release(a)                       # unregistered -> free
    b = bp.alloc()
    bp.register(list(range(4)), [b])
    bp.release(b)                       # registered -> cold
    out.append((bp.used_blocks(), bp.free_capacity()))
    out.append((bp.match_retain(list(range(4))), bp.used_blocks()))
    assert out == [(1, 3), (0, 4), ([b], 1)]
    return out


def _pool_lru_leaf_eviction(radix, pool):
    bp = pool(2, 4)
    a, b = bp.alloc(), bp.alloc()
    bp.register(list(range(8)), [a, b])   # a interior, b leaf
    bp.release(a)
    bp.release(b)
    c = bp.alloc()                        # evicts leaf b, not a
    out = [c == b, bp.match_peek(list(range(8))) == [a],
           bp.stats.evictions]
    assert out == [True, True, 1]
    return out


def _pool_exhaustion(radix, pool):
    bp = pool(1, 4)
    bp.alloc()
    with pytest.raises(RuntimeError) as e:
        bp.alloc()
    return type(e.value).__name__


def _pool_match_retain_cap(radix, pool):
    bp = pool(4, 4)
    a, b = bp.alloc(), bp.alloc()
    bp.register(list(range(8)), [a, b])
    bp.release(a)
    bp.release(b)
    out = [bp.match_retain(list(range(8)), max_tokens=7), bp.ref[a],
           bp.ref[b]]
    assert out == [[a], 1, 0]
    return out


HOST_SCRIPTS = {f.__name__[1:]: f for f in (
    _radix_match, _radix_first_writer, _radix_forget_leaf,
    _pool_refcount_states, _pool_lru_leaf_eviction, _pool_exhaustion,
    _pool_match_retain_cap)}


@pytest.mark.parametrize("name", sorted(HOST_SCRIPTS))
def test_host_structures_replay(name):
    script = HOST_SCRIPTS[name]
    assert script(RadixPrefixCache, BlockPool) == script(JRadix, JBlockPool)


def test_pool_exhausted_is_the_port_type():
    bp = BlockPool(1, 4)
    bp.alloc()
    with pytest.raises(PoolExhausted):
        bp.alloc()


# ---------------------------------------------------------------------------
# paged cache plans
# ---------------------------------------------------------------------------

GEOM = dict(block_size=4, num_blocks=8, slots=2, blocks_per_slot=4)


def _plans(quant):
    jp = jcache.gqa_paged_plan(2, 8, jnp.float32, quant,
                               geometry=jcache.PagedGeometry(**GEOM))
    tp = cache_mod.gqa_paged_plan(2, 8, torch.float32, quant,
                                  geometry=cache_mod.PagedGeometry(**GEOM))
    return jp, tp


@pytest.mark.parametrize("quant", [None, "int8"])
def test_paged_plan_matches_reference(quant):
    jp, tp = _plans(quant)
    assert tp.family == jp.family and tp.quantized == jp.quantized
    spec = jp.spec(9, 4)
    leaves = tp.leaves(9, 4)
    assert list(leaves) == list(spec)
    for name, (shape, dtype) in leaves.items():
        assert shape == spec[name].shape, name
        assert str(dtype).split(".")[-1] == spec[name].dtype.name, name
    init = tp.init(9, 4, "cpu")
    assert int(init["block_tables"].min()) == tp.paged.dummy_block
    for attr in ("bytes_per_token", "bytes_per_slot", "bytes_per_block"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert tp.bytes_per_step(2, 16) == jp.bytes_per_step(2, 16)
    got = cache_mod.plan_from_cache(init)
    assert got.family == tp.family and got.paged == tp.paged


@pytest.mark.parametrize("write", ["prefill", "chunk"])
def test_paged_plan_rejects_prompt_writes(write):
    _, tp = _plans(None)
    cache = tp.init(9, 4, "cpu")
    new = {"k": torch.zeros(1, 4, 2, 8), "v": torch.zeros(1, 4, 2, 8)}
    with pytest.raises(ValueError):
        if write == "prefill":
            tp.write_prefill(cache, new)
        else:
            tp.write_chunk(cache, new, 0)


def test_paged_mla_rejected():
    cfg = ModelConfig(name="mla-t", mla=True, num_layers=1, d_model=64,
                      num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=64,
                      dtype="float32")
    with pytest.raises(ValueError):
        cache_mod.build_cache_plan(cfg, torch.float32, None,
                                   cache_mod.PagedGeometry(**GEOM))


@pytest.mark.parametrize("positions", [(16, 3), (5, 14), (0, 9)],
                         ids=["oob-to-dummy", "mid-block", "block-start"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_write_matches_reference(quant, positions):
    """One decode write through the tables, on the same pool: every leaf
    bit-identical (position 16 == max_seq lands in the dummy block, not
    on the slot's last block; int8 blocks requantize at the running
    max, one scale row per block)."""
    jp, tp = _plans(quant)
    rng = np.random.default_rng(len(positions) + positions[0])
    cache = {k: np.asarray(v) for k, v in jp.init(9, 4).items()}
    cache["block_tables"] = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    for name in ("k", "v"):
        if quant:
            cache[name + "_q"] = rng.integers(-127, 128, (9, 4, 2, 8)
                                              ).astype(np.int8)
            cache[name + "_scale"] = (rng.random((9, 2, 8)) + 0.5
                                      ).astype(np.float32)
        else:
            cache[name] = rng.standard_normal((9, 4, 2, 8)
                                              ).astype(np.float32)
    new = {n: (rng.standard_normal((2, 2, 8)) * 2).astype(np.float32)
           for n in ("k", "v")}
    pos = np.asarray(positions, np.int32)
    want = jp.write_decode({k: jnp.asarray(v) for k, v in cache.items()},
                           {k: jnp.asarray(v) for k, v in new.items()},
                           jnp.asarray(pos))
    got = tp.write_decode(bridge.to_torch(cache, "cpu"),
                          bridge.to_torch(new, "cpu"), torch.from_numpy(pos))
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), _np(want[name]),
                                      err_msg=name)
    if positions[0] == 16:
        key = "k_q" if quant else "k"
        np.testing.assert_array_equal(got[key][:4].numpy(),
                                      cache[key][:4])   # slot 0 untouched


# ---------------------------------------------------------------------------
# paged decode attention: plain versions vs the reference
# ---------------------------------------------------------------------------

def _paged_inputs(seed, quant, b=3, kh=2, g=2, d=16, nb=6, bs=8, nblk=3):
    """Numpy inputs: 3 slots, the last idle (no valid position, a table
    row of dummies); block NB is the dummy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, kh * g, d)).astype(np.float32)
    pool = [rng.standard_normal((nb + 1, bs, kh, d)).astype(np.float32)
            for _ in range(2)]
    bt = np.array([[0, 2, nb], [1, 4, 5], [nb, nb, nb]], np.int32)
    pos = np.array([11, 20, -1], np.int32)
    if quant:
        out = []
        for x in pool:
            scale = np.abs(x).max(axis=1) / 127.0
            qv = np.clip(np.round(x / np.where(scale > 0, scale, 1.0)[:, None]),
                         -127, 127).astype(np.int8)
            out += [qv, scale.astype(np.float32)]
        pool = out
    return q, pool, bt, pos


@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_plain_matches_reference(quant, softcap):
    name = "decode_attention_paged" + ("_q" if quant else "")
    q, pool, bt, pos = _paged_inputs(int(softcap) + quant, quant)
    args = (q, *pool, bt, pos)
    got = getattr(ref, name + "_ref")(
        *[torch.from_numpy(a) for a in args], softcap=softcap).numpy()
    want = _np(getattr(jref, name + "_ref")(
        *[jnp.asarray(a) for a in args], softcap=softcap))
    pallas = _np(getattr(jops, name)(*[jnp.asarray(a) for a in args],
                                     softcap=softcap, force_kernel=True))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    assert np.abs(got - pallas).max() <= 1e-5 * scale
    assert np.isfinite(got).all()


def test_paged_f32_plain_equals_slot_attention():
    """After the gather the paged plain version is the slot pool's decode
    attention op for op: bit-identical."""
    q, (k, v), bt, pos = _paged_inputs(3, False)
    q, k, v, bt, pos = (torch.from_numpy(a) for a in (q, k, v, bt, pos))
    ks, vs = ref._gather_blocks(k, bt), ref._gather_blocks(v, bt)
    valid = torch.arange(ks.shape[1])[None, :] <= pos.long()[:, None]
    want = cache_mod.gqa_decode_attention(q, ks, vs, valid, 0.0)
    assert torch.equal(ref.decode_attention_paged_ref(q, k, v, bt, pos),
                       want)


# ---------------------------------------------------------------------------
# PagedKVPoolManager
# ---------------------------------------------------------------------------

def _models():
    return jget_model(jax_cfg()), get_model(torch_cfg(), "cpu")


def _staging(jm, seed):
    """A batch=1 full-precision staging cache of random values, as a
    reference tree and a port tree."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        jm.init_cache(1, 64))
    return jax.tree.map(jnp.asarray, tree), bridge.to_torch(tree, "cpu")


def _same_pool_state(jpool, tpool):
    assert tpool.tables == jpool.tables
    assert tpool.blocks.ref == jpool.blocks.ref
    assert tpool.used_bytes() == jpool.used_bytes()
    assert tpool.physical_blocks_in_use() == jpool.physical_blocks_in_use()
    assert tpool.prefix_stats() == jpool.prefix_stats()
    tpool.check_integrity()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_insert_gather_roundtrip_matches_reference(quant):
    """Insert a staged stream, release it (its full blocks go cold in the
    radix), readmit the same prompt: the pool leaves equal the
    reference's bit for bit (int8 values and per-block scales), and the
    gathered prefix equals the reference's gather (for f32: the staged
    values themselves).  The reference runs eagerly here: under ``jit``
    XLA turns its ``absmax / 127`` into a multiply by the reciprocal,
    which moves about 1 % of its scales by one ulp (a quirk of the
    reference, ROADMAP section C); the port divides, as the reference's
    source does."""
    jm, tm = _models()
    jstage, tstage = _staging(jm, 0)
    pools = (JPagedPool(jm, 2, 64, block_size=BS, kv_quantize=quant),
             PagedKVPoolManager(tm, 2, 64, block_size=BS, kv_quantize=quant))
    gathered = []
    for pool, stage, mdl in ((pools[0], jstage, jm), (pools[1], tstage, tm)):
        with jax.disable_jit():
            pool.allocate(0, len(SHARED), tokens=list(SHARED))
            pool.insert(stage, 0, len(SHARED))
            pool.release(0)
            matched = pool.allocate(1, len(SHARED), tokens=list(SHARED))
            assert matched == (len(SHARED) // BS) * BS
            gathered.append(pool.gather_prefix(mdl.init_cache(1, 64), 1,
                                               matched))
    _same_pool_state(*pools)
    for name, leaf in flat(pools[1].cache).items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      _np(flat(pools[0].cache)[name]),
                                      err_msg=name)
    want, got = flat(gathered[0]), flat(gathered[1])
    for name in got:
        np.testing.assert_array_equal(got[name].numpy(), _np(want[name]),
                                      err_msg=name)
    if quant is None:
        for name in got:
            np.testing.assert_array_equal(
                got[name][:, 0, :matched].numpy(),
                flat(tstage)[name][:, 0, :matched].numpy())


def _stored_once(pool):
    pool.allocate(0, len(SHARED), tokens=list(SHARED))
    pool.positions[0] = len(SHARED)            # as if inserted
    pool.release(0)
    for slot in range(3):
        pool.allocate(slot, len(SHARED), tokens=list(SHARED))
    n_shared = len(SHARED) // BS
    assert pool.physical_blocks_in_use() == n_shared + 3
    assert pool.blocks.ref[pool.tables[0][0]] == 3
    assert len({pool.tables[i][-1] for i in range(3)}) == 3   # private tails
    return pool.prefix_stats()


def _shared_counted_once(pool):
    _stored_once(pool)
    used = pool.used_bytes()
    for slot in range(3):
        pool.release(slot)
    return used // pool.bytes_per_block, pool.used_bytes()


def _grow_on_crossing(pool):
    pool.allocate(0, BS - 1, tokens=list(range(1, BS)))
    n0 = len(pool.tables[0])
    pool.positions[0] = BS - 1                 # as if inserted
    pool.grow(0, token=7)                      # crosses into block 1
    return n0, len(pool.tables[0]), pool.tokens[0][-1]


POOL_SCRIPTS = {f.__name__[1:]: f for f in (
    _stored_once, _shared_counted_once, _grow_on_crossing)}


@pytest.mark.parametrize("name", sorted(POOL_SCRIPTS))
def test_paged_pool_replay(name):
    jm, tm = _models()
    jpool = JPagedPool(jm, 3, 64, block_size=BS)
    tpool = PagedKVPoolManager(tm, 3, 64, block_size=BS)
    script = POOL_SCRIPTS[name]
    assert script(tpool) == script(jpool)
    _same_pool_state(jpool, tpool)


# -- lifecycle (tests/test_pool_lifecycle.py) -------------------------------

TOKS = [list(range(1, 41)), [7, 8, 9]]
X = list(range(1, 41))


def _release_zeroes(pool):
    for slot, toks in enumerate(TOKS):
        pool.allocate(slot, len(toks), tokens=toks)
        pool.positions[slot] = len(toks)
        for t in (11, 12, 13):
            pool.grow(slot, token=t)
    out = [pool.used_bytes() > 0]
    for slot in (1, 0):
        pool.release(slot)
    out += [pool.used_bytes(), pool.free_slots()]
    assert out == [True, 0, [0, 1]]
    return out


def _pressure_then_zero(pool):
    unit = getattr(pool, "bytes_per_block", 0) or pool.bytes_per_token * 16
    pool.byte_budget = int(unit * 2)
    for slot, toks in enumerate(TOKS):
        pool.allocate(slot, len(toks), tokens=toks)
        pool.positions[slot] = len(toks)
    victims = pool.pressure_victims()
    for slot in victims:
        pool.release(slot)
    pool.release(0)
    assert victims == [1] and pool.used_bytes() == 0
    return victims


def _empty_pool_override(pool):
    pool.byte_budget = 1
    out = [pool.can_admit(40, tokens=list(range(1, 41)))]
    pool.allocate(0, 40, tokens=list(range(1, 41)))
    out.append(pool.can_admit(40, tokens=list(range(41, 81))))
    assert out == [True, False]
    return out


def _paged_release_registers(pool):
    pool.allocate(0, len(X), tokens=X)
    pool.positions[0] = len(X)
    pool.release(0)
    out = [pool.used_bytes(), pool.blocks.match_peek(X) != []]
    pool.allocate(0, len(X), tokens=X)
    out.append(pool.used_bytes() > 0)
    pool.release(0)
    out.append(pool.used_bytes())
    assert out == [0, True, True, 0]
    return out


def _cold_prefix(pool):
    """X's 2 full blocks cold-cached, one live stream of 2 blocks."""
    pool.allocate(0, len(X), tokens=X)
    pool.positions[0] = len(X)
    pool.release(0)
    live = list(range(100, 117))
    pool.allocate(0, len(live), tokens=live)
    pool.positions[0] = len(live)


def _cold_blocks_physical_gate(pool):
    _cold_prefix(pool)
    probe = X + list(range(200, 224))
    fresh = list(range(300, 317))
    out = [pool.blocks.free_capacity(),
           pool.can_admit(len(probe), tokens=probe),
           pool.can_admit(len(fresh), tokens=fresh)]
    pool.allocate(1, len(fresh), tokens=fresh)
    assert out == [2, False, True]
    return out


def _cold_blocks_byte_gate(pool):
    _cold_prefix(pool)
    bpb = pool.bytes_per_block
    probe = X + list(range(200, 224))
    out = [pool.used_bytes() // bpb]
    pool.byte_budget = 5 * bpb
    out.append(pool.can_admit(len(probe), tokens=probe))
    pool.byte_budget = 6 * bpb
    out.append(pool.can_admit(len(probe), tokens=probe))
    pool.allocate(1, len(probe), tokens=probe)
    out.append(pool.used_bytes() // bpb)
    assert out == [2, False, True, 6]
    return out


def _victims_free_shared_blocks_jointly(pool):
    shared = list(range(1, 33))
    pool.allocate(2, len(shared), tokens=shared)
    pool.positions[2] = len(shared)
    pool.release(2)
    for slot, toks in ((0, list(range(100, 110))), (1, list(range(200, 210))),
                       (2, shared + [300]), (3, shared + [301])):
        pool.allocate(slot, len(toks), tokens=toks)
        pool.positions[slot] = len(toks)
    bpb = pool.bytes_per_block
    out = [pool.used_bytes() // bpb]
    pool.byte_budget = 2 * bpb
    out.append(pool.pressure_victims())
    assert out == [6, [3, 2]]
    return out


LIFECYCLE = {
    # name: (script, pools it runs on, pool kwargs)
    "release_zeroes": (_release_zeroes, ("slot", "paged"), {}),
    "pressure_then_zero": (_pressure_then_zero, ("slot", "paged"), {}),
    "empty_pool_override": (_empty_pool_override, ("slot", "paged"), {}),
    "paged_release_registers": (_paged_release_registers, ("paged",), {}),
    "cold_blocks_physical_gate": (_cold_blocks_physical_gate, ("paged",),
                                  {"num_blocks": 4}),
    "cold_blocks_byte_gate": (_cold_blocks_byte_gate, ("paged",),
                              {"num_blocks": 8}),
    "victims_free_shared_blocks_jointly": (
        _victims_free_shared_blocks_jointly, ("paged",),
        {"num_blocks": 16, "slots": 4}),
}


@pytest.mark.parametrize("name,layout", [
    (n, lay) for n, (_, lays, _) in LIFECYCLE.items() for lay in lays])
def test_pool_lifecycle_replay(name, layout):
    script, _, kw = LIFECYCLE[name]
    kw = dict(kw)
    slots = kw.pop("slots", 2)
    jm, tm = _models()
    if layout == "slot":
        pools = (JSlotPool(jm, slots, 64), KVPoolManager(tm, slots, 64))
    else:
        pools = (JPagedPool(jm, slots, 64, block_size=16, **kw),
                 PagedKVPoolManager(tm, slots, 64, block_size=16, **kw))
    assert script(pools[1]) == script(pools[0])
    assert pools[1].used_bytes() == pools[0].used_bytes()


# ---------------------------------------------------------------------------
# engine: greedy streams against the reference engine
# ---------------------------------------------------------------------------

def _serve(eng, prompts, n, request):
    reqs = [request(uid=i, prompt=list(p), max_new_tokens=n)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.add_request(r)
    seen = []
    while eng.scheduler.busy():
        eng.step()
        if all(r is not None for r in eng.scheduler.active) \
                and hasattr(eng.pool, "physical_blocks_in_use"):
            seen.append(eng.pool.physical_blocks_in_use())
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], seen


#: scenario: (prompts, new tokens, slots, byte budget in blocks or None)
SCENARIOS = {
    "shared-prefix": ([list(SHARED) + [40 + i] for i in range(4)]
                      + [list(ROBUST), [4, 5, 6]], 4, 2, None),
    "concurrent-twins": ([list(SHARED)] * 3, 16, 3, None),
    "preemption": ([list(ROBUST[:15]), [9, 8, 7]], 20, 2, 3),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("kvq", [None, "int8"], ids=["f32", "int8"])
def test_paged_streams_match_reference_engine(kvq, scenario):
    prompts, n, slots, budget = SCENARIOS[scenario]
    kw = dict(slots=slots, max_seq=64, prefill_chunk=8, kv_quantize=kvq,
              kv_layout="paged")
    jeng = JEngine(JRun(model=jax_cfg(), parallel=ParallelConfig()),
                   jax_tree("dense")[0], **kw)
    eng = ServeEngine(RunConfig(model=torch_cfg()), torch_tree("dense"),
                      device="cpu", **kw)
    if budget:
        jeng.pool.byte_budget = eng.pool.byte_budget = \
            budget * eng.pool.bytes_per_block
    want, jseen = _serve(jeng, prompts, n, JRequest)
    got, seen = _serve(eng, prompts, n, Request)
    assert got == want
    assert eng.pool.prefix_stats() == jeng.pool.prefix_stats()
    assert seen == jseen
    assert eng.pool.used_bytes() == 0
    eng.pool.check_integrity()
    assert eng.plan_summary["kv_layout"] == "paged"
    assert eng.plan_summary["kv_cache_family"] == \
        jeng.plan_summary["kv_cache_family"]
    assert eng.plan_summary["kv_bytes_per_step"] == \
        jeng.plan_summary["kv_bytes_per_step"]
    st = eng.pool.prefix_stats()
    if scenario == "shared-prefix":
        assert st["prefix_block_hits"] > 0
    if scenario == "concurrent-twins":
        n_shared = len(SHARED) // BS
        assert st["adopted_blocks"] == 2 * n_shared
        assert min(seen) == n_shared + 3      # the prefix stored once
        assert got[0] == got[1] == got[2]
    if scenario == "preemption":
        assert eng.scheduler.preemptions > 0
        free = ServeEngine(RunConfig(model=torch_cfg()), torch_tree("dense"),
                           device="cpu", **kw)
        assert _serve(free, prompts, n, Request)[0] == got   # resumes exactly


@pytest.mark.parametrize("kvq", [None, "int8"], ids=["f32", "int8"])
def test_paged_engine_matches_slot_engine(kvq):
    prompts = [list(ROBUST), [4, 5, 6]] + [list(SHARED) + [7]] * 2
    out = {}
    for layout in ("slot", "paged"):
        eng = ServeEngine(RunConfig(model=torch_cfg()), torch_tree("dense"),
                          device="cpu", slots=2, max_seq=64,
                          prefill_chunk=8, kv_quantize=kvq, kv_layout=layout)
        out[layout] = _serve(eng, prompts, 6, Request)[0]
    assert out["paged"] == out["slot"]


@pytest.mark.parametrize("kw", [dict(admission="blocking"),
                                dict(max_seq=60),
                                dict(kv_layout="ring")],
                         ids=["blocking-admission", "block-size-vs-max-seq",
                              "unknown-layout"])
def test_paged_configuration_errors(kw):
    kw = {"kv_layout": "paged", "max_seq": 64, **kw}
    with pytest.raises(ValueError):
        ServeEngine(RunConfig(model=torch_cfg()), torch_tree("dense"),
                    device="cpu", slots=2, **kw)
