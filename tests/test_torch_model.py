"""LMModel of the port vs the reference on bridged smoke trees (dense,
SVD, SVD+branched; f32): prefill, bucket-padded prefill, chunked prefill
with padding, and several decode steps give logits within 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_cfg, jax_tree, torch_cfg, torch_tree
from repro.models.api import get_model as jget_model
from repro_torch.layers.plan import build_plan_tree, plan_leaves
from repro_torch.models.api import get_model
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

TOL = dict(rtol=1e-4, atol=1e-4)
TREES = ["dense", "svd", "branched"]
S_MAX = 32


def _models(name):
    return (jget_model(jax_cfg()), jax_tree(name)[0],
            get_model(torch_cfg(), "cpu"), torch_tree(name))


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _toks(n, seed=0, b=1):
    return np.random.default_rng(seed).integers(1, 250, (b, n)).astype(
        np.int32)


@pytest.mark.parametrize("name", TREES)
def test_tree_kinds(name):
    kinds = {p.kind for p in plan_leaves(build_plan_tree(torch_tree(name)))}
    want = {"dense": {"dense"}, "svd": {"dense", "lowrank"},
            "branched": {"dense", "lowrank", "branched"}}[name]
    assert kinds == want


@pytest.mark.parametrize("name", TREES)
def test_prefill_and_padded_prefill_logits(name):
    jm, jp, tm, tp = _models(name)
    toks = _toks(11, b=2)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                        jm.init_cache(2, S_MAX))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                        tm.init_cache(2, S_MAX))
    _close(tl, jl)
    _close(tc["blocks"]["k"], jc["blocks"]["k"])
    _close(tc["blocks"]["v"], jc["blocks"]["v"])
    # bucket padding: 11 real tokens in a 16-token bucket
    pad = np.zeros((1, 16), np.int32)
    pad[0, :11] = toks[0]
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(pad)},
                       jm.init_cache(1, S_MAX), last_pos=jnp.asarray(10))
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(pad).long()},
                       tm.init_cache(1, S_MAX), last_pos=10)
    _close(tl, jl)


@pytest.mark.parametrize("name", TREES)
def test_chunked_prefill_then_decode_logits(name):
    jm, jp, tm, tp = _models(name)
    prompt = _toks(13, seed=1)[0]
    jc, tc = jm.init_cache(1, S_MAX), tm.init_cache(1, S_MAX)
    for start in (0, 8):          # chunks of 8 real tokens, bucketed to 8
        c = min(8, len(prompt) - start)
        pad = np.zeros((1, 8), np.int32)
        pad[0, :c] = prompt[start:start + c]
        eff = min(len(prompt), start + c)
        jl, jc = jm.prefill_chunk(jp, {"tokens": jnp.asarray(pad)}, jc,
                                  start_pos=jnp.asarray(start),
                                  prompt_len=jnp.asarray(eff))
        tl, tc = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(pad).long()},
                                  tc, start_pos=start, prompt_len=eff)
        _close(tl, jl)
    _close(tc["blocks"]["k"], jc["blocks"]["k"])
    # three decode steps of a 2-slot pool: slot 0 continues the prompt,
    # slot 1 is idle at position 0 (idle slots decode too)
    jpool, tpool = jm.init_cache(2, S_MAX), tm.init_cache(2, S_MAX)
    jpool = {"blocks": {n: jpool["blocks"][n].at[:, 0].set(
        jc["blocks"][n][:, 0]) for n in ("k", "v")}}
    for n in ("k", "v"):
        tpool["blocks"][n][:, 0] = tc["blocks"][n][:, 0]
    tok = np.array([[int(np.argmax(np.asarray(jl)[0, 0]))], [0]], np.int32)
    pos = np.array([len(prompt), 0], np.int32)
    for _ in range(3):
        jl, jpool = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(pos),
                                   jpool)
        tl, tpool = tm.decode_step(tp, torch.from_numpy(tok).long(),
                                   torch.from_numpy(pos).long(), tpool)
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(
            np.int32)[:, None]
        pos = pos + np.array([1, 0], np.int32)
    _close(tpool["blocks"]["v"], jpool["blocks"]["v"])


def test_init_is_seeded_and_shaped_like_reference():
    import jax
    tm = get_model(torch_cfg(), "cpu")
    p1, axes = tm.init(torch.Generator().manual_seed(0))
    p2, _ = tm.init(torch.Generator().manual_seed(0))
    jp, jaxes = jget_model(jax_cfg()).init(jax.random.PRNGKey(0))
    jflat = {jax.tree_util.keystr(k): v.shape for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(t, pre=""):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                out.update(flat(v, f"{pre}['{k}']"))
            return out
        return {pre: tuple(t.shape)}
    assert flat(p1) == jflat
    assert all(torch.equal(a, b) for a, b in zip(
        flat_values(p1), flat_values(p2)))
    assert axes["blocks"]["attn"]["q"]["w"] == \
        jaxes["blocks"]["attn"]["q"]["w"]


def flat_values(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in flat_values(v)]
    return [t]
