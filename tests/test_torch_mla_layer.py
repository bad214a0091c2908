"""MLA's attention layer in the port vs the reference on the same numpy
inputs (f32): ``apply_mla`` without a cache, in whole prefill, chunk
mode (the chunk's pad rows zeroed at the latent write) and absorbed
decode, over the full-width and the int8 latent cache, for both query
paths (``q_lora_rank`` 0 and 32) and a dense, SVD or branched ``kv_b``.

Tolerances: outputs and full-width caches at rtol = atol = 1e-5 (the
same sums taken in another order); int8 latents within one step (a
latent that lands on a rounding boundary may round the other way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import mla_cfg
from repro.layers import attention as jattn
from repro.layers import cache as jcache
from repro_torch import bridge
from repro_torch.configs.base import LRDConfig as TLRD
from repro_torch.core.surgery import decompose_model as tdecompose
from repro_torch.layers import attention as tattn
from repro_torch.layers import cache as tcache
from repro_torch.layers.param import ParamBuilder
from _torch_parity import torch_threads

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the smoke products are too small to share, and
    under several test workers the threads only contend."""
    with torch_threads(1):
        yield

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(t: torch.Tensor, j, **tol) -> None:
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def _mla_layer(cfg_name: str, kv_b: str):
    """One MLA layer's params (port init, seed 0) with kv_b dense or
    decomposed by the port's surgery ("svd" / "branched"), as (torch
    tree, jax tree)."""
    cfg = mla_cfg(cfg_name, "torch")
    pb = ParamBuilder(torch.Generator().manual_seed(3), torch.float32,
                      "cpu")
    tattn.init_mla(pb, "mla", cfg)
    p, axes = pb.params, pb.axes
    if kv_b != "dense":
        lrd = TLRD(enabled=True, rank_mode="ratio", min_dim=4,
                   rank_align=1, branches=2 if kv_b == "branched" else 1,
                   targets=("mla_kvb",))
        p, axes, rep = tdecompose(p, axes, lrd)
        assert [d.kind for d in rep.decomposed] == [kv_b]
    return p["mla"], jax.tree.map(jnp.asarray, bridge.to_numpy(p))["mla"]


def test_padded_chunk_rows_masked_at_latent_write():
    """Bucket-padded chunks zero the pad rows' latents at the write, and
    the chunked latents equal the whole prefill's."""
    cfg = mla_cfg("mla-tiny", "torch")
    tp, _ = _mla_layer("mla-tiny", "dense")
    rng = np.random.default_rng(7)
    s, s_max = 12, 32
    x = _t(rng.standard_normal((1, s, 32), np.float32) * 0.3)
    garbage = torch.full((1, 3, 32), 7.7)
    plan = tcache.mla_plan(16, 8, torch.float32)
    _, whole = tattn.apply_mla(tp, x, cfg,
                               positions=torch.arange(s)[None, :],
                               cache=plan.init(1, s_max, "cpu"))
    cache = plan.init(1, s_max, "cpu")
    tattn.apply_mla(tp, torch.cat([x[:, :5], garbage], 1), cfg,
                    positions=torch.arange(8)[None, :], cache=cache,
                    start_pos=0, prompt_len=5)
    assert float(cache["ckv"][:, 5:8].abs().max()) == 0.0
    assert float(cache["krope"][:, 5:8].abs().max()) == 0.0
    tattn.apply_mla(tp, x[:, 5:], cfg, positions=5 + torch.arange(7)[None],
                    cache=cache, start_pos=5, prompt_len=s)
    torch.testing.assert_close(cache["ckv"][:, :s], whole["ckv"][:, :s],
                               **TOL)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("cfg_name,kv_b", [
    ("mla-tiny", "dense"), ("deepseek-smoke", "dense"),
    ("deepseek-smoke", "svd"), ("deepseek-smoke", "branched")])
def test_apply_mla_matches_reference(cfg_name, kv_b, quant):
    """Whole prefill into a cache, a chunk at an offset, then two
    absorbed decode steps (one slot past the pool, dropped): outputs
    within 1e-5 of the reference and the caches equal after every
    write."""
    jcfg, tcfg = mla_cfg(cfg_name, "jax"), mla_cfg(cfg_name, "torch")
    tp, jp = _mla_layer(cfg_name, kv_b)
    rng = np.random.default_rng(11)
    d, s_max, n0, n1 = tcfg.d_model, 24, 9, 6
    jplan = jcache.mla_plan(tcfg.kv_lora_rank, tcfg.qk_rope_dim,
                            jnp.float32, quant)
    tplan = tcache.mla_plan(tcfg.kv_lora_rank, tcfg.qk_rope_dim,
                            torch.float32, quant)
    x0 = rng.standard_normal((2, n0, d), np.float32) * 0.5
    jc, tc = jplan.init(2, s_max), tplan.init(2, s_max, "cpu")
    jo, jc = jattn.apply_mla(jp, jnp.asarray(x0), jcfg,
                             positions=jnp.arange(n0)[None, :], cache=jc,
                             plan=jplan)
    to, tc = tattn.apply_mla(tp, _t(x0), tcfg,
                             positions=torch.arange(n0)[None, :], cache=tc,
                             plan=tplan)
    _close(to, jo)

    def caches_close():
        for name, leaf in tc.items():
            if leaf.dtype == torch.int8:     # one rounding step at most
                assert int((leaf.int() - _t(jc[name]).int()).abs().max()) \
                    <= 1, name
            else:
                _close(leaf, jc[name])
    caches_close()
    x1 = rng.standard_normal((2, n1, d), np.float32) * 0.5
    jo, jc = jattn.apply_mla(jp, jnp.asarray(x1), jcfg,
                             positions=n0 + jnp.arange(n1)[None, :],
                             cache=jc, start_pos=jnp.asarray(n0),
                             prompt_len=jnp.asarray(n0 + n1 - 2),
                             plan=jplan)
    to, tc = tattn.apply_mla(tp, _t(x1), tcfg,
                             positions=n0 + torch.arange(n1)[None, :],
                             cache=tc, start_pos=n0,
                             prompt_len=n0 + n1 - 2, plan=tplan)
    _close(to, jo)
    caches_close()
    for pos in ([n0 + n1 - 2, 7], [n0 + n1 - 1, s_max]):
        xd = rng.standard_normal((2, 1, d), np.float32) * 0.5
        p = np.array(pos, np.int32)
        jo, jc = jattn.apply_mla(jp, jnp.asarray(xd), jcfg,
                                 positions=jnp.asarray(p)[:, None],
                                 cache=jc, cache_pos=jnp.asarray(p),
                                 plan=jplan)
        to, tc = tattn.apply_mla(tp, _t(xd), tcfg,
                                 positions=_t(p)[:, None], cache=tc,
                                 cache_pos=_t(p), plan=tplan)
        _close(to, jo)
        caches_close()


def test_apply_mla_without_cache_matches_reference():
    jcfg, tcfg = mla_cfg("deepseek-smoke", "jax"), mla_cfg("deepseek-smoke",
                                                           "torch")
    tp, jp = _mla_layer("deepseek-smoke", "dense")
    x = np.random.default_rng(12).standard_normal((2, 7, 64), np.float32)
    jo, _ = jattn.apply_mla(jp, jnp.asarray(x), jcfg,
                            positions=jnp.arange(7)[None, :])
    to, cache = tattn.apply_mla(tp, _t(x), tcfg,
                                positions=torch.arange(7)[None, :])
    assert cache is None
    _close(to, jo)
