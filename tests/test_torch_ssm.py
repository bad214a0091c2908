"""The port's mamba2 layer (``repro_torch.layers.ssm``) against the
reference's ``repro.layers.ssm`` on the CPU, f32, on the same
numpy-seeded inputs: the chunked SSD scan at S below, equal to and above
the chunk (not a multiple of it) and from an initial state, the causal
conv with and without a tail, the gated RMSNorm, the full-sequence layer
with its final state, the decode step, and softplus above 20.

Tolerance: max |port - reference| / max |reference| <= 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import smoke_cfg, torch_threads
from repro.layers import norm as jnorm
from repro.layers import ssm as jssm
from repro_torch import bridge
from repro_torch.layers import norm as tnorm
from repro_torch.layers import ssm as tssm
from repro_torch.layers.param import ParamBuilder

TOL = 1e-5
CHUNK = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * np.abs(want).max(), err / np.abs(want).max()


def _rng(seed):
    return np.random.default_rng(seed)


def _dims(chunk=CHUNK):
    cfg = smoke_cfg("mamba2-2.7b", "torch", ssm_chunk=chunk)
    return tssm.dims_from_config(cfg), jssm.dims_from_config(
        smoke_cfg("mamba2-2.7b", "jax", ssm_chunk=chunk))


def _layer(seed=0):
    """One SSM layer's params (port tensors, numpy copy) with the scalar
    leaves drawn too, so a_log, dt_bias, d_skip and the conv biases are
    not their init constants."""
    dims = _dims()[0]
    pb = ParamBuilder(torch.Generator().manual_seed(seed), torch.float32,
                      "cpu")
    tssm.init_ssm(pb, "ssm", dims)
    p = pb.params["ssm"]
    r = _rng(seed + 1)
    for k, lo, hi in (("a_log", -1.0, 1.5), ("dt_bias", -2.0, 1.0),
                      ("d_skip", 0.5, 1.5), ("conv_x_b", -0.2, 0.2),
                      ("conv_bc_b", -0.2, 0.2)):
        p[k] = torch.from_numpy(r.uniform(lo, hi, p[k].shape).astype(
            np.float32))
    p["norm"]["scale"] = torch.from_numpy(
        r.uniform(0.5, 1.5, p["norm"]["scale"].shape).astype(np.float32))
    return p, jax.tree.map(jnp.asarray, bridge.to_numpy(p))


def _scan_inputs(s, seed=0, b=2):
    dims = _dims()[0]
    r = _rng(seed)
    x = r.standard_normal((b, s, dims.n_heads, dims.head_dim)) * 0.5
    dt = np.log1p(np.exp(r.standard_normal((b, s, dims.n_heads)) - 1.0))
    a = -np.exp(r.uniform(-1.0, 1.0, dims.n_heads))
    bb = r.standard_normal((b, s, dims.d_state)) * 0.5
    cc = r.standard_normal((b, s, dims.d_state)) * 0.5
    return [t.astype(np.float32) for t in (x, dt, a, bb, cc)]


@pytest.mark.parametrize("s", [7, CHUNK, 45, 3 * CHUNK])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_reference(s, init):
    """S below, equal to and above the chunk, 45 not a multiple of it
    (padded with dt = 0), 96 three chunks of inter-chunk recurrence."""
    tdims, jdims = _dims()
    ins = _scan_inputs(s)
    st = (_rng(9).standard_normal((2, tdims.n_heads, tdims.head_dim,
                                   tdims.d_state)).astype(np.float32)
          if init else None)
    jy, jst = jssm._ssd_chunked(*map(jnp.asarray, ins), jdims,
                                init_state=None if st is None
                                else jnp.asarray(st))
    ty, tst = tssm._ssd_chunked(*map(torch.from_numpy, ins), tdims,
                                init_state=None if st is None
                                else torch.from_numpy(st))
    assert ty.shape == jy.shape and tst.shape == jst.shape
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("tail", [False, True])
def test_causal_conv_matches_reference(tail):
    r = _rng(3)
    seq = r.standard_normal((2, 11, 24)).astype(np.float32)
    w = r.standard_normal((4, 24)).astype(np.float32) / 4
    b = r.standard_normal(24).astype(np.float32) * 0.1
    tl = r.standard_normal((2, 3, 24)).astype(np.float32) if tail else None
    want = jssm._causal_conv(jnp.asarray(seq), jnp.asarray(w),
                             jnp.asarray(b),
                             None if tl is None else jnp.asarray(tl))
    got = tssm._causal_conv(torch.from_numpy(seq), torch.from_numpy(w),
                            torch.from_numpy(b),
                            None if tl is None else torch.from_numpy(tl))
    _close(got, want)


def test_gated_rms_norm_matches_reference():
    r = _rng(4)
    x, gate = (r.standard_normal((2, 5, 128)).astype(np.float32)
               for _ in range(2))
    scale = r.uniform(0.5, 1.5, 128).astype(np.float32)
    want = jnorm.gated_rms_norm({"scale": jnp.asarray(scale)},
                                jnp.asarray(x), jnp.asarray(gate))
    got = tnorm.gated_rms_norm({"scale": torch.from_numpy(scale)},
                               torch.from_numpy(x), torch.from_numpy(gate))
    _close(got, want)


def _state(b, dims):
    return tssm.init_ssm_state(b, dims, torch.float32, "cpu")


@pytest.mark.parametrize("s", [5, 45])
def test_apply_ssm_matches_reference(s):
    """The layer's output and the state it leaves (the final SSD state
    and the pre-conv tails) for a prompt under and over the chunk."""
    tdims, jdims = _dims()
    tp, jp = _layer()
    x = _rng(5).standard_normal((2, s, tdims.d_model)).astype(np.float32)
    jy, jst = jssm.apply_ssm(jp, jnp.asarray(x), jdims,
                             state=jssm.init_ssm_state(2, jdims,
                                                       jnp.float32))
    ty, tst = tssm.apply_ssm(tp, torch.from_numpy(x), tdims,
                             state=_state(2, tdims))
    _close(ty, jy)
    for k in ("ssm", "conv_x", "conv_bc"):
        _close(tst[k], jst[k])
    ty2, none = tssm.apply_ssm(tp, torch.from_numpy(x), tdims)
    assert none is None and torch.equal(ty, ty2)


@pytest.mark.parametrize("s", [1, 2])
def test_short_prompt_tails_are_zero_padded(s):
    """A prompt shorter than the conv tail (3 rows) leaves its inputs at
    the tail's end with zeros before them: the zero tail that the
    full-sequence conv starts from (the reference keeps only the prompt's
    rows, ``repro/layers/ssm.py:199-205``)."""
    tdims, _ = _dims()
    tp, _ = _layer()
    x = _rng(6).standard_normal((1, s, tdims.d_model)).astype(np.float32)
    st = _state(1, tdims)
    for k in st:
        st[k].fill_(7.0)                 # a previous stream's rows
    tssm.apply_ssm(tp, torch.from_numpy(x), tdims, state=st)
    assert st["conv_x"].shape[1] == 3
    assert not st["conv_x"][:, :3 - s].any()
    assert not st["conv_bc"][:, :3 - s].any()
    zx = torch.from_numpy(x) @ tp["in_proj"]["w"]
    _close(st["conv_x"][:, 3 - s:], zx[..., tdims.d_inner:].numpy())


def test_decode_continues_prefill():
    """Prefill of 37 tokens, then one decode step per token to 45: every
    step's output equals the full-sequence output at its position, and
    equals the reference's decode step from the same state."""
    tdims, jdims = _dims()
    tp, jp = _layer()
    x = _rng(7).standard_normal((2, 45, tdims.d_model)).astype(np.float32)
    full, _ = tssm.apply_ssm(tp, torch.from_numpy(x), tdims)
    st = _state(2, tdims)
    tssm.apply_ssm(tp, torch.from_numpy(x[:, :37]), tdims, state=st)
    for i in range(37, 45):
        # copies, and the reference's step finished before the port's: jax
        # may alias a numpy buffer, and the port's step writes ``st`` in place
        jst = {k: jnp.asarray(v.numpy().copy()) for k, v in st.items()}
        jy, jst = jax.block_until_ready(jssm.apply_ssm_decode(
            jp, jnp.asarray(x[:, i:i + 1]), jdims, jst))
        ty, st = tssm.apply_ssm_decode(tp, torch.from_numpy(x[:, i:i + 1]),
                                       tdims, st)
        _close(ty, jy)
        _close(ty[:, 0], full[:, i].numpy())
        for k in st:
            _close(st[k], jst[k])


def test_softplus_above_twenty():
    """torch's softplus (the layer's) is the identity above 20 and jax's
    is not; in f32 they agree there (and below it)."""
    x = np.array([-30.0, -1.0, 0.0, 1.0, 19.5, 19.999, 20.0, 20.001, 20.5,
                  25.0, 50.0, 1e4], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    assert np.array_equal(got[x >= 20], want[x >= 20])
