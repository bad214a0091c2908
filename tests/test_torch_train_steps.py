"""The port's training steps against the reference on the CPU, from one
bridged state (f32 smoke trees built by the port): ``lr_schedule``,
``adamw_update`` with a freeze mask (zero-size moments), EF-PowerSGD's
``compress_decompress``, and k steps of ``make_train_step`` with
``grad_accum`` 1 and 2 (and with compression) give the same losses,
parameters and state; ``ByteTextLM`` gives the reference's batches token
for token; the bridge carries the optimizer and PowerSGD state.

Tolerance: f32 on both sides.  One update: within 1e-5 of the largest
element (the same formulas, sums in another order).  Three train steps:
the losses within 1e-5 relative, the parameters within 1e-4 of each
leaf's largest element (Adam divides by sqrt(v), which amplifies the
gradients' last-bit differences where v is small)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flat, jax_cfg, port_tree, torch_cfg, torch_threads
from repro.configs.base import LRDConfig as JLRD
from repro.configs.base import ParallelConfig as JPar
from repro.configs.base import RunConfig as JRun
from repro.models.api import get_model as jget_model
from repro.train import compression as jcomp
from repro.train import optim as joptim
from repro.train import steps as jsteps
from repro.train.data import ByteTextLM as JByteTextLM
from repro.core.freezing import trainable_mask as jmask
from repro_torch import bridge
from repro_torch.configs.base import LRDConfig, ParallelConfig, RunConfig
from repro_torch.core import freezing
from repro_torch.models.api import get_model
from repro_torch.train import compression as comp
from repro_torch.train import optim
from repro_torch.train import steps
from repro_torch.train.data import ByteTextLM, DataState, SyntheticLM
from repro_torch.tree import paths
from test_torch_train import _fresh, _norm_err, jax_params

OCFG = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _rand_like(tree, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(np.shape(v)).astype(np.float32)
            for k, v in flat(tree).items()}


def _nest(flat_tree):
    out: dict = {}
    for k, v in flat_tree.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _assert_tree_close(got, want, tol, what=""):
    got, want = flat(got), flat(_to_np(want))
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert np.shape(g) == np.shape(w), (what, k)
        if np.size(w):
            assert _norm_err(g, w) <= tol, (what, k, _norm_err(g, w))


def test_lr_schedule_matches_reference():
    for kw in (OCFG, dict(peak_lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)):
        jc, tc = joptim.OptimConfig(**kw), optim.OptimConfig(**kw)
        for s in (0, 1, 2, 5, 10, 55, 100, 150):
            assert float(optim.lr_schedule(tc, torch.tensor(s))) == \
                pytest.approx(float(joptim.lr_schedule(jc, jnp.asarray(s))),
                              rel=1e-6)


@pytest.mark.parametrize("freeze", [False, True])
def test_adamw_update_matches_reference(freeze):
    jp = jax_params("branched")
    jm = jmask(jp, enabled=freeze)
    cfg = dict(OCFG, grad_clip=0.5)
    jstate = joptim.adamw_init(jp, jm)
    tp = _fresh("branched")
    tm = freezing.trainable_mask(tp, enabled=freeze)
    tstate = bridge.to_torch(_to_np(jstate), "cpu")
    if freeze:
        assert tstate["m"]["blocks"]["mlp"]["up"]["u"].shape == (0,)
    jupdate = jax.jit(lambda g, s, p: joptim.adamw_update(
        g, s, p, joptim.OptimConfig(**cfg), jm))
    for i in range(3):
        g = _nest(_rand_like(jp, seed=10 + i))
        jp, jstate, jmet = jupdate(jax.tree.map(jnp.asarray, g), jstate, jp)
        tp, tstate, tmet = optim.adamw_update(
            bridge.to_torch(g, "cpu"), tstate, tp, optim.OptimConfig(**cfg),
            tm)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-5)
        assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]),
                                                  rel=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    _assert_tree_close(tp, jp, 1e-5, "params")
    _assert_tree_close(tstate["m"], jstate["m"], 1e-5, "m")
    _assert_tree_close(tstate["v"], jstate["v"], 1e-5, "v")
    assert optim.optimizer_state_bytes(tstate) == \
        joptim.optimizer_state_bytes(jstate)


def test_compress_decompress_matches_reference():
    shapes = {"w": (64, 48), "stack": (2, 32, 40), "bias": (8,),
              "tiny": (6, 5)}
    cfg = dict(rank=4, min_dim=4)
    rng = np.random.default_rng(0)
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    jstate = jcomp.init_state(jax.tree.map(jnp.asarray, grads[0]),
                              jcomp.CompressionConfig(**cfg),
                              jax.random.PRNGKey(3))
    tstate = bridge.to_torch(_to_np(jstate), "cpu")
    assert set(tstate["w"]) == {"err", "q"} and set(tstate["bias"]) == {"err"}
    for g in grads:
        jg, jstate, jst = jcomp.compress_decompress(
            jax.tree.map(jnp.asarray, g), jstate,
            jcomp.CompressionConfig(**cfg), lambda t: t)
        tg, tstate, tst = comp.compress_decompress(
            bridge.to_torch(g, "cpu"), tstate, comp.CompressionConfig(**cfg),
            lambda t: t)
        assert tst == jst
        _assert_tree_close(tg, jg, 1e-4, "grads")
        _assert_tree_close(tstate, jstate, 1e-4, "state")


def _runs(name, freeze, accum, rank):
    lrd = dict(enabled=True, rank_mode="aligned", rank_align=8, min_dim=32,
               branches=2, freeze=freeze)
    par = dict(remat="none", grad_accum=accum, grad_compression_rank=rank)
    return (JRun(model=jax_cfg(), lrd=JLRD(**lrd), parallel=JPar(**par)),
            RunConfig(model=torch_cfg(), lrd=LRDConfig(**lrd),
                      parallel=ParallelConfig(**par)))


@pytest.mark.parametrize("name,freeze,accum,rank", [
    ("branched", True, 1, 0), ("branched", True, 2, 0),
    ("svd", False, 2, 2)])
def test_train_steps_match_reference(name, freeze, accum, rank):
    jrun, trun = _runs(name, freeze, accum, rank)
    jm, tm = jget_model(jrun.model), get_model(trun.model, "cpu")
    jocfg, tocfg = joptim.OptimConfig(**OCFG), optim.OptimConfig(**OCFG)
    jp = jax_params(name)
    jstate = jsteps.init_opt_state(jm, jrun, jp, jocfg)
    tp = freezing.set_requires_grad(_fresh(name), freeze=freeze)
    tstate = bridge.to_torch(_to_np(jstate), "cpu")
    jstep = jax.jit(jsteps.make_train_step(jm, jrun, jocfg))
    tstep = steps.make_train_step(tm, trun, tocfg)
    data = ByteTextLM(trun.model, batch=4, seq_len=32)
    for i in range(3):
        batch = data.batch(i)
        jp, jstate, jmet = jstep(jp, jstate, {"tokens": jnp.asarray(
            batch["tokens"])})
        tp, tstate, tmet = tstep(tp, tstate, {"tokens": torch.from_numpy(
            batch["tokens"])})
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-5)
    _assert_tree_close(tp, jp, 1e-4, "params")
    _assert_tree_close(tstate["adam"], jstate["adam"], 1e-4, "adam")
    if freeze:
        # the frozen factors did not move
        want = port_tree(name)["blocks"]["mlp"]["up"]["u"]
        assert torch.equal(tp["blocks"]["mlp"]["up"]["u"], want)


def test_frozen_leaves_get_no_moments_and_stay():
    _, trun = _runs("branched", True, 1, 0)
    tm = get_model(trun.model, "cpu")
    tp = freezing.set_requires_grad(_fresh("branched"), freeze=True)
    ocfg = optim.OptimConfig(**OCFG)
    state = steps.init_opt_state(tm, trun, tp, ocfg)
    up = state["adam"]["m"]["blocks"]["mlp"]["up"]
    assert up["u"].numel() == 0 and up["v"].numel() == 0
    assert up["xc"].shape == tp["blocks"]["mlp"]["up"]["xc"].shape
    k = state["adam"]["m"]["blocks"]["attn"]["k"]
    assert k["w0"].numel() == 0 and k["w1"].numel() > 0
    before = {k: v.clone() for k, v in flat(tp).items()}
    step = steps.make_train_step(tm, trun, ocfg)
    data = ByteTextLM(trun.model, batch=2, seq_len=16)
    for i in range(2):
        tp, state, _ = step(tp, state, {"tokens": torch.from_numpy(
            data.batch(i)["tokens"])})
    mask = flat(freezing.trainable_mask(tp))
    for key, v in flat(tp).items():
        assert torch.equal(v, before[key]) == (not mask[key]), key
    assert float(up["xc"].abs().max()) > 0


def test_one_rank_mesh_step_equals_the_step_without_a_mesh(tmp_path):
    """Two train steps on a one-rank (1, 1, 1) ("pod", "data", "model")
    mesh (a gloo group through a FileStore), with FSDP, the vocab
    sharded, multi-pod and PowerSGD at rank 2, equal the steps without a
    mesh bit for bit: one rank changes no arithmetic.  Without a mesh the
    sharding fields are inert, as the reference's are: a train step with
    llama's registered ``parallel("train")`` (seq_shard, remat "full")
    equals one with remat "full" and the other fields at their defaults,
    bit for bit."""
    import torch.distributed as dist
    from _torch_parity import port_tree_with_axes
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import placement
    from repro_torch.parallel.sharding import make_param_shardings
    _, trun = _runs("branched", True, 1, 2)
    trun = dataclasses.replace(trun, parallel=dataclasses.replace(
        trun.parallel, fsdp=True, shard_vocab=True, multi_pod=True))
    data = ByteTextLM(trun.model, batch=2, seq_len=16)
    tm = get_model(trun.model, "cpu")
    ocfg = optim.OptimConfig(**OCFG)
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        runs = []
        for mesh in (None, make_mesh((1, 1, 1), ("pod", "data", "model"))):
            tp = freezing.set_requires_grad(_fresh("branched"), freeze=True)
            if mesh is not None:
                tp = placement.place(tp, make_param_shardings(
                    mesh, tp, port_tree_with_axes("branched")[1],
                    trun.parallel))
                # a leaf gathered at use is whole and contiguous, as the
                # card's kernels take their operands
                for _, p in paths(tp):
                    g = placement.gather(p)
                    assert g.shape == p.shape and g.is_contiguous()
            state = steps.init_opt_state(tm, trun, tp, ocfg)
            step = steps.make_train_step(tm, trun, ocfg, mesh)
            losses = []
            for i in range(2):
                tp, state, met = step(tp, state, {"tokens": torch.from_numpy(
                    data.batch(i)["tokens"])})
                losses.append(float(met["loss"]))
            runs.append((losses, flat(placement.whole(tp) if mesh else tp)))
    finally:
        dist.destroy_process_group()
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    assert p0.keys() == p1.keys()
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    registered = registry.get("llama3.2-1b").parallel("train")
    assert registered != ParallelConfig(remat="full")
    data = ByteTextLM(trun.model, batch=2, seq_len=16)
    out = []
    for par in (registered, ParallelConfig(remat="full")):
        run = dataclasses.replace(trun, parallel=par)
        tm = get_model(run.model, "cpu")
        tp = freezing.set_requires_grad(_fresh("branched"), freeze=True)
        ocfg = optim.OptimConfig(**OCFG)
        state = steps.init_opt_state(tm, run, tp, ocfg)
        step = steps.make_train_step(tm, run, ocfg)
        losses = []
        for i in range(2):
            tp, state, met = step(tp, state, {"tokens": torch.from_numpy(
                data.batch(i)["tokens"])})
            losses.append(float(met["loss"]))
        out.append((losses, flat(tp)))
    (l0, p0), (l1, p1) = out
    assert l0 == l1
    assert p0.keys() == p1.keys()
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


# ---------------------------------------------------------------------------
# data and the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,batch,seq", [(0, 4, 64), (3, 3, 40)])
def test_byte_text_batches_match_reference(seed, batch, seq, tmp_path):
    cfg = dataclasses.replace(torch_cfg(), vocab_size=97)
    jcfg = dataclasses.replace(jax_cfg(), vocab_size=97)
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(bytes(range(256)) * 9)
    for path in (None, str(corpus)):
        t = ByteTextLM(cfg, batch=batch, seq_len=seq, path=path, seed=seed)
        j = JByteTextLM(jcfg, batch=batch, seq_len=seq, path=path, seed=seed)
        per_epoch = max(1, t.n_seqs // batch)
        for step in (0, 1, per_epoch - 1, per_epoch, 3 * per_epoch + 2):
            got = t.batch(step)["tokens"]
            assert isinstance(got, np.ndarray) and got.dtype == np.int32
            np.testing.assert_array_equal(got, np.asarray(
                j.batch(step)["tokens"]))


def test_synthetic_batches_deterministic():
    from repro_torch.configs.base import ShapeConfig
    ds = SyntheticLM(torch_cfg(), ShapeConfig("smoke", 16, 2, "train"),
                     seed=3)
    stream = ds.stream(DataState())
    batches = [next(stream) for _ in range(4)]
    b2, _ = next(ds.stream(batches[1][1]))
    assert torch.equal(b2["tokens"], batches[2][0]["tokens"])
    assert not torch.equal(batches[0][0]["tokens"], batches[1][0]["tokens"])
    assert batches[0][0]["tokens"].dtype == torch.int32


def test_bridge_carries_optimizer_and_powersgd_state():
    jrun, _ = _runs("branched", True, 1, 2)
    jp = jax_params("branched")
    state = _to_np(jsteps.init_opt_state(jget_model(jrun.model), jrun, jp,
                                         joptim.OptimConfig()))
    tt = bridge.to_torch(state, "cpu")
    assert tt["adam"]["step"].dtype == torch.int32
    assert tt["adam"]["step"].shape == ()
    assert tt["adam"]["m"]["blocks"]["attn"]["k"]["w0"].shape == (0,)
    assert set(tt["ef"]["embed"]["w"]) == {"err", "q"}
    assert set(tt["ef"]["final_norm"]["scale"]) == {"err"}
    back = flat(bridge.to_numpy(tt))
    for k, a in flat(state).items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        assert back[k].tobytes() == a.tobytes(), k
