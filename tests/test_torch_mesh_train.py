"""Training on a mesh: two gloo ranks on the CPU (``_torch_mesh.py``: one
spawn for every case of this file) against one process without a mesh,
and multi-pod EF-PowerSGD against the reference's ``compress_decompress``.

(a) data parallel on (pod, data, model) = (1, 2, 1) and (b) FSDP with
the vocab sharded on (1, 1, 2) equal two steps of one process on the
whole batch: the losses within 1e-6 relative, every updated parameter
within 1e-5 relative L2 (f32; the gradient is a mean over ranks, summed
in another order); under (b) each rank stores exactly the shard bytes
its placements imply, fewer than the whole tree.  (c) One multi-pod sync
on (2, 1, 1): each pod's synced gradients and error buffer equal the
reference's ``compress_decompress`` run under ``jax.vmap(...,
axis_name="pod")`` with ``reduce_fn = pmean over "pod"`` on both pods'
gradients, within 1e-5 relative L2, and its Qs up to the sign of each
column (QR's sign is free; ``p @ q.T`` is not); the warm-start Qs come
from the reference's ``init_state``, since ``jax.random`` cannot be
replayed.  (d) ``train()`` on a (1, 2, 1) FSDP mesh resumed from a
checkpoint written on the mesh continues as the run that never stopped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh as tm
from _torch_parity import flat, torch_threads
from repro.train import compression as jcomp

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _ref_qs():
    """The reference's warm-start Qs for the (c) tree's gradients."""
    params, _ = tm.smoke_tree(tm.train_run(False, multi_pod=True,
                                           grad_compression_rank=2))
    zeros = jax.tree.map(lambda t: jnp.zeros(tuple(t.shape), jnp.float32),
                         params)
    return jcomp.init_state(zeros, jcomp.CompressionConfig(rank=2),
                            jax.random.PRNGKey(17))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ef0 = _ref_qs()
    payload = {"q": tm.q_paths(ef0),
               "ckpt_dir": str(tmp_path_factory.mktemp("mesh_ckpt"))}
    return tm.run_ranks("train_cases", payload), ef0


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _same_steps(got: dict, want: dict) -> None:
    for g, w in zip(got["losses"], want["losses"]):
        assert abs(g - w) <= 1e-6 * abs(w), (got["losses"], want["losses"])
    gp, wp = flat(got["params"]), flat(want["params"])
    assert gp.keys() == wp.keys()
    for k in wp:
        assert _rel(gp[k].numpy(), wp[k].numpy()) <= REL, k


def test_data_parallel_step_equals_the_whole_batch(ranks):
    outs, _ = ranks
    want = tm.steps_of(tm.train_run(True))
    for r in outs:
        _same_steps(r["dp"], want)


def test_fsdp_vocab_sharded_step_equals_the_whole_batch(ranks):
    outs, _ = ranks
    want = tm.steps_of(tm.train_run(True, fsdp=True, shard_vocab=True))
    for r in outs:
        got = r["fsdp"]
        _same_steps(got, want)
        assert got["stored_bytes"] == got["implied_bytes"]
        assert got["stored_bytes"] < got["whole_bytes"]


def _nest(flat_tree: dict) -> dict:
    out: dict = {}
    for k, v in flat_tree.items():
        node = out
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def test_multi_pod_powersgd_equals_reference_under_vmap(ranks):
    outs, ef0 = ranks
    pods = sorted((o["pod"] for o in outs), key=lambda r: r["pod"])
    assert [r["pod"] for r in pods] == [0, 1]
    assert pods[0]["loss"] == pods[1]["loss"]      # averaged over pods
    locals_ = [flat(r["local"]) for r in pods]
    keys = sorted(locals_[0])
    assert all(lc[k] is not None for lc in locals_ for k in keys)
    grads = _nest({k: jnp.stack([jnp.asarray(lc[k].numpy())
                                 for lc in locals_]) for k in keys})

    def sync(g):
        g2, ef2, _ = jcomp.compress_decompress(
            g, ef0, jcomp.CompressionConfig(rank=2),
            lambda t: jax.lax.pmean(t, "pod"))
        return g2, ef2
    g2, ef2 = jax.vmap(sync, axis_name="pod")(grads)
    g2, ef2 = flat(g2), flat(ef2)
    n_q = 0
    for pod, r in enumerate(pods):
        synced, ef = flat(r["synced"]), flat(r["ef"])
        assert synced.keys() == set(keys)
        for k in keys:
            assert _rel(synced[k].numpy(), g2[k][pod]) <= REL, k
        assert ef.keys() == ef2.keys()
        for k, v in ef.items():
            want = np.asarray(ef2[k][pod])
            if k.endswith("/q"):
                signs = np.sign(np.sum(v.numpy() * want, axis=0))
                assert np.all(signs != 0), k
                assert _rel(v.numpy() * signs, want) <= REL, k
                n_q += 1
            elif v.numel():
                assert _rel(v.numpy(), want) <= REL, k
    assert n_q > 0


def test_checkpoint_on_the_mesh_resumes_the_same_step(ranks):
    outs, _ = ranks
    for r in outs:
        got = r["ckpt"]
        assert got["resumed_from"] == 2
        assert got["first"] == got["straight"][:2]
        assert len(got["again"]) == 1
        assert abs(got["again"][0] - got["straight"][2]) \
            <= 1e-6 * abs(got["straight"][2])
        assert got["shard_bytes"] > 0
