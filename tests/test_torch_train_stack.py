"""The reference's training-stack tests (``tests/test_train_stack.py``)
replayed on the port, on the CPU: optimizer, compression, checkpoints
(round trip, corruption, atomic commit, async writer), data resume,
fault tolerance, and the loop's resume-identical, fault-restart,
preemption and freezing runs; then the quickstart twin, whose loss must
fall.  The straggler detector is driven by an injected clock, not by
timed sleeps."""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import torch_threads
from repro_torch.configs import registry
from repro_torch.configs.base import (LRDConfig, ParallelConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import optim
from repro_torch.train.data import ByteTextLM, DataState, SyntheticLM
from repro_torch.train.fault_tolerance import (PreemptionHandler,
                                               StragglerDetector,
                                               run_with_restart)
from repro_torch.train.loop import train

SHAPE = ShapeConfig("smoke", 64, 2, "train")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def tiny_run(lrd=LRDConfig()):
    return RunConfig(model=registry.get("llama3.2-1b").smoke, lrd=lrd,
                     parallel=ParallelConfig(remat="none"))


def _quiet(**kw):
    return dict(log_every=0, log_fn=lambda s: None, device="cpu", **kw)


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(0)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

class TestOptim:
    def test_adamw_reduces_quadratic(self):
        params = {"w": torch.tensor([3.0, -2.0])}
        cfg = optim.OptimConfig(peak_lr=0.1, warmup_steps=1, total_steps=50,
                                weight_decay=0.0, grad_clip=0)
        state = optim.adamw_init(params)
        for _ in range(50):
            grads = {"w": 2 * params["w"]}
            params, state, _ = optim.adamw_update(grads, state, params, cfg)
        assert float(params["w"].abs().max()) < 0.6

    def test_masked_leaves_not_updated_and_stateless(self):
        params = {"a": torch.ones(4), "b": torch.ones(4)}
        mask = {"a": True, "b": False}
        state = optim.adamw_init(params, mask)
        assert state["m"]["b"].numel() == 0       # no moment memory
        grads = {"a": torch.ones(4), "b": torch.ones(4)}
        cfg = optim.OptimConfig(peak_lr=0.1, warmup_steps=1, total_steps=10)
        p2, _, _ = optim.adamw_update(grads, state, params, cfg, mask)
        assert float((p2["b"] - 1.0).abs().max()) == 0
        assert float((p2["a"] - 1.0).abs().max()) > 0

    def test_lr_schedule(self):
        cfg = optim.OptimConfig(peak_lr=1.0, warmup_steps=10,
                                total_steps=100, min_lr_frac=0.1)
        assert float(optim.lr_schedule(cfg, 5)) == pytest.approx(0.5,
                                                                 rel=0.1)
        assert float(optim.lr_schedule(cfg, 100)) == pytest.approx(0.1,
                                                                   rel=0.05)

    def test_bf16_leaf_updates_in_f32(self):
        params = {"w": torch.ones(3, dtype=torch.bfloat16)}
        state = optim.adamw_init(params)
        assert state["m"]["w"].dtype == torch.float32
        p2, s2, _ = optim.adamw_update({"w": torch.ones(3,
                                                        dtype=torch.bfloat16)},
                                       state, params, optim.OptimConfig(
                                           warmup_steps=1))
        assert p2["w"].dtype == torch.bfloat16 and int(s2["step"]) == 1


# ---------------------------------------------------------------------------
# PowerSGD compression
# ---------------------------------------------------------------------------

class TestCompression:
    def test_lowrank_grad_exact(self, gen):
        g = {"w": torch.randn(64, 4, generator=gen)
             @ torch.randn(4, 48, generator=gen)}
        cfg = comp.CompressionConfig(rank=4, min_dim=4)
        st = comp.init_state(g, cfg, gen)
        out, _, stats = comp.compress_decompress(g, st, cfg, lambda x: x)
        np.testing.assert_allclose(out["w"].numpy(), g["w"].numpy(),
                                   atol=1e-3)
        assert stats["bytes_sent"] < stats["bytes_raw"]

    def test_error_feedback_accumulates(self, gen):
        g = {"w": torch.randn(32, 32, generator=gen)}
        cfg = comp.CompressionConfig(rank=2, min_dim=4)
        st = comp.init_state(g, cfg, gen)
        total = torch.zeros_like(g["w"])
        n = 30
        for _ in range(n):
            out, st, _ = comp.compress_decompress(g, st, cfg, lambda x: x)
            total = total + out["w"]
        rel = float(torch.linalg.norm(total / n - g["w"])
                    / torch.linalg.norm(g["w"]))
        assert rel < 0.45

    def test_small_tensors_uncompressed(self, gen):
        g = {"bias": torch.ones(8)}
        cfg = comp.CompressionConfig(rank=4, min_dim=64)
        st = comp.init_state(g, cfg, gen)
        out, _, stats = comp.compress_decompress(g, st, cfg, lambda x: x)
        np.testing.assert_allclose(out["bias"].numpy(), 1.0)
        assert stats["bytes_sent"] == stats["bytes_raw"]

    def test_missing_gradient_passes_through(self, gen):
        g = {"w": torch.randn(32, 32, generator=gen), "frozen": None}
        cfg = comp.CompressionConfig(rank=2, min_dim=4)
        st = comp.init_state({"w": g["w"], "frozen": torch.zeros(32, 32)},
                             cfg, gen)
        out, st2, _ = comp.compress_decompress(g, st, cfg, lambda x: x)
        assert out["frozen"] is None and st2["frozen"] is st["frozen"]


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def _tree(self, gen):
        return {"params": {"w": torch.randn(8, 8, generator=gen),
                           "h": torch.randn(4, generator=gen).to(
                               torch.bfloat16).requires_grad_(True)},
                "opt": {"step": torch.tensor(7, dtype=torch.int32)},
                "data": {"step": np.asarray(7)}}

    def test_roundtrip(self, tmp_path, gen):
        tree = self._tree(gen)
        ckpt.save(str(tmp_path), 7, tree, meta={"loss": 1.5})
        got, manifest = ckpt.restore_latest(str(tmp_path), tree)
        assert torch.equal(got["params"]["w"], tree["params"]["w"])
        h = got["params"]["h"]
        assert h.dtype == torch.bfloat16 and h.requires_grad
        assert torch.equal(h, tree["params"]["h"])
        assert got["opt"]["step"].dtype == torch.int32
        assert isinstance(got["data"]["step"], np.ndarray)
        assert manifest["step"] == 7 and manifest["meta"]["loss"] == 1.5

    def test_corruption_detected_and_skipped(self, tmp_path, gen):
        tree = self._tree(gen)
        ckpt.save(str(tmp_path), 1, tree)
        ckpt.save(str(tmp_path), 2, tree)
        with open(os.path.join(str(tmp_path), "step_00000002",
                               "arrays.npz"), "r+b") as f:
            f.seek(10)
            f.write(b"\xde\xad\xbe\xef")
        assert ckpt.latest_valid(str(tmp_path)) == "step_00000001"

    def test_atomic_no_partial(self, tmp_path, gen):
        """A .tmp dir left behind never counts as a checkpoint."""
        tree = self._tree(gen)
        os.makedirs(os.path.join(str(tmp_path), ".tmp-step_00000009"))
        ckpt.save(str(tmp_path), 3, tree)
        assert ckpt.latest_valid(str(tmp_path)) == "step_00000003"

    def test_async_writer(self, tmp_path, gen):
        tree = self._tree(gen)
        w = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3):
            w.save(s, tree)
        w.close()
        names = ckpt.list_steps(str(tmp_path))
        assert names[-1] == "step_00000003"
        assert len(names) <= 2               # gc kept 2


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

class TestData:
    def test_synthetic_deterministic_resume(self):
        cfg = registry.get("llama3.2-1b").smoke
        ds = SyntheticLM(cfg, SHAPE, seed=3)
        stream = ds.stream(DataState())
        batches = [next(stream) for _ in range(5)]
        b3, _ = next(ds.stream(batches[2][1]))
        assert torch.equal(b3["tokens"], batches[3][0]["tokens"])

    def test_byte_text_shapes_and_resume(self):
        cfg = registry.get("llama3.2-1b").smoke
        ds = ByteTextLM(cfg, batch=2, seq_len=32)
        assert ds.batch(0)["tokens"].shape == (2, 32)
        np.testing.assert_array_equal(ds.batch(5)["tokens"],
                                      ds.batch(5)["tokens"])


# ---------------------------------------------------------------------------
# fault tolerance + loop integration
# ---------------------------------------------------------------------------

class TestFaultTolerance:
    def test_straggler_detector(self):
        durations = [0.002, 0.002, 0.002, 0.002, 0.05, 0.002]
        now = [0.0]
        d = StragglerDetector(threshold=3.0, warmup=1, clock=lambda: now[0])
        for i, dt in enumerate(durations):
            d.start()
            now[0] += dt
            d.stop(i)
        assert [e.step for e in d.events] == [4]
        assert d.report()["steps"] == 6

    def test_run_with_restart(self):
        calls = []

        def fn(attempt):
            calls.append(attempt)
            if attempt < 2:
                raise RuntimeError("injected node failure")
            return {"ok": True}

        out = run_with_restart(fn, max_restarts=3)
        assert out["restarts"] == 2 and calls == [0, 1, 2]


class TestLoopIntegration:
    def test_train_checkpoint_resume_identical(self, tmp_path):
        """Train 6 steps straight vs 3 + resume + 3: identical loss path
        (deterministic data stream + exact state restore)."""
        run = tiny_run()
        data = SyntheticLM(run.model, SHAPE, seed=1)
        r_full = train(run, data, num_steps=6, ckpt_dir=None, **_quiet())
        d1 = str(tmp_path / "ck")
        train(run, data, num_steps=3, ckpt_dir=d1, ckpt_every=1, **_quiet())
        r_b = train(run, data, num_steps=6, ckpt_dir=d1, ckpt_every=3,
                    resume=True, **_quiet())
        assert r_b.resumed_from == 3
        np.testing.assert_allclose(r_full.losses[3:], r_b.losses,
                                   rtol=2e-4, atol=2e-4)

    def test_fault_injection_restart(self, tmp_path):
        """A crash at step 4 restarts from the last checkpoint and
        completes — no step skipped or repeated in the loss path."""
        run = tiny_run()
        data = SyntheticLM(run.model, SHAPE, seed=1)
        d = str(tmp_path / "ck")
        crashed = {"done": False}

        def fault_hook(step):
            if step == 4 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("injected crash")

        def attempt(i):
            return {"result": train(run, data, num_steps=6, ckpt_dir=d,
                                    ckpt_every=1, fault_hook=fault_hook,
                                    **_quiet())}

        out = run_with_restart(attempt, max_restarts=2)
        assert out["restarts"] == 1
        assert out["result"].step == 6
        assert out["result"].resumed_from == 4

    def test_preemption_checkpoints_and_exits(self, tmp_path):
        run = tiny_run()
        data = SyntheticLM(run.model, SHAPE, seed=1)
        d = str(tmp_path / "ck")
        handler = PreemptionHandler(signals=())

        def hook(step):
            if step == 2:
                handler.request()

        r = train(run, data, num_steps=10, ckpt_dir=d, ckpt_every=100,
                  fault_hook=hook, preemption=handler, **_quiet())
        assert r.step == 3                    # stopped early
        assert ckpt.latest_valid(d) is not None

    def test_freezing_trains_only_live_factors(self):
        """Paper §2.2 end to end: frozen factors identical after training,
        no moments for them, the live factor moved."""
        from repro_torch.core import freezing
        from repro_torch.core.surgery import decompose_model
        from repro_torch.models.api import get_model
        from repro_torch.train.steps import init_opt_state, make_train_step
        run = tiny_run(LRDConfig(enabled=True, rank_mode="ratio", min_dim=32,
                                 freeze=True))
        data = SyntheticLM(run.model, SHAPE, seed=1)
        m = get_model(run.model, "cpu")
        with torch.no_grad():
            params, axes = m.init(torch.Generator().manual_seed(0))
            params, _, _ = decompose_model(params, axes, run.lrd)
        freezing.set_requires_grad(params, freeze=True)
        w0_before = params["blocks"]["mlp"]["up"]["w0"].clone()
        ocfg = optim.OptimConfig(peak_lr=1e-2, warmup_steps=1, total_steps=3)
        opt = init_opt_state(m, run, params, ocfg)
        step = make_train_step(m, run, ocfg)
        batch = data.batch(0)
        for _ in range(3):
            params, opt, _ = step(params, opt, batch)
        assert torch.equal(params["blocks"]["mlp"]["up"]["w0"], w0_before)
        m_state = opt["adam"]["m"]["blocks"]["mlp"]["up"]
        assert m_state["w0"].numel() == 0        # frozen: no moments
        assert float(m_state["w1"].abs().max()) > 0

    def test_train_reports_counts(self):
        run = tiny_run(LRDConfig(enabled=True, rank_mode="ratio", min_dim=32,
                                 freeze=True))
        r = train(run, SyntheticLM(run.model, SHAPE, seed=1), num_steps=2,
                  **_quiet())
        st = r.stats
        assert len(st["step_seconds"]) == 2 and len(r.losses) == 2
        assert st["trainable_params"] > 0 and st["frozen_params"] > 0
        # two f32 moments a trainable value, and the int32 step
        assert st["optimizer_state_bytes"] == 8 * st["trainable_params"] + 4


def test_quickstart_twin_loss_falls():
    sys.path.insert(0, str(ROOT / "examples_torch"))
    try:
        import quickstart
    finally:
        sys.path.pop(0)
    result = quickstart.main(["--cpu"])
    assert result.losses[-1] < result.losses[0]
