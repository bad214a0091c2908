"""The port's config API and launchers against the reference's: the
registry's ``names()``, ``assigned_names()`` and every arch's
``parallel(kind)``; the shape cells (``SHAPES``, ``applicable_shapes``,
``skip_reason``); ``param_count`` / ``matmul_param_count`` /
``flops_per_token`` for every registered full and smoke config (the
port counts its own tree on the ``meta`` device); and both launchers
run ``--smoke --cpu`` to their last line."""
import dataclasses

import pytest

from _torch_parity import torch_threads
from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

KINDS = ("train", "prefill", "decode")
CONFIGS = [(a, w) for a in jreg.names() for w in ("full", "smoke")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def test_names_equal_reference():
    assert treg.names() == jreg.names()
    assert treg.assigned_names() == jreg.assigned_names()
    assert len(treg.assigned_names()) == 10


@pytest.mark.parametrize("arch", jreg.names())
def test_parallel_equals_reference(arch):
    for kind in KINDS:
        want = dataclasses.asdict(jreg.get(arch).parallel(kind))
        got = dataclasses.asdict(treg.get(arch).parallel(kind))
        assert got == want, (arch, kind)
    run = treg.run_config(arch, "decode")
    jrun = jreg.run_config(arch, "decode")
    assert dataclasses.asdict(run.parallel) == dataclasses.asdict(
        jrun.parallel)
    assert run.model == treg.get(arch).full
    assert run.lrd == tbase.LRDConfig()


def test_shape_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.asdict(getattr(tbase, name)) == \
            dataclasses.asdict(getattr(jbase, name))
    for arch, which in CONFIGS:
        t = getattr(treg.get(arch), which)
        j = getattr(jreg.get(arch), which)
        assert [s.name for s in tbase.applicable_shapes(t)] == \
            [s.name for s in jbase.applicable_shapes(j)]
        for name in tbase.SHAPES:
            assert tbase.skip_reason(t, tbase.SHAPES[name]) == \
                jbase.skip_reason(j, jbase.SHAPES[name])


@pytest.mark.parametrize("arch,which", CONFIGS)
def test_param_count_equals_reference(arch, which):
    t = getattr(treg.get(arch), which)
    j = getattr(jreg.get(arch), which)
    for active in (False, True):
        assert t.param_count(active) == j.param_count(active)
        assert t.matmul_param_count(active) == j.matmul_param_count(active)
        assert t.flops_per_token(active) == j.flops_per_token(active)
    if t.moe_num_experts:
        assert t.param_count(True) < t.param_count(False)


def test_parallel_config_takes_every_field():
    """The sharding fields are inert without a mesh, as the reference's."""
    fields = {f.name for f in dataclasses.fields(jbase.ParallelConfig)}
    assert fields == {f.name for f in dataclasses.fields(
        tbase.ParallelConfig)}
    for arch in jreg.names():
        for kind in KINDS:
            tbase.ParallelConfig(**dataclasses.asdict(
                jreg.get(arch).parallel(kind)))
    with pytest.raises(ValueError):
        tbase.ParallelConfig(remat="some")


def test_train_launcher_smoke_cpu(capsys, tmp_path):
    out = ttrain.main(["--arch", "llama3.2-1b", "--smoke", "--cpu",
                       "--steps", "2", "--ckpt-dir", str(tmp_path),
                       "--ckpt-every", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("[done] step=2 loss=")
    assert "restarts=0" in lines[-1]
    assert lines[0].startswith("[lrd] ")
    assert out["restarts"] == 0 and len(out["result"].losses) == 2
    # the checkpoint it wrote serves
    eng = tserve.main(["--arch", "llama3.2-1b", "--smoke", "--cpu",
                       "--ckpt-dir", str(tmp_path), "--requests", "2",
                       "--max-new", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1] == "[restore] step 2"
    assert lines[-1].startswith("[throughput] ")
    assert eng.throughput()["status_counts"] == {"finished": 2}


def test_train_launcher_vlm_feeds_image_embeds(capsys):
    out = ttrain.main(["--arch", "llama-3.2-vision-90b", "--smoke", "--cpu",
                       "--steps", "1", "--batch", "1", "--seq", "16",
                       "--lrd", "none"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "[done] step=1 loss=")
    assert out["result"].losses[0] > 0


def test_serve_launcher_smoke_cpu(capsys):
    eng = tserve.main(["--arch", "llama3.2-1b", "--smoke", "--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[lrd] ")
    assert lines[-1].startswith("[throughput] ")
    tp = eng.throughput()
    assert tp["status_counts"] == {"finished": 8}
    assert all(len(r.output) == 32 for r in eng.finished)


def test_serve_launcher_refuses_an_encoder():
    with pytest.raises(SystemExit, match="encoder-only"):
        tserve.main(["--arch", "hubert-xlarge", "--smoke", "--cpu"])


def test_launchers_take_only_the_reference_flags(monkeypatch):
    """The same flags as the reference's launchers, plus --cpu (each
    main's parser is read as it is built; ``--arch bogus`` then stops
    it at parse time)."""
    import argparse
    import sys

    import repro.launch.serve as jserve
    import repro.launch.train as jtrain
    monkeypatch.setattr(sys, "argv", ["launch", "--arch", "bogus"])
    orig = argparse.ArgumentParser.add_argument

    def flags(main):
        seen = []

        def spy(self, *a, **k):
            seen.extend(x for x in a if x.startswith("--"))
            return orig(self, *a, **k)
        monkeypatch.setattr(argparse.ArgumentParser, "add_argument", spy)
        with pytest.raises(SystemExit):
            main()
        monkeypatch.setattr(argparse.ArgumentParser, "add_argument", orig)
        return seen
    assert flags(ttrain.main) == flags(jtrain.main) + ["--cpu"]
    assert flags(tserve.main) == flags(jserve.main) + ["--cpu"]
