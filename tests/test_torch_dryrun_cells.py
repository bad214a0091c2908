"""The port's dry run (``launch/dryrun.py``) at full width: llama3.2-1b's
decode_32k cell on a 256-rank fake process group, in a subprocess
(the card is never touched), the report over it, and the sweep's cell
list against the reference's."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import report
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------

def run_cell_subprocess(tmp: Path, *flags: str) -> dict:
    out = tmp / "cell.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "llama3.2-1b", *flags, "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.exists(), res.stderr[-3000:]
    cell = json.loads(out.read_text())
    assert res.returncode == 0, cell.get("error", res.stderr[-3000:])
    return cell


@pytest.fixture(scope="module")
def decode_cell(tmp_path_factory) -> tuple[Path, dict]:
    tmp = tmp_path_factory.mktemp("dryrun")
    return tmp, run_cell_subprocess(tmp, "--shape", "decode_32k")


CELL_KEYS = {"arch", "shape", "mesh", "status", "n_devices", "trace_s",
             "memory", "costs", "roofline", "surgery", "sharding_notes",
             "total_s", "cuda_initialized"}


def test_the_decode_cell_runs_on_the_256_rank_fake_mesh(decode_cell):
    _, c = decode_cell
    assert c["status"] == "ok" and set(c) == CELL_KEYS
    assert (c["mesh"], c["n_devices"]) == ("single_pod", 256)
    assert c["cuda_initialized"] is False
    assert c["memory"]["fits_hbm"] and 0 < c["memory"]["argument_bytes"] \
        <= c["memory"]["peak_bytes"]
    co = c["costs"]
    assert co["collective_detail"]["all-gather"] > 0
    assert co["kernel_detail"]["lowrank_matmul"]["calls"] > 0
    r = c["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < r["useful_flops_ratio"] < 1
    assert c["surgery"]["layers_decomposed"] > 0


def test_the_report_renders_the_cell(decode_cell, capsys):
    tmp, c = decode_cell
    cells = report.load_cells(str(tmp))
    assert cells == [c]
    table = report.roofline_table(cells, "single_pod")
    assert f"| llama3.2-1b | decode_32k |" in table
    assert f"**{c['roofline']['bottleneck']}**" in table
    assert "| llama3.2-1b | decode_32k |" in report.dryrun_table(
        cells, "single_pod")
    assert report.summarize(str(tmp))["ok"] == 1
    report.main([str(tmp)])
    assert "## Summary" in capsys.readouterr().out


_REFERENCE_CELLS = (
    "import json, repro.launch.dryrun as d; print(json.dumps(d.all_cells()))")


def test_all_cells_equal_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REFERENCE_CELLS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = [tuple(c) for c in json.loads(res.stdout.strip().splitlines()[-1])]
    assert dryrun.all_cells() == want
