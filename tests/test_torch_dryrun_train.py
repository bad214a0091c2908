"""The port's dry run at full width on the multi-pod mesh: llama3.2-1b's
train_4k cell on a 512-rank fake process group (2 x 16 x 16), in a
subprocess: the step's all-gathers, its gradients' mean over ``pod``,
the memory per device and the report's tables."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import report

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def train_cell(tmp_path_factory) -> tuple[Path, dict]:
    tmp = tmp_path_factory.mktemp("dryrun_mp")
    out = tmp / "llama3.2-1b__train_4k__mp.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--shape", "train_4k", "--multi-pod", "--out",
         str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert out.exists(), res.stderr[-3000:]
    cell = json.loads(out.read_text())
    assert res.returncode == 0, cell.get("error", res.stderr[-3000:])
    return tmp, cell


def test_the_train_cell_runs_on_the_512_rank_fake_mesh(train_cell):
    _, c = train_cell
    assert c["status"] == "ok"
    assert (c["mesh"], c["n_devices"]) == ("multi_pod", 512)
    assert c["cuda_initialized"] is False
    assert c["memory"]["fits_hbm"]
    co = c["costs"]
    # every block's leaves gathered at use, over data (16) or model (16)
    assert co["collective_groups"]["all-gather N=16"] > 0
    # the gradients' mean over pod (2 ranks): the train step's pod sync
    assert co["collective_groups"]["all-reduce N=2"] > 0
    assert co["collective_bytes_per_device"] == pytest.approx(
        sum(co["collective_detail"].values()))
    # the backward's explicit products are counted beside the kernels'
    # forwards (twice each under remat "full")
    kd = co["kernel_detail"]["lowrank_matmul"]
    assert co["flops_per_device"] > 2 * kd["flops"] > 0
    assert c["roofline"]["useful_flops_ratio"] > 0


def test_the_report_renders_the_multi_pod_cell(train_cell):
    tmp, c = train_cell
    cells = report.load_cells(str(tmp))
    assert "| llama3.2-1b | train_4k |" in report.dryrun_table(
        cells, "multi_pod")
    assert "train_4k" not in report.dryrun_table(cells, "single_pod")
    assert "**" + c["roofline"]["bottleneck"] + "**" in \
        report.roofline_table(cells, "multi_pod")
