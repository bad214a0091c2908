"""The port stands alone: it imports torch, never jax, and nothing of the
reference package."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules() -> list[str]:
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_has_the_slice_modules():
    mods = set(_modules())
    for m in ("repro_torch.bridge", "repro_torch.configs.base",
              "repro_torch.kernels.ops", "repro_torch.kernels.ref",
              "repro_torch.kernels.build", "repro_torch.layers.plan",
              "repro_torch.layers.cache", "repro_torch.core.surgery",
              "repro_torch.models.lm", "repro_torch.serve.engine",
              "repro_torch.quant.quantize", "repro_torch.quant.kv",
              "repro_torch.kernels.lowrank_matmul_q",
              "repro_torch.kernels.branched_matmul_q",
              "repro_torch.kernels.decode_attention_q",
              "repro_torch.kernels.lowrank_matmul_qa",
              "repro_torch.kernels.branched_matmul_qa",
              "repro_torch.kernels.decode_attention_paged",
              "repro_torch.core.cost_model", "repro_torch.serve.paging",
              "repro_torch.kernels.decode_attention_latent_q",
              "repro_torch.configs.deepseek_v2_236b",
              "repro_torch.quant.sparse",
              "repro_torch.kernels.lowrank_matmul_sq",
              "repro_torch.kernels.branched_matmul_sq",
              "repro_torch.kernels.autograd", "repro_torch.core.freezing",
              "repro_torch.models.api", "repro_torch.train.optim",
              "repro_torch.train.compression", "repro_torch.train.steps",
              "repro_torch.train.data", "repro_torch.train.checkpoint",
              "repro_torch.train.fault_tolerance",
              "repro_torch.train.loop", "repro_torch.analysis",
              "repro_torch.analysis.hw_specs",
              "repro_torch.core.rank_selection",
              "repro_torch.core.merging", "repro_torch.core.svd",
              "repro_torch.serve.faults", "repro_torch.serve.guard",
              "repro_torch.serve.router", "repro_torch.layers.moe",
              "repro_torch.layers.mlp", "repro_torch.configs.granite_8b",
              "repro_torch.configs.mistral_nemo_12b",
              "repro_torch.configs.minitron_4b",
              "repro_torch.configs.moonshot_v1_16b_a3b",
              "repro_torch.layers.ssm", "repro_torch.configs.mamba2_2_7b",
              "repro_torch.configs.zamba2_1_2b", "repro_torch.core.tucker",
              "repro_torch.layers.conv", "repro_torch.models.resnet",
              "repro_torch.configs.resnet",
              "repro_torch.configs.llama_3_2_vision_90b",
              "repro_torch.configs.hubert_xlarge",
              "repro_torch.configs.registry", "repro_torch.launch.train",
              "repro_torch.launch.serve", "repro_torch.launch.mesh",
              "repro_torch.parallel", "repro_torch.parallel.sharding",
              "repro_torch.parallel.placement",
              "repro_torch.analysis.roofline", "repro_torch.analysis.report",
              "repro_torch.launch.dryrun"):
        assert m in mods, m


def test_importing_every_module_leaves_jax_and_repro_out():
    examples = sorted(str(p) for p in (ROOT / "examples_torch").glob("*.py"))
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        f"for i, p in enumerate({examples!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'jaxlib', "
        "'repro') or k.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                        r"|from\s+repro\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + sorted((ROOT / "examples_torch").glob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_or_reference_import(path):
    text = path.read_text()
    assert not _FORBIDDEN.findall(text), _FORBIDDEN.findall(text)
    assert not re.search(r"\bfrom repro\.", text)
    assert not re.search(r"\bimport repro\b(?!_torch)", text)
