"""ResNet fine-tuning in the port against the reference: the loss and
every gradient of the reference's trees (``tests/_torch_resnet.py``)
against ``jax.value_and_grad``, with the §2.2 freeze off and on (loss
within 1e-5, gradients within 1e-4 relative L2; a factor the port's
forward detached has no gradient where the reference's ``stop_gradient``
gives zeros), the optimizer's freeze mask leaf for leaf, the image
source and the model API, and the ``examples_torch/compress_resnet.py``
twin on the CPU.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_resnet as R
from _torch_resnet import one_thread  # noqa: F401  (autouse fixture)
from repro.core.freezing import trainable_mask as jtrainable_mask
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import freezing
from repro_torch.models import resnet
from repro_torch.models.api import get_model, synth_inputs
from repro_torch.models.blocks import BlockOpts
from repro_torch.train.data import DataState, SyntheticImages
from repro_torch.tree import paths

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _flat(tree):
    return {tuple(getattr(k, "key", k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


#: the dense and merged trees hold no factor the freeze would stop
@pytest.mark.parametrize("name,freeze", [
    ("dense", False), ("layer_merging", False), ("vanilla_lrd", False),
    ("vanilla_lrd", True), ("layer_branching", False),
    ("layer_branching", True)])
def test_loss_and_gradients_equal_reference(name, freeze):
    batch = R.images(2, seed=5)
    jm = R.jax_model()
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, freeze_factors=freeze), has_aux=True))(
        R.jax_tree(name), R.jnp_tree(batch))
    m = resnet.ResNetModel(R.cfg("torch"), "cpu")
    tp = freezing.set_requires_grad(R.torch_tree(name), freeze=freeze)
    tl, tmet = m.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                      opts=BlockOpts(freeze_factors=freeze))
    wrt = [(p, t) for p, t in paths(tp) if t.requires_grad]
    grads = dict(zip((p for p, _ in wrt),
                     torch.autograd.grad(tl, [t for _, t in wrt])))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(tmet["acc"]) == float(jmet["acc"])
    jflat = _flat(jg)
    frozen = set()
    for path, _ in paths(tp):
        want = np.asarray(jflat[path])
        if path not in grads:            # detached: the reference's zeros
            assert freeze and not np.any(want), path
            frozen.add(path[-1])
            continue
        g = grads[path].numpy()
        rel = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-4, (path, rel)
    want_frozen = {"vanilla_lrd": {"w0", "tucker_u", "tucker_v"},
                   "layer_branching": {"u", "v", "tucker_u", "tucker_v"}}
    assert frozen == (want_frozen[name] if freeze else set())
    # the optimizer's mask is the reference's, leaf for leaf
    tmask = dict(paths(freezing.trainable_mask(tp, enabled=freeze)))
    jmask = {k: bool(v) for k, v in _flat(jtrainable_mask(
        R.jax_tree(name), enabled=freeze)).items()}
    assert tmask == jmask


def test_synthetic_images_and_api():
    cfg = R.cfg("torch")
    data = SyntheticImages(cfg, batch=3, seed=1)
    b = data.batch(4)
    assert b["images"].shape == (3, 32, 32, 3)
    assert b["images"].dtype == torch.float32
    assert b["labels"].dtype == torch.int32
    assert 0 <= int(b["labels"].min()) and int(b["labels"].max()) < 10
    assert torch.equal(b["images"], data.batch(4)["images"])
    assert not torch.equal(b["images"], data.batch(5)["images"])
    b0, st = next(data.stream(DataState(4)))
    assert st.step == 5 and torch.equal(b0["labels"], b["labels"])
    m = get_model(cfg, "cpu")
    assert isinstance(m, resnet.ResNetModel) and m.device.type == "cpu"
    assert get_model(treg.get("resnet101").full).device.type == "cuda"
    ins = synth_inputs(cfg, ShapeConfig("t", 0, 5, "train"),
                       torch.Generator().manual_seed(0))
    assert ins["images"].shape == (5, 32, 32, 3)
    assert ins["images"].dtype == torch.float32
    assert ins["labels"].dtype == torch.int32
    assert int(ins["labels"].max()) < cfg.num_classes
    params, _ = m.init(torch.Generator().manual_seed(0))
    loss, met = m.loss(params, ins)
    assert torch.isfinite(loss) and set(met) == {"ce", "acc"}
    with pytest.raises(ValueError, match="remat"):
        m.loss(params, ins, remat="full")


def test_compress_resnet_example_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "compress_resnet", ROOT / "examples_torch" / "compress_resnet.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    rows = {ln.split()[0]: ln.split() for ln in out.splitlines()[1:]}
    assert set(rows) == {"original", "vanilla_lrd", "optimized_ranks",
                         "layer_freezing", "layer_merging",
                         "layer_branching"}
    assert rows["original"][1] == rows["layer_merging"][1] == "18"
    assert int(rows["vanilla_lrd"][1]) > 18
    for row in rows.values():
        assert all(np.isfinite(float(row[i])) for i in (4, 6))
