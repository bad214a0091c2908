"""Bridge round trips: keys, shapes, dtypes and bits exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import flat, jax_tree, to_numpy
from repro_torch import bridge


@pytest.mark.parametrize("name", ["dense", "svd", "branched"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_tree_round_trips(name, dtype):
    tree = to_numpy(jax_tree(name)[0])
    if dtype == "bfloat16":
        tree = {k: v for k, v in flat(tree).items()}
        tree = {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
                for k, v in tree.items()}
    src = flat(tree)
    tt = bridge.to_torch(tree, "cpu")
    flat_t = flat(tt)
    assert flat_t.keys() == src.keys()
    want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for k, t in flat_t.items():
        assert t.dtype == want and tuple(t.shape) == src[k].shape, k
    back = flat(bridge.to_numpy(tt))
    assert back.keys() == src.keys()
    for k, a in back.items():
        assert a.dtype == src[k].dtype and a.shape == src[k].shape, k
        assert a.tobytes() == src[k].tobytes(), k


def test_int32_and_nesting_round_trip():
    tree = {"a": {"b": np.arange(12, dtype=np.int32).reshape(3, 4)},
            "c": np.float32(2.5) * np.ones((2,), np.float32)}
    tt = bridge.to_torch(tree, "cpu")
    assert tt["a"]["b"].dtype == torch.int32
    back = bridge.to_numpy(tt)
    assert back["a"]["b"].dtype == np.int32
    np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"])
    np.testing.assert_array_equal(back["c"], tree["c"])


def test_bf16_values_survive_exactly():
    x = np.asarray(jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32))
                   .astype(jnp.bfloat16))
    t = bridge.array_to_tensor(x, "cpu")
    np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                  x.astype(np.float32))
