"""The port's one departure from the reference in the SSM and hybrid
families (ROADMAP §C): a prompt of 1 or 2 tokens, shorter than the conv
tail (``conv_width - 1`` = 3 rows), continues in the port's engine as the
reference's full-sequence ``LMModel.forward`` does (greedy argmax
recomputed token by token, f32), alone and after another stream in the
same slot.  The reference's engine keeps only the prompt's rows in the
tail and writes them at its start, over the slot's previous rows
(``repro/layers/ssm.py:199-205``, ``repro/serve/pool.py:271-285``), so
its stream departs from its own forward there; for prompts of 3 or more
tokens the two engines agree (``test_torch_serve_ssm.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import smoke_cfg, smoke_port_tree, to_jax, torch_threads
from repro.models.api import get_model as jget_model
from repro_torch.configs.base import RunConfig
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
N_NEW = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def _engine(name):
    return ServeEngine(RunConfig(model=smoke_cfg(name, "torch")),
                       smoke_port_tree(name, "dense")[0], device="cpu",
                       slots=1, max_seq=64, debug=True)


def _serve(eng, prompt_list):
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=N_NEW)
            for i, p in enumerate(prompt_list)]
    for r in reqs:
        eng.add_request(r)
    eng.run_until_done()
    assert all(r.status == "finished" and len(r.output) == N_NEW
               for r in reqs)
    return [r.output for r in reqs]


def _forward_greedy(name, params, prompt, n):
    """The reference's full-sequence forward, argmax recomputed token by
    token."""
    jm = jget_model(smoke_cfg(name, "jax"))
    jp = to_jax(params)
    seq, out = list(prompt), []
    for _ in range(n):
        x, _ = jm.forward(jp, {"tokens": jnp.asarray([seq], jnp.int32)})
        tok = int(jnp.argmax(jm.logits(jp, x[:, -1:])[0, -1]))
        out.append(tok)
        seq.append(tok)
    return out


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("plen", [1, 2])
def test_short_prompts_follow_the_forward(name, plen):
    """One slot: the short prompt served alone, and again after a 9-token
    stream has left its rows in the slot's conv tail."""
    params = smoke_port_tree(name, "dense")[0]
    short = np.random.default_rng(plen).integers(1, 250, plen).tolist()
    want = _forward_greedy(name, params, short, N_NEW)
    assert _serve(_engine(name), [short]) == [want]
    first = np.random.default_rng(11).integers(1, 250, 9).tolist()
    assert _serve(_engine(name), [first, short])[1] == want
