"""The port's step counter (``repro_torch.analysis.roofline``): the twin of
``tests/test_roofline_parser.py``, ``roofline()`` against the
reference's, ring collective bytes on a fake process group, and the
kernel entry points as one fused op each (their costs, their FLOPs
against torch's counter on the plain versions, nothing inside them
counted, nothing changed when no counter is active)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import roofline as jrl
from repro.analysis.hw_specs import TPU_V5E
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.hw_specs import H100, HardwareSpec
from repro_torch.kernels import ops, ref
from repro_torch.quant.kv import kv_scales, quantize_kv, quantize_kv_prefill
from repro_torch.quant.quantize import quantize_array
from repro_torch.quant.sparse import sparsify_array

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _count(fn, *args):
    with rl.StepCounter() as c:
        fn(*args)
    return c.costs


# ---------------------------------------------------------------------------
# Twins of tests/test_roofline_parser.py
# ---------------------------------------------------------------------------

class TestCounter:
    def test_single_mm_flops(self):
        a, b = torch.randn(128, 256), torch.randn(256, 512)
        assert _count(lambda: a @ b).flops == 2 * 128 * 256 * 512

    def test_loop_trip_scaling(self):
        x, w = torch.randn(32, 64), torch.randn(64, 64)

        def f():
            c = x
            for _ in range(7):
                c = torch.tanh(c @ w)
        assert _count(f).flops == 7 * 2 * 32 * 64 * 64

    def test_nested_loop(self):
        x, w = torch.randn(16, 32), torch.randn(32, 32)

        def f():
            c = x
            for _ in range(5):
                for _ in range(3):
                    c = c @ w
        assert _count(f).flops == 15 * 2 * 16 * 32 * 32

    def test_conv_flops(self):
        x, w = torch.randn(2, 16, 8, 8), torch.randn(32, 16, 3, 3)
        got = _count(lambda: F.conv2d(x, w, padding=1)).flops
        assert got == 2 * (2 * 8 * 8 * 32) * (3 * 3 * 16)

    def test_memory_traffic_positive_and_sane(self):
        a, b = torch.randn(128, 256), torch.randn(256, 512)
        costs = _count(lambda: a @ b)
        io_bytes = 4 * (128 * 256 + 256 * 512 + 128 * 512)
        assert io_bytes * 0.5 <= costs.hbm_bytes <= io_bytes * 4

    def test_views_are_free_and_a_slice_write_costs_the_slice(self):
        pool = torch.zeros(64, 1024)
        row = torch.randn(4, 1024)
        idx = torch.tensor([3, 9, 17, 40])

        def views():
            pool.t()[3:7].unsqueeze(0).expand(2, -1, -1)
            pool.view(-1)[:10].reshape(2, 5).select(0, 1)
        assert _count(views).hbm_bytes == 0
        costs = _count(lambda: pool.index_put_((idx,), row))
        # the rows written and read; the 32 index bytes are under the
        # reference's 128-byte floor
        assert costs.hbm_bytes == 2 * row.numel() * 4
        costs = _count(lambda: pool[5:9].copy_(row))
        assert costs.hbm_bytes == 2 * row.numel() * 4


class TestRoofline:
    def test_bottleneck_selection(self):
        c = rl.StepCosts(flops=1e12, hbm_bytes=1e6, collective_bytes=0)
        r = rl.roofline(c, n_devices=1, model_flops_global=5e11)
        assert r.bottleneck == "compute"
        assert r.useful_ratio == pytest.approx(0.5)
        c2 = rl.StepCosts(flops=1e9, hbm_bytes=1e12, collective_bytes=0)
        assert rl.roofline(c2, n_devices=1,
                           model_flops_global=1e9).bottleneck == "memory"

    def test_terms_use_hw_constants(self):
        c = rl.StepCosts(flops=H100.peak_flops_bf16,
                         hbm_bytes=H100.hbm_bandwidth,
                         collective_bytes=H100.ici_link_bandwidth)
        r = rl.roofline(c, n_devices=1, model_flops_global=1.0)
        assert r.compute_s == pytest.approx(1.0)
        assert r.memory_s == pytest.approx(1.0)
        assert r.collective_s == pytest.approx(1.0)

    @pytest.mark.parametrize("flops,hbm,coll,model,n", [
        (1e12, 1e6, 0.0, 5e11, 1), (1e9, 1e12, 3e8, 2e9, 16),
        (4e13, 2e11, 9e10, 1e16, 256), (0.0, 1e3, 0.0, 0.0, 1)])
    def test_roofline_equals_the_reference(self, flops, hbm, coll, model, n):
        spec = HardwareSpec(**{f: getattr(TPU_V5E, f) for f in (
            "name", "peak_flops_bf16", "hbm_bandwidth", "hbm_bytes",
            "ici_link_bandwidth", "mxu_dim", "sublanes", "vmem_bytes")})
        detail = {"all-gather": coll}
        got = rl.roofline(rl.StepCosts(flops, hbm, coll, dict(detail)),
                          n_devices=n, model_flops_global=model, spec=spec)
        want = jrl.roofline(jrl.HloCosts(flops, hbm, coll, dict(detail)),
                            n_devices=n, model_flops_global=model,
                            spec=TPU_V5E)
        for f in ("compute_s", "memory_s", "collective_s", "flops",
                  "hbm_bytes", "collective_bytes", "model_flops",
                  "bottleneck", "useful_ratio", "detail", "step_s",
                  "roofline_fraction"):
            assert getattr(got, f) == getattr(want, f), f


_COLLECTIVES = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.analysis.roofline import StepCounter
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
g = mesh.get_group("model")
out = {}
with FakeTensorMode():
    x = torch.empty(1000, dtype=torch.bfloat16)
    parts = [torch.empty_like(x) for _ in range(16)]
    for kind, fn in (("gather", lambda: dist.all_gather(parts, x, group=g)),
                     ("reduce", lambda: dist.all_reduce(x, group=g))):
        with StepCounter() as c:
            fn()
        out[kind] = [c.costs.collective_bytes, c.costs.collective_detail]
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_collective_bytes_follow_the_ring_formulas_on_a_fake_group():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _COLLECTIVES], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    n, payload = 16, 1000 * 2
    assert got["gather"] == [(n - 1) / n * n * payload,
                             {"all-gather": (n - 1) / n * n * payload}]
    assert got["reduce"] == [2 * (n - 1) / n * payload,
                             {"all-reduce": 2 * (n - 1) / n * payload}]


# ---------------------------------------------------------------------------
# The kernel entry points as fused ops
# ---------------------------------------------------------------------------

#: (M, C, R, S, N) of the chains at two shapes: a decode row block and a
#: ragged one
CHAIN_SHAPES = ((8, 64, 16, 96, 2), (37, 128, 32, 64, 3))
#: (B, S, KH, G, D) of the attentions at two shapes
ATTN_SHAPES = ((3, 32, 2, 2, 16), (4, 64, 1, 4, 32))
BS = 8


def _chain_args(name: str, i: int, g: torch.Generator) -> tuple:
    m, c, r, s, n = CHAIN_SHAPES[i]

    def rnd(*shape):
        return torch.randn(shape, generator=g) * shape[-2] ** -0.5

    x = torch.randn((m, c), generator=g)
    lowrank = name.startswith("lowrank")
    dims = [(c, r), (r, s)] if lowrank else [(n, c, r), (n, r, r), (n, r, s)]
    if name in ("lowrank_matmul", "branched_matmul"):
        return (x, *[rnd(*d) for d in dims])
    if name.endswith("_sq"):
        packs = [sparsify_array(rnd(*d), mode="int8") for d in dims]
        if not lowrank:
            packs[1] = quantize_array(rnd(*dims[1]), "int8")
        return (x, *[t for p in packs for t in p])
    return (x, *[t for d in dims for t in quantize_array(rnd(*d), "int8")])


def _attn_args(name: str, i: int, g: torch.Generator) -> tuple:
    b, s, kh, gg, d = ATTN_SHAPES[i]
    pos = torch.randint(s // 2, s, (b,), generator=g, dtype=torch.int32)
    pos[-1] = -1                                     # an idle slot
    if name == "decode_attention_latent_q":
        h, lora, rope = kh * gg, d, 8
        ckv_q, ckv_s = quantize_kv_prefill(torch.randn((b, s, 1, lora),
                                                       generator=g))
        kr_q, kr_s = quantize_kv_prefill(torch.randn((b, s, 1, rope),
                                                     generator=g))
        return (torch.randn((b, 1, h, lora), generator=g),
                torch.randn((b, 1, h, rope), generator=g),
                ckv_q[:, :, 0], ckv_s[:, 0], kr_q[:, :, 0], kr_s[:, 0], pos)
    q = torch.randn((b, 1, kh * gg, d), generator=g)
    if name == "decode_attention_q":
        k_q, k_s = quantize_kv_prefill(torch.randn((b, s, kh, d),
                                                   generator=g))
        v_q, v_s = quantize_kv_prefill(torch.randn((b, s, kh, d),
                                                   generator=g))
        return (q, k_q, k_s, v_q, v_s, pos)
    nblk, nb = s // BS, b * (s // BS)
    perm = torch.randperm(nb, generator=g).to(torch.int32)
    tables = torch.full((b, nblk), nb, dtype=torch.int32)
    for j in range(b):
        tables[j] = perm[j * nblk:(j + 1) * nblk]
    tables[0, 1] = tables[1, 0]                      # a shared block
    pool = []
    for _ in "kv":
        x = torch.randn((nb + 1, BS, kh, d), generator=g)
        if name.endswith("_q"):
            sc = kv_scales(x, axis=1)
            pool += [quantize_kv(x, sc[:, None]), sc]
        else:
            pool.append(x)
    return (q, *pool, tables, pos)


def _args(name: str, i: int) -> tuple:
    g = torch.Generator().manual_seed(7 + i)
    if name in rl.CHAIN_FACTORS:
        return _chain_args(name, i, g)
    return _attn_args(name, i, g)


def _kw(name: str) -> dict:
    return {"scale": 0.125} if name == "decode_attention_latent_q" else {}


def _reach(name: str, args: tuple) -> tuple[int, int]:
    """(live, walked) that the positions of ``args`` need, by hand."""
    pos = args[-1].tolist()
    if name.startswith("decode_attention_paged"):
        tables = args[-2]
        nblk = tables.shape[1]
        walks = [nblk if p < 0 else min(nblk, p // BS + 1) for p in pos]
        seen = {int(t) for j, w in enumerate(walks) for t in tables[j, :w]}
        return sum(walks), len(seen)
    s = args[2].shape[1] if name.endswith("latent_q") else args[1].shape[1]
    return sum(s if p < 0 else min(s, p + 1) for p in pos), 0


def _hand_cost(name: str, args: tuple, live=None, walked=None):
    """``chip_smoke.py``'s bound formulas, written out per kernel."""
    def nb(t):
        return t.numel() * t.element_size()
    if name in rl.CHAIN_FACTORS:
        x = args[0]
        m, c = x.shape
        lowrank = name.startswith("lowrank")
        if name in ("lowrank_matmul", "branched_matmul"):
            ws = args[1:]
        elif name.endswith("_sq"):
            ws = (args[1], args[4]) if lowrank else (args[1], args[4],
                                                     args[6])
        else:
            ws = args[1::2]
        s = ws[-1].shape[-1]
        if name.endswith("_sq"):
            kept = sum(w.numel() for w in ws)       # the kept half
        elif lowrank:
            kept = c * ws[0].shape[1] + ws[1].numel()
        else:
            n, _, r1 = ws[0].shape
            kept = n * (c * r1 + r1 * ws[1].shape[2] + ws[1].shape[2] * s)
        nbytes = x.element_size() * (m * c + m * s) + sum(
            nb(t) for t in args[1:])
        return 2 * m * kept, nbytes
    q = args[0]
    b = q.shape[0]
    if name == "decode_attention_q":
        _, k_q, k_s, v_q, v_s, _ = args
        s, kh, d = k_q.shape[1:]
        live = b * s if live is None else live
        return (4 * q.numel() // b * live,
                2 * live * kh * d + 2 * 4 * b * kh * d + 2 * nb(q) + 4 * b)
    if name == "decode_attention_latent_q":
        q_lat, q_rope, ckv_q, _, kr_q, _, _ = args
        s, lora = ckv_q.shape[1:]
        rope, h = kr_q.shape[-1], q_lat.shape[2]
        live = b * s if live is None else live
        return (2 * h * (2 * lora + rope) * live,
                (2 * q_lat.numel() + q_rope.numel()) * q.element_size()
                + live * (lora + rope) + 4 * b * (lora + rope) + 4 * b)
    quant = name.endswith("_q")
    k, tables = args[1], args[-2]
    nblk1, bs, kh, d = k.shape
    live = b * tables.shape[1] if live is None else live
    walked = min(live, nblk1) if walked is None else walked
    block = 2 * bs * kh * d * (1 if quant else k.element_size()) \
        + (2 * kh * d * 4 if quant else 0)
    return (4 * q.numel() // b * bs * live,
            walked * block + 4 * live + 4 * b + 2 * nb(q))


@pytest.mark.parametrize("i", range(2))
@pytest.mark.parametrize("name", rl.KERNELS)
def test_kernel_cost_equals_the_hand_formula(name, i):
    args = _args(name, i)
    shapes = [a.shape for a in args]
    dtypes = [a.dtype for a in args]
    assert rl.kernel_cost(name, shapes, dtypes) == _hand_cost(name, args)
    if name in rl.ATTENTIONS:
        live, walked = _reach(name, args)
        kw = {"live": live} | ({"walked": walked} if walked else {})
        assert rl.kernel_cost(name, shapes, dtypes, **kw) \
            == _hand_cost(name, args, live, walked or None)
        assert rl.kernel_cost_of(name, args) == _hand_cost(
            name, args, live, walked or None)


@pytest.mark.parametrize("name", list(rl.CHAIN_FACTORS))
def test_chain_flops_equal_torchs_counter_on_the_plain_version(name):
    args = _args(name, 1)
    with FlopCounterMode(display=False) as fc:
        getattr(ref, name + "_ref")(*args)
    flops, _ = rl.kernel_cost_of(name, args)
    if name.endswith("_sq"):
        # the plain version multiplies the expanded (dense) factors: the
        # kernel does the kept half of each 2:4 pack's products
        args_dense = _args(name.replace("_sq", "_q"), 1)
        with FlopCounterMode(display=False) as fc:
            getattr(ref, name.replace("_sq", "_q") + "_ref")(*args_dense)
        m = args[0].shape[0]
        packed = [args[i] for i in rl.CHAIN_FACTORS[name]]
        pruned = sum(2 * m * p.numel() for j, p in enumerate(packed)
                     if name.startswith("lowrank") or j != 1)
        assert flops == fc.get_total_flops() - pruned
    else:
        assert flops == fc.get_total_flops()


@pytest.mark.parametrize("name", rl.KERNELS)
def test_an_active_counter_charges_the_entry_point_once(name):
    args = _args(name, 0)
    with rl.StepCounter() as c:
        getattr(ops, name)(*args, **_kw(name))
    flops, nbytes = rl.kernel_cost_of(name, args)
    assert (c.costs.flops, c.costs.hbm_bytes) == (flops, nbytes)
    assert c.costs.kernel_detail == {name: (1, flops, nbytes)}
    assert ops._COUNTER is None


def test_the_counter_charges_an_entry_point_under_autograd_once():
    x, w0, w1 = _args("lowrank_matmul", 0)
    x.requires_grad_(True)
    with rl.StepCounter() as c:
        ops.lowrank_matmul(x, w0, w1).sum().backward()
    flops, _ = rl.kernel_cost_of("lowrank_matmul", (x, w0, w1))
    m = x.shape[0]
    # dx = (g @ w1^T) @ w0^T: the backward's products are counted as ops
    assert c.costs.flops == flops + 2 * m * (w1.numel() + w0.numel())
    assert c.costs.kernel_detail["lowrank_matmul"][0] == 1


@pytest.mark.parametrize("name", rl.KERNELS)
def test_without_a_counter_the_outputs_are_bit_identical(name):
    args = _args(name, 1)
    got = getattr(ops, name)(*args, **_kw(name))
    plain = getattr(ops, name).__wrapped__(*args, **_kw(name))
    assert ops._COUNTER is None
    assert torch.equal(got, plain)
    with rl.StepCounter():
        counted = getattr(ops, name)(*args, **_kw(name))
    assert torch.equal(got, counted)


def test_an_entry_point_that_raises_is_not_charged():
    from repro_torch.serve.faults import FaultInjector
    x, w0, w1 = _args("lowrank_matmul", 0)
    inj = FaultInjector(seed=0, rates={"kernel_gate": 1.0})
    with rl.StepCounter() as c, ops.fault_gate(inj):
        with pytest.raises(ops.KernelRejected):
            ops.lowrank_matmul(x, w0, w1)
    assert c.costs.flops == 0 and c.costs.kernel_detail == {}
