#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as a release check
    python3 chip_smoke.py --phases device,build,kernels

Phases (each prints its own seconds; any failure exits non-zero):

1. device  — requires a CUDA card; prints its name and power limit
             (``nvidia-smi``) and the torch / CUDA versions.
2. build   — compiles the repo's ``.cu`` kernels for sm_90a and prints
             each kernel's registers, shared memory and spills.
3. kernels — holds each kernel against its plain PyTorch version on the
             card, in bf16 and f32, at every main-path shape and
             M = 8 (decode), 64 (prefill chunk), 37 (ragged) -- the
             quantized chains with int8 and fp8 factors, the int8-KV
             decode attention at the served pool shape and at a ragged
             S with idle slots and with a softcap; times the kernel, the
             plain version and one library call as yardstick (CUDA
             events), beside the bound (bytes at 3.35 TB/s, FLOPs at
             989 TFLOP/s bf16 / 67 TFLOP/s f32).
4. serve   — llama3.2-1b at full width (random weights from a seed, bf16)
             decomposed with SVD + branched surgery, served by
             ServeEngine(slots=8, max_seq=1024) on 8 requests; every
             model segment must launch exactly 32 lowrank and 80
             branched kernels (112 lowrank with branches=1, a shorter
             second pass).
5. check   — one prefill's last-position logits on the card (kernels,
             bf16) against the same weights in f32 on the CPU through
             the plain versions.
6. serve_q — the branches=4 model with int8 factors and an int8 KV pool
             (quantize="int8", kv_quantize="int8"), same engine and
             requests; every decode step must launch exactly 32
             lowrank_matmul_q, 80 branched_matmul_q and 16
             decode_attention_q kernels, every prefill chunk 32 + 80 + 0,
             and no unquantized chain kernel.
7. check_q — prefill plus 16 greedy decode steps of the quantized model
             over the int8 pool on the card against the same quantized
             tree in f32 on the CPU through the plain versions.

Only on request (``--phases ...,profile``): torch.profiler over steady
decode steps of the branches=4 model, plain and quantized — device time
by operator and the device's idle share.

Prints ``{"kernels": [...]}`` and the card's name and power limit on
lines before the last, and ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("device", "build", "kernels", "serve", "check", "serve_q",
          "check_q")
#: phases run only when asked for with --phases
EXTRA_PHASES = ("profile",)

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

#: normalised tolerance of a kernel vs its plain version on the same
#: inputs: max|kernel - plain| / max|plain|.  f32: the two sum the same
#: exact products in another order (K up to 8192).  bf16: the rank
#: intermediates round to bf16 in both, so a last-bit difference in an
#: f32 partial sum can flip one intermediate's rounding (2^-8 relative).
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

#: max |card bf16 logits - CPU f32 logits| / std(CPU logits): bf16
#: activations and weights round at every layer boundary of 16 layers.
CHECK_TOL = 0.25

LRD = dict(enabled=True, compression=2.0, rank_mode="aligned",
           rank_align=128, min_dim=256)

#: main-path shapes (C, R, S) of the SVD pairs and (N, C, r, S) of the
#: branched linears of llama3.2-1b under LRD with branches=4 / branches=1
LOWRANK_SHAPES = {"k,v": (2048, 128, 512), "q,o (branches=1)": (2048, 512,
                                                                 2048),
                  "gate,up (branches=1)": (2048, 768, 8192),
                  "down (branches=1)": (8192, 768, 2048)}
BRANCHED_SHAPES = {"q,o": (4, 2048, 128, 2048), "gate,up": (4, 2048, 192,
                                                            8192),
                   "down": (4, 8192, 192, 2048)}
#: decode attention over the int8 pool: the served shape (8 slots of
#: max_seq 1024, 8 KV heads of 64, 4 query heads each), a ragged S with
#: idle slots (no valid position), and a softcap
ATTN_CASES = {"served": dict(b=8, s=1024, kh=8, g=4, d=64, idle=0,
                             softcap=0.0),
              "ragged S, 3 idle": dict(b=8, s=1000, kh=8, g=4, d=64, idle=3,
                                       softcap=0.0),
              "softcap 30": dict(b=8, s=1024, kh=8, g=4, d=64, idle=0,
                                 softcap=30.0)}
#: launches of each kernel per decode step of the branches=4 model
#: (quantized kernels: with quantize="int8", kv_quantize="int8")
DECODE_LAUNCHES = {"lowrank_matmul": {"k,v": 32},
                   "branched_matmul": {"q,o": 32, "gate,up": 32,
                                       "down": 16},
                   "lowrank_matmul_q": {"k,v": 32},
                   "branched_matmul_q": {"q,o": 32, "gate,up": 32,
                                         "down": 16},
                   "decode_attention_q": {"served": 16}}
M_CASES = (8, 64, 37)
QMODES = ("int8", "fp8")
#: kernel module of each wrapper, its CUDA source and the TPU kernel it
#: replaces
KERNELS = {
    "lowrank_matmul": ("lowrank_matmul", "src/repro/kernels/lowrank_matmul.py:54"),
    "branched_matmul": ("branched_matmul",
                        "src/repro/kernels/branched_matmul.py:56"),
    "lowrank_matmul_q": ("lowrank_matmul_q",
                         "src/repro/kernels/lowrank_matmul_q.py:57"),
    "branched_matmul_q": ("branched_matmul_q",
                          "src/repro/kernels/branched_matmul_q.py:71"),
    "decode_attention_q": ("decode_attention_q",
                           "src/repro/kernels/decode_attention_q.py:103"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== phase {self.name}: {time.perf_counter() - self.t0:.2f}"
                " s")
        return False


# ---------------------------------------------------------------------------
# kernels vs plain
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def kernel_module(name: str):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{KERNELS[name][0]}")


def check_kernels(card: str) -> list[dict]:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.quant.quantize import quantize_array

    lk, bk = kernel_module("lowrank_matmul"), kernel_module("branched_matmul")
    lqk = kernel_module("lowrank_matmul_q")
    bqk = kernel_module("branched_matmul_q")
    g = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    def qrnd(*shape, mode):
        """A factor quantized as the engine quantizes it: (q, scale)."""
        return quantize_array(rnd(*shape, scale=shape[-2] ** -0.5), mode)

    def dq(q, scale, dt):
        return (q.to(torch.float32) * scale).to(dt)

    rows: dict[str, list[dict]] = {k: [] for k in KERNELS}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        xb = dt.itemsize
        for label, (c, r, s) in LOWRANK_SHAPES.items():
            for m in M_CASES:
                x = rnd(m, c, dtype=dt)
                w0 = rnd(c, r, scale=c ** -0.5, dtype=dt)
                w1 = rnd(r, s, scale=r ** -0.5, dtype=dt)
                y = lk.lowrank_matmul(x, w0, w1)
                want = ref.lowrank_matmul_ref(x, w0, w1)
                torch.cuda.synchronize()
                rows["lowrank_matmul"].append(dict(
                    shape=label, dtype=dname, M=m, C=c, R=r, S=s,
                    **_compare(y, want, dname),
                    ms=time_ms(lambda: lk.lowrank_matmul(x, w0, w1)),
                    plain_ms=time_ms(lambda: ref.lowrank_matmul_ref(x, w0,
                                                                    w1)),
                    library_ms=time_ms(lambda: (x @ w0) @ w1),
                    **_bound(xb * (m * c + c * r + r * s + m * s),
                             2 * m * (c * r + r * s), dname)))
                for mode in QMODES:
                    w0q, w0s = qrnd(c, r, mode=mode)
                    w1q, w1s = qrnd(r, s, mode=mode)
                    args = (x, w0q, w0s, w1q, w1s)
                    y = lqk.lowrank_matmul_q(*args)
                    want = ref.lowrank_matmul_q_ref(*args)
                    torch.cuda.synchronize()
                    w0d, w1d = dq(w0q, w0s, dt), dq(w1q, w1s, dt)
                    rows["lowrank_matmul_q"].append(dict(
                        shape=label, dtype=dname, qmode=mode, M=m, C=c, R=r,
                        S=s, **_compare(y, want, dname),
                        ms=time_ms(lambda: lqk.lowrank_matmul_q(*args)),
                        plain_ms=time_ms(
                            lambda: ref.lowrank_matmul_q_ref(*args)),
                        library_ms=time_ms(lambda: (x @ w0d) @ w1d),
                        **_bound(xb * (m * c + m * s) + c * r + r * s
                                 + 4 * (r + s), 2 * m * (c * r + r * s),
                                 dname)))
        for label, (n, c, r, s) in BRANCHED_SHAPES.items():
            for m in M_CASES:
                x = rnd(m, c, dtype=dt)
                u = rnd(n, c, r, scale=c ** -0.5, dtype=dt)
                xc = rnd(n, r, r, scale=r ** -0.5, dtype=dt)
                v = rnd(n, r, s, scale=r ** -0.5, dtype=dt)
                y = bk.branched_matmul(x, u, xc, v)
                want = ref.branched_matmul_ref(x, u, xc, v)
                torch.cuda.synchronize()
                xb3 = x.expand(n, m, c)
                flops = 2 * m * n * (c * r + r * r + r * s)
                rows["branched_matmul"].append(dict(
                    shape=label, dtype=dname, M=m, N=n, C=c, r=r, S=s,
                    **_compare(y, want, dname),
                    ms=time_ms(lambda: bk.branched_matmul(x, u, xc, v)),
                    plain_ms=time_ms(lambda: ref.branched_matmul_ref(
                        x, u, xc, v)),
                    library_ms=time_ms(lambda: torch.bmm(torch.bmm(
                        torch.bmm(xb3, u), xc), v).sum(0)),
                    **_bound(xb * (m * c + n * (c * r + r * r + r * s)
                                   + m * s), flops, dname)))
                for mode in QMODES:
                    qs = [qrnd(n, c, r, mode=mode), qrnd(n, r, r, mode=mode),
                          qrnd(n, r, s, mode=mode)]
                    args = (x, *[t for pair in qs for t in pair])
                    y = bqk.branched_matmul_q(*args)
                    want = ref.branched_matmul_q_ref(*args)
                    torch.cuda.synchronize()
                    ud, xcd, vd = (dq(q, sc, dt) for q, sc in qs)
                    rows["branched_matmul_q"].append(dict(
                        shape=label, dtype=dname, qmode=mode, M=m, N=n, C=c,
                        r=r, S=s, **_compare(y, want, dname),
                        ms=time_ms(lambda: bqk.branched_matmul_q(*args)),
                        plain_ms=time_ms(
                            lambda: ref.branched_matmul_q_ref(*args)),
                        library_ms=time_ms(lambda: torch.bmm(torch.bmm(
                            torch.bmm(xb3, ud), xcd), vd).sum(0)),
                        **_bound(xb * (m * c + m * s)
                                 + n * (c * r + r * r + r * s)
                                 + 4 * n * (2 * r + s), flops, dname)))
        for label, case in ATTN_CASES.items():
            rows["decode_attention_q"].append(
                _check_attention(label, case, dname, rnd))
    failures = []
    for name, rs in rows.items():
        for row in rs:
            ok = row["norm_err"] <= KERNEL_TOL[row["dtype"]]
            log(f"{name:18s} {row['shape']:22s} {row['dtype']:8s} "
                f"{row.get('qmode', ''):4s} M={row.get('M', row.get('B')):4d}"
                f" max_abs_err={row['max_abs_err']:.3e} "
                f"norm_err={row['norm_err']:.3e} "
                f"(tol {KERNEL_TOL[row['dtype']]:.0e}) "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']:.4f} "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                f"[{card}] {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((name, row))
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version: "
                         f"{failures}")
    return _kernel_entries(rows)


def _check_attention(label: str, case: dict, dname: str, rnd) -> dict:
    """One decode_attention_q row: the pool quantized like the engine's
    (one-shot scales), q in ``dname``; slots past the first ``idle``
    live ones have no valid position (cache_pos -1).  The yardstick is
    SDPA on the pool dequantized beforehand, K/V expanded to every query
    head."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.quant.kv import quantize_kv_prefill
    dak = kernel_module("decode_attention_q")
    b, s, kh, g_, d = (case[k] for k in ("b", "s", "kh", "g", "d"))
    dt = getattr(torch, dname)
    q = rnd(b, kh, g_, d, dtype=dt)
    k_q, k_s = quantize_kv_prefill(rnd(b, s, kh, d))
    v_q, v_s = quantize_kv_prefill(rnd(b, s, kh, d))
    pos = torch.randint(s // 2, s, (b,), device="cuda", dtype=torch.int32)
    pos[b - case["idle"]:] = -1
    pos[0] = s - 1
    args = (q, k_q, k_s, v_q, v_s, pos)
    kw = {"softcap": case["softcap"]}
    y = dak.decode_attention_q(*args, **kw)
    q4 = q.reshape(b, 1, kh * g_, d)
    want = ref.decode_attention_q_ref(q4, *args[1:], **kw)
    torch.cuda.synchronize()
    kd = (k_q.float() * k_s[:, None]).to(dt).permute(0, 2, 1, 3) \
        .repeat_interleave(g_, dim=1).contiguous()
    vd = (v_q.float() * v_s[:, None]).to(dt).permute(0, 2, 1, 3) \
        .repeat_interleave(g_, dim=1).contiguous()
    qd = q.reshape(b, kh * g_, 1, d)
    mask = (torch.arange(s, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]
    nbytes = (2 * b * s * kh * d + 2 * 4 * b * kh * d
              + 2 * b * kh * g_ * d * dt.itemsize + 4 * b)
    return dict(shape=label, dtype=dname, B=b, S=s, KH=kh, G=g_, D=d,
                softcap=case["softcap"], idle=case["idle"],
                **_compare(y.reshape(want.shape), want, dname),
                ms=time_ms(lambda: dak.decode_attention_q(*args, **kw)),
                plain_ms=time_ms(lambda: ref.decode_attention_q_ref(
                    q4, *args[1:], **kw)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qd, kd, vd, attn_mask=mask)),
                **_bound(nbytes, 4 * b * kh * g_ * s * d, dname))


def _compare(y, want, dname: str) -> dict:
    import torch
    d = (y.to(torch.float32) - want.to(torch.float32)).abs().max().item()
    scale = want.to(torch.float32).abs().max().item()
    if not math.isfinite(d):
        raise SystemExit("kernel produced non-finite output")
    return {"max_abs_err": d, "norm_err": d / max(scale, 1e-30)}


def _bound(nbytes: int, flops: int, dname: str) -> dict:
    t, by = bound_ms(nbytes, flops, dname)
    return {"bound_ms": t, "bound_by": by, "flops": flops, "bytes": nbytes}


def _kernel_entries(rows: dict[str, list[dict]]) -> list[dict]:
    """One entry per kernel: times summed over one decode step of the
    branches=4 model (bf16; M = 8 and int8 factors for the chains, the
    served pool shape for the attention), from this run's
    measurements."""
    out = []
    for name, rs in rows.items():
        per_step = {k: 0.0 for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bytes", "flops")}
        for label, count in DECODE_LAUNCHES[name].items():
            row = next(r for r in rs if r["shape"] == label
                       and r.get("M", 8) == 8 and r["dtype"] == "bfloat16"
                       and r.get("qmode", "int8") == "int8")
            for k in per_step:
                per_step[k] += count * row[k]
        by = ("bytes" if per_step["bytes"] / HBM_BYTES_PER_S
              >= per_step["flops"] / PEAK_FLOPS["bfloat16"] else
              "operations")
        module, replaces = KERNELS[name]
        out.append({"name": name, "route": "cuda",
                    "source": f"src/repro_torch/kernels/csrc/{module}.cu",
                    "replaces": replaces, "launches": None,
                    "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
                    "bound_ms": per_step["bound_ms"], "bound_by": by,
                    "library_ms": per_step["library_ms"],
                    "timed_as": ("one decode step's launches, bf16"
                                 + (", M=8, int8 factors" if name.endswith(
                                     "matmul_q") else "")),
                    "shapes": rs})
    return out


# ---------------------------------------------------------------------------
# serve + cross-check
# ---------------------------------------------------------------------------

def full_model(seed: int = 0):
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.api import get_model
    cfg = registry.get("llama3.2-1b").full
    model = get_model(cfg, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    params, axes = model.init(g)
    torch.cuda.synchronize()
    return cfg, params, axes


def decompose(params, axes, branches: int):
    import torch
    from repro_torch.configs.base import LRDConfig
    from repro_torch.core.surgery import decompose_model
    lrd = LRDConfig(**LRD, branches=branches)
    t0 = time.perf_counter()
    with torch.inference_mode():
        p2, _, rep = decompose_model(params, axes, lrd)
    torch.cuda.synchronize()
    return lrd, p2, rep, time.perf_counter() - t0


def serve(cfg, lrd, params, *, n_req: int, prompt_lo: int, prompt_hi: int,
          new_tokens: int, expect: dict[str, dict[str, int]], card: str,
          seed: int, quantize: str = "none",
          kv_quantize: str = "none") -> dict:
    """Serve ``n_req`` requests and check the launches of every kernel in
    every model segment: ``expect[seg_kind][kernel]`` (a kernel not
    named must not launch at all).  Every count is set to 0 just before
    the requests are driven and read just after."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.serve.engine import Request, ServeEngine

    mods = {name: kernel_module(name) for name in KERNELS}
    eng = ServeEngine(RunConfig(model=cfg, lrd=lrd), params, slots=8,
                      max_seq=1024, quantize=quantize,
                      kv_quantize=kv_quantize, device="cuda")
    segs: list[tuple[str, dict[str, int]]] = []
    step = eng.runner.step

    def counted(tokens, positions, seg_kind, **kw):
        before = {k: m.launches for k, m in mods.items()}
        out = step(tokens, positions, seg_kind, **kw)
        segs.append((seg_kind, {k: m.launches - before[k]
                                for k, m in mods.items()}))
        return out
    eng.runner.step = counted

    rng = np.random.default_rng(seed)
    reqs = [Request(uid=i, prompt=rng.integers(
                        0, cfg.vocab_size,
                        int(rng.integers(prompt_lo, prompt_hi + 1))).tolist(),
                    max_new_tokens=new_tokens,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(n_req)]
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    for r in reqs:
        eng.add_request(r)
    t0 = time.perf_counter()
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: m.launches for k, m in mods.items()}
    bad = [r.uid for r in reqs
           if r.status != "finished" or len(r.output) != new_tokens]
    if bad:
        raise SystemExit(f"requests {bad} did not finish with "
                         f"{new_tokens} tokens")
    want = {kind: {k: counts.get(k, 0) for k in KERNELS}
            for kind, counts in expect.items()}
    wrong = [s for s in segs if s[1] != want[s[0]]]
    if wrong:
        raise SystemExit(f"segments launched other kernel counts than "
                         f"{want}: {wrong[:5]}")
    for counts in expect.values():
        for name, n in counts.items():
            if n and launches[name] == 0:
                raise SystemExit(f"{name} never launched on the main path")
    tp = eng.throughput()
    res = {"quantize": quantize, "kv_quantize": kv_quantize,
           "requests": n_req, "new_tokens": new_tokens, "wall_s": wall,
           "segments": len(segs),
           "decode_segments": sum(1 for s in segs if s[0] == "decode"),
           "per_segment": {kind: {k: n for k, n in c.items() if n}
                           for kind, c in want.items()},
           "launches": launches, "tokens_per_s": tp["tokens_per_s"],
           "ttft_mean_s": tp["ttft_mean_s"],
           "decode_step_ms_mean": tp["decode_step_ms_mean"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "kv_bytes_per_step": eng.plan_summary["kv_bytes_per_step"],
           "weight_bytes": eng.plan_summary["weight_bytes"],
           "quant_bytes": eng.plan_summary["quant_bytes"],
           "kv_cache_family": eng.plan_summary["kv_cache_family"],
           "card": card}
    log("serve " + json.dumps(res))
    return res


def profile_decode(cfg, lrd, params, card: str, seed: int,
                   steps: int = 5, quantize: str = "none",
                   kv_quantize: str = "none") -> dict:
    """Where one decode step's time goes: ``torch.profiler`` over
    ``steps`` steady decode steps of 8 live slots, device time by
    operator and the device's busy share of the host-clock window."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import RunConfig
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(RunConfig(model=cfg, lrd=lrd), params, slots=8,
                      max_seq=1024, quantize=quantize,
                      kv_quantize=kv_quantize, device="cuda")
    rng = np.random.default_rng(seed)
    for i in range(8):
        eng.add_request(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, 32).tolist(), max_new_tokens=4 * steps))
    while eng.scheduler.prefilling or eng.scheduler.waiting:
        eng.step()                                  # admit + prefill all
    for _ in range(2):
        eng.step()                                  # warm decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = prof.key_averages()
    # device-side rows only: a host op's device time repeats the time of
    # the kernels it launched, which have rows of their own
    kernels = sorted((e for e in events
                      if e.device_type == DeviceType.CUDA),
                     key=dev_us, reverse=True)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    res = {"quantize": quantize, "kv_quantize": kv_quantize,
           "steps": steps, "live_slots": 8,
           "step_ms": wall_ms / steps,
           "device_busy_ms_per_step": busy_ms / steps,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "top_device_kernels": [
               {"kernel": e.key[:70], "launches_per_step": e.count / steps,
                "ms_per_step": dev_us(e) / 1e3 / steps}
               for e in kernels[:10]],
           "top_host_ops": [
               {"op": e.key[:40], "calls_per_step": e.count / steps,
                "self_ms_per_step": e.self_cpu_time_total / 1e3 / steps}
               for e in host[:10]],
           "card": card}
    log("profile " + json.dumps(res))
    return res


def cross_check(cfg, params, card: str, seed: int, n_tok: int = 64
                ) -> dict:
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models.api import get_model
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n_tok)),
                           dtype=torch.long)
    with torch.inference_mode():
        m_gpu = get_model(cfg, "cuda")
        lg, _ = m_gpu.prefill(params, {"tokens": toks.cuda()},
                              m_gpu.init_cache(1, n_tok))
        lg = lg[0, 0].float().cpu()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        m_cpu = get_model(cfg32, "cpu")

        def to_cpu(t):
            if isinstance(t, dict):
                return {k: to_cpu(v) for k, v in t.items()}
            return t.to("cpu", torch.float32)
        p_cpu = to_cpu(params)
        lc, _ = m_cpu.prefill(p_cpu, {"tokens": toks},
                              m_cpu.init_cache(1, n_tok))
        lc = lc[0, 0]
    rel = ((lg - lc).abs().max() / lc.std()).item()
    res = {"tokens": n_tok, "max_diff_over_std": rel, "tol": CHECK_TOL,
           "greedy_agree": bool(lg.argmax() == lc.argmax()),
           "top5_overlap": len(set(lg.topk(5).indices.tolist())
                               & set(lc.topk(5).indices.tolist())),
           "card": card}
    log("check " + json.dumps(res))
    if not rel <= CHECK_TOL:
        raise SystemExit(f"card logits differ from the CPU f32 reference: "
                         f"{rel:.4f} > {CHECK_TOL}")
    return res


def time_kv_write(card: str) -> dict:
    """One decode write into an int8 pool leaf of the served shape (8
    slots x 1024 x 8 KV heads x 64), in the steady state where no scale
    grows: the unconditional history requant included."""
    import torch
    from repro_torch.quant.kv import kv_write_token
    g = torch.Generator(device="cuda").manual_seed(7)
    pool = torch.randint(-127, 128, (8, 1024, 8, 64), generator=g,
                         device="cuda", dtype=torch.int8)
    scale = torch.rand((8, 8, 64), generator=g, device="cuda") + 0.5
    new = torch.randn((8, 8, 64), generator=g, device="cuda") * 0.1
    pos = torch.arange(8, device="cuda", dtype=torch.int32)
    ms = time_ms(lambda: kv_write_token(pool, scale, new, pos))
    res = {"kv_write_token_ms": ms, "leaves_per_decode_step": 32,
           "ms_per_decode_step": 32 * ms, "card": card}
    log("kv_write " + json.dumps(res))
    return res


def to_cpu_f32(tree):
    """A param tree on the CPU, float leaves widened to f32; int8 / e4m3
    factors keep their storage (their f32 scales already are f32)."""
    import torch
    if isinstance(tree, dict):
        return {k: to_cpu_f32(v) for k, v in tree.items()}
    if tree.dtype in (torch.int8, torch.float8_e4m3fn):
        return tree.to("cpu")
    return tree.to("cpu", torch.float32)


def cross_check_q(cfg, params_q, card: str, seed: int, n_tok: int = 64,
                  steps: int = 16) -> dict:
    """Prefill and ``steps`` greedy decode steps over an int8 KV pool:
    the card (quantized kernels, bf16) against the same quantized tree in
    f32 on the CPU (plain versions).  Both are fed the CPU's greedy
    tokens, so every step compares logits of the same context."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models.api import get_model
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n_tok)),
                           dtype=torch.long)
    m_gpu = get_model(cfg, "cuda")
    m_cpu = get_model(dataclasses.replace(cfg, dtype="float32"), "cpu")
    p_cpu = to_cpu_f32(params_q)
    plans = (m_gpu.cache_plan("int8"), m_cpu.cache_plan("int8"))
    dak = kernel_module("decode_attention_q")
    rels, agree = [], []
    with torch.inference_mode():
        c_gpu = m_gpu.init_cache(1, n_tok + steps, "int8")
        c_cpu = m_cpu.init_cache(1, n_tok + steps, "int8")
        lg, _ = m_gpu.prefill(params_q, {"tokens": toks.cuda()}, c_gpu,
                              cache_plan=plans[0])
        lc, _ = m_cpu.prefill(p_cpu, {"tokens": toks}, c_cpu,
                              cache_plan=plans[1])
        launches0 = dak.launches
        for i in range(steps + 1):
            lg, lc = lg[0, -1].float().cpu(), lc[0, -1]
            rels.append(((lg - lc).abs().max() / lc.std()).item())
            agree.append(bool(lg.argmax() == lc.argmax()))
            if i == steps:
                break
            tok = lc.argmax().reshape(1, 1)
            pos = torch.tensor([n_tok + i])
            lg, _ = m_gpu.decode_step(params_q, tok.cuda(), pos.cuda(),
                                      c_gpu, cache_plan=plans[0])
            lc, _ = m_cpu.decode_step(p_cpu, tok, pos, c_cpu,
                                      cache_plan=plans[1])
    torch.cuda.synchronize()
    res = {"tokens": n_tok, "decode_steps": steps,
           "max_diff_over_std": max(rels), "per_step": rels,
           "tol": CHECK_TOL, "greedy_agree": f"{sum(agree)}/{len(agree)}",
           "decode_attention_q_launches": dak.launches - launches0,
           "card": card}
    log("check_q " + json.dumps(res))
    if not max(rels) <= CHECK_TOL:
        raise SystemExit(f"card logits over the int8 pool differ from the "
                         f"CPU f32 reference: {max(rels):.4f} > {CHECK_TOL}")
    if dak.launches - launches0 != steps * cfg.num_layers:
        raise SystemExit("decode over the int8 pool did not run through "
                         "decode_attention_q in every layer")
    return res


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    with Phase("device"):
        card = smi()
        log(f"card: {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    kernels = None
    model_phases = {"serve", "check", "serve_q", "check_q", "profile"}
    if set(phases) & ({"build", "kernels"} | model_phases):
        with Phase("build"):
            from repro_torch.kernels import build
            _, report = build.build()
            for line in report.splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "spill" in line or line.startswith("==")):
                    log(line.strip())
            lib = build.load()
            # dynamic shared memory per launch (ptxas reports static only);
            # the quantized chains stage their weights in f32 after
            # dequantizing, so each needs what its plain twin needs
            for dt, code in (("bfloat16", 1), ("float32", 0)):
                for m in (8, 64):
                    lr = {k: int(lib.lrk_lowrank_smem(code, m, r))
                          for k, (_, r, _) in LOWRANK_SHAPES.items()}
                    br = {k: int(lib.lrk_branched_smem(code, m, n, r, r))
                          for k, (n, _, r, _) in BRANCHED_SHAPES.items()}
                    fits = max([*lr.values(), *br.values()]) \
                        <= build.SMEM_LIMIT
                    log(f"dynamic shared memory, {dt}, M={m}, plain and "
                        f"quantized chains: lowrank {lr} branched {br} "
                        f"(limit {build.SMEM_LIMIT} B: "
                        f"{'every rank fits' if fits else 'OVER'})")

    if "kernels" in phases:
        with Phase("kernels"):
            kernels = check_kernels(card)

    serve_res = {}
    if set(phases) & model_phases:
        cfg, dense, axes = full_model(args.seed)
        lrd, p4, rep, surg_s = decompose(dense, axes, branches=4)
        log(f"surgery branches=4: {surg_s:.2f} s, "
            f"{json.dumps(rep.summary())} [{card}]")
    if "serve" in phases:
        with Phase("serve"):
            every = lambda counts: {"decode": counts,  # noqa: E731
                                    "prefill_chunk": counts}
            serve_res["branches4"] = serve(
                cfg, lrd, p4, n_req=8, prompt_lo=32, prompt_hi=512,
                new_tokens=32, card=card, seed=args.seed,
                expect=every({"lowrank_matmul": 32, "branched_matmul": 80}))
            serve_res["branches4"]["surgery_s"] = surg_s
            lrd1, p1, _, surg1_s = decompose(dense, axes, branches=1)
            log(f"surgery branches=1: {surg1_s:.2f} s [{card}]")
            serve_res["branches1"] = serve(
                cfg, lrd1, p1, n_req=4, prompt_lo=32, prompt_hi=128,
                new_tokens=8, card=card, seed=args.seed + 1,
                expect=every({"lowrank_matmul": 112}))
            serve_res["branches1"]["surgery_s"] = surg1_s
            del p1
    if "check" in phases:
        with Phase("check"):
            cross_check(cfg, p4, card, args.seed)
    if set(phases) & {"serve_q", "check_q"}:
        from repro_torch.quant.quantize import quantize_tree
        t0 = time.perf_counter()
        with torch.inference_mode():
            pq = quantize_tree(p4, "int8", targets=lrd.quant_targets)
        torch.cuda.synchronize()
        log(f"quantize int8: {time.perf_counter() - t0:.2f} s [{card}]")
    if "serve_q" in phases:
        with Phase("serve_q"):
            chain = {"lowrank_matmul_q": 32, "branched_matmul_q": 80}
            serve_res["quantized"] = serve(
                cfg, lrd, pq, n_req=8, prompt_lo=32, prompt_hi=512,
                new_tokens=32, card=card, seed=args.seed, quantize="int8",
                kv_quantize="int8",
                expect={"decode": {**chain, "decode_attention_q": 16},
                        "prefill_chunk": chain})
            serve_res["quantized"]["kv_write"] = time_kv_write(card)
    if "check_q" in phases:
        with Phase("check_q"):
            cross_check_q(cfg, pq, card, args.seed)
    if "profile" in phases:
        with Phase("profile"):
            profile_decode(cfg, lrd, p4, card, args.seed)
            profile_decode(cfg, lrd, p4, card, args.seed, quantize="int8",
                           kv_quantize="int8")

    if kernels is not None:
        for k in kernels:
            run = ("quantized" if k["name"].endswith("_q") else "branches4")
            if run in serve_res:
                k["launches"] = serve_res[run]["launches"][k["name"]]
        log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
