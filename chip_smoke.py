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
             M = 8 (decode), 64 (prefill chunk), 37 (ragged); times the
             kernel, the plain version and one cuBLAS chain as yardstick
             (CUDA events), beside the bound (bytes at 3.35 TB/s, FLOPs
             at 989 TFLOP/s bf16 / 67 TFLOP/s f32).
4. serve   — llama3.2-1b at full width (random weights from a seed, bf16)
             decomposed with SVD + branched surgery, served by
             ServeEngine(slots=8, max_seq=1024) on 8 requests; every
             model segment must launch exactly 32 lowrank and 80
             branched kernels (112 lowrank with branches=1, a shorter
             second pass).
5. check   — one prefill's last-position logits on the card (kernels,
             bf16) against the same weights in f32 on the CPU through
             the plain versions.

Only on request (``--phases ...,profile``): torch.profiler over steady
decode steps of the branches=4 model — device time by operator and the
device's idle share.

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

PHASES = ("device", "build", "kernels", "serve", "check")
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
#: launches of each kernel per decode step of the branches=4 model
DECODE_LAUNCHES = {"lowrank_matmul": {"k,v": 32},
                   "branched_matmul": {"q,o": 32, "gate,up": 32,
                                       "down": 16}}
M_CASES = (8, 64, 37)


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


def check_kernels(card: str) -> list[dict]:
    import torch
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(*shape, scale=1.0, dtype):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    rows: dict[str, list[dict]] = {"lowrank_matmul": [],
                                   "branched_matmul": []}
    failures = []
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
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
                    **_bound(m * c + c * r + r * s + m * s,
                             2 * m * (c * r + r * s), dt, dname)))
        for label, (n, c, r, s) in BRANCHED_SHAPES.items():
            for m in M_CASES:
                x = rnd(m, c, dtype=dt)
                u = rnd(n, c, r, scale=c ** -0.5, dtype=dt)
                xc = rnd(n, r, r, scale=r ** -0.5, dtype=dt)
                v = rnd(n, r, s, scale=r ** -0.5, dtype=dt)
                y = bk.branched_matmul(x, u, xc, v)
                want = ref.branched_matmul_ref(x, u, xc, v)
                torch.cuda.synchronize()
                xb = x.expand(n, m, c)
                rows["branched_matmul"].append(dict(
                    shape=label, dtype=dname, M=m, N=n, C=c, r=r, S=s,
                    **_compare(y, want, dname),
                    ms=time_ms(lambda: bk.branched_matmul(x, u, xc, v)),
                    plain_ms=time_ms(lambda: ref.branched_matmul_ref(
                        x, u, xc, v)),
                    library_ms=time_ms(lambda: torch.bmm(torch.bmm(
                        torch.bmm(xb, u), xc), v).sum(0)),
                    **_bound(m * c + n * (c * r + r * r + r * s) + m * s,
                             2 * m * n * (c * r + r * r + r * s), dt,
                             dname)))
    for name, rs in rows.items():
        for row in rs:
            ok = row["norm_err"] <= KERNEL_TOL[row["dtype"]]
            log(f"{name:16s} {row['shape']:22s} {row['dtype']:8s} "
                f"M={row['M']:3d} max_abs_err={row['max_abs_err']:.3e} "
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


def _compare(y, want, dname: str) -> dict:
    import torch
    d = (y.to(torch.float32) - want.to(torch.float32)).abs().max().item()
    scale = want.to(torch.float32).abs().max().item()
    if not math.isfinite(d):
        raise SystemExit("kernel produced non-finite output")
    return {"max_abs_err": d, "norm_err": d / max(scale, 1e-30)}


def _bound(elems: int, flops: int, dt, dname: str) -> dict:
    t, by = bound_ms(elems * dt.itemsize, flops, dname)
    return {"bound_ms": t, "bound_by": by, "flops": flops,
            "bytes": elems * dt.itemsize}


def _kernel_entries(rows: dict[str, list[dict]]) -> list[dict]:
    """One entry per kernel: times summed over one decode step of the
    branches=4 model (M = 8, bf16), from this run's measurements."""
    src = {"lowrank_matmul": ("src/repro_torch/kernels/csrc/lowrank_matmul.cu",
                              "src/repro/kernels/lowrank_matmul.py:54"),
           "branched_matmul": (
               "src/repro_torch/kernels/csrc/branched_matmul.cu",
               "src/repro/kernels/branched_matmul.py:56")}
    out = []
    for name, rs in rows.items():
        per_step = {k: 0.0 for k in ("ms", "plain_ms", "library_ms",
                                     "bound_ms", "bytes", "flops")}
        for label, count in DECODE_LAUNCHES[name].items():
            row = next(r for r in rs if r["shape"] == label
                       and r["M"] == 8 and r["dtype"] == "bfloat16")
            for k in per_step:
                per_step[k] += count * row[k]
        by = ("bytes" if per_step["bytes"] / HBM_BYTES_PER_S
              >= per_step["flops"] / PEAK_FLOPS["bfloat16"] else
              "operations")
        out.append({"name": name, "route": "cuda", "source": src[name][0],
                    "replaces": src[name][1], "launches": None,
                    "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
                    "bound_ms": per_step["bound_ms"], "bound_by": by,
                    "library_ms": per_step["library_ms"],
                    "timed_as": "one decode step's launches, M=8, bf16",
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
          new_tokens: int, expect: dict[str, int], card: str,
          seed: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import lowrank_matmul as lk
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(RunConfig(model=cfg, lrd=lrd), params, slots=8,
                      max_seq=1024, device="cuda")
    segs: list[tuple[str, int, int]] = []
    step = eng.runner.step

    def counted(tokens, positions, seg_kind, **kw):
        l0, b0 = lk.launches, bk.launches
        out = step(tokens, positions, seg_kind, **kw)
        segs.append((seg_kind, lk.launches - l0, bk.launches - b0))
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
    lk.launches = bk.launches = 0
    for r in reqs:
        eng.add_request(r)
    t0 = time.perf_counter()
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"lowrank_matmul": lk.launches,
                "branched_matmul": bk.launches}
    bad = [r.uid for r in reqs
           if r.status != "finished" or len(r.output) != new_tokens]
    if bad:
        raise SystemExit(f"requests {bad} did not finish with "
                         f"{new_tokens} tokens")
    want = (expect["lowrank_matmul"], expect["branched_matmul"])
    wrong = [s for s in segs if (s[1], s[2]) != want]
    if wrong:
        raise SystemExit(f"segments launched other kernel counts than "
                         f"{want}: {wrong[:5]}")
    for name, n in launches.items():
        if expect[name] and n == 0:
            raise SystemExit(f"{name} never launched on the main path")
    tp = eng.throughput()
    decode_segs = sum(1 for s in segs if s[0] == "decode")
    res = {"requests": n_req, "new_tokens": new_tokens, "wall_s": wall,
           "segments": len(segs), "decode_segments": decode_segs,
           "per_segment": dict(zip(("lowrank_matmul", "branched_matmul"),
                                   want)),
           "launches": launches, "tokens_per_s": tp["tokens_per_s"],
           "ttft_mean_s": tp["ttft_mean_s"],
           "decode_step_ms_mean": tp["decode_step_ms_mean"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "kv_bytes_per_step": eng.plan_summary["kv_bytes_per_step"],
           "weight_bytes": eng.plan_summary["weight_bytes"],
           "card": card}
    log("serve " + json.dumps(res))
    return res


def profile_decode(cfg, lrd, params, card: str, seed: int,
                   steps: int = 5) -> dict:
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
                      max_seq=1024, device="cuda")
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
    res = {"steps": steps, "live_slots": 8,
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
    if set(phases) & {"build", "kernels", "serve", "profile"}:
        with Phase("build"):
            from repro_torch.kernels import build
            _, report = build.build()
            for line in report.splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "spill" in line or line.startswith("==")):
                    log(line.strip())
            lib = build.load()
            # dynamic shared memory per launch (ptxas reports static only)
            for dt, code in (("bfloat16", 1), ("float32", 0)):
                for m in (8, 64):
                    lr = {k: int(lib.lrk_lowrank_smem(code, m, r))
                          for k, (_, r, _) in LOWRANK_SHAPES.items()}
                    br = {k: int(lib.lrk_branched_smem(code, m, n, r, r))
                          for k, (n, _, r, _) in BRANCHED_SHAPES.items()}
                    log(f"dynamic shared memory, {dt}, M={m}: lowrank "
                        f"{lr} branched {br} (limit {build.SMEM_LIMIT} B)")

    if "kernels" in phases:
        with Phase("kernels"):
            kernels = check_kernels(card)

    serve_res = {}
    if set(phases) & {"serve", "check", "profile"}:
        cfg, dense, axes = full_model(args.seed)
        lrd, p4, rep, surg_s = decompose(dense, axes, branches=4)
        log(f"surgery branches=4: {surg_s:.2f} s, "
            f"{json.dumps(rep.summary())} [{card}]")
    if "serve" in phases:
        with Phase("serve"):
            serve_res["branches4"] = serve(
                cfg, lrd, p4, n_req=8, prompt_lo=32, prompt_hi=512,
                new_tokens=32, card=card, seed=args.seed,
                expect={"lowrank_matmul": 32, "branched_matmul": 80})
            serve_res["branches4"]["surgery_s"] = surg_s
            lrd1, p1, _, surg1_s = decompose(dense, axes, branches=1)
            log(f"surgery branches=1: {surg1_s:.2f} s [{card}]")
            serve_res["branches1"] = serve(
                cfg, lrd1, p1, n_req=4, prompt_lo=32, prompt_hi=128,
                new_tokens=8, card=card, seed=args.seed + 1,
                expect={"lowrank_matmul": 112, "branched_matmul": 0})
            serve_res["branches1"]["surgery_s"] = surg1_s
            del p1
    if "check" in phases:
        with Phase("check"):
            cross_check(cfg, p4, card, args.seed)
    if "profile" in phases:
        with Phase("profile"):
            profile_decode(cfg, lrd, p4, card, args.seed)

    if kernels is not None:
        if serve_res:
            for k in kernels:
                k["launches"] = serve_res["branches4"]["launches"][k["name"]]
        log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
