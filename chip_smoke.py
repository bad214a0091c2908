#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as a release check
    python3 chip_smoke.py --phases device,build,kernels

Phases (each prints its own seconds; any failure exits non-zero):

1. device  — requires a CUDA card; prints its name and power limit
             (``nvidia-smi``) and the torch / CUDA versions.
2. build   — compiles the repo's ``.cu`` kernels for sm_90a and prints
             each kernel's registers, shared memory and spills.
3. kernels — holds each kernel (``--kernels NAME[,NAME]`` for some of
             them; all twelve by default) against its plain PyTorch
             version on the card, in bf16 and f32, at every main-path
             shape and
             M = 8 (decode), 64 (prefill chunk), 37 (ragged) -- the
             quantized chains with int8 and fp8 factors, the int8-KV
             decode attention at the served pool shape and at a ragged
             S with idle slots and with a softcap; the int8-activation
             chains at M = 64, 37 and 512 with an all-zero row; the paged
             attentions (full width and int8) at the served pool with
             shuffled tables, ragged positions and an idle slot; the 2:4
             chains (int8 and fp8 packs, some groups keeping their top
             rows) at the k/v SVD shape and every branched shape; times
             the kernel, the plain version and one library call as
             yardstick (CUDA events), beside the bound (bytes at 3.35
             TB/s, operations at 989 TFLOP/s bf16 / 67 TFLOP/s f32 /
             1,979 TOP/s int8).  The branched chain rows (bf16,
             quantized and 2:4: B2, B4, B12) also time the kernel and
             the library call with a cold L2 (``cold_ms``,
             ``library_cold_ms``: 100 MB written before each launch),
             and in bf16 the cluster kernel (the earlier bf16 design)
             in turns with the split-phase kernel (``prev_ms``), the
             split-phase kernel's three phases (``phase_us``, its own
             timer), and check that a second call gives the same bits;
             a control row beside DeepSeek-V2's ``ds o`` at a rank of
             whole 128-byte int8 rows (``ALIGNED_CONTROL``).  The
             redesigned rows of B5, B8, B9, B10 (the split attentions,
             in both dtypes), B1, B3, B11 (the two-phase lowrank chains)
             and B6, B7 (the split-phase s8 chains) are timed with the
             host kept ahead of the card (a spin kernel first, so the times
             are the device's), and between CUDA events without
             (``event_ms``, ``library_event_ms``): the earlier kernel (one
             CTA per slot; the chains' cluster kernel) in turns with the
             new one (``prev_ms``), the two held within tolerance of each
             other (``prev_err``; B6 / B7 bit for bit, ``differing_prev``),
             a second call's bits, the cold-L2 times; the attentions' split
             count and, at the served bf16 shape, the kernel at 1, 2, the
             planned and twice the planned splits (``split_ms``); the
             chains' phase timer (``phase_us``) and, at M = 8 at the
             shapes of ``LOWRANK_PLAN_SHAPES`` (B6 / B7: M = 64, bf16,
             every shape), the device and phase times of other plans
             (``plan_us``: coarser and finer K slices, fewer CTAs).
             ``--kernels decode_attention_paged,lowrank_matmul_sq`` with
             ``--phases device,build,kernels`` is the quick call for B8
             and B11, ``--kernels lowrank_matmul,lowrank_matmul_q`` for B1
             and B3, ``--kernels decode_attention_q,branched_matmul_qa``
             for B5 and B7, ``--kernels lowrank_matmul_qa`` for B6.
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
8. serve_paged — the bf16 branches=4 model over the paged pool
             (kv_layout="paged", blocks of 16) on 8 requests, four of
             which share a 256-token prefix (one of them arrives once the
             first has been prefilled, so it hits the radix cache); every
             decode step must launch exactly 32 lowrank, 80 branched and
             16 decode_attention_paged kernels, every prefill chunk
             32 + 80 + 0; radix hits > 0 and the pool's integrity check.
9. check_paged — prefill plus 16 greedy decode steps through the paged
             pool (staging, insert, block tables) on the card against the
             same tree in f32 on the CPU.
10. serve_qa — the int8 tree with int8 activations on prefill and an int8
             paged pool (quantize="int8", act_quantize="int8",
             kv_quantize="int8", kv_layout="paged"), same requests: every
             prefill chunk exactly 32 lowrank_matmul_qa + 80
             branched_matmul_qa and nothing else, every decode step 32
             lowrank_matmul_q + 80 branched_matmul_q + 16
             decode_attention_paged_q.
11. check_qa — check_paged on that configuration.
12. serve_mla — the llama trees freed, DeepSeek-V2's MLA stack at its
             published widths (d_model 5120, 128 heads, q_lora 1536,
             kv_lora 512, rope 64, the first layer's dense FFN of 12288
             in every layer, vocab 102400 untied; 4 of its 60 layers,
             random weights from a seed, bf16) decomposed with the same
             LRD at branches=4 (o, gate, up, down and the unembed
             branched; the mla_* projections dense), served over the
             ``mla_latent`` slot pool on 8 requests: every decode step
             and prefill chunk exactly 17 branched_matmul and nothing
             else.
13. check_mla — prefill plus 16 greedy decode steps through the latent
             pool as the engine drives it, on the card against the same
             tree in f32 on the CPU.
14. serve_mla_q — the same tree with int8 factors over the int8 latent
             pool (``mla_latent_int8``): every decode step exactly 17
             branched_matmul_q and 4 decode_attention_latent_q, every
             prefill chunk 17 branched_matmul_q.
15. check_mla_q — check_mla on that configuration.
16. serve_sq — the llama branches=4 tree 2:4-packed in int8
             (quantize="int8", sparsify="2:4", kv_quantize="int8"), the
             serve_q request set: every decode step exactly 32
             lowrank_matmul_sq + 80 branched_matmul_sq + 16
             decode_attention_q, every prefill chunk 32 + 80, no other
             chain kernel; prints plan_summary (weight_bytes, sparse).
17. check_sq — prefill plus 16 greedy decode steps of that tree over the
             int8 slot pool, on the card against the same packed tree in
             f32 on the CPU.
18. serve_mla_sq — the MLA stack 2:4-packed in int8 over the int8 latent
             pool: every decode step exactly 17 branched_matmul_sq + 4
             decode_attention_latent_q, every prefill chunk 17
             branched_matmul_sq.
19. check_mla_sq — check_mla on that configuration.
20. train   — fine-tuning through the port's ``train()`` on the card:
             llama3.2-1b at full width (random weights from the seed)
             decomposed with the same LRD at branches=4 and the §2.2 freeze
             (``freeze=True``), bf16, on ByteTextLM's built-in corpus at
             batch 4 x seq 256 (M = 1,024 rows a chain kernel), 8 AdamW
             steps: every step must launch exactly 32 lowrank_matmul + 80
             branched_matmul forwards and no other chain kernel, and the
             loss must fall; then 2 steps under remat="full" (64 + 160 a
             step); beside it, nothing claimed: the same 8 steps with
             ``freeze=False`` (the paper's §2.2 comparison) and the
             undecomposed tree's steps (the port's dense path: products
             widened to f32), no chain kernel.  Prints step ms (median of
             the steps after the first), tokens/s, peak device memory,
             ``optimizer_state_bytes``, trainable and frozen parameters,
             launches per step and the loss at the first and last step.
21. check_train — one step's loss and every trainable leaf's gradient of
             that frozen tree and batch on the card (bf16, kernels)
             against the port on the CPU in f32 (plain versions), full
             depth: the loss within 1e-2 relative, each gradient within
             0.05 relative L2 (``TRAIN_CHECK_TOL``).

The kernels phase also holds bf16 B1 (k/v) and B2 (q,o, gate,up, down)
at the training M (1,024 rows): the kernel against its plain version,
its times beside the cuBLAS chain, and the autograd Function's gradients
(kernel forward, explicit backward) against autograd of the plain
version within ``KERNEL_TOL``.

Only on request (``--phases ...,profile``): torch.profiler over steady
decode steps of the branches=4 model, plain, int8 and 2:4-packed int8 —
device time by operator and the device's idle share; ``profile_qa`` the
same over steady act-quant prefill chunks of serve_qa's engine (32 B6 +
80 B7 each), with the first chunk timed alone; ``profile_mla`` the same
over the bf16 MLA decode step.

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
          "check_q", "serve_paged", "check_paged", "serve_qa", "check_qa",
          "serve_sq", "check_sq", "serve_mla", "check_mla", "serve_mla_q",
          "check_mla_q", "serve_mla_sq", "check_mla_sq", "train",
          "check_train")
#: the phases that serve or check the llama3.2-1b trees, the MLA ones and
#: the training ones
LLAMA_PHASES = ("serve", "check", "serve_q", "check_q", "serve_paged",
                "check_paged", "serve_qa", "check_qa", "serve_sq",
                "check_sq", "profile", "profile_qa")
MLA_PHASES = ("serve_mla", "check_mla", "serve_mla_q", "check_mla_q",
              "serve_mla_sq", "check_mla_sq", "profile_mla")
TRAIN_PHASES = ("train", "check_train")
#: phases run only when asked for with --phases
EXTRA_PHASES = ("profile", "profile_qa", "profile_mla")

HBM_BYTES_PER_S = 3.35e12
#: dense peak rates of one H100 SXM (NVIDIA's data sheet constants, not
#: measurements): bf16 and int8 on the tensor cores, f32 outside them
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}

#: normalised tolerance of a kernel vs its plain version on the same
#: inputs: max|kernel - plain| / max|plain|.  f32: the two sum the same
#: exact products in another order (K up to 8192).  bf16: the rank
#: intermediates round to bf16 in both, so a last-bit difference in an
#: f32 partial sum can flip one intermediate's rounding (2^-8 relative).
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: extra times of the branched chain rows (B2, B4, B12), the split
#: attention rows (B5, B8, B9, B10), the lowrank chain rows (B1, B3, B11)
#: and the activation-quantized rows (B6, B7):
#: the earlier design (the cluster kernel in bf16; the one-CTA-per-slot
#: attention kernels) on the same inputs in the same call, and the kernel
#: and its library call with a cold L2
SPLIT_TIMES = ("prev_ms", "cold_ms", "library_cold_ms")
#: the kernel and its library call between CUDA events with the host not
#: kept ahead, on the rows whose ``ms`` / ``library_ms`` are device times
#: with the host ahead (B1, B3, B5-B11): the series of the earlier
#: event-timed runs
EVENT_TIMES = ("event_ms", "library_event_ms")

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
#: DeepSeek-V2's branched linears (N, C, r, S) under the same LRD at
#: branches=4, and their launches per decode step / prefill chunk of the
#: 4-layer MLA stack
DEEPSEEK_BRANCHED_SHAPES = {"ds o": (4, 16384, 480, 5120),
                            "ds gate,up": (4, 5120, 448, 12288),
                            "ds down": (4, 12288, 448, 5120),
                            "ds unembed": (4, 5120, 608, 102400)}
#: a control beside "ds o": the same sizes at a rank whose int8 rows are
#: whole 128-byte lines (512, where 480 puts most column tiles across two
#: lines), so the rows' phase 1 times show what line-straddling rows cost
#: each weight view; timed at M = 8 with int8 factors
ALIGNED_CONTROL = {"ds o, r 512": (4, 16384, 512, 5120)}
MLA_LAYERS = 4
MLA_BRANCHED_LAUNCHES = {"ds o": MLA_LAYERS, "ds gate,up": 2 * MLA_LAYERS,
                         "ds down": MLA_LAYERS, "ds unembed": 1}
#: row counts of the DeepSeek-shape chain rows: a decode step, a chunk
DEEPSEEK_M_CASES = (8, 64)
#: the int8 latent decode attention at the served latent pool (8 slots of
#: max_seq 1024, 128 heads, kv_lora 512, rope 64; ragged positions over
#: [S/2, S)), with an idle slot (no valid position), and at a ragged S
LATENT_CASES = {"served": dict(b=8, s=1024, h=128, lora=512, rope=64,
                               idle=0),
                "idle slot": dict(b=8, s=1024, h=128, lora=512, rope=64,
                                  idle=1),
                "ragged S 1000": dict(b=8, s=1000, h=128, lora=512,
                                      rope=64, idle=1)}

#: launches of each kernel per decode step of the branches=4 model
#: (quantized kernels: with quantize="int8", kv_quantize="int8")
DECODE_LAUNCHES = {"lowrank_matmul": {"k,v": 32},
                   "branched_matmul": {"q,o": 32, "gate,up": 32,
                                       "down": 16},
                   "lowrank_matmul_q": {"k,v": 32},
                   "branched_matmul_q": {"q,o": 32, "gate,up": 32,
                                         "down": 16},
                   "decode_attention_q": {"served": 16},
                   "decode_attention_paged": {"served": 16},
                   "decode_attention_paged_q": {"served": 16},
                   "decode_attention_latent_q": {"served": MLA_LAYERS},
                   "lowrank_matmul_sq": {"k,v": 32},
                   "branched_matmul_sq": {"q,o": 32, "gate,up": 32,
                                          "down": 16}}
M_CASES = (8, 64, 37)
QMODES = ("int8", "fp8")
#: the SVD pairs that the branches=4 tree serves 2:4-packed (B11 rows)
SPARSE_LOWRANK = ("k,v",)
#: the SVD pairs whose bf16 B1 / B3 rows at M = 8 time the plans of
#: LOWRANK_PLAN_SWEEP (B11's: SPARSE_LOWRANK): every served pair, from the
#: k/v pair's 0.3 MB of int8 weights to gate/up's 12.6 MB of bf16 w1
LOWRANK_PLAN_SHAPES = tuple(LOWRANK_SHAPES)
#: the bf16 two-phase lowrank plans (B1, B3, B11) an M = 8 row times
#: beside its own (lowrank_split's ``items``, one count or one a phase,
#: None for the default of two a SM; and ``ctas``, the CTAs a launch takes
#: at most, 0 for the whole persistent grid, None for the default of one
#: a SM where no phase has more items than SMs, else the whole grid): fewer
#: items give longer K slices and fewer partials to sum, one item a column
#: tile (phase 2 at 4 at k/v) no sum and no grid sync for it; fewer CTAs
#: a cheaper grid sync
LOWRANK_PLAN_SWEEP = ((8, None), (16, None), (32, None), (None, None),
                      ((None, 4), None), ((None, 8), None), (None, 0),
                      (16, 0), ((None, 4), 0), (None, 64), (None, 132))
#: row counts of the activation-quantized chains, which run prefill
#: segments only: a prefill chunk, a ragged chunk, a long prompt
QA_M_CASES = (64, 37, 512)
#: the plans of the split-phase s8 kernel (B7) a bf16 M = 64 row times
#: beside its own (qa_split's ``items`` a phase; None its default of two a
#: SM): longer K slices, fewer int32 partials to write and sum
QA_PLAN_SWEEP = (None, 132, 64)
#: the plans of its two-phase form (B6) a bf16 M = 64 row times beside its
#: own (lowrank_qa_split's ``items``, one count or one a phase, None its
#: default of half an item a SM in phase 1 and one in phase 2; and
#: ``ctas``, 0 the whole persistent grid, None the default of one a SM
#: where no phase has more items than SMs): two a SM in both phases (the
#: first default); more or fewer phase-1 items (K slices, partials for
#: the requantization to sum); one K slice in phase 2; the CTA cap
QA_LOWRANK_PLAN_SWEEP = ((None, None), (None, 0), (None, 64),
                         ((264, 264), None), ((264, None), None),
                         ((32, None), None), ((None, 264), None),
                         ((None, 1), None), ((1, 1), None))
#: paged decode attention at the served pool: 8 slots of 64 blocks of 16
#: positions (max_seq 1024) over 512 physical blocks + the dummy, tables
#: shuffled, ragged positions, one idle slot (no valid position)
PAGED_CASES = {"served": dict(b=8, kh=8, g=4, d=64, bs=16, nblk=64, nb=512,
                              idle=1, softcap=0.0),
               "softcap 30": dict(b=8, kh=8, g=4, d=64, bs=16, nblk=64,
                                  nb=512, idle=1, softcap=30.0)}
#: launches of each activation-quantized chain per prefill chunk (M = 64)
#: of the branches=4 model
PREFILL_LAUNCHES = {"lowrank_matmul_qa": {"k,v": 32},
                    "branched_matmul_qa": {"q,o": 32, "gate,up": 32,
                                           "down": 16}}
#: the train phases: llama3.2-1b at full width decomposed at branches=4
#: with the §2.2 freeze, fine-tuned on ByteTextLM's built-in corpus at
#: batch x seq (M = 1,024 rows through every chain kernel), and its steps
TRAIN_BATCH, TRAIN_SEQ = 4, 256
TRAIN_M = TRAIN_BATCH * TRAIN_SEQ
TRAIN_STEPS = 8
#: the optimizer of the train phases (cosine over the run's steps)
TRAIN_OPTIM = dict(peak_lr=2e-3, warmup_steps=2)
#: launches of each chain kernel's forward per train step with
#: remat="none" ("full" runs every block's forward again in backward:
#: twice these)
TRAIN_LAUNCHES = {"lowrank_matmul": {"k,v": 32},
                  "branched_matmul": {"q,o": 32, "gate,up": 32,
                                      "down": 16}}
#: check_train: the card's bf16 step against the CPU's f32 step on the
#: same params and batch: the loss within 1e-2 relative and every
#: trainable leaf's gradient within 0.05 relative L2 (||card - cpu|| /
#: ||cpu||).  bf16 rounds activations, intermediates and cotangents at
#: every op of 16 layers; a 16-layer stack of d_model 256 under the same
#: LRD read 0.005-0.010 on the CPU (bf16 against f32, the same rounding
#: points), so 0.05 leaves a factor of 5 for the full width.
TRAIN_CHECK_TOL = {"loss": 1e-2, "grad": 5e-2}

#: kernel module of each wrapper (its CUDA source has the module's name),
#: the wrapper's launch counter and the TPU kernel it replaces
KERNELS = {
    "lowrank_matmul": ("lowrank_matmul", "launches",
                       "src/repro/kernels/lowrank_matmul.py:54"),
    "branched_matmul": ("branched_matmul", "launches",
                        "src/repro/kernels/branched_matmul.py:56"),
    "lowrank_matmul_q": ("lowrank_matmul_q", "launches",
                         "src/repro/kernels/lowrank_matmul_q.py:57"),
    "branched_matmul_q": ("branched_matmul_q", "launches",
                          "src/repro/kernels/branched_matmul_q.py:71"),
    "decode_attention_q": ("decode_attention_q", "launches",
                           "src/repro/kernels/decode_attention_q.py:103"),
    "lowrank_matmul_qa": ("lowrank_matmul_qa", "launches",
                          "src/repro/kernels/lowrank_matmul_qa.py:83"),
    "branched_matmul_qa": ("branched_matmul_qa", "launches",
                           "src/repro/kernels/branched_matmul_qa.py:77"),
    "decode_attention_paged": ("decode_attention_paged", "launches",
                               "src/repro/kernels/decode_attention_paged.py:96"),
    "decode_attention_paged_q": (
        "decode_attention_paged", "launches_q",
        "src/repro/kernels/decode_attention_paged.py:192"),
    "decode_attention_latent_q": (
        "decode_attention_latent_q", "launches",
        "src/repro/kernels/decode_attention_q.py:214"),
    "lowrank_matmul_sq": ("lowrank_matmul_sq", "launches",
                          "src/repro/kernels/lowrank_matmul_sq.py:84"),
    "branched_matmul_sq": ("branched_matmul_sq", "launches",
                           "src/repro/kernels/branched_matmul_sq.py:70"),
}

#: the CUDA source of a kernel whose wrapper module's own source is not
#: where it lives (B5 runs the split kernel of the paged pools)
SOURCE_OF = {"decode_attention_q": "decode_attention_paged.cu"}
#: the serve run (key of the serve phases' results) whose launches each
#: kernel's entry reports: the path the kernel belongs to
RUN_OF = {"lowrank_matmul": "branches4", "branched_matmul": "branches4",
          "lowrank_matmul_q": "quantized", "branched_matmul_q": "quantized",
          "decode_attention_q": "quantized", "lowrank_matmul_qa": "qa",
          "branched_matmul_qa": "qa", "decode_attention_paged": "paged",
          "decode_attention_paged_q": "qa",
          "decode_attention_latent_q": "mla_q", "lowrank_matmul_sq": "sq",
          "branched_matmul_sq": "sq"}
#: the paged serve runs: tokens per block, and the shared prompt prefix
#: (16 blocks) that four of the eight requests begin with
PAGED_BLOCK = 16
SHARED_PREFIX = 256


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

#: spin cycles queued before a timed run with the host ahead (about 10 ms
#: at the H100's clock: longer than the host takes to enqueue the run)
AHEAD_CYCLES = 20_000_000


def time_ms(fn, iters: int = 20, warmup: int = 3,
            ahead: bool = False) -> float:
    """Mean time of ``fn`` over ``iters`` launches between CUDA events.
    ``ahead``: a spin kernel first keeps the card busy while the host
    enqueues the run, so the events time the device's work and not the
    host's enqueue (which sets the time of a launch shorter than its
    wrapper's host code)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda.synchronize()
        torch.cuda._sleep(AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: bytes written between cold-L2 launches: twice the H100's 50 MB L2
L2_FLUSH_BYTES = 100 * 1024 * 1024


def cold_ms(fn, flush, iters: int = 10, warmup: int = 2,
            ahead: bool = False) -> float:
    """Mean time of ``fn`` with a cold L2: before each timed launch, and
    outside its events, ``flush`` (L2_FLUSH_BYTES) is written, so no
    weight byte is left in L2, as in a served stack of many layers.
    ``ahead``: a short spin kernel after each flush keeps the host ahead
    of the card (:func:`time_ms`)."""
    import torch
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        if ahead:
            torch.cuda._sleep(AHEAD_CYCLES // 20)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def kernel_module(name: str):
    import importlib
    return importlib.import_module(f"repro_torch.kernels.{KERNELS[name][0]}")


def launch_count(name: str) -> int:
    return getattr(kernel_module(name), KERNELS[name][1])


def reset_launches() -> None:
    for name in KERNELS:
        setattr(kernel_module(name), KERNELS[name][1], 0)


def check_kernels(card: str, only: frozenset = frozenset(KERNELS)
                  ) -> list[dict]:
    """Every row of the kernels in ``only`` (default all twelve) against
    its plain version; returns their entries of the kernels line."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.quant.quantize import quantize_array
    from repro_torch.quant.sparse import sparsify_array

    lk = kernel_module("lowrank_matmul")
    lqk = kernel_module("lowrank_matmul_q")
    g = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(dtype)

    def qrnd(*shape, mode):
        """A factor quantized as the engine quantizes it: (q, scale)."""
        return quantize_array(rnd(*shape, scale=shape[-2] ** -0.5), mode)

    def dq(q, scale, dt):
        return (q.to(torch.float32) * scale).to(dt)

    def spack(*shape, mode):
        """A factor 2:4-packed as the engine packs it, (sp, idx, scale):
        rows 0 and 1 of every other group shrunk, so that group keeps its
        top positions (idx 2 and 3)."""
        w = rnd(*shape, scale=shape[-2] ** -0.5)
        top = torch.arange(shape[-2], device="cuda")
        w[..., ((top // 4) % 2 == 0) & (top % 4 < 2), :] *= 0.125
        return sparsify_array(w, mode=mode)

    rows: dict[str, list[dict]] = {k: [] for k in KERNELS if k in only}

    def add(name: str, make_row) -> None:
        """Make and keep a row of ``name`` if the kernel was asked for."""
        if name in only:
            rows[name].append(make_row())

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    lowrank = {"lowrank_matmul", "lowrank_matmul_q", "lowrank_matmul_sq"}
    branched = {"branched_matmul", "branched_matmul_q", "branched_matmul_sq"}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        xb = dt.itemsize
        for label, (c, r, s) in LOWRANK_SHAPES.items():
            if not only & lowrank:
                break
            for m in M_CASES:
                x = rnd(m, c, dtype=dt)
                w0 = rnd(c, r, scale=c ** -0.5, dtype=dt)
                w1 = rnd(r, s, scale=r ** -0.5, dtype=dt)
                y = lk.lowrank_matmul(x, w0, w1)
                want = ref.lowrank_matmul_ref(x, w0, w1)
                torch.cuda.synchronize()
                plans = label in LOWRANK_PLAN_SHAPES and m == 8
                add("lowrank_matmul", lambda: dict(
                    shape=label, dtype=dname, M=m, C=c, R=r, S=s,
                    **_compare(y, want, dname),
                    **_lowrank_times("lowrank_matmul", (x, w0, w1), y,
                                     lambda: (x @ w0) @ w1, dname, flush,
                                     plans),
                    plain_ms=time_ms(lambda: ref.lowrank_matmul_ref(x, w0,
                                                                    w1)),
                    **_bound(xb * (m * c + c * r + r * s + m * s),
                             2 * m * (c * r + r * s), dname)))
                for mode in QMODES:
                    if not only & (lowrank - {"lowrank_matmul"}):
                        break
                    w0q, w0s = qrnd(c, r, mode=mode)
                    w1q, w1s = qrnd(r, s, mode=mode)
                    args = (x, w0q, w0s, w1q, w1s)
                    y = lqk.lowrank_matmul_q(*args)
                    want = ref.lowrank_matmul_q_ref(*args)
                    torch.cuda.synchronize()
                    w0d, w1d = dq(w0q, w0s, dt), dq(w1q, w1s, dt)
                    add("lowrank_matmul_q", lambda: dict(
                        shape=label, dtype=dname, qmode=mode, M=m, C=c, R=r,
                        S=s, **_compare(y, want, dname),
                        **_lowrank_times("lowrank_matmul_q", args, y,
                                         lambda: (x @ w0d) @ w1d, dname,
                                         flush, plans),
                        plain_ms=time_ms(
                            lambda: ref.lowrank_matmul_q_ref(*args)),
                        **_bound(xb * (m * c + m * s) + c * r + r * s
                                 + 4 * (r + s), 2 * m * (c * r + r * s),
                                 dname)))
                    if label in SPARSE_LOWRANK:
                        add("lowrank_matmul_sq", lambda: _check_sq(
                            label, x, [spack(c, r, mode=mode),
                                       spack(r, s, mode=mode)], dname,
                            flush))
        for label, shape in BRANCHED_SHAPES.items():
            for m in (M_CASES if only & branched else ()):
                _check_branched(add, label, shape, m, dname, rnd, qrnd,
                                QMODES, spack, flush, only)
        for label, case in LATENT_CASES.items():
            add("decode_attention_latent_q",
                lambda: _check_latent(label, case, dname, rnd, flush))
        if dname == "bfloat16" and only & branched:
            for label, shape in DEEPSEEK_BRANCHED_SHAPES.items():
                for m in DEEPSEEK_M_CASES:
                    _check_branched(add, label, shape, m, dname, rnd, qrnd,
                                    ("int8",), spack, flush, only)
            for label, shape in ALIGNED_CONTROL.items():
                _check_branched(add, label, shape, 8, dname, rnd, qrnd,
                                ("int8",), spack, flush, only)
        for label, case in ATTN_CASES.items():
            add("decode_attention_q",
                lambda: _check_attention(label, case, dname, rnd, flush))
        for label, (c, r, s) in LOWRANK_SHAPES.items():
            for m in QA_M_CASES:
                add("lowrank_matmul_qa", lambda: _check_qa(
                    label, m, dname, rnd, [qrnd(c, r, mode="int8"),
                                           qrnd(r, s, mode="int8")], flush))
        for label, (n, c, r, s) in BRANCHED_SHAPES.items():
            for m in QA_M_CASES:
                add("branched_matmul_qa", lambda: _check_qa(
                    label, m, dname, rnd, [qrnd(n, c, r, mode="int8"),
                                           qrnd(n, r, r, mode="int8"),
                                           qrnd(n, r, s, mode="int8")],
                    flush))
        for label, case in PAGED_CASES.items():
            for quant in (False, True):
                add("decode_attention_paged" + ("_q" if quant else ""),
                    lambda: _check_paged(label, case, dname, quant, g, flush))
    bf = torch.bfloat16
    for label in TRAIN_LAUNCHES["lowrank_matmul"]:
        c, r, s = LOWRANK_SHAPES[label]
        add("lowrank_matmul", lambda: _train_row(
            "lowrank_matmul", label, (rnd(TRAIN_M, c, dtype=bf),
                                      rnd(c, r, scale=c ** -0.5, dtype=bf),
                                      rnd(r, s, scale=r ** -0.5, dtype=bf)),
            rnd, flush))
    for label in TRAIN_LAUNCHES["branched_matmul"]:
        n, c, r, s = BRANCHED_SHAPES[label]
        add("branched_matmul", lambda: _train_row(
            "branched_matmul", label, (
                rnd(TRAIN_M, c, dtype=bf),
                rnd(n, c, r, scale=c ** -0.5, dtype=bf),
                rnd(n, r, r, scale=r ** -0.5, dtype=bf),
                rnd(n, r, s, scale=r ** -0.5, dtype=bf)), rnd, flush))
    failures = []
    for name, rs in rows.items():
        for row in rs:
            ok = (row["norm_err"] <= KERNEL_TOL[row["dtype"]]
                  and row.get("same_bits", True)
                  and row.get("prev_err", 0.0) <= KERNEL_TOL[row["dtype"]]
                  and row.get("differing", 0) == 0
                  and row.get("differing_prev", 0) == 0
                  and row.get("grad_err", 0.0) <= KERNEL_TOL[row["dtype"]])
            lib_ms = row["library_ms"]
            extra = "".join(f"{k}={row[k]:.4f} "
                            for k in SPLIT_TIMES + EVENT_TIMES
                            if row.get(k) is not None)
            if row.get("phase_us"):
                extra += "phase_us=" + "/".join(
                    f"{t:.1f}" for t in row["phase_us"]) + " "
            if row.get("plan_us"):
                extra += "plan_us=" + " ".join(
                    f"{k}:{v['ms'] * 1e3:.1f}:" + "/".join(
                        f"{t:.1f}" for t in v["phase_us"])
                    for k, v in row["plan_us"].items()) + " "
            log(f"{name:24s} {row['shape']:22s} {row['dtype']:8s} "
                f"{row.get('qmode', ''):4s} M={row.get('M', row.get('B')):4d}"
                f" max_abs_err={row['max_abs_err']:.3e} "
                f"norm_err={row['norm_err']:.3e} "
                f"(tol {KERNEL_TOL[row['dtype']]:.0e}) "
                + (f"differing={row['differing']} "
                   if "differing" in row else "")
                + (f"differing_prev={row['differing_prev']} "
                   if "differing_prev" in row else "")
                + (f"same_bits={row['same_bits']} "
                   if "same_bits" in row else "")
                + (f"splits={row['splits']} " if "splits" in row else "")
                + (f"prev_err={row['prev_err']:.3e} "
                   if "prev_err" in row else "")
                + (f"grad_err={row['grad_err']:.3e} bwd_ms="
                   f"{row['bwd_ms']:.4f} bwd_frozen_ms="
                   f"{row['bwd_frozen_ms']:.4f} "
                   if "grad_err" in row else "")
                + ("split_ms=" + "/".join(f"{n}:{t:.4f}" for n, t in
                                          row["split_ms"].items()) + " "
                   if "split_ms" in row else "")
                + f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                + extra +
                f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                f"[{card}] {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append((name, row))
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version (or "
                         f"with its own first call): {failures}")
    return _kernel_entries(rows)


def _split_times(kernel, prev, phases, library, flush, dname: str) -> dict:
    """Times of one branched chain row (B2, B4 or B12) beside its cuBLAS
    chain ``library``.  bf16 runs the split-phase ``kernel``: timed in
    turns with ``prev``, the cluster kernel (the earlier design; new, old,
    old, new: ``prev_ms``), its phase timer read (``phase_us``, the
    fastest of five launches of ``phases()``) and a second call held to
    the first's bits (``same_bits``).  f32 runs the cluster kernel.
    ``cold_ms`` and ``library_cold_ms`` time the kernel and the library
    call with a cold L2."""
    import torch
    out = dict(prev_ms=None, phase_us=None)
    if dname == "bfloat16":
        turns = [time_ms(kernel), time_ms(prev), time_ms(prev),
                 time_ms(kernel)]
        out.update(ms=(turns[0] + turns[3]) / 2,
                   prev_ms=(turns[1] + turns[2]) / 2,
                   phase_us=min((phases() for _ in range(5)), key=sum),
                   same_bits=torch.equal(kernel(), kernel()))
    else:
        out["ms"] = time_ms(kernel)
    return dict(out, cold_ms=cold_ms(kernel, flush),
                library_ms=time_ms(library),
                library_cold_ms=cold_ms(library, flush))


def _branched_row(label: str, x, u, xc, v, dname: str, flush) -> dict:
    """One branched_matmul row (:func:`_split_times`)."""
    import torch
    from repro_torch.kernels import ref
    bk = kernel_module("branched_matmul")
    m, c = x.shape
    n, _, r = u.shape
    s = v.shape[-1]
    y = bk.branched_matmul(x, u, xc, v)
    want = ref.branched_matmul_ref(x, u, xc, v)
    torch.cuda.synchronize()
    xb3 = x.expand(n, m, c)
    return dict(
        shape=label, dtype=dname, M=m, N=n, C=c, r=r, S=s,
        **_compare(y, want, dname),
        **_split_times(
            lambda: bk.branched_matmul(x, u, xc, v),
            lambda: bk.cluster_branched_matmul(x, u, xc, v),
            lambda: bk.branched_matmul_phase_us(x, u, xc, v),
            lambda: torch.bmm(torch.bmm(torch.bmm(xb3, u), xc), v).sum(0),
            flush, dname),
        plain_ms=time_ms(lambda: ref.branched_matmul_ref(x, u, xc, v)),
        **_bound(x.dtype.itemsize * (m * c + n * (c * r + r * r + r * s)
                                     + m * s),
                 2 * m * n * (c * r + r * r + r * s), dname))


def _check_branched(add, label: str, shape: tuple, m: int, dname: str, rnd,
                    qrnd, qmodes, spack, flush, only) -> None:
    """One branched_matmul row at (N, C, r, S) and M rows in ``dname``,
    and one branched_matmul_q and one branched_matmul_sq row per factor
    mode of ``qmodes`` (each only if in ``only``); the yardstick is the
    cuBLAS chain of batched products (on factors dequantized, or
    expanded, beforehand for the quantized and the 2:4 kernels)."""
    import torch
    from repro_torch.kernels import ref
    bqk = kernel_module("branched_matmul_q")
    n, c, r, s = shape
    dt = getattr(torch, dname)
    xb = dt.itemsize
    x = rnd(m, c, dtype=dt)
    u = rnd(n, c, r, scale=c ** -0.5, dtype=dt)
    xc = rnd(n, r, r, scale=r ** -0.5, dtype=dt)
    v = rnd(n, r, s, scale=r ** -0.5, dtype=dt)
    add("branched_matmul", lambda: _branched_row(label, x, u, xc, v, dname,
                                                 flush))
    xb3 = x.expand(n, m, c)
    flops = 2 * m * n * (c * r + r * r + r * s)
    del u, xc, v
    for mode in qmodes:
        if not only & {"branched_matmul_q", "branched_matmul_sq"}:
            break
        qs = [qrnd(n, c, r, mode=mode), qrnd(n, r, r, mode=mode),
              qrnd(n, r, s, mode=mode)]
        args = (x, *[t for pair in qs for t in pair])
        y = bqk.branched_matmul_q(*args)
        want = ref.branched_matmul_q_ref(*args)
        torch.cuda.synchronize()
        ud, xcd, vd = ((q.to(torch.float32) * sc).to(dt) for q, sc in qs)
        add("branched_matmul_q", lambda: dict(
            shape=label, dtype=dname, qmode=mode, M=m, N=n, C=c, r=r, S=s,
            **_compare(y, want, dname),
            **_split_times(
                lambda: bqk.branched_matmul_q(*args),
                lambda: bqk.cluster_branched_matmul_q(*args),
                lambda: bqk.branched_matmul_q_phase_us(*args),
                lambda: torch.bmm(torch.bmm(torch.bmm(xb3, ud), xcd),
                                  vd).sum(0), flush, dname),
            plain_ms=time_ms(lambda: ref.branched_matmul_q_ref(*args)),
            **_bound(xb * (m * c + m * s) + n * (c * r + r * r + r * s)
                     + 4 * n * (2 * r + s), flops, dname)))
        del ud, xcd, vd
        add("branched_matmul_sq", lambda: _check_sq(
            label, x, [spack(n, c, r, mode=mode), qs[1],
                       spack(n, r, s, mode=mode)], dname, flush))


def _check_sq(label: str, x, factors: list, dname: str,
              flush=None) -> dict:
    """One row of a 2:4 chain on ``x``: ``factors`` are the 2:4 packs
    (sp, idx, scale) of w0 / w1, or of u / v around the quantized core
    (q, scale) of xc.  The yardstick is the cuBLAS chain on the factors
    expanded and dequantized beforehand; a branched row takes
    :func:`_split_times` (``flush`` for its cold-L2 times), a lowrank row
    :func:`_lowrank_times`, with the plans of :data:`LOWRANK_PLAN_SWEEP`
    at the served decode shape.
    The bound counts the packed values, the index bytes, the scales and
    the activations at HBM rate, and the kept products only (the pruned
    half costs no operations)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.quant.sparse import expand_sparse
    lowrank = len(factors) == 2
    name = "lowrank_matmul_sq" if lowrank else "branched_matmul_sq"
    mod = kernel_module(name)
    fn = getattr(mod, name)
    plain = getattr(ref, name + "_ref")
    args = (x, *[t for f in factors for t in f])
    y = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    dt = x.dtype
    m, c = x.shape
    qmode = "int8" if factors[0][0].dtype == torch.int8 else "fp8"
    packs = [factors[0], factors[-1]]
    dense = [expand_sparse(*f, dtype=dt) for f in packs]
    if lowrank:
        (r, s), n = dense[1].shape, 1
        w0d, w1d = dense
        times = _lowrank_times(name, args, y, lambda: (x @ w0d) @ w1d,
                               dname, flush,
                               label in SPARSE_LOWRANK and m == 8)
        kept = c * r // 2 + r * s // 2
        dims = dict(C=c, R=r, S=s)
    else:
        n, r, s = dense[1].shape
        ud, vd = dense
        xcd = (factors[1][0].to(torch.float32) * factors[1][1]).to(dt)
        xb3 = x.expand(n, m, c)
        times = _split_times(
            lambda: fn(*args),
            lambda: mod.cluster_branched_matmul_sq(*args),
            lambda: mod.branched_matmul_sq_phase_us(*args),
            lambda: torch.bmm(torch.bmm(torch.bmm(xb3, ud), xcd),
                              vd).sum(0), flush, dname)
        kept = n * (c * r // 2 + r * r + r * s // 2)
        dims = dict(N=n, C=c, r=r, S=s)
    del dense
    nbytes = (dt.itemsize * m * (c + s) + kept
              + sum(f[1].numel() for f in packs)
              + 4 * sum(f[-1].numel() for f in factors))
    top = int((packs[0][1][..., 0, :, 0] == 2).sum().item())
    return dict(shape=label, dtype=dname, qmode=qmode, M=m, **dims,
                top_groups=top, **_compare(y, want, dname), **times,
                plain_ms=time_ms(lambda: plain(*args)),
                library="cuBLAS chain on factors expanded beforehand",
                **_bound(nbytes, 2 * m * kept, dname))


def _lowrank_times(name: str, args: tuple, y, library, dname: str, flush,
                   plans: bool) -> dict:
    """Times of a lowrank chain row (B1, B3 or B11, the wrapper ``name``
    on ``args``, whose output was ``y``) beside its cuBLAS chain
    ``library``, by :func:`_attention_times`: bf16 runs the two-phase
    split kernel, timed in turns with the cluster kernel (the earlier
    design, ``prev_ms``), held to it (``prev_err``) and its phase timer
    read (``phase_us``, the fastest of five launches), with ``plans`` the
    times of the plans of :data:`LOWRANK_PLAN_SWEEP` (``plan_us``); f32
    runs the cluster kernel."""
    mod = kernel_module(name)
    fn = getattr(mod, name)
    cluster = getattr(mod, "cluster_" + name)
    bf16 = dname == "bfloat16"
    times = dict(prev_err=_compare(y, cluster(*args), dname)["norm_err"],
                 **_attention_times(lambda: fn(*args),
                                    (lambda: cluster(*args)) if bf16
                                    else None, library, flush))
    if bf16:
        phases = getattr(mod, name + "_phase_us")
        times["phase_us"] = min((phases(*args) for _ in range(5)), key=sum)
        if plans:
            times["plan_us"] = _lowrank_plans(mod, name, args,
                                              LOWRANK_PLAN_SWEEP)
    return times


def _lowrank_plans(mod, name: str, args: tuple, sweep: tuple) -> dict:
    """Device ms of one launch (host ahead) and the phase times (the
    fastest of five launches) of the two-phase lowrank kernel of the
    wrapper ``name`` (bf16 B1, B3, B11 at :data:`LOWRANK_PLAN_SWEEP`; B6
    at :data:`QA_LOWRANK_PLAN_SWEEP`) at each plan of ``sweep``, keyed
    ``items/ctas`` (``items`` a count for both phases, or one a phase;
    ``-`` the wrapper's default)."""
    split = getattr(mod, name + "_split")
    phases = getattr(mod, name + "_phase_us")
    out = {}
    for items, ctas in sweep:
        knobs = dict(items=items, ctas=ctas)
        label = "/".join(",".join("-" if n is None else str(n) for n in v)
                         if isinstance(v, tuple) else
                         "-" if v is None else str(v) for v in (items, ctas))
        out[label] = dict(
            ms=time_ms(lambda: split(*args, **knobs), ahead=True),
            phase_us=min((phases(*args, **knobs) for _ in range(5)),
                         key=sum))
    return out


def _train_row(name: str, label: str, args: tuple, rnd, flush) -> dict:
    """One bf16 B1 (three ``args``) or B2 (four) row at the training M:
    the kernel against its plain version; its times with the host kept
    ahead of the card, with a cold L2 and between events, beside the
    cuBLAS chain (:func:`_attention_times`; no earlier design timed); the
    autograd Function's gradients (kernel forward, explicit backward) for
    a random cotangent against autograd of the plain version on the same
    inputs (``grad_errs`` by input, ``grad_err`` the largest, normalised
    as the forward's); and the backward products' time with every
    gradient (``bwd_ms``) and with the frozen factors' left out, as a
    step under the §2.2 freeze runs them (``bwd_frozen_ms``).  The bound
    is the forward's."""
    import torch
    from repro_torch.kernels import autograd as kgrad
    from repro_torch.kernels import ref
    fn = getattr(kernel_module(name), name)
    plain = getattr(ref, name + "_ref")
    x = args[0]
    m, c = x.shape
    y = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if len(args) == 3:
        _, w0, w1 = args
        r, s = w1.shape
        library = lambda: (x @ w0) @ w1  # noqa: E731
        fwd, bwd = kgrad.LowrankMatmul, kgrad.lowrank_matmul_bwd
        names, frozen = ("x", "w0", "w1"), (True, False, True)
        dims = dict(C=c, R=r, S=s)
        kept = c * r + r * s
    else:
        _, u, xc, v = args
        n, _, r = u.shape
        s = v.shape[-1]
        xb3 = x.expand(n, m, c)
        library = lambda: torch.bmm(torch.bmm(torch.bmm(  # noqa: E731
            xb3, u), xc), v).sum(0)
        fwd, bwd = kgrad.BranchedMatmul, kgrad.branched_matmul_bwd
        names, frozen = ("x", "u", "xc", "v"), (True, False, True, False)
        dims = dict(N=n, C=c, r=r, S=s)
        kept = n * (c * r + r * r + r * s)
    g = rnd(m, s, dtype=x.dtype)
    ins = [a.detach().clone().requires_grad_(True) for a in args]
    got = torch.autograd.grad(fwd.apply(*ins), ins, g)
    pins = [a.detach().clone().requires_grad_(True) for a in args]
    ref_g = torch.autograd.grad(plain(*pins), pins, g)
    errs = {k: _compare(a, b, "bfloat16")["norm_err"]
            for k, a, b in zip(names, got, ref_g)}
    del ins, pins, got, ref_g
    every = (True,) * len(args)
    return dict(shape=label, dtype="bfloat16", M=m, **dims, path="train",
                **_compare(y, want, "bfloat16"),
                **_attention_times(lambda: fn(*args), None, library, flush),
                grad_err=max(errs.values()), grad_errs=errs,
                bwd_ms=time_ms(lambda: bwd(g, *args, needs=every),
                               ahead=True),
                bwd_frozen_ms=time_ms(lambda: bwd(g, *args, needs=frozen),
                                      ahead=True),
                plain_ms=time_ms(lambda: plain(*args)),
                **_bound(2 * (m * c + kept + m * s), 2 * m * kept,
                         "bfloat16"))


def latent_inputs(case: dict, dname: str, rnd) -> tuple:
    """Absorbed-decode inputs at a latent pool: q_lat (B, 1, H, L) and
    q_rope (B, 1, H, R) in ``dname``; the int8 latents quantized as the
    engine's insert quantizes them (one-shot per-(slot, channel)
    scales); cache_pos ragged over [S/2, S), slot 0 at S - 1, the last
    ``idle`` slots -1 (no valid position)."""
    import torch
    from repro_torch.quant.kv import quantize_kv_prefill
    b, s, h, lora, rope = (case[k] for k in ("b", "s", "h", "lora", "rope"))
    dt = getattr(torch, dname)
    q_lat = rnd(b, 1, h, lora, scale=0.5, dtype=dt)
    q_rope = rnd(b, 1, h, rope, scale=0.5, dtype=dt)
    ckv_q, ckv_s = quantize_kv_prefill(rnd(b, s, lora))
    krope_q, krope_s = quantize_kv_prefill(rnd(b, s, rope))
    pos = (torch.arange(b, device="cuda", dtype=torch.int32) * 97
           % (s - s // 2) + s // 2).to(torch.int32)
    pos[0] = s - 1
    if case["idle"]:
        pos[b - case["idle"]:] = -1
    return q_lat, q_rope, ckv_q, ckv_s, krope_q, krope_s, pos


def _split_sweep(launch, planned: int) -> dict:
    """Device ms of one launch at 1, 2, the planned and twice the planned
    splits (``launch(n)`` runs the kernel at n splits), keyed by the
    split count: the fixed cost of a split against the work it divides."""
    return {str(n): time_ms(lambda n=n: launch(n), ahead=True)
            for n in sorted({1, 2, planned, 2 * planned})}


def _attention_times(kernel, prev, library, flush) -> dict:
    """Times of a redesigned kernel's row (the split attentions B5, B8,
    B9, B10; the two-phase lowrank chains B1, B3, B11; the split-phase s8
    chains B6, B7) beside its library call ``library`` (None where there is
    none: its times are null), every one with the host ahead of the card
    (:func:`time_ms`): the kernel in turns with ``prev``, the earlier
    design (new, old, old, new: ``prev_ms``; ``prev`` None where the row
    runs the earlier design itself), a second call held to the first's
    bits (``same_bits``), the kernel and the library call with a cold L2
    (``cold_ms``, ``library_cold_ms``), and both between CUDA events with
    the host not kept ahead (:data:`EVENT_TIMES`, the series of the rows
    timed so before)."""
    import torch
    if prev is None:
        out = dict(ms=time_ms(kernel, ahead=True), prev_ms=None)
    else:
        turns = [time_ms(f, ahead=True) for f in (kernel, prev, prev, kernel)]
        out = dict(ms=(turns[0] + turns[3]) / 2,
                   prev_ms=(turns[1] + turns[2]) / 2)
    lib = library is not None
    return dict(out, same_bits=torch.equal(kernel(), kernel()),
                cold_ms=cold_ms(kernel, flush, ahead=True),
                library_ms=time_ms(library, ahead=True) if lib else None,
                library_cold_ms=(cold_ms(library, flush, ahead=True)
                                 if lib else None),
                event_ms=time_ms(kernel),
                library_event_ms=time_ms(library) if lib else None)


def _check_latent(label: str, case: dict, dname: str, rnd, flush) -> dict:
    """One decode_attention_latent_q row.  The bound counts the work this
    run's positions need: a live slot's positions up to its cache_pos
    (the kernel skips the blocks past it), an idle slot's whole pool;
    the operations (2 H (2L + R) per position) at the ``dname`` peak,
    the bytes (q rows, those positions' latents, the scale rows, the
    output) at HBM rate.  The yardstick is SDPA on the latents
    dequantized beforehand: q = [q_lat | q_rope], k = [ckv | krope] and
    v = ckv expanded over the heads, a position mask.  Times at the
    wrapper (the engine's ops entry adds a slice of q); ``prev_err`` is
    the split kernel's distance from the earlier kernel, normalised as
    ``norm_err``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dlk = kernel_module("decode_attention_latent_q")
    b, s, h, lora, rope = (case[k] for k in ("b", "s", "h", "lora", "rope"))
    dt = getattr(torch, dname)
    args = latent_inputs(case, dname, rnd)
    scale = 1.0 / math.sqrt(128 + rope)        # 1/sqrt(qk_nope + qk_rope)
    y = ops.decode_attention_latent_q(*args, scale=scale)
    want = ref.decode_attention_latent_q_ref(*args, scale=scale)
    torch.cuda.synchronize()
    q_lat, q_rope, ckv_q, ckv_s, krope_q, krope_s, pos = args
    flat = (q_lat[:, 0].contiguous(), q_rope[:, 0].contiguous(), ckv_q,
            ckv_s, krope_q, krope_s, pos)
    old = dlk.prev_decode_attention_latent_q(*flat, scale=scale)
    ckv = (ckv_q.float() * ckv_s[:, None]).to(dt)
    krope = (krope_q.float() * krope_s[:, None]).to(dt)
    qd = torch.cat([q_lat, q_rope], -1).transpose(1, 2)    # (B, H, 1, L+R)
    kd = torch.cat([ckv, krope], -1)[:, None].expand(b, h, s, lora + rope)
    vd = ckv[:, None].expand(b, h, s, lora)
    mask = (torch.arange(s, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]
    live = sum(s if cp < 0 else min(s, cp + 1) for cp in pos.tolist())
    nbytes = (q_lat.numel() + q_rope.numel() + y.numel()) * dt.itemsize \
        + live * (lora + rope) + 4 * b * (lora + rope) + 4 * b
    plan = dlk.latent_split(b, h, s, lora, rope,
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count)
    sweep = {}
    if label == "served" and dname == "bfloat16":
        sweep["split_ms"] = _split_sweep(
            lambda n: dlk.decode_attention_latent_q_split(
                *flat, scale=scale, splits=n), plan.splits)
    return dict(shape=label, dtype=dname, B=b, S=s, H=h, L=lora, R=rope,
                idle=case["idle"], splits=plan.splits, **sweep,
                **_compare(y, want, dname),
                prev_err=_compare(y[:, 0], old, dname)["norm_err"],
                **_attention_times(
                    lambda: dlk.decode_attention_latent_q(*flat, scale=scale),
                    lambda: dlk.prev_decode_attention_latent_q(*flat,
                                                               scale=scale),
                    lambda: F.scaled_dot_product_attention(
                        qd, kd, vd, attn_mask=mask, scale=scale), flush),
                plain_ms=time_ms(lambda: ref.decode_attention_latent_q_ref(
                    *args, scale=scale)),
                library="sdpa on dequantized latents",
                **_bound(nbytes, 2 * h * (2 * lora + rope) * live, dname))


def _check_attention(label: str, case: dict, dname: str, rnd,
                     flush) -> dict:
    """One decode_attention_q row: the pool quantized like the engine's
    (one-shot scales), q in ``dname``; slots past the first ``idle``
    live ones have no valid position (cache_pos -1).  B5 runs the split
    kernel's slot view: :func:`_attention_times` against the earlier
    kernel (one CTA per slot and KV head), ``prev_err``, the planned split
    count and, at the served bf16 shape, ``split_ms``.  The bound counts
    the work this run's positions need: a live slot's positions up to its
    cache_pos (the kernel skips the entries past it), an idle slot's whole
    S; the bytes (those positions' K and V, the scale rows, q and the
    output, cache_pos) at HBM rate, the operations (4 G D per position
    and KV head) at the ``dname`` peak.  The yardstick is SDPA on the
    pool dequantized beforehand, K/V expanded to every query head."""
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
    old = dak.prev_decode_attention_q(*args, **kw)
    torch.cuda.synchronize()
    kd = (k_q.float() * k_s[:, None]).to(dt).permute(0, 2, 1, 3) \
        .repeat_interleave(g_, dim=1).contiguous()
    vd = (v_q.float() * v_s[:, None]).to(dt).permute(0, 2, 1, 3) \
        .repeat_interleave(g_, dim=1).contiguous()
    qd = q.reshape(b, kh * g_, 1, d)
    mask = (torch.arange(s, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]
    live = sum(s if cp < 0 else min(s, cp + 1) for cp in pos.tolist())
    nbytes = (2 * live * kh * d + 2 * 4 * b * kh * d
              + 2 * q.numel() * dt.itemsize + 4 * b)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    planned = dak.slot_split(b, kh, s, sms, g=g_, d=d).splits
    times = {}
    if label == "served" and dname == "bfloat16":
        times["split_ms"] = _split_sweep(
            lambda n: dak.decode_attention_q_split(*args, **kw, splits=n),
            planned)
    return dict(shape=label, dtype=dname, B=b, S=s, KH=kh, G=g_, D=d,
                softcap=case["softcap"], idle=case["idle"], splits=planned,
                **times, **_compare(y.reshape(want.shape), want, dname),
                prev_err=_compare(y, old, dname)["norm_err"],
                **_attention_times(
                    lambda: dak.decode_attention_q(*args, **kw),
                    lambda: dak.prev_decode_attention_q(*args, **kw),
                    lambda: F.scaled_dot_product_attention(
                        qd, kd, vd, attn_mask=mask), flush),
                plain_ms=time_ms(lambda: ref.decode_attention_q_ref(
                    q4, *args[1:], **kw)),
                **_bound(nbytes, 4 * kh * g_ * d * live, dname))


def _int_mm_chain(args: tuple):
    """The library yardstick of the activation-quantized chains: the same
    quantization and folds around ``torch._int_mm`` (cuBLASLt int8 x
    int8 -> int32) for every dot.  ``args`` are a lowrank or a branched
    kernel's arguments."""
    import torch
    from repro_torch.kernels.ref import quantize_rows

    def dot(a_q, b_q, a_s, b_s):
        return torch._int_mm(a_q, b_q).to(torch.float32) * a_s * b_s
    x = args[0]
    xq, xs = quantize_rows(x)
    if len(args) == 5:
        _, w0q, w0s, w1q, w1s = args
        hq, hs = quantize_rows(dot(xq, w0q, xs, w0s))
        return dot(hq, w1q, hs, w1s).to(x.dtype)
    _, uq, us, xcq, xcs, vq, vs = args
    y = 0.0
    for i in range(uq.shape[0]):
        h1q, h1s = quantize_rows(dot(xq, uq[i], xs, us[i]))
        h2q, h2s = quantize_rows(dot(h1q, xcq[i], h1s, xcs[i]))
        y = y + dot(h2q, vq[i], h2s, vs[i])
    return y.to(x.dtype)


def _check_qa(label: str, m: int, dname: str, rnd, factors: list,
              flush) -> dict:
    """One row of an activation-quantized chain (B6 with two ``factors``,
    B7 with three): int8 (q, scale) pairs, x in ``dname`` with one
    all-zero row (scale 0, output exactly 0).  ``differing`` counts
    output elements not bit-equal to the plain version (the folds and
    roundings are the same, so 0 is expected).  The yardstick is the
    same quantization and folds around ``torch._int_mm``
    (:func:`_int_mm_chain`; null where cuBLASLt refuses the shape).  Both
    run the split-phase s8 kernel, timed by :func:`_attention_times`
    against the cluster kernel (the earlier design), whose output it must
    equal bit for bit (``differing_prev``), with its phase timer
    (``phase_us``, the fastest of five launches) and, at M = 64 in bf16,
    the plans of :data:`QA_LOWRANK_PLAN_SWEEP` / :data:`QA_PLAN_SWEEP`
    (``plan_us``)."""
    import torch
    from repro_torch.kernels import ref
    lowrank = len(factors) == 2
    name = "lowrank_matmul_qa" if lowrank else "branched_matmul_qa"
    mod = kernel_module(name)
    fn = getattr(mod, name)
    cluster = getattr(mod, "cluster_" + name)
    phases = getattr(mod, name + "_phase_us")
    plain = ref.lowrank_matmul_qa_ref if lowrank \
        else ref.branched_matmul_qa_ref
    c = factors[0][0].shape[-2]
    x = rnd(m, c, dtype=getattr(torch, dname))
    x[m // 2] = 0
    args = (x, *[t for pair in factors for t in pair])
    y = fn(*args)
    want = plain(*args)
    old = cluster(*args)
    torch.cuda.synchronize()
    n = 1 if lowrank else factors[0][0].shape[0]
    chain = [tuple(q.shape[-2:]) for q, _ in factors]
    s = chain[-1][1]
    library = lambda: _int_mm_chain(args)  # noqa: E731
    try:
        library()
    except RuntimeError as e:             # the yardstick only, never the port
        log(f"torch._int_mm chain unavailable at M={m} ({e}); "
            "library_ms null")
        library = None
    dims = dict(C=c, R=chain[0][1], S=s) if lowrank else \
        dict(N=n, C=c, r=chain[0][1], S=s)

    def differing(a):
        return int((y.to(torch.float32) != a.to(torch.float32)).sum().item())
    times = dict(
        differing_prev=differing(old),
        prev_err=_compare(y, old, dname)["norm_err"],
        **_attention_times(lambda: fn(*args), lambda: cluster(*args),
                           library, flush),
        phase_us=min((phases(*args) for _ in range(5)), key=sum))
    if m == 64 and dname == "bfloat16":
        if lowrank:
            times["plan_us"] = _lowrank_plans(mod, name, args,
                                              QA_LOWRANK_PLAN_SWEEP)
        else:
            times["plan_us"] = {
                "-" if items is None else str(items): dict(
                    ms=time_ms(lambda: mod.branched_matmul_qa_split(
                        *args, items=items), ahead=True),
                    phase_us=min((phases(*args, items=items)
                                  for _ in range(5)), key=sum))
                for items in QA_PLAN_SWEEP}
    return dict(shape=label, dtype=dname, M=m, **dims,
                **_compare(y, want, dname), differing=differing(want),
                **times, plain_ms=time_ms(lambda: plain(*args)),
                **_bound(x.element_size() * m * (c + s)
                         + n * sum(k * o + 4 * o for k, o in chain),
                         2 * m * n * sum(k * o for k, o in chain), "int8"))


def paged_inputs(case: dict, dname: str, quant: bool, g) -> tuple:
    """Decode attention inputs over a paged pool of ``nb`` + 1 blocks:
    q (B, 1, H, D) in ``dname``; the pool in ``dname`` (or int8 with one
    scale row per block, quantized as the engine's insert quantizes a
    block); tables whose live entries are a shuffled run of physical
    blocks, the dummy past them; cache_pos ragged over [S/2, S), the
    last ``idle`` slots -1 (no valid position) on rows of dummies.
    Returns ``(q, pool, tables, cache_pos)``, ``pool`` being ``(k, v)``
    or ``(k_q, k_scale, v_q, v_scale)``."""
    import torch
    from repro_torch.quant.kv import kv_scales, quantize_kv
    b, kh, gg, d, bs, nblk, nb = (case[k] for k in
                                  ("b", "kh", "g", "d", "bs", "nblk", "nb"))
    dt = getattr(torch, dname)
    q = torch.randn((b, 1, kh * gg, d), generator=g, device="cuda").to(dt)
    seq = nblk * bs
    pos = torch.randint(seq // 2, seq, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    pos[0] = seq - 1
    perm = torch.randperm(nb, generator=g, device="cuda").to(torch.int32)
    tables = torch.full((b, nblk), nb, dtype=torch.int32, device="cuda")
    for i in range(b):
        if i >= b - case["idle"]:
            pos[i] = -1
            continue
        used = int(pos[i]) // bs + 1
        tables[i, :used] = perm[i * nblk:i * nblk + used]
    pool = []
    for _ in ("k", "v"):
        x = torch.randn((nb + 1, bs, kh, d), generator=g, device="cuda")
        if quant:
            scale = kv_scales(x, axis=1)
            pool += [quantize_kv(x, scale[:, None]), scale]
        else:
            pool.append(x.to(dt))
    return q, tuple(pool), tables, pos


def _check_paged(label: str, case: dict, dname: str, quant: bool,
                 g, flush) -> dict:
    """One paged decode attention row (full-width pool in ``dname``, or
    int8).  The bound counts the blocks the tables reach up to each
    slot's position once each (every entry for an idle slot), their scale
    rows, the table entries read, q and the output; the yardstick is SDPA
    on the pool gathered (and dequantized) beforehand, K/V expanded to
    every query head.  Both pools run the split kernel (B8 full width, B9
    int8): :func:`_attention_times` against the earlier kernel, timed at
    the wrapper, ``prev_err``, the planned split count and, at the served
    bf16 shape, ``split_ms``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    name = "decode_attention_paged" + ("_q" if quant else "")
    q, pool, tables, pos = paged_inputs(case, dname, quant, g)
    kw = {"softcap": case["softcap"]}
    fn = getattr(ops, name)
    plain = getattr(ref, name + "_ref")
    args = (q, *pool, tables, pos)
    y = fn(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    b, kh, gg, d, bs, nblk = (case[k] for k in
                              ("b", "kh", "g", "d", "bs", "nblk"))
    dt = q.dtype
    if quant:
        kd, vd = (pool[0].float() * pool[1][:, None],
                  pool[2].float() * pool[3][:, None])
    else:
        kd, vd = pool
    heads = [ref._gather_blocks(t.to(dt), tables).permute(0, 2, 1, 3)
             .repeat_interleave(gg, dim=1).contiguous() for t in (kd, vd)]
    qd = q.reshape(b, kh * gg, 1, d)
    mask = (torch.arange(nblk * bs, device="cuda")[None, :]
            <= pos[:, None].long())[:, None, None, :]
    walked, live = set(), 0
    for i, cp in enumerate(pos.tolist()):
        walk = nblk if cp < 0 else min(nblk, cp // bs + 1)
        walked.update(tables[i, :walk].tolist())
        live += walk
    block_bytes = 2 * bs * kh * d * (1 if quant else dt.itemsize) \
        + (2 * kh * d * 4 if quant else 0)
    nbytes = (len(walked) * block_bytes + 4 * live + 4 * b
              + 2 * q.numel() * dt.itemsize)
    library = (lambda: F.scaled_dot_product_attention(
        qd, heads[0], heads[1], attn_mask=mask))
    dpk = kernel_module(name)
    rows = (q.reshape(b, kh, gg, d), *pool, tables, pos)
    split = getattr(dpk, name + "_split")
    old = getattr(dpk, "prev_" + name)(*rows, **kw)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    esize = 1 if quant else dt.itemsize
    planned = dpk.paged_split(b, kh, nblk, sms,
                              fit=(gg, d, bs, esize, quant)).splits
    times = {}
    if label == "served" and dname == "bfloat16":
        times["split_ms"] = _split_sweep(
            lambda n: split(*rows, **kw, splits=n), planned)
    times.update(
        splits=planned,
        prev_err=_compare(y.reshape(old.shape), old, dname)["norm_err"],
        **_attention_times(
            lambda: getattr(dpk, name)(*rows, **kw),
            lambda: getattr(dpk, "prev_" + name)(*rows, **kw),
            library, flush))
    return dict(shape=label, dtype=dname, B=b, KH=kh, G=gg, D=d, bs=bs,
                nblk=nblk, softcap=case["softcap"], idle=case["idle"],
                **_compare(y, want, dname), **times,
                plain_ms=time_ms(lambda: plain(*args, **kw)),
                **_bound(nbytes, 4 * gg * d * kh * bs * live, dname))


def _compare(y, want, dname: str) -> dict:
    import torch
    d = (y.to(torch.float32) - want.to(torch.float32)).abs().max().item()
    scale = want.to(torch.float32).abs().max().item()
    if not math.isfinite(d):
        raise SystemExit("kernel produced non-finite output")
    return {"max_abs_err": d, "norm_err": d / max(scale, 1e-30)}


def _bound(nbytes: int, flops: int, peak: str) -> dict:
    t, by = bound_ms(nbytes, flops, peak)
    return {"bound_ms": t, "bound_by": by, "flops": flops, "bytes": nbytes,
            "peak": peak}


def _kernel_entries(rows: dict[str, list[dict]]) -> list[dict]:
    """One entry per kernel, from this run's measurements: times summed
    over the kernel's launches in one decode step of the branches=4
    model (bf16; M = 8 and int8 factors for the weight-only chains, the
    served pool for the attentions) or, for the activation-quantized
    chains, which run prefill only, in one prefill chunk (M = 64)."""
    out = []
    for name, rs in rows.items():
        prefill = name in PREFILL_LAUNCHES
        m = 64 if prefill else 8
        timed = ("ms", "plain_ms", "library_ms", "bound_ms") + tuple(
            k for k in SPLIT_TIMES + EVENT_TIMES if k in rs[0])
        per_step = {k: 0.0 for k in timed + ("bytes", "flops")}
        t_ops = 0.0
        for label, count in (PREFILL_LAUNCHES if prefill
                             else DECODE_LAUNCHES)[name].items():
            row = next(r for r in rs if r["shape"] == label
                       and r.get("M", m) == m and r["dtype"] == "bfloat16"
                       and r.get("qmode", "int8") == "int8")
            for k in per_step:
                if per_step[k] is not None:
                    per_step[k] = (None if row[k] is None
                                   else per_step[k] + count * row[k])
            t_ops += count * row["flops"] / PEAK_FLOPS[row["peak"]]
        by = ("bytes" if per_step["bytes"] / HBM_BYTES_PER_S >= t_ops
              else "operations")
        module, _, replaces = KERNELS[name]
        extra = {}
        if "splits" in rs[0]:
            extra["splits"] = next(r["splits"] for r in rs
                                   if r["shape"] == "served"
                                   and r["dtype"] == "bfloat16")
        if name in ("branched_matmul", "branched_matmul_q",
                    "branched_matmul_sq"):
            extra["mla_path"] = {
                f"M={m}": {k: sum(n * next(
                    r for r in rs if r["shape"] == label and r["M"] == m
                    and r["dtype"] == "bfloat16")[k]
                    for label, n in MLA_BRANCHED_LAUNCHES.items())
                    for k in timed}
                for m in DEEPSEEK_M_CASES}
            extra["mla_path"]["timed_as"] = (
                "the 17 launches of one decode step (M=8) or prefill chunk "
                "(M=64) of the 4-layer DeepSeek-V2 MLA stack, bf16")
        trows = [r for r in rs if r.get("path") == "train"]
        if trows:
            tkeys = ("ms", "plain_ms", "library_ms", "bound_ms", "cold_ms",
                     "library_cold_ms", "event_ms", "library_event_ms",
                     "bwd_ms", "bwd_frozen_ms")
            extra["train_path"] = {
                k: sum(n * next(r for r in trows if r["shape"] == label)[k]
                       for label, n in TRAIN_LAUNCHES[name].items())
                for k in tkeys}
            extra["train_path"].update(
                grad_err=max(r["grad_err"] for r in trows), launches=None,
                timed_as=f"the {sum(TRAIN_LAUNCHES[name].values())} forward "
                "launches of one train step (M=1024, bf16) and their "
                "backward products (bwd_ms every gradient, bwd_frozen_ms "
                "under the §2.2 freeze); launches: the train phase's run")
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              + SOURCE_OF.get(name, f"{module}.cu"),
                    "replaces": replaces, "launches": None,
                    "max_abs_err": max(r["max_abs_err"] for r in rs),
                    "ms": per_step["ms"], "plain_ms": per_step["plain_ms"],
                    "bound_ms": per_step["bound_ms"], "bound_by": by,
                    "library_ms": per_step["library_ms"],
                    **{k: per_step[k] for k in SPLIT_TIMES + EVENT_TIMES
                       if k in per_step},
                    "timed_as": (
                        "one prefill chunk's launches, M=64, bf16, int8 "
                        "factors" if prefill else
                        "one decode step's launches, bf16"
                        + (", M=8, int8 factors"
                           if name.endswith("matmul_q") else "")
                        + (", M=8, int8 2:4 packs"
                           if name.endswith("matmul_sq") else "")),
                    **extra, "shapes": rs})
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


def request_prompts(cfg, seed: int, n_req: int, lo: int, hi: int,
                    shared: int = 0) -> list[list[int]]:
    """``n_req`` prompts of ``lo``-``hi`` tokens from the seed; with
    ``shared``, the first ``shared`` of them begin with one
    :data:`SHARED_PREFIX`-token prefix (and run at least 32 tokens past
    it)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = (rng.integers(0, cfg.vocab_size, SHARED_PREFIX).tolist()
              if shared else [])
    out = []
    for i in range(n_req):
        n = int(rng.integers(lo, hi + 1))
        if i < shared:
            n = max(n, SHARED_PREFIX + 32)
            out.append(prefix + rng.integers(
                0, cfg.vocab_size, n - SHARED_PREFIX).tolist())
        else:
            out.append(rng.integers(0, cfg.vocab_size, n).tolist())
    return out


def serve(cfg, lrd, params, *, n_req: int, prompt_lo: int, prompt_hi: int,
          new_tokens: int, expect: dict[str, dict[str, int]], card: str,
          seed: int, shared: int = 0, **engine_kw) -> dict:
    """Serve ``n_req`` requests and check the launches of every kernel in
    every model segment: ``expect[seg_kind][kernel]`` (a kernel not
    named must not launch at all).  Every count is set to 0 just before
    the requests are driven and read just after.  ``engine_kw`` go to
    :class:`ServeEngine` (quantize, kv_quantize, act_quantize,
    kv_layout, kv_block_size, sparsify).  With ``shared`` (a paged pool),
    the first
    ``shared`` prompts begin with one prefix and the last of them is
    submitted only once the first has its first token, so its admission
    finds the prefix in the radix cache."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(RunConfig(model=cfg, lrd=lrd), params, slots=8,
                      max_seq=1024, device="cuda", **engine_kw)
    paged = eng.kv_layout == "paged"
    segs: list[tuple[str, dict[str, int]]] = []
    blocks_peak = 0
    step = eng.runner.step

    def counted(tokens, positions, seg_kind, **kw):
        nonlocal blocks_peak
        before = {k: launch_count(k) for k in KERNELS}
        out = step(tokens, positions, seg_kind, **kw)
        segs.append((seg_kind, {k: launch_count(k) - before[k]
                                for k in KERNELS}))
        if paged:
            blocks_peak = max(blocks_peak, eng.pool.physical_blocks_in_use())
        return out
    eng.runner.step = counted

    reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i, p in enumerate(request_prompts(
                cfg, seed, n_req, prompt_lo, prompt_hi, shared))]
    late = reqs[shared - 1:shared] if shared > 1 else []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for r in reqs:
        if r not in late:
            eng.add_request(r)
    t0 = time.perf_counter()
    if late:
        while not reqs[0].output:
            eng.step()
        eng.pool.check_integrity()
        eng.add_request(late[0])
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: launch_count(k) for k in KERNELS}
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
    res = {**{k: engine_kw.get(k, "none")
              for k in ("quantize", "sparsify", "kv_quantize",
                        "act_quantize")},
           "kv_layout": eng.kv_layout, "requests": n_req, "new_tokens": new_tokens,
           "wall_s": wall, "segments": len(segs),
           "decode_segments": sum(1 for s in segs if s[0] == "decode"),
           "per_segment": {kind: {k: n for k, n in c.items() if n}
                           for kind, c in want.items()},
           "launches": launches, "tokens_per_s": tp["tokens_per_s"],
           "ttft_mean_s": tp["ttft_mean_s"],
           "decode_step_ms_mean": tp["decode_step_ms_mean"],
           "prefill_seconds": tp["prefill_seconds"],
           "decode_seconds": tp["decode_seconds"],
           "preemptions": tp["preemptions"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "kv_bytes_per_step": eng.plan_summary["kv_bytes_per_step"],
           "weight_bytes": eng.plan_summary["weight_bytes"],
           "quant_bytes": eng.plan_summary["quant_bytes"],
           "kv_cache_family": eng.plan_summary["kv_cache_family"],
           "plan_summary": eng.plan_summary, "card": card}
    if paged:
        eng.pool.check_integrity()
        res.update(prefix_stats=eng.pool.prefix_stats(),
                   physical_blocks_in_use_peak=blocks_peak,
                   physical_blocks=eng.pool.num_blocks,
                   bytes_per_block=eng.pool.bytes_per_block)
        if res["prefix_stats"]["prefix_block_hits"] <= 0:
            raise SystemExit(f"no radix prefix hit: {res['prefix_stats']}")
    log("serve " + json.dumps(res))
    return res


def _profiled(step, steps: int) -> dict:
    """``torch.profiler`` over ``steps`` calls of ``step`` (engine steps)
    after a device sync: the host-clock window, the device's busy share
    of it, the top kernels by device time and the top host ops by self
    time, each per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
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
    return {"steps": steps, "step_ms": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "top_device_kernels": [
                {"kernel": e.key[:70], "launches_per_step": e.count / steps,
                 "ms_per_step": dev_us(e) / 1e3 / steps}
                for e in kernels[:10]],
            "top_host_ops": [
                {"op": e.key[:40], "calls_per_step": e.count / steps,
                 "self_ms_per_step": e.self_cpu_time_total / 1e3 / steps}
                for e in host[:10]]}


def profile_decode(cfg, lrd, params, card: str, seed: int,
                   steps: int = 5, quantize: str = "none",
                   kv_quantize: str = "none", sparsify: str = "none"
                   ) -> dict:
    """Where one decode step's time goes: ``torch.profiler`` over
    ``steps`` steady decode steps of 8 live slots, device time by
    operator and the device's busy share of the host-clock window."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(RunConfig(model=cfg, lrd=lrd), params, slots=8,
                      max_seq=1024, quantize=quantize, sparsify=sparsify,
                      kv_quantize=kv_quantize, device="cuda")
    rng = np.random.default_rng(seed)
    for i in range(8):
        eng.add_request(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, 32).tolist(), max_new_tokens=4 * steps))
    while eng.scheduler.prefilling or eng.scheduler.waiting:
        eng.step()                                  # admit + prefill all
    for _ in range(2):
        eng.step()                                  # warm decode
    res = {"quantize": quantize, "sparsify": sparsify,
           "kv_quantize": kv_quantize, "live_slots": 8,
           **_profiled(eng.step, steps), "card": card}
    log("profile " + json.dumps(res))
    return res


def profile_prefill(cfg, lrd, params_q, card: str, seed: int,
                    steps: int = 8) -> dict:
    """Where one act-quant prefill chunk's time goes (serve_qa's engine:
    int8 factors, int8 activations, int8 paged pool): 8 prompts of 512
    tokens that finish at their first token, so every engine step is one
    64-token prefill chunk (32 B6 + 80 B7) and nothing decodes.  The
    first chunk is timed alone (host clock to a device sync: first-call
    costs included), then ``torch.profiler`` over ``steps`` steady
    chunks after two more."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(RunConfig(model=cfg, lrd=lrd), params_q, slots=8,
                      max_seq=1024, quantize="int8", act_quantize="int8",
                      kv_quantize="int8", kv_layout="paged",
                      kv_block_size=PAGED_BLOCK, device="cuda")
    rng = np.random.default_rng(seed)
    for i in range(8):
        eng.add_request(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, 512).tolist(), max_new_tokens=1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(2):
        eng.step()
    reset_launches()
    res = {"act_quantize": "int8", "chunk_tokens": eng.prefill_chunk,
           "first_chunk_ms": first_ms, **_profiled(eng.step, steps)}
    res["launches_per_step"] = {k: launch_count(k) / steps for k in KERNELS
                                if launch_count(k)}
    res["card"] = card
    log("profile_qa " + json.dumps(res))
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
    """A param (or gradient) tree on the CPU, float leaves widened to f32;
    int8 / e4m3 factors keep their storage (their f32 scales already are
    f32); ``None`` leaves stay."""
    import torch
    if isinstance(tree, dict):
        return {k: to_cpu_f32(v) for k, v in tree.items()}
    if tree is None:
        return None
    if tree.dtype in (torch.int8, torch.float8_e4m3fn):
        return tree.to("cpu")
    return tree.to("cpu", torch.float32)


def _greedy_gap(step: int, lg, lc) -> dict[str, float]:
    """``{}`` where the card's greedy token at ``step`` (logits ``lg``) is
    the CPU's (``lc``); else ``{step: gap}``, how far below its own pick
    the CPU f32 logits rank the card's, in CPU-logit stds -- a gap under
    the step's distance is a near tie that the card's roundings flip."""
    a, b = int(lg.argmax()), int(lc.argmax())
    return {} if a == b else {str(step): ((lc[b] - lc[a]) / lc.std()).item()}


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
    rels, gaps = [], {}
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
            gaps.update(_greedy_gap(i, lg, lc))
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
           "tol": CHECK_TOL,
           "greedy_agree": f"{len(rels) - len(gaps)}/{len(rels)}",
           "greedy_gap": gaps,
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


def cross_check_staged(cfg, params, card: str, seed: int, *, label: str,
                       want: dict[str, int], paged: bool = False,
                       kv_quantize: str | None = None,
                       act_quantize: str | None = None, n_tok: int = 64,
                       steps: int = 16) -> dict:
    """Prefill and ``steps`` greedy decode steps as the engine drives them
    -- the prompt chunk-prefilled into a full-precision staging cache,
    inserted into the pool (quantized for an int8 pool; into the
    stream's blocks for a ``paged`` one), decode over the pool -- on the
    card (kernels, bf16) against the same tree in f32 on the CPU (plain
    versions).  Both are fed the CPU's greedy tokens, so every step
    compares logits of the same context.  Checks that the card launched
    exactly ``want`` (kernel -> launches over the prefill chunk and the
    decode steps; every other kernel none)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models.api import get_model
    from repro_torch.serve.pool import KVPoolManager, PagedKVPoolManager
    from repro_torch.serve.runner import ModelRunner
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n_tok).tolist()
    max_seq = n_tok + steps + 1
    if paged:
        max_seq = -(-max_seq // PAGED_BLOCK) * PAGED_BLOCK
    sides = []
    for model, p in ((get_model(cfg, "cuda"), params),
                     (get_model(dataclasses.replace(cfg, dtype="float32"),
                                "cpu"), to_cpu_f32(params))):
        if paged:
            pool = PagedKVPoolManager(model, 1, max_seq,
                                      kv_quantize=kv_quantize,
                                      block_size=PAGED_BLOCK)
        else:
            pool = KVPoolManager(model, 1, max_seq, kv_quantize=kv_quantize)
        runner = ModelRunner(model, p, max_seq=max_seq,
                             kv_quantize=kv_quantize,
                             act_quantize=act_quantize,
                             paged=getattr(pool, "geometry", None))
        sides.append((model.device, pool, runner))
    reset_launches()
    rels, gaps, logits = [], {}, []
    with torch.inference_mode():
        for dev, pool, runner in sides:
            pool.allocate(0, n_tok, tokens=toks)
            lg, staged = runner.step(
                torch.tensor([toks], device=dev), None, "prefill_chunk",
                cache=runner.new_stream_cache(), start_pos=0,
                prompt_len=n_tok)
            pool.insert(staged, 0, n_tok)
            logits.append(lg[0, -1])
        for i in range(steps + 1):
            lg, lc = logits[0].float().cpu(), logits[1]
            rels.append(((lg - lc).abs().max() / lc.std()).item())
            gaps.update(_greedy_gap(i, lg, lc))
            if i == steps:
                break
            tok = int(lc.argmax())
            logits = []
            for dev, pool, runner in sides:
                lg, pool.cache = runner.step(
                    torch.tensor([[tok]], device=dev),
                    torch.as_tensor(pool.positions, device=dev), "decode",
                    cache=pool.cache)
                pool.grow(0, token=tok)
                logits.append(lg[0, -1])
    torch.cuda.synchronize()
    launches = {k: launch_count(k) for k in KERNELS}
    want = {k: want.get(k, 0) for k in KERNELS}
    res = {"kv_quantize": kv_quantize or "none",
           "act_quantize": act_quantize or "none", "paged": paged,
           "tokens": n_tok, "decode_steps": steps,
           "max_diff_over_std": max(rels), "per_step": rels,
           "tol": CHECK_TOL,
           "greedy_agree": f"{len(rels) - len(gaps)}/{len(rels)}",
           "greedy_gap": gaps,
           "launches": {k: n for k, n in launches.items() if n},
           "card": card}
    log(f"{label} " + json.dumps(res))
    if not max(rels) <= CHECK_TOL:
        raise SystemExit(f"{label}: card logits differ from the CPU f32 "
                         f"reference: {max(rels):.4f} > {CHECK_TOL}")
    if launches != want:
        raise SystemExit(f"{label} launched {launches}, want {want}")
    return res


def cross_check_paged(cfg, params, card: str, seed: int, *,
                      kv_quantize: str | None = None,
                      act_quantize: str | None = None,
                      steps: int = 16) -> dict:
    """:func:`cross_check_staged` through the paged pool of the llama
    tree: one prefill chunk and ``steps`` decode steps through the
    kernels of the path, the paged attention in every layer."""
    L = cfg.num_layers
    if act_quantize:
        want = {"lowrank_matmul_qa": 2 * L, "branched_matmul_qa": 5 * L,
                "lowrank_matmul_q": 2 * L * steps,
                "branched_matmul_q": 5 * L * steps}
    else:
        want = {"lowrank_matmul": 2 * L * (steps + 1),
                "branched_matmul": 5 * L * (steps + 1)}
    want["decode_attention_paged" + ("_q" if kv_quantize else "")] = \
        L * steps
    return cross_check_staged(
        cfg, params, card, seed, paged=True, want=want, steps=steps,
        label="check_qa" if act_quantize else "check_paged",
        kv_quantize=kv_quantize, act_quantize=act_quantize)


def cross_check_mla(cfg, params, card: str, seed: int, *, label: str,
                    chain: str, kv_quantize: str | None = None,
                    steps: int = 16) -> dict:
    """:func:`cross_check_staged` through the MLA stack's latent slot
    pool: 4 branched linears per layer and the unembed in the prefill
    chunk and every decode step, all through the ``chain`` kernel
    (branched_matmul, or the _q / _sq chain of an int8 or 2:4 tree),
    and over the int8 latent pool the latent attention in every layer
    of every decode step."""
    want = {chain: (4 * cfg.num_layers + 1) * (steps + 1)}
    if kv_quantize:
        want["decode_attention_latent_q"] = cfg.num_layers * steps
    return cross_check_staged(cfg, params, card, seed, want=want,
                              steps=steps, label=label,
                              kv_quantize=kv_quantize)


def mla_model(seed: int = 0):
    """DeepSeek-V2's MLA stack at its published widths, served without
    experts: every layer the first layer's dense FFN, 4 of the 60 layers
    (``moe_first_dense`` goes to 0 with the experts); random bf16 weights
    from ``seed``, on the card."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.api import get_model
    cfg = dataclasses.replace(registry.get("deepseek-v2-236b").full,
                              family="dense", moe_num_experts=0,
                              moe_first_dense=0, num_layers=MLA_LAYERS)
    model = get_model(cfg, "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    params, axes = model.init(g)
    torch.cuda.synchronize()
    return cfg, params, axes


#: the surgery decisions the MLA stack must get under ``LRD`` at
#: branches=4: path -> (kind, rank per branch); every other linear skips
MLA_SURGERY = {"blocks/mla/o": ("branched", 480),
               "blocks/mlp/gate": ("branched", 448),
               "blocks/mlp/up": ("branched", 448),
               "blocks/mlp/down": ("branched", 448),
               "unembed": ("branched", 608)}


def check_mla_surgery(rep, params, card: str) -> None:
    """Print every surgery decision of the MLA stack and hold the branched
    ones (and their factors' per-branch ranks) to :data:`MLA_SURGERY`."""
    got = {}
    for d in rep.decisions:
        log(f"surgery mla: {d.path} label={d.label} kind={d.kind} "
            f"shape={list(d.shape)} rank={d.rank} {d.reason} [{card}]")
        if d.kind != "skip":
            node = params
            for k in d.path.split("/"):
                node = node[k]
            got[d.path] = (d.kind, int(node["u"].shape[-1])
                           if "u" in node else d.rank)
    if got != MLA_SURGERY:
        raise SystemExit(f"MLA surgery decided {got}, want {MLA_SURGERY}")


def split_kernels() -> None:
    """Print the shared memory and the persistent grid of every
    split-phase kernel (bf16 B2; B4, B12 on int8 / e4m3; the two-phase
    B1, and B3, B11 on int8 / e4m3; the s8 kernels of B7 and B6 on bf16
    and f32 activations) at each row tile count, the two-phase kernels'
    served plans at M = 8 (B1 / B3 at every SVD pair of LOWRANK_SHAPES,
    B11 at the 2:4-served ones) and B7's and B6's at M = 64, and fail
    where the C side's shared memory disagrees with the wrapper's count
    or a grid is empty."""
    import torch
    from repro_torch.kernels import branched_matmul as bk
    from repro_torch.kernels import build
    lib = build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for chain, kind, qtypes, shapes in (
            ("branched", "bf16", (None,), ()), ("branched", "q", (0, 1), ()),
            ("branched", "sq", (0, 1), ()),
            ("lowrank", "bf16", (None,), LOWRANK_SHAPES),
            ("lowrank", "q", (0, 1), LOWRANK_SHAPES),
            ("lowrank", "sq", (0, 1), SPARSE_LOWRANK)):
        tag = "" if kind == "bf16" else f"_{kind}"
        name = f"{chain}_matmul{tag}"
        smem = int(getattr(lib, f"lrk_{chain}{tag}_mma_smem")())
        want = bk.mma_smem_bytes(kind if chain == "branched"
                                 else f"lowrank_{kind}")
        grid_of = getattr(lib, f"lrk_{chain}{tag}_mma_grid")
        plans = []
        for label in shapes:
            c, r, s = LOWRANK_SHAPES[label]
            sp = bk.lowrank_split(8, c, r, s, sms)
            plans.append(
                f"{label}: {sp.slices(1)} x {math.ceil(r / bk.BN)} items of "
                f"K slice {sp.k1} (phase 1), {sp.slices(2)} x "
                f"{math.ceil(s / bk.BN)} of {sp.k2} (phase 2), "
                + (f"{sp.ctas} CTAs at most" if sp.ctas else "the whole grid")
                + f", {sp.scratch_bytes} B of scratch")
        for qt in qtypes:
            grids = {rows: int(grid_of(rows) if qt is None
                               else grid_of(qt, rows))
                     for rows in (8, 32, 64)}
            factors = "" if qt is None else ("int8", "e4m3")[qt] + ", "
            log(f"{name} ({'split-phase' if not shapes else 'two-phase split'}"
                f", {factors}{bk.STAGES} stages): {smem} B of dynamic shared "
                f"memory (wrapper's count {want}, limit {build.SMEM_LIMIT}); "
                f"persistent grid (CTAs) at 8 / 32 / 64 rows: {grids} on "
                f"{sms} SMs" + ("; served plans at M = 8: " + "; ".join(plans)
                                if plans else ""))
            if smem != want or min(grids.values()) <= 0:
                raise SystemExit(f"{name} split-phase kernel: shared memory "
                                 "or grid disagrees with the wrapper")
    bak = kernel_module("branched_matmul_qa")
    smem = int(lib.lrk_branched_qa_mma_smem())
    grids = {dt: {rows: int(lib.lrk_branched_qa_mma_grid(code, rows))
                  for rows in (8, 32, 64)}
             for dt, code in (("bf16", 1), ("f32", 0))}
    plans = []
    for label, (n, c, r, s) in BRANCHED_SHAPES.items():
        sp = bak.qa_split(64, c, n, r, r, s, sms)
        plans.append(f"{label}: " + ", ".join(
            f"{sp.slices(i)} x {n} x {math.ceil(sp.phase(i)[2] / bk.BN)} "
            f"items of K slice {sp.phase(i)[3]} (phase {i})"
            for i in sp.PHASES) + f", {sp.scratch_bytes} B of scratch")
    log(f"branched_matmul_qa (split-phase s8, 4 stages): {smem} B of dynamic "
        f"shared memory (wrapper's count {bak.QA_SMEM}, limit "
        f"{build.SMEM_LIMIT}); persistent grid (CTAs) at 8 / 32 / 64 rows: "
        f"{grids} on {sms} SMs; served plans at M = 64: " + "; ".join(plans))
    if smem != bak.QA_SMEM or smem > build.SMEM_LIMIT \
            or min(min(g.values()) for g in grids.values()) <= 0:
        raise SystemExit("branched_matmul_qa split-phase kernel: shared "
                         "memory or grid disagrees with the wrapper")
    lak = kernel_module("lowrank_matmul_qa")
    smem = int(lib.lrk_lowrank_qa_mma_smem())
    grids = {dt: {rows: int(lib.lrk_lowrank_qa_mma_grid(code, rows))
                  for rows in (8, 32, 64)}
             for dt, code in (("bf16", 1), ("f32", 0))}
    plans = []
    for label, (c, r, s) in LOWRANK_SHAPES.items():
        sp = lak.lowrank_qa_split(64, c, r, s, sms)
        plans.append(f"{label}: " + ", ".join(
            f"{sp.slices(i)} x {math.ceil(sp.phase(i)[2] / bk.BN)} items of "
            f"K slice {sp.phase(i)[3]} (phase {i})" for i in sp.PHASES)
            + (f", {sp.ctas} CTAs at most" if sp.ctas else ", the whole grid")
            + f", {sp.scratch_bytes} B of scratch")
    log(f"lowrank_matmul_qa (two-phase split s8, 4 stages): {smem} B of "
        f"dynamic shared memory (wrapper's count {bak.QA_SMEM}, limit "
        f"{build.SMEM_LIMIT}); persistent grid (CTAs) at 8 / 32 / 64 rows: "
        f"{grids} on {sms} SMs; served plans at M = 64: " + "; ".join(plans))
    if smem != bak.QA_SMEM or smem > build.SMEM_LIMIT \
            or min(min(g.values()) for g in grids.values()) <= 0:
        raise SystemExit("lowrank_matmul_qa split-phase kernel: shared "
                         "memory or grid disagrees with the wrapper")


def attention_splits() -> None:
    """Print the plan and the shared memory of the split attention
    kernels (B10 at the served latent pool; B9, and B8 on bf16 and f32
    pools, at the served paged pool; B5 at the served slot pool), and fail
    where the C side's shared memory disagrees with the wrapper's count or
    exceeds the limit."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention_latent_q as dlk
    from repro_torch.kernels import decode_attention_paged as dpk
    lib = build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    c = LATENT_CASES["served"]
    sp = dlk.latent_split(c["b"], c["h"], c["s"], c["lora"], c["rope"], sms)
    smem = int(lib.lrk_decode_attention_latent_q_smem(c["lora"], c["rope"],
                                                      sp.bs, sp.mt))
    want = dlk.latent_smem(c["lora"], c["rope"], sp.bs, sp.mt)
    log(f"decode_attention_latent_q (split, mma.sync) at the served latent "
        f"pool: {sp.tiles} head tiles x {c['b']} slots x {sp.splits} "
        f"splits of {sp.span} positions = {sp.ctas} CTAs on {sms} SMs, "
        f"{sp.bs} positions per stage; {smem} B of dynamic shared memory "
        f"(wrapper's count {want}, limit {build.SMEM_LIMIT})")
    p = PAGED_CASES["served"]
    bad = smem != want or smem > build.SMEM_LIMIT
    for name, esize in (("decode_attention_paged_q", 1),
                        ("decode_attention_paged, bf16", 2),
                        ("decode_attention_paged, f32", 4)):
        fit = (p["g"], p["d"], p["bs"], esize, esize == 1)
        pp = dpk.paged_split(p["b"], p["kh"], p["nblk"], sms, fit=fit)
        psmem = int(lib.lrk_decode_attention_paged_split_smem(
            *fit[:4], int(fit[4]), pp.span))
        log(f"{name} (split) at the served paged pool: {p['kh']} KV heads "
            f"x {p['b']} slots x {pp.splits} splits of {pp.span} entries = "
            f"{pp.ctas} CTAs on {sms} SMs; {psmem} B of dynamic shared "
            f"memory (wrapper's count {dpk.split_smem(*fit, pp.span)}, "
            f"limit {build.SMEM_LIMIT})")
        bad |= psmem != dpk.split_smem(*fit, pp.span) \
            or psmem > build.SMEM_LIMIT
    a = ATTN_CASES["served"]
    dak = kernel_module("decode_attention_q")
    sp = dak.slot_split(a["b"], a["kh"], a["s"], sms, g=a["g"], d=a["d"])
    fit = (a["g"], a["d"], dak.SLOT_ENTRY, 1, False)
    ssmem = int(lib.lrk_decode_attention_paged_split_smem(*fit[:4], 0,
                                                          sp.span))
    log(f"decode_attention_q (split, slot view) at the served slot pool: "
        f"{a['kh']} KV heads x {a['b']} slots x {sp.splits} splits of "
        f"{sp.span} entries of {dak.SLOT_ENTRY} positions = {sp.ctas} CTAs "
        f"on {sms} SMs; {ssmem} B of dynamic shared memory (wrapper's count "
        f"{dpk.split_smem(*fit, sp.span)}, limit {build.SMEM_LIMIT})")
    bad |= ssmem != dpk.split_smem(*fit, sp.span) \
        or ssmem > build.SMEM_LIMIT
    if bad:
        raise SystemExit("split attention kernels: shared memory disagrees "
                         "with the wrapper or exceeds the limit")


def pack_sparse(params, lrd, card: str, what: str):
    """The engine's load pipeline for ``sparsify="2:4", quantize="int8"``
    run once up front (the serve and check phases then share the tree;
    the engine's own pass finds nothing left to pack): the
    ``lrd.sparse_targets`` factors 2:4-packed in int8, the rest (the
    branched cores) quantized."""
    import torch
    from repro_torch.quant.quantize import quantize_tree
    from repro_torch.quant.sparse import sparsify_tree
    t0 = time.perf_counter()
    with torch.inference_mode():
        psq = quantize_tree(sparsify_tree(params, "2:4", mode="int8",
                                          targets=lrd.sparse_targets),
                            "int8", targets=lrd.quant_targets)
    torch.cuda.synchronize()
    log(f"pack 2:4 int8 ({what}): {time.perf_counter() - t0:.2f} s [{card}]")
    return psq


def run_llama(phases: list[str], card: str, seed: int,
              serve_res: dict) -> None:
    """The llama3.2-1b phases (serve ... check_sq, profile) on one set of
    trees, freed when this returns."""
    import torch
    cfg, dense, axes = full_model(seed)
    lrd, p4, rep, surg_s = decompose(dense, axes, branches=4)
    log(f"surgery branches=4: {surg_s:.2f} s, "
        f"{json.dumps(rep.summary())} [{card}]")
    if "serve" in phases:
        with Phase("serve"):
            every = lambda counts: {"decode": counts,  # noqa: E731
                                    "prefill_chunk": counts}
            serve_res["branches4"] = serve(
                cfg, lrd, p4, n_req=8, prompt_lo=32, prompt_hi=512,
                new_tokens=32, card=card, seed=seed,
                expect=every({"lowrank_matmul": 32, "branched_matmul": 80}))
            serve_res["branches4"]["surgery_s"] = surg_s
            lrd1, p1, _, surg1_s = decompose(dense, axes, branches=1)
            log(f"surgery branches=1: {surg1_s:.2f} s [{card}]")
            serve_res["branches1"] = serve(
                cfg, lrd1, p1, n_req=4, prompt_lo=32, prompt_hi=128,
                new_tokens=8, card=card, seed=seed + 1,
                expect=every({"lowrank_matmul": 112}))
            serve_res["branches1"]["surgery_s"] = surg1_s
            del p1
    if "check" in phases:
        with Phase("check"):
            cross_check(cfg, p4, card, seed)
    if set(phases) & {"serve_q", "check_q", "serve_qa", "check_qa",
                      "profile_qa"}:
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
                new_tokens=32, card=card, seed=seed, quantize="int8",
                kv_quantize="int8",
                expect={"decode": {**chain, "decode_attention_q": 16},
                        "prefill_chunk": chain})
            serve_res["quantized"]["kv_write"] = time_kv_write(card)
    if "check_q" in phases:
        with Phase("check_q"):
            cross_check_q(cfg, pq, card, seed)
    paged_run = dict(n_req=8, prompt_lo=32, prompt_hi=512, new_tokens=32,
                     card=card, seed=seed, shared=4,
                     kv_layout="paged", kv_block_size=PAGED_BLOCK)
    if "serve_paged" in phases:
        with Phase("serve_paged"):
            serve_res["paged"] = serve(
                cfg, lrd, p4, **paged_run,
                expect={"decode": {"lowrank_matmul": 32,
                                   "branched_matmul": 80,
                                   "decode_attention_paged": 16},
                        "prefill_chunk": {"lowrank_matmul": 32,
                                          "branched_matmul": 80}})
    if "check_paged" in phases:
        with Phase("check_paged"):
            cross_check_paged(cfg, p4, card, seed)
    if "serve_qa" in phases:
        with Phase("serve_qa"):
            serve_res["qa"] = serve(
                cfg, lrd, pq, **paged_run, quantize="int8",
                act_quantize="int8", kv_quantize="int8",
                expect={"decode": {"lowrank_matmul_q": 32,
                                   "branched_matmul_q": 80,
                                   "decode_attention_paged_q": 16},
                        "prefill_chunk": {"lowrank_matmul_qa": 32,
                                          "branched_matmul_qa": 80}})
    if "check_qa" in phases:
        with Phase("check_qa"):
            cross_check_paged(cfg, pq, card, seed, kv_quantize="int8",
                              act_quantize="int8")
    if "profile_qa" in phases:
        with Phase("profile_qa"):
            profile_prefill(cfg, lrd, pq, card, seed)
    if set(phases) & {"serve_sq", "check_sq"}:
        psq = pack_sparse(p4, lrd, card, "llama")
    if "serve_sq" in phases:
        with Phase("serve_sq"):
            chain = {"lowrank_matmul_sq": 32, "branched_matmul_sq": 80}
            serve_res["sq"] = serve(
                cfg, lrd, psq, n_req=8, prompt_lo=32, prompt_hi=512,
                new_tokens=32, card=card, seed=seed, quantize="int8",
                sparsify="2:4", kv_quantize="int8",
                expect={"decode": {**chain, "decode_attention_q": 16},
                        "prefill_chunk": chain})
    if "check_sq" in phases:
        with Phase("check_sq"):
            L = cfg.num_layers
            cross_check_staged(
                cfg, psq, card, seed, label="check_sq", kv_quantize="int8",
                want={"lowrank_matmul_sq": 2 * L * 17,
                      "branched_matmul_sq": 5 * L * 17,
                      "decode_attention_q": L * 16})
    if "profile" in phases:
        with Phase("profile"):
            profile_decode(cfg, lrd, p4, card, seed)
            profile_decode(cfg, lrd, p4, card, seed, quantize="int8",
                           kv_quantize="int8")
            profile_decode(cfg, lrd, p4, card, seed, quantize="int8",
                           kv_quantize="int8", sparsify="2:4")


def run_mla(phases: list[str], card: str, seed: int,
            serve_res: dict) -> None:
    """The MLA phases: DeepSeek-V2's MLA stack decomposed once, served
    and checked over the full-width latent pool, then with int8 and with
    2:4-packed int8 factors over the int8 latent pool."""
    import torch
    cfg, dense, axes = mla_model(seed)
    lrd, pm, rep, surg_s = decompose(dense, axes, branches=4)
    del dense
    torch.cuda.empty_cache()
    log(f"surgery mla branches=4: {surg_s:.2f} s, "
        f"{json.dumps(rep.summary())} [{card}]")
    check_mla_surgery(rep, pm, card)
    chain = 4 * cfg.num_layers + 1          # o, gate, up, down; unembed
    run = dict(n_req=8, prompt_lo=32, prompt_hi=512, new_tokens=32,
               card=card, seed=seed)
    if "serve_mla" in phases:
        with Phase("serve_mla"):
            every = {"branched_matmul": chain}
            serve_res["mla"] = serve(
                cfg, lrd, pm, **run,
                expect={"decode": every, "prefill_chunk": every})
            serve_res["mla"]["surgery_s"] = surg_s
    if "check_mla" in phases:
        with Phase("check_mla"):
            cross_check_mla(cfg, pm, card, seed, label="check_mla",
                            chain="branched_matmul")
    if "profile_mla" in phases:
        with Phase("profile_mla"):
            profile_decode(cfg, lrd, pm, card, seed)
    if not set(phases) & {"serve_mla_q", "check_mla_q", "serve_mla_sq",
                          "check_mla_sq"}:
        return
    from repro_torch.quant.quantize import quantize_tree
    t0 = time.perf_counter()
    with torch.inference_mode():
        pq = quantize_tree(pm, "int8", targets=lrd.quant_targets)
    torch.cuda.synchronize()
    log(f"quantize int8 (mla): {time.perf_counter() - t0:.2f} s [{card}]")
    psq = None
    if set(phases) & {"serve_mla_sq", "check_mla_sq"}:
        psq = pack_sparse(pm, lrd, card, "mla")
    del pm
    torch.cuda.empty_cache()
    if "serve_mla_q" in phases:
        with Phase("serve_mla_q"):
            q_chain = {"branched_matmul_q": chain}
            serve_res["mla_q"] = serve(
                cfg, lrd, pq, **run, quantize="int8", kv_quantize="int8",
                expect={"decode": {**q_chain, "decode_attention_latent_q":
                                   cfg.num_layers},
                        "prefill_chunk": q_chain})
            serve_res["mla_q"]["surgery_s"] = surg_s
    if "check_mla_q" in phases:
        with Phase("check_mla_q"):
            cross_check_mla(cfg, pq, card, seed, label="check_mla_q",
                            chain="branched_matmul_q", kv_quantize="int8")
    del pq
    torch.cuda.empty_cache()
    if "serve_mla_sq" in phases:
        with Phase("serve_mla_sq"):
            sq_chain = {"branched_matmul_sq": chain}
            serve_res["mla_sq"] = serve(
                cfg, lrd, psq, **run, quantize="int8", sparsify="2:4",
                kv_quantize="int8",
                expect={"decode": {**sq_chain, "decode_attention_latent_q":
                                   cfg.num_layers},
                        "prefill_chunk": sq_chain})
            serve_res["mla_sq"]["surgery_s"] = surg_s
    if "check_mla_sq" in phases:
        with Phase("check_mla_sq"):
            cross_check_mla(cfg, psq, card, seed, label="check_mla_sq",
                            chain="branched_matmul_sq", kv_quantize="int8")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_run(cfg, card: str, seed: int, *, label: str, lrd, remat: str,
              steps: int, expect: dict[str, int], falls: bool) -> dict:
    """``steps`` steps of the port's ``train()`` on the card (bf16,
    ByteTextLM at TRAIN_BATCH x TRAIN_SEQ) and the checks: every step
    launches exactly ``expect`` (kernel -> forwards; a kernel not named
    must not launch), and with ``falls`` the last loss is below the
    first.  The counts are set to 0 just before ``train()`` and read at
    the start of every step (its ``fault_hook``) and just after."""
    import statistics
    import torch
    from repro_torch.configs.base import ParallelConfig, RunConfig
    from repro_torch.train.data import ByteTextLM
    from repro_torch.train.loop import train
    from repro_torch.train.optim import OptimConfig
    run = RunConfig(model=cfg, lrd=lrd, parallel=ParallelConfig(remat=remat),
                    seed=seed)
    marks: list[dict[str, int]] = []

    def mark(step: int) -> None:
        marks.append({k: launch_count(k) for k in KERNELS})

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    r = train(run, ByteTextLM(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
              num_steps=steps, optim_cfg=OptimConfig(total_steps=steps,
                                                     **TRAIN_OPTIM),
              fault_hook=mark, log_every=0, log_fn=log, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mark(steps)
    per_step = [{k: b[k] - a[k] for k in KERNELS if b[k] != a[k]}
                for a, b in zip(marks, marks[1:])]
    wrong = [(i, c) for i, c in enumerate(per_step) if c != expect]
    if wrong or len(per_step) != steps:
        raise SystemExit(f"train {label}: steps launched other kernel "
                         f"counts than {expect}: {wrong[:3]}")
    if not all(math.isfinite(x) for x in r.losses):
        raise SystemExit(f"train {label}: non-finite loss {r.losses}")
    if falls and not r.losses[-1] < r.losses[0]:
        raise SystemExit(f"train {label}: the loss did not fall: "
                         f"{r.losses}")
    secs = r.stats["step_seconds"]
    med = statistics.median(secs[1:])
    res = {"label": label, "freeze": lrd.freeze, "lrd": lrd.enabled,
           "remat": remat, "steps": steps, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "loss_first": r.losses[0],
           "loss_last": r.losses[-1], "losses": r.losses,
           "step_ms_median": med * 1e3, "first_step_ms": secs[0] * 1e3,
           "step_ms": [t * 1e3 for t in secs],
           "tokens_per_s": TRAIN_M / med,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "optimizer_state_bytes": r.stats["optimizer_state_bytes"],
           "trainable_params": r.stats["trainable_params"],
           "frozen_params": r.stats["frozen_params"],
           "launches_per_step": expect,
           "launches": {k: launch_count(k) for k in expect},
           "wall_s": wall, "card": card}
    log("train " + json.dumps(res))
    return res


def check_train(cfg, card: str, seed: int) -> dict:
    """One step's loss and every trainable leaf's gradient of the frozen
    branches=4 tree on the card (bf16, kernels) against the same params
    and batch on the CPU in f32 (plain versions), full depth, within
    TRAIN_CHECK_TOL; the frozen factors have no gradient on either side."""
    import dataclasses
    import torch
    from repro_torch.configs.base import LRDConfig, RunConfig
    from repro_torch.core import freezing
    from repro_torch.core.surgery import decompose_model
    from repro_torch.models.api import get_model
    from repro_torch.train.data import ByteTextLM
    from repro_torch.train.steps import make_loss_fn, value_and_grad
    from repro_torch.tree import paths

    def flat(tree):
        return {"/".join(p): v for p, v in paths(tree)}
    lrd = LRDConfig(**LRD, branches=4, freeze=True)
    run = RunConfig(model=cfg, lrd=lrd, seed=seed)
    m_gpu = get_model(cfg, "cuda")
    with torch.no_grad():
        params, axes = m_gpu.init(
            torch.Generator(device="cuda").manual_seed(seed))
        params, _, _ = decompose_model(params, axes, lrd)
    freezing.set_requires_grad(params, freeze=True)
    toks = torch.as_tensor(ByteTextLM(cfg, TRAIN_BATCH,
                                      TRAIN_SEQ).batch(0)["tokens"])
    reset_launches()
    t0 = time.perf_counter()
    lg, _, gg = value_and_grad(make_loss_fn(m_gpu, run), params,
                               {"tokens": toks.cuda()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {k: launch_count(k) for k in KERNELS if launch_count(k)}
    gg = flat(to_cpu_f32(gg))
    with torch.no_grad():
        p_cpu = to_cpu_f32(params)
    del params
    torch.cuda.empty_cache()
    freezing.set_requires_grad(p_cpu, freeze=True)
    m_cpu = get_model(dataclasses.replace(cfg, dtype="float32"), "cpu")
    t0 = time.perf_counter()
    lc, _, gc = value_and_grad(make_loss_fn(m_cpu, run), p_cpu,
                               {"tokens": toks})
    cpu_s = time.perf_counter() - t0
    gc = flat(gc)
    if {k for k, g in gg.items() if g is None} != \
            {k for k, g in gc.items() if g is None}:
        raise SystemExit("check_train: the card and the CPU leave other "
                         "leaves without a gradient")
    errs = {k: ((gg[k] - g).norm() / g.norm().clamp_min(1e-30)).item()
            for k, g in gc.items() if g is not None}
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    res = {"loss_card": float(lg), "loss_cpu": float(lc),
           "loss_rel": loss_rel, "grad_rel_l2": errs,
           "grad_rel_l2_max": max(errs.values()),
           "no_grad": sorted(k for k, g in gc.items() if g is None),
           "tol": TRAIN_CHECK_TOL, "launches": launches,
           "card_step_s": card_s, "cpu_step_s": cpu_s, "depth": cfg.num_layers,
           "card": card}
    log("check_train " + json.dumps(res))
    if not (loss_rel <= TRAIN_CHECK_TOL["loss"]
            and res["grad_rel_l2_max"] <= TRAIN_CHECK_TOL["grad"]):
        raise SystemExit(f"check_train: the card's step differs from the "
                         f"CPU f32 step: loss {loss_rel:.2e}, gradients "
                         f"{res['grad_rel_l2_max']:.3e} (tol "
                         f"{TRAIN_CHECK_TOL})")
    return res


def run_train(phases: list[str], card: str, seed: int,
              train_res: dict) -> None:
    """The training phases on llama3.2-1b at full width."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig
    cfg = registry.get("llama3.2-1b").full
    chain = {k: sum(v.values()) for k, v in TRAIN_LAUNCHES.items()}
    frozen = LRDConfig(**LRD, branches=4, freeze=True)
    if "train" in phases:
        with Phase("train"):
            train_res["frozen"] = train_run(
                cfg, card, seed, label="frozen", lrd=frozen, remat="none",
                steps=TRAIN_STEPS, expect=chain, falls=True)
            train_res["frozen_remat_full"] = train_run(
                cfg, card, seed, label="frozen, remat full", lrd=frozen,
                remat="full", steps=2,
                expect={k: 2 * n for k, n in chain.items()}, falls=False)
            train_res["unfrozen"] = train_run(
                cfg, card, seed, label="unfrozen",
                lrd=LRDConfig(**LRD, branches=4), remat="none",
                steps=TRAIN_STEPS, expect=chain, falls=False)
            train_res["dense"] = train_run(
                cfg, card, seed, label="dense (f32-widened products)",
                lrd=LRDConfig(), remat="none", steps=TRAIN_STEPS, expect={},
                falls=False)
    if "check_train" in phases:
        with Phase("check_train"):
            train_res["check"] = check_train(cfg, card, seed)


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + EXTRA_PHASES))
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernels phase's rows: comma-separated subset "
                    "of " + ",".join(KERNELS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    only = frozenset(args.kernels.split(","))
    if only - set(KERNELS):
        ap.error(f"unknown kernels {sorted(only - set(KERNELS))}")

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
    if set(phases) & {"build", "kernels", *LLAMA_PHASES, *MLA_PHASES,
                      *TRAIN_PHASES}:
        with Phase("build"):
            from repro_torch.kernels import build
            _, report = build.build()
            for line in report.splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "spill" in line or line.startswith("==")):
                    log(line.strip())
            lib = build.load()
            # dynamic shared memory per launch (ptxas reports static only)
            # at the row block each launch takes; the quantized chains
            # stage their weights in f32 after dequantizing, so each needs
            # what its plain twin needs
            for dt, code in (("bfloat16", 1), ("float32", 0)):
                for m in (8, 64):
                    lr = {k: build.chain_bm(m, lambda bm, r=r: int(
                        lib.lrk_lowrank_smem(code, bm, r)))
                        for k, (_, r, _) in LOWRANK_SHAPES.items()}
                    br = {k: build.chain_bm(m, lambda bm, n=n, r=r: int(
                        lib.lrk_branched_smem(code, bm, n, r, r)))
                        for k, (n, _, r, _) in {
                            **BRANCHED_SHAPES,
                            **DEEPSEEK_BRANCHED_SHAPES}.items()}
                    fits = max(b for _, b in [*lr.values(), *br.values()]) \
                        <= build.SMEM_LIMIT
                    log(f"dynamic shared memory (row block, bytes), {dt}, "
                        f"M={m}, plain and quantized chains: lowrank {lr} "
                        f"branched {br} (limit {build.SMEM_LIMIT} B: "
                        f"{'every rank fits' if fits else 'OVER'})")
            for dt, code in (("bfloat16", 1), ("float32", 0)):
                at32 = {k: int(lib.lrk_branched_smem(code, 32, n, r, r))
                        for k, (n, _, r, _) in
                        DEEPSEEK_BRANCHED_SHAPES.items()}
                log(f"dynamic shared memory, {dt}, DeepSeek-V2 branched "
                    f"shapes at 32 rows (the block a prefill chunk took "
                    f"before the fit repair): {at32}")
            split_kernels()
            attention_splits()

    if "kernels" in phases:
        with Phase("kernels"):
            kernels = check_kernels(card, only)

    serve_res: dict[str, dict] = {}
    if set(phases) & set(LLAMA_PHASES):
        run_llama(phases, card, args.seed, serve_res)
        # the llama trees are gone with run_llama's frame
        torch.cuda.empty_cache()
    if set(phases) & set(MLA_PHASES):
        run_mla(phases, card, args.seed, serve_res)
        torch.cuda.empty_cache()
    train_res: dict[str, dict] = {}
    if set(phases) & set(TRAIN_PHASES):
        run_train(phases, card, args.seed, train_res)

    if kernels is not None:
        for k in kernels:
            run = serve_res.get(RUN_OF[k["name"]])
            if run is not None:
                k["launches"] = run["launches"][k["name"]]
            if "train_path" in k and "frozen" in train_res:
                k["train_path"]["launches"] = \
                    train_res["frozen"]["launches"][k["name"]]
        log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
