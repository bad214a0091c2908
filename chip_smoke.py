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
             yardstick (CUDA events), beside the bound (the bytes and
             operations of ``analysis/roofline.py::kernel_cost``; bytes
             at 3.35 TB/s, operations at 989 TFLOP/s bf16 / 67 TFLOP/s
             f32 / 1,979 TOP/s int8: ``repro_torch.analysis.hw_specs.
             H100``).
             The branched chain rows (bf16, quantized and 2:4: B2, B4,
             B12) also time the kernel and
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

Serve hardening and the router add, in PHASES' order after check_paged:

- serve_faults — the bf16 branches=4 tree over an int8 slot pool
             (kv_quantize="int8": 32 B1 + 80 B2 + 16 B5 every decode
             step, 32 + 80 every prefill chunk), 8 greedy requests of
             32-512 prompt and 32 new tokens: a clean run, then the same
             requests with ``debug=True`` (the pool's integrity check
             after every step) under a fault schedule (NaN logits once on
             decode at slot 0, one corrupted int8 scale row, two refused
             allocations, one host step slowed by 0.2 s), one request
             cancelled mid-flight and one with ``deadline_s=0``: every
             request ends with a status, at least one is quarantined and
             one step flagged slow, the pool holds 0 bytes after the
             drain, every survivor's stream is the clean run's token for
             token, every segment's launches exact; then a ``kernel_gate``
             scheduled at one dispatch must make ``step()`` raise
             ``KernelRejected`` with every earlier dispatch launched, that
             one not, and no plain version run.
- serve_router — ``ServeRouter(replicas=2, devices=["cuda", "cuda"],
             slots=8, max_seq=1024, kv_layout="paged", slo_itl_ms=200)``
             (32 B1 + 80 B2 + 16 B8 every decode step), 12 greedy requests
             (8 interactive, 4 batch; four on one 256-token prefix), and
             one engine's run of the same requests beside it; once
             replica 0 has streams in flight its step raises: it must trip
             and be evacuated, every request finish with the engine's
             stream, the radix hit, the launches be exact, and both
             replicas serve one tree on the card with a pool each.

Each prints its decode-step ms (the router its ``round_seconds``),
tokens/s, per-class p99 ITL and peak memory.

The search slice adds, in PHASES' order:

- search  — for each of llama3.2-1b's four linear shapes at M = 8 and
             4,096 rows: the rank of ``select_rank(mode="search")`` on
             the H100 cost model and of ``algorithm1`` on the timer
             measured on the card (bf16, CUDA events, the L2 flushed
             before every call; run twice, and once more with the
             factors left in L2), the timers' t(r) at those ranks, at
             the aligned and at the ratio rank, the spread of five fresh
             timings, each search's own seconds; every rank in [r_min,
             r_start] or ORG.  The whole measured curves go to
             ``build/search_curves.json``.
- serve_search — the full-width llama decomposed through
             ``decompose_model`` with ``rank_mode="search"``, branches=4
             (q/o SVD 384, k/v SVD 191, gate/up/down branched 4 x 192),
             served as ``serve``: every segment exactly the launches the
             surgery report implies (64 B1 + 48 B2 at those ranks);
             prints the ranks and ``weight_bytes`` beside the aligned
             tree's.
- check_search — prefill plus 16 greedy decode steps of that tree on the
             card against the same tree in f32 on the CPU, as check_paged
             over the slot pool.

and, in the kernels phase, bf16 B1 rows at the searched SVD pairs (2048,
191, 512), (2048, 384, 2048) and rank 191's aligned neighbour (2048,
192, 512), M = 8 and 64, timed as the other B1 rows; the B1 / B2 entries
of the kernels line carry ``search_path``, one decode step of the
searched tree.

The other configs add, in PHASES' order after check_mla_sq (each tree
built on the card at its published widths, cut in depth only, random
bf16 weights from the seed, decomposed there with ``LRD`` at
branches=4, its surgery decisions held to ``CONFIG_SURGERY`` and printed,
freed after its two phases; 8 requests of 32-512 prompt and 32 new tokens
at slots=8, max_seq=1024; each phase's peak memory printed):

- serve_granite / check_granite — granite-8b, 4 of 36 layers (head dim
             128, GQA group 4), paged bf16 pool: every decode step 8 B1 +
             21 B2 + 4 B8, every prefill chunk 8 + 21.
- serve_nemo / check_nemo — mistral-nemo-12b, 4 of 40 (q 4,096 wide at
             d_model 5,120), int8 slot pool: 8 B1 + 21 B2 + 4 B5.
- serve_minitron / check_minitron — minitron-4b, 4 of 32 (group 3, the
             gelu MLP without a gate), paged int8 pool: 8 B1 + 17 B2 +
             4 B9.
- serve_moe / check_moe — moonshot-v1-16b-a3b, 4 of 48 (64 routed
             experts top 6, 2 shared; group 1), int8 slot pool, blocking
             admission: every decode step and prefill 29 B2 (+ 4 B5 a
             decode step); the routed experts run plain batched products.
- serve_mla_moe / check_mla_moe — deepseek-v2-236b with its experts, 2
             of 60 (the dense first layer and one MoE layer of 160
             experts), ``mla_latent_int8`` pool, blocking: 9 B2 (+ 2 B10
             a decode step).

- serve_mamba2 / check_mamba2 — mamba2-2.7b, 8 of 64 layers (attention
             free: d_inner 5,120, 80 SSD heads of 64, state 128, chunk
             256), bf16 factors over the recurrent slot pool, blocking:
             every decode step and prefill 16 B2, no attention kernel.
- serve_zamba2 / check_zamba2 — zamba2-1.2b, 14 of 38 (2 groups of 6
             SSM layers, each followed by the shared attention + MLP
             block over its own KV entry, and 2 trailing SSM layers),
             int8 factors over the int8 slot pool, blocking: every
             segment 42 B4 (28 for the SSM layers, 7 a shared-block
             invocation), every decode step 2 B5 (G 1, D 64, 32 KV
             heads).

Each of those two prints the pool's recurrent state bytes (read and
written by every decode step; ``kv_bytes_per_step`` is 0 for mamba2)
beside ``weight_bytes``.  Their checks (:func:`cross_check_recurrent`)
prefill 300 tokens (past the 256-token chunk, not a multiple of it) and
run 16 greedy decode steps, fed the CPU f32 run's tokens: the tree in
f32 on the card against f32 on the CPU over the full-width pool
(``CHECK_TOL_F32``); in bf16 on the card (and, reported, on the CPU)
against f32 on the CPU over the phase's pool (``CHECK_TOL``); and, over
zamba2's int8 pool, in f32 on the card against f32 on the CPU
(``CHECK_TOL_POOL_F32``: B5 on the shared block's KV end to end).

The dense checks are check_paged's (a prefill chunk and 16 greedy decode
steps through the phase's pool, bf16 on the card against f32 on the
CPU, launches exact, ``CHECK_TOL``). The MoE checks run the blocking
prefill and 16 decode steps five ways, all fed one run's greedy tokens:
over the full-width slot pool the tree in f32 on the card must route
every (token, k) to the experts the CPU's f32 run picks (the dispatch's
top-k recorded through a wrapper), bar near ties (the CPU's gates of the
swapped experts within ``ROUTER_TIE``, relative), and stay within
``CHECK_TOL_F32`` of its logits; over the phase's int8 pool the bf16
and f32 card runs' distance, greedy agreement and share of equal
choices against the CPU's f32 run over that pool are printed, not gated
(two f32 runs round a K / V value on an int8 boundary apart, which
moves logits by ~1e-3 std and can tip a near-tied router score).  The
kernels phase adds B5 at (G, D) = (4, 128) and (1, 128), B8 at (4, 128),
B9 at (3, 128) (``WIDE_ATTN_CASES``, ``WIDE_PAGED_CASES``), and bf16 B1
/ B2 rows at M = 8 at these trees' ranks and widths
(``WIDE_LOWRANK_SHAPES``, ``WIDE_BRANCHED_SHAPES``).

The ResNets (the paper's own benchmark architectures, Tables 1 and 3)
add, in PHASES' order after check_zamba2, at full width and depth, f32
(TF32 off for the whole run: the times are strict f32), 224 x 224,
1,000 classes, every tree built and decomposed on the card from the
seed (``RESNET_LRD``, ``RESNET_VARIANTS``):

- infer_resnet — resnet50 original and the Table 3 rows (vanilla LRD,
             searched ranks on the H100 cost model, layer freezing (the
             vanilla tree), merged bottlenecks, branched Tucker at N = 4,
             and the vanilla tree with int8 factors), resnet101 and
             resnet152 original and vanilla (Table 1): layers, params,
             forward GFLOPs at 224, surgery seconds, images/s at batch 32
             (mean and spread of 10 forwards after warm-up, each ending
             in a sync), batch-1 ms, peak memory, speedup over the
             original, and the exact chain-kernel launches per forward:
             one B1 (the fc's SVD pair, the f32 form) for the
             vanilla and searched trees, one B3 for the int8 tree, none
             for the others.  The convolutions are cuDNN's.
- check_resnet — every tree's f32 logits on the card against the port's
             CPU f32 run of the same tree (4 images for resnet50, 2 for
             the others) within ``CHECK_TOL_F32`` of the CPU logits' std;
             top-1 agreement and each decomposed tree's distance from the
             original printed.
- train_resnet — 5 masked-AdamW steps at batch 32 of resnet50 original,
             vanilla, freezing, merging and branching (the example's
             ``finetune``): step ms (mean of steps 2-5), peak memory,
             losses, speedup over the original, one B1 forward a step
             where the fc is an SVD pair; the frozen factors unchanged.
- check_train_resnet — one step of vanilla and freezing at batch 2, card
             against CPU f32: loss within 1e-2, every gradient within
             0.05 relative L2 (``TRAIN_CHECK_TOL``).

The kernels phase adds B1 and B3 in f32 at the fc's shapes
(``RESNET_FC``: C 2,048, S 1,000, rank 335 (ratio) and 256 (search), M =
32 and 1); their rows are the ``resnet_path`` of the kernels line.

The last two model families add, in PHASES' order after
check_train_resnet (each tree built on the card at its published widths,
random bf16 weights from the seed, decomposed there with ``LRD`` at
branches=4, its surgery decisions held to ``VLM_SURGERY`` /
``HUBERT_SURGERY`` and printed, freed after its phases):

- serve_vlm / check_vlm — llama-3.2-vision-90b, 5 of 100 layers (one
             super block: 4 self layers, then the gated cross-attention
             block over 1,601 image tokens; 64 query heads over 8 KV
             heads of 128), bf16 slot pool, blocking admission with
             bucketed prompts and zero image embeddings (the engine's
             stub image): every prefill 10 B1 (the cross k / v at M =
             1,601 among them) + 26 B2, every decode step 8 B1 + 26 B2
             (``VLM_CHAINS``, derived from the surgery report by
             :func:`vlm_chains`); ``kv_bytes_per_step`` counts the image
             K/V. The check (:func:`cross_check_vlm`) runs
             ``LMModel.prefill`` of 64 tokens with random image
             embeddings and 16 greedy decode steps, every cross gate at
             0.5, bf16 on the card against f32 on the CPU
             (``CHECK_TOL``), f32 on the card against it too
             (``CHECK_TOL_F32``: the f32 form of B1 / B2 takes any
             per-branch rank; its decode step's ms and distance printed
             on a line of their own), and the card with
             the gates at 0 beside each (the image path must move the
             bf16 logits by more than ``CHECK_TOL_F32``).
- serve_vlm_q / check_vlm_q — the same tree with int8 factors over the
             int8 slot pool (the image K/V stays bf16): 10 B3 + 26 B4 a
             prefill, 8 B3 + 26 B4 + 4 B5 (G 8, D 128) a decode step.
- infer_hubert / check_hubert — hubert-xlarge, all 48 layers (16 heads
             of 80, bidirectional, layer norms, gelu MLP, 504 units
             padded to 512) through ``make_forward_step`` on 4 clips of
             500 frames (M = 2,000 rows a linear): ms a forward (mean
             and stdev of 10), frames/s, the dense tree's forward before
             the surgery beside it, peak memory, 193 B1 + 96 B2 a
             forward, exactly; the check on one clip: f32 on the card
             within ``CHECK_TOL_F32`` and bf16 within ``CHECK_TOL`` of
             f32 on the CPU.

The large-M form (``kernels/csrc/chain_wgmma.cuh``: bf16 B1 / B2 at M >=
``LARGE_M``, one output-tiled ``wgmma`` launch a product) adds: in the
build phase its plans at the main path's shapes (:func:`large_m_plans`);
in the kernels phase, on every B1 / B2 row it takes (the train step's,
hubert's, the VLM's cross k / v, mamba2's blocking prefill, the family
train rows), ``form`` "large_m" and the split-phase form forced, timed in
turns as ``prev_ms`` (``prev_err`` its distance), each row failing where
the large-M form is not the faster; and the ``LARGE_M`` sweep
(:func:`_large_m_sweep`: both forms at M = 64 to 2,000 at llama's train
shapes and hubert's, ``large_m_sweep`` of the kernels line), failing
where a swept M >= LARGE_M finds the split form faster.  Two profile
phases (:func:`_profiled`: the device's busy and idle share, the top
device kernels and host ops, exact launches):

- profile_hubert — (after check_hubert) three forwards of infer_hubert's
             decomposed tree after two warm ones.
- profile_train — (after check_train) three ``make_train_step`` steps of
             the frozen branches=4 llama tree at TRAIN_BATCH x TRAIN_SEQ
             after two warm ones (:func:`profile_train`).

The kernels phase adds their rows (``path``: "vlm" / "hubert"): B1 / B2
and B3 / B4 at the VLM's shapes, M = 8, with the 128,256-column unembed;
B2 / B4 in f32 at the VLM's gate / up / down and unembed, M = 8 and 128
(``VLM_F32_SHAPES``, ``path`` "vlm_f32": the f32 form, ``vlm_f32_path``
of the kernels line);
B1 / B3 at the cross k / v's M = 1,601; B5 at (G 8, D 128) in
``WIDE_ATTN_CASES``; B1 / B2 at hubert's shapes, M = 2,000; summed per
decode step or forward as ``vlm_path`` / ``hubert_path`` of the kernels
line, the cuBLAS chain's time beside each.

The f32 form of B1 / B2 (``kernels/csrc/chain_f32.cu``: one output-tiled,
K-sliced split-TF32 ``mma.sync`` launch a product, every M) adds: in the
build phase its plans (:func:`f32_plans`); in the kernels phase, on every
f32 B1 / B2 row (llama's shapes at M = 8 / 64 / 37, ``vlm_f32``,
``resnet``, and the rows below), ``form`` "f32" and the cluster kernel
(the earlier f32 kernel) timed in turns as ``prev_ms`` (``prev_err`` its
distance), the bound's operations at the split-TF32 peak (``peak``
"tf32x3", 495 / 3 TFLOP/s), each row failing where the f32 form is off
``KERNEL_TOL``, gives other bits on a second call or is not faster than
``prev_ms``; f32 B1 rows at the VLM's cross k / v over the image tokens
and hubert's q,k,v,o over one clip (``F32_LOWRANK_ROWS``: ``vlm_f32_path``,
``hubert_f32_path``); and f32 B2 rows with their gradients at the family
train shapes whose check step runs f32, at its M
(``TRAIN_FAMILY_F32_ROWS``, in ``train_family_path``).

B3 / B4 (int8 / e4m3 factors) run both forms too: bf16 at M >=
``LARGE_M_Q`` the large-M form on the factors the dequantizing pass
(``kernels/csrc/chain_dequant.cu``) writes as bf16 into the call's
scratch, f32 at every M the f32 form reading their bytes.  In the build
phase their plans (with the dequantized factors and the scratch bytes);
in the kernels phase, on every such row, ``form``, ``prev_ms`` (the split
form forced, or the cluster kernel; ``prev_refused`` where the cluster
kernel refuses the ranks), ``dq_us`` (the pass alone) and
``equal_to_unquantized`` (the bits of B1 / B2 in the same form on the
factors dequantized beforehand), each row failing where it is off
``KERNEL_TOL``, its bits differ or it is not faster than ``prev_ms``:
the int8 VLM's cross k / v at M = 1,601 and its prefill rows at
``VLM_PREFILL_M`` (``vlm_prefill_path``), zamba2's at M = 512, the f32
rows at llama's, the VLM's and the fc's shapes and at ``F32_WIDE_RANK``
(``f32_wide_path``); the ``LARGE_M`` sweep holds B3 / B4 at the int8
VLM's and zamba2's shapes to ``LARGE_M_Q``.

Training the other families (ROADMAP A13t) adds one pair per family
(``TRAIN_FAMILY_RUNS``), each right after the serve phases of the same
tree (moonshot after check_moe, DeepSeek-V2 after check_mla_moe, mamba2
and zamba2 after their checks, the VLM after check_vlm_q; hubert's, 12
of its 48 layers, after check_train): the registered config at its
published widths, cut in depth only, random bf16 weights from the seed,
decomposed on the card with ``LRD`` at branches=4 (the serve phases'
tree where they ran, else built for the pair), trained with the §2.2
freeze (the VLM's cross gates set to 0.5: at 0, ``tanh(gate)`` gives
the cross block no gradient):

- check_train_<key> — one step's loss and every trainable leaf's
             gradient on ``check_batch`` rows of the family's first batch
             (:func:`check_train_step`): the card in bf16, and in f32
             where the check's reference is f32, against the same params
             and batch on the CPU in f32.  The gate (loss within 1e-2,
             every gradient within 0.05 relative L2:
             ``TRAIN_CHECK_TOL``) holds the run ``check`` names: f32 for
             the MoE families (bf16 flips 1.7-6.7 % of top-k choices,
             and a flipped token sends its gradient to another expert),
             the SSM, the hybrid and the encoder; bf16 for the VLM.  The
             other run is reported, and
             the VLM's image path's share of its cross block's gradient
             (bf16 card step with zero image embeddings beside it).
             Exact launches: :func:`train_launches`.
- train_<key> — ``steps`` steps of the port's ``train()`` on the card
             (bf16) on the family's data: ``ByteTextLM`` for the LMs
             (with the random image embeddings of ``synth_inputs`` for
             the VLM: ``WithImageEmbeds``), ``SyntheticLM`` frames for
             hubert; exact launches every step (each decomposed
             linear's forward, the decomposed unembed's again per CE
             chunk in backward), finite losses; step ms, tokens (frames)
             / s, peak memory, seconds.

The kernels phase adds one bf16 B2 row per family at its widest chain
shape and its training M (``TRAIN_FAMILY_ROWS``, ``path`` "train": the
kernel, the autograd Function's gradients, the backward products' time,
the bound and the cuBLAS chain).

- launch — the port's launchers on the card, in-process
             (``repro_torch.launch.train.main`` / ``serve.main``): the
             train launcher for every registered arch's ``--smoke``
             config, 2 steps with ``--lrd aligned --freeze --branches
             4``; for llama3.2-1b at full width, 4 steps (its registered
             ``parallel("train")``, remat "full": exactly 64 B1 + 160 B2
             a step); the serve launcher for llama3.2-1b at full
             width, 8 requests; its refusal of hubert.  Each train run
             prints a finite loss and launches B1 / B2 exactly where its
             tree has an SVD pair / branched linear outside the routed
             experts and the convolutions, and nothing else.

- mesh — (after check_train) a process group of one NCCL rank, joined
             through a ``FileStore`` in a temporary directory, and a
             (1, 1, 1) ("pod", "data", "model") mesh from
             ``launch/mesh.py``: llama3.2-1b at full width (the train
             phase's frozen branches=4 tree and batch) under FSDP, the
             sharded vocab, multi-pod and PowerSGD rank 4
             (``MESH_PARALLEL``), 2 steps of ``train(..., mesh=)`` and 2
             without the mesh, exact B1 / B2 launches in both, the
             losses and one step's synced gradients within ``MESH_TOL``
             (1e-6 relative) of the run without; then serve_q's int8
             tree, quantized before it is placed, served on the mesh
             over the int8 slot pool with exact launches, its greedy
             streams token-identical to serve_q's.  One rank holds the
             mesh code path and the kernels under it; collectives across
             ranks are held on the CPU (gloo tests).

- roofline — (after mesh) the whole-step count of
             ``analysis/roofline.py``: the full-width branches=4 llama
             tree (bf16, slot pool) serves 8 greedy requests of one
             64-token prefill chunk each, with a ``StepCounter`` around
             the first prefill chunk and the first decode step of all 8
             slots, and again without: token-identical streams, exact
             B1 / B2 launches (as many as the counter charged), and each
             counted call replayed on the CPU (fake tensors, the plain
             path) to the same FLOPs and bytes; the call timed without
             the counter (20 runs, CUDA events): the bound (the larger
             of the compute and memory terms) over the median, counted
             over model FLOPs.

- dryrun — ``python -m repro_torch.launch.dryrun --arch llama3.2-1b``
             for decode_32k and train_4k, single- and multi-pod, four
             child processes side by side (fake process groups of 256 /
             512 ranks, fake CPU tensors): each ``status: "ok"`` with
             CUDA never initialised; each cell's bottleneck,
             useful-FLOPs ratio, collective bytes and peak bytes.

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
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.hw_specs import H100  # noqa: E402

PHASES = ("device", "build", "kernels", "search", "serve", "check",
          "serve_search", "check_search", "serve_q", "check_q",
          "serve_paged", "check_paged", "serve_faults", "serve_router",
          "serve_qa", "check_qa", "serve_sq",
          "check_sq", "serve_mla", "check_mla", "serve_mla_q", "check_mla_q",
          "serve_mla_sq", "check_mla_sq", "serve_granite", "check_granite",
          "serve_nemo", "check_nemo", "serve_minitron", "check_minitron",
          "serve_moe", "check_moe", "check_train_moonshot",
          "train_moonshot", "serve_mla_moe", "check_mla_moe",
          "check_train_deepseek", "train_deepseek", "serve_mamba2",
          "check_mamba2", "check_train_mamba2", "train_mamba2",
          "serve_zamba2", "check_zamba2", "check_train_zamba2",
          "train_zamba2", "infer_resnet", "check_resnet", "train_resnet",
          "check_train_resnet", "serve_vlm", "check_vlm", "serve_vlm_q",
          "check_vlm_q", "check_train_vlm", "train_vlm", "infer_hubert",
          "check_hubert", "profile_hubert", "train", "check_train",
          "profile_train", "mesh", "roofline",
          "dryrun", "check_train_hubert", "train_hubert", "launch")
#: the phases that search, serve or check the llama3.2-1b trees, the MLA
#: ones, the other configs' (CONFIG_RUNS) and the training ones
LLAMA_PHASES = ("search", "serve", "check", "serve_search", "check_search",
                "serve_q", "check_q", "serve_paged", "check_paged",
                "serve_faults", "serve_router", "serve_qa", "check_qa", "serve_sq", "check_sq", "profile",
                "profile_qa")
MLA_PHASES = ("serve_mla", "check_mla", "serve_mla_q", "check_mla_q",
              "serve_mla_sq", "check_mla_sq", "profile_mla")
CONFIG_PHASES = ("serve_granite", "check_granite", "serve_nemo",
                 "check_nemo", "serve_minitron", "check_minitron",
                 "serve_moe", "check_moe", "serve_mla_moe", "check_mla_moe",
                 "serve_mamba2", "check_mamba2", "serve_zamba2",
                 "check_zamba2")
TRAIN_PHASES = ("train", "check_train", "profile_train")
TRAIN_FAMILY_PHASES = tuple(p for p in PHASES if p.startswith(
    ("train_", "check_train_")) and not p.endswith("resnet"))
RESNET_PHASES = ("infer_resnet", "check_resnet", "train_resnet",
                 "check_train_resnet")
VLM_PHASES = ("serve_vlm", "check_vlm", "serve_vlm_q", "check_vlm_q")
HUBERT_PHASES = ("infer_hubert", "check_hubert", "profile_hubert")
#: phases run only when asked for with --phases
EXTRA_PHASES = ("profile", "profile_qa", "profile_mla")

#: one H100 SXM's memory rate and dense peak rates (NVIDIA's data sheet
#: constants, not measurements, from the port's hardware spec): bf16 and
#: int8 on the tensor cores, f32 outside them, and "tf32x3": f32 work in
#: split TF32, three TF32 tensor-core products a term (the peak of the
#: f32 form of B1 / B2, ``csrc/chain_f32.cu``)
HBM_BYTES_PER_S = H100.hbm_bandwidth
PEAK_FLOPS = {"bfloat16": H100.peak_flops(2),
              "float32": H100.peak_flops_f32, "int8": H100.peak_flops(1),
              "tf32x3": H100.peak_flops_tf32 / 3}

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
#: the search phase: llama3.2-1b's four linear shapes (C, S), and the rows
#: Algorithm 1 times them at (a decode step, the cost model's default)
SEARCH_SHAPES = {"q,o": (2048, 2048), "k,v": (2048, 512),
                 "gate,up": (2048, 8192), "down": (8192, 2048)}
SEARCH_M = (8, 4096)
#: the searched tree (rank_mode="search", branches=4) on the H100 spec:
#: q/o an SVD pair at 384 (384 / 4 is under rank_align), k/v one at 191,
#: gate/up/down branched at 4 x 192 -- per decode step or prefill chunk
#: 64 B1 + 48 B2 (serve_search holds the run to what the surgery report
#: implies, and says whether that is this)
SEARCH_LAUNCHES = {"lowrank_matmul": {"q,o r384": 32, "k,v r191": 32},
                   "branched_matmul": {"gate,up": 32, "down": 16}}
#: bf16 B1 rows at the searched SVD pairs and at the aligned neighbour of
#: rank 191 (whole 16-byte rows of w0), at a decode step and a chunk
SEARCH_LOWRANK_SHAPES = {"k,v r191": (2048, 191, 512),
                         "q,o r384": (2048, 384, 2048),
                         "k,v r192": (2048, 192, 512)}
SEARCH_M_CASES = (8, 64)
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
#: the decode attentions at the head shapes of the other configs: B5 on
#: the int8 slot pool at mistral-nemo's (8 KV heads of 128, G 4),
#: moonshot's (16 KV heads of 128, G 1), zamba2's (32 of 64, G 1) and
#: llama-3.2-vision's (8 of 128, G 8: G * D at the kernel's 1,024 limit),
#: served 8 slots of 1,024
WIDE_ATTN_CASES = {"nemo G4 D128": dict(b=8, s=1024, kh=8, g=4, d=128,
                                        idle=0, softcap=0.0),
                   "moonshot G1 D128": dict(b=8, s=1024, kh=16, g=1, d=128,
                                            idle=0, softcap=0.0),
                   "zamba2 G1 D64": dict(b=8, s=1024, kh=32, g=1, d=64,
                                         idle=0, softcap=0.0),
                   "vlm G8 D128": dict(b=8, s=1024, kh=8, g=8, d=128,
                                       idle=0, softcap=0.0)}
#: B8 on granite's bf16 / f32 paged pool (8 KV heads of 128, G 4) and B9
#: on minitron's int8 one (8 KV heads of 128, G 3), as PAGED_CASES'
#: served pool otherwise; ``quant`` picks the pool
WIDE_PAGED_CASES = {"granite G4 D128": dict(b=8, kh=8, g=4, d=128, bs=16,
                                            nblk=64, nb=512, idle=1,
                                            softcap=0.0, quant=False),
                    "minitron G3 D128": dict(b=8, kh=8, g=3, d=128, bs=16,
                                             nblk=64, nb=512, idle=1,
                                             softcap=0.0, quant=True)}
#: the SVD pairs (C, R, S) and branched linears (N, C, r, S) of the other
#: configs under LRD at branches=4 (CONFIG_SURGERY), timed at a decode
#: step's M = 8 in bf16: the k/v pairs at rank 384, per-branch ranks 128
#: to 608, output widths up to minitron's 256,000-wide unembed
WIDE_LOWRANK_SHAPES = {"granite k,v": (4096, 384, 1024),
                       "nemo k,v": (5120, 384, 1024),
                       "minitron k,v": (3072, 384, 1024)}
WIDE_BRANCHED_SHAPES = {
    "granite q,o": (4, 4096, 256, 4096),
    "granite gate,up": (4, 4096, 384, 14336),
    "granite down": (4, 14336, 384, 4096),
    "granite unembed": (4, 4096, 448, 49152),
    "nemo q": (4, 5120, 256, 4096), "nemo o": (4, 4096, 256, 5120),
    "nemo gate,up": (4, 5120, 448, 14336),
    "nemo down": (4, 14336, 448, 5120),
    "nemo unembed": (4, 5120, 608, 131072),
    "minitron q,o": (4, 3072, 192, 3072),
    "minitron up": (4, 3072, 288, 9216),
    "minitron down": (4, 9216, 288, 3072),
    "minitron unembed": (4, 3072, 352, 256000),
    "moonshot q,k,v,o": (4, 2048, 128, 2048),
    "moonshot shared gate,up": (4, 2048, 128, 2816),
    "moonshot shared down": (4, 2816, 128, 2048),
    "moonshot unembed": (4, 2048, 224, 163840),
    "ds shared gate,up": (4, 5120, 224, 3072),
    "ds shared down": (4, 3072, 224, 5120)}
#: the recurrent trees' branched linears (N, C, r, S) under LRD at
#: branches=4, timed at a decode step's M = 8 and a blocking prefill's
#: M = 512: mamba2's in bf16 (B2), zamba2's with int8 factors (B4; its
#: in_proj and the shared block's up / gate share a shape)
SSM_BRANCHED_SHAPES = {"mamba2 in_proj": (4, 2560, 256, 10240),
                       "mamba2 out_proj": (4, 5120, 192, 2560)}
ZAMBA_BRANCHED_SHAPES = {"zamba2 in_proj,up,gate": (4, 2048, 192, 8192),
                         "zamba2 out_proj": (4, 4096, 160, 2048),
                         "zamba2 q,k,v,o": (4, 2048, 128, 2048),
                         "zamba2 down": (4, 8192, 192, 2048)}
SSM_M_CASES = (8, 512)
#: launches of those rows' kernels in one decode step of the recurrent
#: trees (8 mamba2 layers; 14 zamba2 layers and 2 shared-block
#: invocations)
SSM_LAUNCHES = {"branched_matmul": {"mamba2 in_proj": 8,
                                    "mamba2 out_proj": 8},
                "branched_matmul_q": {"zamba2 in_proj,up,gate": 18,
                                      "zamba2 out_proj": 14,
                                      "zamba2 q,k,v,o": 8, "zamba2 down": 2},
                "decode_attention_q": {"zamba2 G1 D64": 2}}
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
#: the family training phases (``train_<key>`` / ``check_train_<key>``):
#: the registered config cut to ``depth`` layers (widths as published),
#: TRAIN_FAMILY_STEPS steps at ``batch`` x ``seq`` (hubert: clips x
#: frames), the check on the first TRAIN_FAMILY_CHECK_BATCH rows of the
#: first batch, gated on the card run in ``check`` (f32 or bf16) against
#: the CPU's f32 step; ``tree_of``: the serve phases (a ``CONFIG_RUNS``
#: key, or the VLM's) whose decomposed tree the pair takes over, right
#: after them, where they ran (the same init and surgery: the §2.2
#: freeze changes neither)
TRAIN_FAMILY_RUNS = {
    "moonshot": dict(arch="moonshot-v1-16b-a3b", depth=4, batch=2, seq=256,
                     check="float32", tree_of="moe"),
    "deepseek": dict(arch="deepseek-v2-236b", depth=2, batch=2, seq=256,
                     check="float32", tree_of="mla_moe"),
    "mamba2": dict(arch="mamba2-2.7b", depth=8, batch=1, seq=512,
                   check="float32", tree_of="mamba2"),
    "zamba2": dict(arch="zamba2-1.2b", depth=14, batch=1, seq=512,
                   check="float32", tree_of="zamba2"),
    "vlm": dict(arch="llama-3.2-vision-90b", depth=5, batch=2, seq=128,
                check="bfloat16", tree_of="vlm"),
    "hubert": dict(arch="hubert-xlarge", depth=12, batch=4, seq=500,
                   check="float32"),
}
TRAIN_FAMILY_STEPS = 4
TRAIN_FAMILY_CHECK_BATCH = 1
#: the kernels phase's train rows of those families: the widest chain
#: shape (N, C, r, S) of each tree and the training M (batch x seq)
TRAIN_FAMILY_ROWS = {
    "moonshot unembed (train)": ("moonshot", (4, 2048, 224, 163840)),
    "deepseek unembed (train)": ("deepseek", (4, 5120, 608, 102400)),
    "mamba2 in_proj (train)": ("mamba2", (4, 2560, 256, 10240)),
    "zamba2 in_proj,up,gate (train)": ("zamba2", (4, 2048, 192, 8192)),
    "vlm unembed (train)": ("vlm", (4, 8192, 960, 128256)),
    "hubert up (train)": ("hubert", (4, 1280, 128, 5120)),
}
#: the f32 train rows: the same shapes of the families whose check step
#: runs f32 on the card (``check="float32"``), at that step's M
#: (TRAIN_FAMILY_CHECK_BATCH x seq), through the f32 form
TRAIN_FAMILY_F32_ROWS = {
    label.replace("(train)", "(train, f32)"): (key, shape)
    for label, (key, shape) in TRAIN_FAMILY_ROWS.items()
    if TRAIN_FAMILY_RUNS[key]["check"] == "float32"}
#: the launch phase: the train launcher's flags for every registered
#: arch's smoke config, and the full-width llama3.2-1b runs
LAUNCH_SMOKE = ("--smoke", "--steps", "2", "--lrd", "aligned", "--freeze",
                "--branches", "4")
LAUNCH_FULL_STEPS = 4
LAUNCH_SERVE_REQUESTS = 8

#: the ResNet phases: the LRD of the paper's Table 1 runs
#: (``benchmarks/bench_table1.py``) and the overrides of each Table 3 row
#: (``benchmarks/bench_table3.py``, ``examples/compress_resnet.py``);
#: ``None`` is the original tree, layer_freezing is vanilla_lrd's tree
#: (frozen in fine-tuning only), vanilla_int8 vanilla_lrd's with int8
#: factors
RESNET_LRD = dict(enabled=True, compression=2.0, rank_mode="ratio",
                  min_dim=8)
RESNET_VARIANTS = {"original": None, "vanilla_lrd": {},
                   "optimized_ranks": {"rank_mode": "search"},
                   "layer_freezing": {},
                   "layer_merging": {"targets": ("conv",)},
                   "layer_branching": {"compression": 1.0001, "branches": 4,
                                       "targets": ("conv",)},
                   "vanilla_int8": {}}
#: the Table 1 archs beside resnet50 (original and vanilla_lrd)
RESNET_TABLE1 = ("resnet101", "resnet152")
RESNET_BATCH = 32
RESNET_TIMED = 10
RESNET_CHECK_IMAGES = {"resnet50": 4, "resnet101": 2, "resnet152": 2}
#: train_resnet's rows, steps and optimizer (the example's finetune)
RESNET_TRAIN = ("original", "vanilla_lrd", "layer_freezing",
                "layer_merging", "layer_branching")
RESNET_TRAIN_STEPS = 5
RESNET_TRAIN_OPTIM = dict(peak_lr=1e-3, warmup_steps=1)
RESNET_CHECK_TRAIN = ("vanilla_lrd", "layer_freezing")
RESNET_CHECK_TRAIN_BATCH = 2
#: the fc's chain (C, R, S) in the vanilla (ratio) and searched trees,
#: and its rows: a batch-32 forward (inference and fine-tune) and batch 1
RESNET_FC = {"fc r335": (2048, 335, 1000), "fc r256": (2048, 256, 1000)}
RESNET_FC_M = (32, 1)

#: the VLM phases: llama-3.2-vision-90b at its published widths, cut to
#: one super block (4 self layers and the cross block after them, 5 of
#: 100 layers), random bf16 weights from the seed, decomposed on the card
#: with ``LRD`` at branches=4; the per-branch ranks and SVD ranks its
#: linears must get (the cross block's as the self blocks', the
#: embedding skipped)
VLM_ARCH = "llama-3.2-vision-90b"
VLM_DEPTH = 5
VLM_SURGERY = {
    **{f"{top}/{p}": ("branched", 512)
       for top in ("blocks/attn", "cross/cross_attn") for p in "qo"},
    **{f"{top}/{p}": ("svd", 384)
       for top in ("blocks/attn", "cross/cross_attn") for p in "kv"},
    **{f"{top}/mlp/{p}": ("branched", 768)
       for top in ("blocks", "cross") for p in ("up", "gate", "down")},
    "unembed": ("branched", 960)}
#: chain launches (B1, B2; B3, B4 for the int8 tree) of a blocking
#: prefill segment and of a decode step: 2 SVD pairs x 4 self layers, 5
#: branched linears x 5 layers and the unembed; the cross block's k / v
#: (its two SVD pairs) run at prefill only, over the 1,601 image tokens
VLM_CHAINS = {"prefill": (10, 26), "decode": (8, 26)}
#: check_vlm: the gate of every cross block (a fresh tree's is 0, where
#: the cross attention adds nothing) and the std of the random image
#: embeddings
VLM_GATE = 0.5
VLM_IMAGE_STD = 0.2
#: the encoder phases: hubert-xlarge at full width and depth, a batch of
#: 4 clips of 500 frames (10 s at 50 frames/s: M = 2,000 rows through
#: every linear), 10 timed forwards; the check on one clip
HUBERT_ARCH = "hubert-xlarge"
HUBERT_CLIPS, HUBERT_FRAMES = 4, 500
HUBERT_M = HUBERT_CLIPS * HUBERT_FRAMES
HUBERT_TIMED = 10
HUBERT_CHECK_CLIPS = 1
HUBERT_SURGERY = {**{f"blocks/attn/{p}": ("svd", 256) for p in "qkvo"},
                  "blocks/mlp/up": ("branched", 128),
                  "blocks/mlp/down": ("branched", 128),
                  "unembed": ("svd", 128)}
#: chain launches (B1, B2) of one forward: 4 SVD pairs x 48 layers and
#: the unembed's; 2 branched linears x 48 layers
HUBERT_CHAINS = (193, 96)
#: the kernels phase's rows of those trees (bf16): the VLM's SVD pairs
#: (C, R, S) and branched linears (N, C, r, S) at a decode step's M = 8
#: (B1 / B2, and B3 / B4 with int8 factors), the cross k / v pair at the
#: prefill's M = 1,601 image tokens; hubert's at M = 2,000
VLM_LOWRANK_SHAPES = {"vlm k,v": (8192, 384, 1024)}
VLM_BRANCHED_SHAPES = {"vlm q,o": (4, 8192, 512, 8192),
                       "vlm gate,up": (4, 8192, 768, 28672),
                       "vlm down": (4, 28672, 768, 8192),
                       "vlm unembed": (4, 8192, 960, 128256)}
VLM_CROSS_M = 1601
#: the f32 rows at the VLM's widest per-branch ranks (768, 960), where the
#: cluster chains (f32 B4's kernel, B2's ``prev_ms``) take 4-row blocks
VLM_F32_SHAPES = {k: VLM_BRANCHED_SHAPES[k]
                  for k in ("vlm gate,up", "vlm down", "vlm unembed")}
VLM_F32_M = (8, 128)
#: the int8 VLM's blocking prefill at its largest prompt: the B3 k,v and
#: B4 q,o / gate,up / down rows at this M (path "vlm_prefill"), the
#: large-M form on the factors its dequantizing pass writes
VLM_PREFILL_M = 512
VLM_PREFILL_SHAPES = ("vlm q,o", "vlm gate,up", "vlm down")
#: the f32 B4 row past the cluster kernel's 4-row block (per-branch ranks
#: 1,600: that kernel refuses it, the f32 form runs it) at a decode step
F32_WIDE_RANK = {"r1600": (4, 256, 1600, 256)}
#: the f32 B1 rows of check_vlm's and check_hubert's f32 runs: the VLM's
#: cross k / v over the image tokens (path "vlm_f32") and hubert's
#: q,k,v,o over one clip (path "hubert_f32")
F32_LOWRANK_ROWS = {"vlm cross k,v": ("vlm_f32", (8192, 384, 1024), 1601),
                    "hubert q,k,v,o": ("hubert_f32", (1280, 256, 1280),
                                       500)}
HUBERT_LOWRANK_SHAPES = {"hubert q,k,v,o": (1280, 256, 1280),
                         "hubert unembed": (1280, 128, 512)}
HUBERT_BRANCHED_SHAPES = {"hubert up": (4, 1280, 128, 5120),
                          "hubert down": (4, 5120, 128, 1280)}
#: launches of those rows' kernels in one VLM decode step (B5 on the 4
#: self layers of the int8 pool: G 8, D 128) and one hubert forward
VLM_LAUNCHES = {
    **{k: {"vlm k,v": 8} for k in ("lowrank_matmul", "lowrank_matmul_q")},
    **{k: {"vlm q,o": 10, "vlm gate,up": 10, "vlm down": 5,
           "vlm unembed": 1}
       for k in ("branched_matmul", "branched_matmul_q")},
    "decode_attention_q": {"vlm G8 D128": 4}}
HUBERT_LAUNCHES = {"lowrank_matmul": {"hubert q,k,v,o": 192,
                                      "hubert unembed": 1},
                   "branched_matmul": {"hubert up": 48, "hubert down": 48}}
#: the LARGE_M sweep of the kernels phase: bf16 B1 / B2 in both forms
#: (the large-M form, the split-phase one) at these M, at llama's train
#: shapes and hubert's; B3 / B4 (int8 factors) at the int8 VLM's and
#: zamba2's
LARGE_M_SWEEP_M = (64, 128, 256, 512, 1024, 2000)
LARGE_M_SWEEP = {
    "lowrank_matmul": {"k,v": LOWRANK_SHAPES["k,v"], **HUBERT_LOWRANK_SHAPES},
    "branched_matmul": {**{k: BRANCHED_SHAPES[k]
                           for k in ("q,o", "gate,up", "down")},
                        **HUBERT_BRANCHED_SHAPES},
    "lowrank_matmul_q": dict(VLM_LOWRANK_SHAPES),
    "branched_matmul_q": {**{k: VLM_BRANCHED_SHAPES[k]
                             for k in VLM_PREFILL_SHAPES},
                          **{k: ZAMBA_BRANCHED_SHAPES[k] for k in (
                              "zamba2 in_proj,up,gate",
                              "zamba2 q,k,v,o")}}}
#: the large-M form's source (``large_m_source`` of the kernels line)
LARGE_M_SOURCE = "src/repro_torch/kernels/csrc/chain_wgmma.cuh"
#: profiled steps of profile_train / profile_hubert (after two warm ones)
PROFILE_STEPS = 3

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

#: the other configs' serve / check phases (``serve_<key>``,
#: ``check_<key>``): the registered config at its published widths, cut
#: to ``depth`` layers (DeepSeek-V2's 2: its dense first layer and one
#: MoE layer), random bf16 weights from the seed, decomposed on the card
#: with ``LRD`` at branches=4; the engine's pool (``engine``) and the
#: attention kernel its decode steps launch in every layer (``attn``);
#: ``shared``: prompts on one prefix (a paged pool's radix hits).  The
#: MoE family admits blocking (whole-prompt prefill segments).
CONFIG_RUNS = {
    "granite": dict(arch="granite-8b", depth=4, attn="decode_attention_paged",
                    engine=dict(kv_layout="paged", kv_block_size=PAGED_BLOCK),
                    shared=4),
    "nemo": dict(arch="mistral-nemo-12b", depth=4,
                 attn="decode_attention_q", engine=dict(kv_quantize="int8")),
    "minitron": dict(arch="minitron-4b", depth=4,
                     attn="decode_attention_paged_q",
                     engine=dict(kv_quantize="int8", kv_layout="paged",
                                 kv_block_size=PAGED_BLOCK), shared=4),
    "moe": dict(arch="moonshot-v1-16b-a3b", depth=4,
                attn="decode_attention_q", engine=dict(kv_quantize="int8")),
    "mla_moe": dict(arch="deepseek-v2-236b", depth=2,
                    attn="decode_attention_latent_q",
                    engine=dict(kv_quantize="int8")),
    "mamba2": dict(arch="mamba2-2.7b", depth=8, attn=None, engine={}),
    "zamba2": dict(arch="zamba2-1.2b", depth=14, attn="decode_attention_q",
                   engine=dict(quantize="int8", kv_quantize="int8"),
                   bf16_against="cpu_bf16"),
}
#: (``bf16_against``: the run the recurrent check holds the card's bf16
#: run to, where the CPU's own bf16 run misses the CPU f32 one by as much
#: as the card's does: zamba2's reads 0.301 std to the card's 0.305, the
#: bf16 recurrent state and int8 pool rounding over 14 layers; the two
#: bf16 runs lie 0.181 apart)
#: the surgery decisions each of those trees must get under ``LRD`` at
#: branches=4 (path -> (kind, rank; a branched linear's per branch)); every
#: other linear skips.  The routed expert banks (``moe_*``) decompose
#: batched over layers and experts and run plain batched products.
_DENSE_SURGERY = {"blocks/attn/q": "branched", "blocks/attn/k": "svd",
                  "blocks/attn/v": "svd", "blocks/attn/o": "branched",
                  "blocks/mlp/up": "branched", "blocks/mlp/gate": "branched",
                  "blocks/mlp/down": "branched", "unembed": "branched"}
CONFIG_SURGERY = {
    "granite": {k: (kind, r) for (k, kind), r in zip(
        _DENSE_SURGERY.items(), (256, 384, 384, 256, 384, 384, 384, 448))},
    "nemo": {k: (kind, r) for (k, kind), r in zip(
        _DENSE_SURGERY.items(), (256, 384, 384, 256, 448, 448, 448, 608))},
    "minitron": {k: (kind, r) for (k, kind), r in zip(
        [kv for kv in _DENSE_SURGERY.items() if kv[0] != "blocks/mlp/gate"],
        (192, 384, 384, 192, 288, 288, 352))},
    "moe": {**{f"blocks/attn/{p}": ("branched", 128) for p in "qkvo"},
            **{f"blocks/moe/experts/{p}": ("svd", 384)
               for p in ("up", "gate", "down")},
            **{f"blocks/moe/shared/{p}": ("branched", 128)
               for p in ("up", "gate", "down")},
            "unembed": ("branched", 224)},
    "mla_moe": {"first/mla/o": ("branched", 480),
                **{f"first/mlp/{p}": ("branched", 448)
                   for p in ("up", "gate", "down")},
                "blocks/mla/o": ("branched", 480),
                **{f"blocks/moe/experts/{p}": ("branched", 128)
                   for p in ("up", "gate", "down")},
                **{f"blocks/moe/shared/{p}": ("branched", 224)
                   for p in ("up", "gate", "down")},
                "unembed": ("branched", 608)},
    "mamba2": {"blocks/ssm/in_proj": ("branched", 256),
               "blocks/ssm/out_proj": ("branched", 192)},
    "zamba2": {"blocks/ssm/in_proj": ("branched", 192),
               "blocks/ssm/out_proj": ("branched", 160),
               **{f"shared_attn/attn/{p}": ("branched", 128) for p in "qkvo"},
               **{f"shared_attn/mlp/{p}": ("branched", 192)
                  for p in ("up", "gate", "down")}},
}
#: chain-kernel launches per model segment that those decisions imply
#: (B1, B2; B3, B4 for an int8 tree): one per layer of every SVD pair and
#: branched linear outside the routed experts, one per invocation of the
#: hybrid's shared block
CONFIG_CHAINS = {"granite": (8, 21), "nemo": (8, 21), "minitron": (8, 17),
                 "moe": (0, 29), "mla_moe": (0, 9), "mamba2": (0, 16),
                 "zamba2": (0, 42)}
#: the MoE checks' f32 gate: max |card f32 logits - CPU f32 logits| /
#: std(CPU logits); the f32 chain kernels are held to 1e-4 a product
CHECK_TOL_F32 = 1e-3
#: the MoE checks' f32 routing gate: every (token, k) choice of the card's
#: f32 run must be the CPU's, except where the CPU's gates of the two
#: experts the runs swap at the top-k boundary lie within this of each
#: other (relative): two f32 runs that sum the router's inputs in another
#: order tip such a near tie either way
ROUTER_TIE = 1e-5
#: the recurrent checks' gate on the card's f32 run over an int8 pool
#: against the CPU's over it: int8 roundings that the two runs take apart
#: (a K / V value on a rounding boundary) move its logits, so it is held
#: to the bf16 runs' gate
CHECK_TOL_POOL_F32 = CHECK_TOL


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
L2_FLUSH_BYTES = 2 * H100.l2_bytes


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
        for label, (c, r, s) in LOWRANK_SHAPES.items():
            if not only & lowrank:
                break
            for m in M_CASES:
                x = rnd(m, c, dtype=dt)
                plans = label in LOWRANK_PLAN_SHAPES and m == 8
                add("lowrank_matmul", lambda: _lowrank_row(
                    label, x, (c, r, s), dname, rnd, flush, plans))
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
                        **_cost_bound("lowrank_matmul_q", args,
                                      _q_peak(dname))))
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
        for label, case in WIDE_ATTN_CASES.items():
            add("decode_attention_q",
                lambda: _check_attention(label, case, dname, rnd, flush))
        for label, case in WIDE_PAGED_CASES.items():
            quant = case["quant"]
            add("decode_attention_paged" + ("_q" if quant else ""),
                lambda: _check_paged(label, case, dname, quant, g, flush))
    for label, shape in SEARCH_LOWRANK_SHAPES.items():
        for m in SEARCH_M_CASES:
            add("lowrank_matmul", lambda: _lowrank_row(
                label, rnd(m, shape[0], dtype=torch.bfloat16), shape,
                "bfloat16", rnd, flush, plans=False))
    bf = torch.bfloat16
    for label, shape in WIDE_LOWRANK_SHAPES.items():
        add("lowrank_matmul", lambda: _lowrank_row(
            label, rnd(8, shape[0], dtype=bf), shape, "bfloat16", rnd, flush,
            plans=False))
    for label, shape in (WIDE_BRANCHED_SHAPES.items()
                         if "branched_matmul" in only else ()):
        _check_branched(add, label, shape, 8, "bfloat16", rnd, qrnd, (),
                        spack, flush, only)
    for label, shape in (SSM_BRANCHED_SHAPES.items()
                         if "branched_matmul" in only else ()):
        for m in SSM_M_CASES:
            _check_branched(add, label, shape, m, "bfloat16", rnd, qrnd, (),
                            spack, flush, only)

    def add_q(name: str, make_row) -> None:
        """:func:`add` of the B4 rows alone (zamba2's tree is int8)."""
        if name == "branched_matmul_q":
            add(name, make_row)
    for label, shape in (ZAMBA_BRANCHED_SHAPES.items()
                         if "branched_matmul_q" in only else ()):
        for m in SSM_M_CASES:
            _check_branched(add_q, label, shape, m, "bfloat16", rnd, qrnd,
                            ("int8",), spack, flush, only)

    def add_path(path: str, names: set):
        """:func:`add` of the rows of ``names`` alone, tagged ``path``."""
        def add_p(name: str, make_row) -> None:
            if name in names:
                add(name, lambda: dict(make_row(), path=path))
        return add_p
    for label, shape in (VLM_BRANCHED_SHAPES.items()
                         if only & {"branched_matmul", "branched_matmul_q"}
                         else ()):
        _check_branched(add_path("vlm", {"branched_matmul",
                                         "branched_matmul_q"}),
                        label, shape, 8, "bfloat16", rnd, qrnd, ("int8",),
                        spack, flush, only)
    for label, shape in (VLM_F32_SHAPES.items()
                         if only & {"branched_matmul", "branched_matmul_q"}
                         else ()):
        for m in VLM_F32_M:
            _check_branched(add_path("vlm_f32", {"branched_matmul",
                                                 "branched_matmul_q"}),
                            label, shape, m, "float32", rnd, qrnd,
                            ("int8",), spack, flush, only)
    for label, shape in VLM_LOWRANK_SHAPES.items():
        for m in (8, VLM_CROSS_M):
            x = rnd(m, shape[0], dtype=bf)
            add("lowrank_matmul", lambda: dict(_lowrank_row(
                label, x, shape, "bfloat16", rnd, flush, plans=False),
                path="vlm"))
            add("lowrank_matmul_q", lambda: dict(_lowrank_q_row(
                label, x, shape, "bfloat16", qrnd, flush), path="vlm"))
        add("lowrank_matmul_q", lambda: dict(_lowrank_q_row(
            label, rnd(VLM_PREFILL_M, shape[0], dtype=bf), shape,
            "bfloat16", qrnd, flush), path="vlm_prefill"))
    for label in (VLM_PREFILL_SHAPES if "branched_matmul_q" in only
                  else ()):
        _check_branched(add_path("vlm_prefill", {"branched_matmul_q"}),
                        label, VLM_BRANCHED_SHAPES[label], VLM_PREFILL_M,
                        "bfloat16", rnd, qrnd, ("int8",), spack, flush,
                        only)
    for label, shape in (F32_WIDE_RANK.items()
                         if "branched_matmul_q" in only else ()):
        _check_branched(add_path("f32_wide", {"branched_matmul_q"}), label,
                        shape, 8, "float32", rnd, qrnd, ("int8",), spack,
                        flush, only)
    for label, shape in (HUBERT_BRANCHED_SHAPES.items()
                         if "branched_matmul" in only else ()):
        _check_branched(add_path("hubert", {"branched_matmul"}), label,
                        shape, HUBERT_M, "bfloat16", rnd, qrnd, (), spack,
                        flush, only)
    for label, shape in HUBERT_LOWRANK_SHAPES.items():
        add("lowrank_matmul", lambda: dict(_lowrank_row(
            label, rnd(HUBERT_M, shape[0], dtype=bf), shape, "bfloat16", rnd,
            flush, plans=False), path="hubert"))
    for label, (path, shape, m) in F32_LOWRANK_ROWS.items():
        add("lowrank_matmul", lambda: dict(_lowrank_row(
            label, rnd(m, shape[0]), shape, "float32", rnd, flush,
            plans=False), path=path))
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
    for label, (key, (n, c, r, s)) in TRAIN_FAMILY_ROWS.items():
        spec = TRAIN_FAMILY_RUNS[key]
        add("branched_matmul", lambda: dict(_train_row(
            "branched_matmul", label, (
                rnd(spec["batch"] * spec["seq"], c, dtype=bf),
                rnd(n, c, r, scale=c ** -0.5, dtype=bf),
                rnd(n, r, r, scale=r ** -0.5, dtype=bf),
                rnd(n, r, s, scale=r ** -0.5, dtype=bf)), rnd, flush),
            family=key))
    for label, (key, (n, c, r, s)) in TRAIN_FAMILY_F32_ROWS.items():
        spec = TRAIN_FAMILY_RUNS[key]
        add("branched_matmul", lambda: dict(_train_row(
            "branched_matmul", label, (
                rnd(TRAIN_FAMILY_CHECK_BATCH * spec["seq"], c),
                rnd(n, c, r, scale=c ** -0.5), rnd(n, r, r, scale=r ** -0.5),
                rnd(n, r, s, scale=r ** -0.5)), rnd, flush),
            family=key, path="train_f32"))
    f32 = torch.float32
    for label, (c, r, s) in RESNET_FC.items():
        for m in RESNET_FC_M:
            x = rnd(m, c)
            add("lowrank_matmul", lambda: dict(_lowrank_row(
                label, x, (c, r, s), "float32", rnd, flush, plans=False),
                path="resnet"))
            if label != "fc r335" or "lowrank_matmul_q" not in only:
                continue
            w0q, w0s = qrnd(c, r, mode="int8")
            w1q, w1s = qrnd(r, s, mode="int8")
            args = (x, w0q, w0s, w1q, w1s)
            y = lqk.lowrank_matmul_q(*args)
            want = ref.lowrank_matmul_q_ref(*args)
            torch.cuda.synchronize()
            w0d, w1d = dq(w0q, w0s, f32), dq(w1q, w1s, f32)
            add("lowrank_matmul_q", lambda: dict(
                shape=label, dtype="float32", qmode="int8", M=m, C=c, R=r,
                S=s, path="resnet", **_compare(y, want, "float32"),
                **_lowrank_times("lowrank_matmul_q", args, y,
                                 lambda: (x @ w0d) @ w1d, "float32", flush,
                                 False),
                plain_ms=time_ms(lambda: ref.lowrank_matmul_q_ref(*args)),
                **_cost_bound("lowrank_matmul_q", args, "tf32x3")))
    sweep = _large_m_sweep(rnd, card, only)
    bkm = kernel_module("branched_matmul")
    least = {name: bkm.LARGE_M_Q if name.endswith("_q") else bkm.LARGE_M
             for name in sweep}
    failures = [(name, label, m, t) for name, shapes in sweep.items()
                for label, ms in shapes.items() for m, t in ms.items()
                if int(m) >= least[name] and t["large_m"] >= t["split"]]
    for name, rs in rows.items():
        for row in rs:
            ok = (row["norm_err"] <= KERNEL_TOL[row["dtype"]]
                  and row.get("same_bits", True)
                  and row.get("prev_err", 0.0) <= KERNEL_TOL[row["dtype"]]
                  and row.get("differing", 0) == 0
                  and row.get("differing_prev", 0) == 0
                  and row.get("grad_err", 0.0) <= KERNEL_TOL[row["dtype"]]
                  and row.get("equal_to_unquantized", True)
                  and (row.get("form") not in ("large_m", "f32")
                       or (row["prev_ms"] is None
                           and bool(row.get("prev_refused")))
                       or row["ms"] < row["prev_ms"]))
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
                + (f"form={row['form']} " if "form" in row else "")
                + (f"dq_us={row['dq_us']:.1f} "
                   if row.get("dq_us") is not None else "")
                + (f"equal_to_unquantized={row['equal_to_unquantized']} "
                   if "equal_to_unquantized" in row else "")
                + ("prev_refused " if row.get("prev_refused") else "")
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
                         f"with its own first call, or B3 / B4 with B1 / B2 "
                         f"on the dequantized factors, or a large-M or f32 "
                         f"call is not faster than the form it replaced): "
                         f"{failures}")
    entries = _kernel_entries(rows)
    for entry in entries:
        if entry["name"] in sweep:
            entry.update(large_m=least[entry["name"]],
                         large_m_source=LARGE_M_SOURCE,
                         large_m_sweep=sweep[entry["name"]])
    return entries


def _large_m_sweep(rnd, card: str, only) -> dict:
    """The LARGE_M sweep: bf16 B1 / B2 and B3 / B4 with int8 factors
    (those in ``only``) at every shape of :data:`LARGE_M_SWEEP` and M of
    :data:`LARGE_M_SWEEP_M`, the large-M form and the split-phase form
    (both uncounted, forced) timed in turns (large, split, split, large;
    device ms with the host kept ahead), keyed kernel -> shape -> M."""
    import torch
    from repro_torch.quant.quantize import quantize_array
    bf = torch.bfloat16
    out = {}
    for name, shapes in LARGE_M_SWEEP.items():
        if name not in only:
            continue
        mod = kernel_module(name)
        large = getattr(mod, "large_m_" + name)
        split = getattr(mod, "split_" + name)
        quant = name.endswith("_q")
        out[name] = {}
        for label, shape in shapes.items():
            if len(shape) == 3:
                c, r, s = shape
                ws = (rnd(c, r, scale=c ** -0.5, dtype=bf),
                      rnd(r, s, scale=r ** -0.5, dtype=bf))
            else:
                n, c, r, s = shape
                ws = (rnd(n, c, r, scale=c ** -0.5, dtype=bf),
                      rnd(n, r, r, scale=r ** -0.5, dtype=bf),
                      rnd(n, r, s, scale=r ** -0.5, dtype=bf))
            if quant:
                ws = tuple(t for w in ws
                           for t in quantize_array(w.float(), "int8"))
            row = {}
            for m in LARGE_M_SWEEP_M:
                x = rnd(m, c, dtype=bf)
                t = [time_ms(lambda f=f: f(x, *ws), ahead=True)
                     for f in (large, split, split, large)]
                row[str(m)] = {"large_m": (t[0] + t[3]) / 2,
                               "split": (t[1] + t[2]) / 2}
            out[name][label] = row
            log(f"large_m sweep {name:16s} {label:16s} " + " ".join(
                f"M={m}:{v['large_m']:.4f}/{v['split']:.4f}"
                for m, v in row.items()) + f" (ms large_m/split) [{card}]")
    return out


def _split_times(kernel, prev, phases, library, flush, dname: str) -> dict:
    """Times of one branched chain row (B2, B4 or B12) beside its cuBLAS
    chain ``library``.  bf16 runs the split-phase ``kernel``: timed in
    turns with ``prev``, the cluster kernel (the earlier design; new, old,
    old, new: ``prev_ms``), its phase timer read (``phase_us``, the
    fastest of five launches of ``phases()``) and a second call held to
    the first's bits (``same_bits``).  f32 runs the cluster kernel (f32
    B12; f32 B2 and B4 take the f32 form instead: :func:`_branched_row`,
    :func:`_branched_q_times`).
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
    """One branched_matmul row in the form :func:`chain_form` names:
    bf16 below LARGE_M the split-phase kernel (:func:`_split_times`); at
    or past it the large-M form, timed in turns with the split form
    forced; f32 the f32 form, timed in turns with the cluster kernel
    (the earlier f32 kernel: ``prev_ms``, ``prev_err``), its bound's
    operations at the split-TF32 peak ("tf32x3")."""
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
    kernel = lambda: bk.branched_matmul(x, u, xc, v)  # noqa: E731
    library = lambda: torch.bmm(torch.bmm(torch.bmm(  # noqa: E731
        xb3, u), xc), v).sum(0)
    form = bk.chain_form(x.dtype, m)
    if form in ("large_m", "f32"):
        prev = (  # noqa: E731
            (lambda: bk.split_branched_matmul(x, u, xc, v))
            if form == "large_m" else
            (lambda: bk.cluster_branched_matmul(x, u, xc, v)))
        times = dict(form=form,
                     prev_err=_compare(y, prev(), dname)["norm_err"],
                     **_attention_times(kernel, prev, library, flush))
    else:
        times = _split_times(
            kernel, lambda: bk.cluster_branched_matmul(x, u, xc, v),
            lambda: bk.branched_matmul_phase_us(x, u, xc, v), library,
            flush, dname)
        if dname == "bfloat16":
            times["form"] = "split"
    return dict(
        shape=label, dtype=dname, M=m, N=n, C=c, r=r, S=s,
        **_compare(y, want, dname), **times,
        plain_ms=time_ms(lambda: ref.branched_matmul_ref(x, u, xc, v)),
        **_cost_bound("branched_matmul", (x, u, xc, v),
                      "tf32x3" if form == "f32" else dname))


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
    x = rnd(m, c, dtype=dt)
    u = rnd(n, c, r, scale=c ** -0.5, dtype=dt)
    xc = rnd(n, r, r, scale=r ** -0.5, dtype=dt)
    v = rnd(n, r, s, scale=r ** -0.5, dtype=dt)
    add("branched_matmul", lambda: _branched_row(label, x, u, xc, v, dname,
                                                 flush))
    xb3 = x.expand(n, m, c)
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
            **_branched_q_times(
                args, y, lambda: torch.bmm(torch.bmm(torch.bmm(xb3, ud),
                                                     xcd), vd).sum(0),
                flush, dname),
            plain_ms=time_ms(lambda: ref.branched_matmul_q_ref(*args)),
            **_cost_bound("branched_matmul_q", args, _q_peak(dname))))
        del ud, xcd, vd
        add("branched_matmul_sq", lambda: _check_sq(
            label, x, [spack(n, c, r, mode=mode), qs[1],
                       spack(n, r, s, mode=mode)], dname, flush))


def _quant_form_extras(name: str, args: tuple, y, form: str) -> dict:
    """What a B3 / B4 row (the wrapper ``name`` on ``args``, output ``y``)
    in the large-M or the f32 form adds: ``dq_us``, the dequantizing pass
    of the call's form alone (us, host ahead; None where the form runs
    none), and ``equal_to_unquantized``, whether ``y`` is bit-equal to B1
    / B2 in the same form on the factors dequantized beforehand."""
    import torch
    from repro_torch.kernels import ref
    mod = kernel_module(name)
    dq = getattr(mod, "dequant_" + name)
    ran = dq(*args) is not None
    x = args[0]
    dense = [ref._dq(q, sc, x.dtype) for q, sc in zip(args[1::2],
                                                      args[2::2])]
    base = name[:-2]
    bmod = kernel_module(base)
    same = getattr(bmod, ("large_m_" if form == "large_m" else "") + base)
    return dict(dq_us=(time_ms(lambda: dq(*args), ahead=True) * 1e3
                       if ran else None),
                equal_to_unquantized=torch.equal(y, same(x, *dense)))


def _branched_q_times(args: tuple, y, library, flush, dname: str) -> dict:
    """Times of one B4 row in the form :func:`chain_form` names: bf16
    below LARGE_M_Q the split-phase kernel (:func:`_split_times`); at or
    past it the large-M form, timed in turns with the split form forced
    (``prev_ms``, ``prev_err``); f32 the f32 form, timed in turns with the
    cluster kernel (the earlier f32 kernel; ``prev_refused`` where it
    refuses the ranks), both with :func:`_quant_form_extras`."""
    bqk = kernel_module("branched_matmul_q")
    x = args[0]
    form = kernel_module("branched_matmul").chain_form(
        x.dtype, x.shape[0], quantized=True)
    kernel = lambda: bqk.branched_matmul_q(*args)  # noqa: E731
    if form == "split":
        return dict(_split_times(
            kernel, lambda: bqk.cluster_branched_matmul_q(*args),
            lambda: bqk.branched_matmul_q_phase_us(*args), library, flush,
            dname), form=form)
    prev = (bqk.split_branched_matmul_q if form == "large_m"
            else bqk.cluster_branched_matmul_q)
    try:
        prev_err = _compare(y, prev(*args), dname)["norm_err"]
        refused = None
    except ValueError as e:  # the cluster kernel's 4-row block too large
        prev_err, refused = None, str(e)
    times = dict(form=form, **_attention_times(
        kernel, None if refused else (lambda: prev(*args)), library, flush),
        **_quant_form_extras("branched_matmul_q", args, y, form))
    if refused:
        times["prev_refused"] = refused
    else:
        times["prev_err"] = prev_err
    return times


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
        dims = dict(N=n, C=c, r=r, S=s)
    del dense
    top = int((packs[0][1][..., 0, :, 0] == 2).sum().item())
    return dict(shape=label, dtype=dname, qmode=qmode, M=m, **dims,
                top_groups=top, **_compare(y, want, dname), **times,
                plain_ms=time_ms(lambda: plain(*args)),
                library="cuBLAS chain on factors expanded beforehand",
                **_cost_bound(name, args, dname))


def _lowrank_row(label: str, x, shape: tuple, dname: str, rnd, flush,
                 plans: bool) -> dict:
    """One B1 row: ``x`` (M, C) through random factors of ``shape`` (C, R,
    S) against the plain version, with :func:`_lowrank_times`."""
    import torch
    from repro_torch.kernels import ref
    c, r, s = shape
    m, dt = x.shape[0], x.dtype
    w0 = rnd(c, r, scale=c ** -0.5, dtype=dt)
    w1 = rnd(r, s, scale=r ** -0.5, dtype=dt)
    y = kernel_module("lowrank_matmul").lowrank_matmul(x, w0, w1)
    want = ref.lowrank_matmul_ref(x, w0, w1)
    torch.cuda.synchronize()
    return dict(
        shape=label, dtype=dname, M=m, C=c, R=r, S=s,
        **_compare(y, want, dname),
        **_lowrank_times("lowrank_matmul", (x, w0, w1), y,
                         lambda: (x @ w0) @ w1, dname, flush, plans),
        plain_ms=time_ms(lambda: ref.lowrank_matmul_ref(x, w0, w1)),
        **_cost_bound("lowrank_matmul", (x, w0, w1),
                      "tf32x3" if dname == "float32" else dname))


def _lowrank_q_row(label: str, x, shape: tuple, dname: str, qrnd, flush,
                   mode: str = "int8") -> dict:
    """One B3 row: ``x`` (M, C) through random factors of ``shape`` (C,
    R, S) quantized as the engine quantizes them (``qrnd``), against the
    plain version, with :func:`_lowrank_times` (the yardstick: the cuBLAS
    chain on factors dequantized beforehand)."""
    import torch
    from repro_torch.kernels import ref
    c, r, s = shape
    m, dt = x.shape[0], x.dtype
    w0q, w0s = qrnd(c, r, mode=mode)
    w1q, w1s = qrnd(r, s, mode=mode)
    args = (x, w0q, w0s, w1q, w1s)
    y = kernel_module("lowrank_matmul_q").lowrank_matmul_q(*args)
    want = ref.lowrank_matmul_q_ref(*args)
    torch.cuda.synchronize()
    w0d = (w0q.to(torch.float32) * w0s).to(dt)
    w1d = (w1q.to(torch.float32) * w1s).to(dt)
    return dict(
        shape=label, dtype=dname, qmode=mode, M=m, C=c, R=r, S=s,
        **_compare(y, want, dname),
        **_lowrank_times("lowrank_matmul_q", args, y,
                         lambda: (x @ w0d) @ w1d, dname, flush, False),
        plain_ms=time_ms(lambda: ref.lowrank_matmul_q_ref(*args)),
        **_cost_bound("lowrank_matmul_q", args, _q_peak(dname)))


def _lowrank_times(name: str, args: tuple, y, library, dname: str, flush,
                   plans: bool) -> dict:
    """Times of a lowrank chain row (B1, B3 or B11, the wrapper ``name``
    on ``args``, whose output was ``y``) beside its cuBLAS chain
    ``library``, by :func:`_attention_times`: bf16 runs the two-phase
    split kernel, timed in turns with the cluster kernel (the earlier
    design, ``prev_ms``), held to it (``prev_err``) and its phase timer
    read (``phase_us``, the fastest of five launches), with ``plans`` the
    times of the plans of :data:`LOWRANK_PLAN_SWEEP` (``plan_us``); f32
    B11 runs the cluster kernel.  A bf16 B1 / B3 call of M >= LARGE_M /
    LARGE_M_Q runs the large-M form (``form``), timed in turns with the
    split kernel forced (``prev_ms``, ``prev_err``), without a phase
    timer; an f32 B1 / B3 call the f32 form, timed in turns with the cluster kernel; B3's
    rows in these forms add :func:`_quant_form_extras`."""
    mod = kernel_module(name)
    fn = getattr(mod, name)
    bf16 = dname == "bfloat16"
    form = (kernel_module("branched_matmul").chain_form(
        args[0].dtype, args[0].shape[0], quantized=name.endswith("_q"))
        if name in ("lowrank_matmul", "lowrank_matmul_q") else None)
    large = form == "large_m"
    prev = getattr(mod, ("split_" if large else "cluster_") + name)
    times = dict(prev_err=_compare(y, prev(*args), dname)["norm_err"],
                 **_attention_times(lambda: fn(*args),
                                    (lambda: prev(*args))
                                    if bf16 or form == "f32" else None,
                                    library, flush))
    if form is not None:
        times["form"] = form
    if name == "lowrank_matmul_q" and form != "split":
        times.update(_quant_form_extras(name, args, y, form))
    if bf16 and not large:
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
    """One B1 (three ``args``) or B2 (four) row at the training M, in the
    dtype of ``args`` (bf16; f32 for the families whose check step runs
    f32): the kernel against its plain version; its times with the host
    kept ahead of the card, with a cold L2 and between events, beside the
    cuBLAS chain (:func:`_attention_times`; at M >= LARGE_M the large-M
    form, timed in turns with the split form forced: ``prev_ms``; f32 the
    f32 form, timed in turns with the cluster kernel); the
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
    mod = kernel_module(name)
    fn = getattr(mod, name)
    plain = getattr(ref, name + "_ref")
    x = args[0]
    m, c = x.shape
    dname = "float32" if x.dtype == torch.float32 else "bfloat16"
    form = kernel_module("branched_matmul").chain_form(x.dtype, m)
    prev = (getattr(mod, "split_" + name) if form == "large_m" else
            getattr(mod, "cluster_" + name) if form == "f32" else None)
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
    g = rnd(m, s, dtype=x.dtype)
    ins = [a.detach().clone().requires_grad_(True) for a in args]
    got = torch.autograd.grad(fwd.apply(*ins), ins, g)
    pins = [a.detach().clone().requires_grad_(True) for a in args]
    ref_g = torch.autograd.grad(plain(*pins), pins, g)
    errs = {k: _compare(a, b, dname)["norm_err"]
            for k, a, b in zip(names, got, ref_g)}
    del ins, pins, got, ref_g
    every = (True,) * len(args)
    extra = ({} if prev is None else
             dict(prev_err=_compare(y, prev(*args), dname)["norm_err"]))
    return dict(shape=label, dtype=dname, M=m, **dims, path="train",
                form=form, **_compare(y, want, dname), **extra,
                **_attention_times(lambda: fn(*args),
                                   prev and (lambda: prev(*args)), library,
                                   flush),
                grad_err=max(errs.values()), grad_errs=errs,
                bwd_ms=time_ms(lambda: bwd(g, *args, needs=every),
                               ahead=True),
                bwd_frozen_ms=time_ms(lambda: bwd(g, *args, needs=frozen),
                                      ahead=True),
                plain_ms=time_ms(lambda: plain(*args)),
                **_cost_bound(name, args,
                              "tf32x3" if form == "f32" else dname))


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
                **_cost_bound("decode_attention_latent_q", args, dname))


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
    # the positions from a seeded generator: a row's bound (its live
    # positions) is the same in every run
    pos = torch.randint(s // 2, s, (b,), device="cuda", dtype=torch.int32,
                        generator=torch.Generator(device="cuda")
                        .manual_seed(b * s + kh * d))
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
                **_cost_bound("decode_attention_q", args, dname))


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
                **_cost_bound(name, args, "int8"))


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
                **_cost_bound(name, args, dname))


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


def _q_peak(dname: str) -> str:
    """The peak a B3 / B4 row's bound takes: f32 calls run the f32 form,
    split TF32 ("tf32x3"), as f32 B1 / B2 do; bf16 calls bf16's."""
    return "tf32x3" if dname == "float32" else dname


def _cost_bound(name: str, args: tuple, peak: str) -> dict:
    """:func:`_bound` of one call of kernel ``name`` on ``args`` (its
    entry point's argument order): the bytes and operations of
    ``analysis/roofline.py::kernel_cost``, the attentions' at the
    positions this run's ``cache_pos`` (and block tables) reach."""
    from repro_torch.analysis.roofline import kernel_cost_of
    flops, nbytes = kernel_cost_of(name, args)
    return _bound(nbytes, flops, peak)


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
        search = SEARCH_LAUNCHES.get(name, {})
        srows = {label: next((r for r in rs if r["shape"] == label
                              and r["M"] == 8 and r["dtype"] == "bfloat16"),
                             None) for label in search}
        if search and None not in srows.values():
            extra["search_path"] = {
                k: sum(n * srows[label][k] for label, n in search.items())
                for k in timed}
            extra["search_path"].update(
                launches=None,
                timed_as=f"the {sum(search.values())} launches of one decode "
                "step (M=8, bf16) of the searched tree (rank_mode='search', "
                "branches=4); launches: the serve_search run")
        ssm = SSM_LAUNCHES.get(name, {})
        ssm_rows = {label: next((r for r in rs if r["shape"] == label
                                 and r.get("M", 8) == 8
                                 and r["dtype"] == "bfloat16"), None)
                    for label in ssm}
        if ssm and None not in ssm_rows.values():
            extra["ssm_path"] = {
                k: sum(n * ssm_rows[label][k] for label, n in ssm.items())
                for k in timed}
            extra["ssm_path"].update(
                launches=sum(ssm.values()),
                timed_as=f"the {sum(ssm.values())} launches of one decode "
                "step (M=8, bf16) of the "
                + ("8-layer mamba2 tree" if name == "branched_matmul"
                   else "14-layer zamba2 tree (int8 factors, int8 pool)"))
        for path, spec, m_path, what in (
                ("vlm", VLM_LAUNCHES, 8, "one decode step (M=8, bf16) of "
                 "the 5-layer llama-3.2-vision tree (int8 factors and the "
                 "int8 slot pool for the _q kernels and B5); launches: the "
                 "serve_vlm / serve_vlm_q run"),
                ("hubert", HUBERT_LAUNCHES, HUBERT_M,
                 f"one forward (M={HUBERT_M}, bf16) of the 48-layer "
                 "hubert-xlarge tree; launches: per forward of the "
                 "infer_hubert run")):
            counts = spec.get(name, {})
            prows = {label: next((r for r in rs if r["shape"] == label
                                  and r.get("M", m_path) == m_path
                                  and r["dtype"] == "bfloat16"
                                  and r.get("qmode", "int8") == "int8"),
                                 None) for label in counts}
            if not counts or None in prows.values():
                continue
            entry = {k: (None if any(prows[lb].get(k) is None
                                     for lb in counts)
                         else sum(n * prows[lb][k]
                                  for lb, n in counts.items()))
                     for k in timed}
            entry.update(launches=None, timed_as=f"the "
                         f"{sum(counts.values())} launches of {what}")
            forms = {prows[lb].get("form") for lb in counts} - {None}
            if forms:
                entry["form"] = sorted(forms)
            cross = next((r for r in rs if r.get("path") == "vlm"
                          and r.get("M") == VLM_CROSS_M), None)
            if path == "vlm" and cross is not None:
                entry["cross_kv"] = dict(
                    {k: cross.get(k) for k in (
                        "form", "ms", "prev_ms", "dq_us",
                        "equal_to_unquantized", "cold_ms", "event_ms",
                        "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "max_abs_err", "norm_err")},
                    launches_per_prefill=2, M=VLM_CROSS_M,
                    timed_as="one launch: the cross block's k or v over "
                    "the 1,601 image tokens of a prefill")
            extra[f"{path}_path"] = entry
        form32 = ("the f32 form" if name in (
            "lowrank_matmul", "branched_matmul", "lowrank_matmul_q",
            "branched_matmul_q") else "the cluster kernel")
        for path, what in (
                ("vlm_f32", "at the VLM's per-branch ranks 768 / 960 "
                 "(B2 / B4) and its cross k / v over the 1,601 image "
                 "tokens (B1); launches: check_vlm's f32 card run"),
                ("f32_wide", "at per-branch ranks (1600, 1600), which the "
                 "cluster kernel refuses (prev_refused); launches: none "
                 "on a served path"),
                ("hubert_f32", "at hubert's q,k,v,o over one clip of 500 "
                 "frames; launches: check_hubert's f32 card run"),
                ("resnet", "at the fc of the resnet50 "
                 + ("int8 vanilla tree" if name.endswith("_q") else
                    "vanilla (r335) and searched (r256) trees")
                 + ": M=32 a batch-32 forward or fine-tune step, M=1 a "
                 "batch-1 forward; launches: per forward of the "
                 "infer_resnet run")):
            prs = [r for r in rs if r.get("path") == path]
            if not prs:
                continue
            extra[f"{path}_path"] = {
                f"{r['shape']} M={r['M']}": dict(
                    {k: r.get(k) for k in (
                        "form", "ms", "prev_ms", "prev_err", "same_bits",
                        "plain_ms", "library_ms", "bound_ms", "bound_by",
                        "peak", "max_abs_err", "norm_err", "cold_ms",
                        "event_ms")},
                    launches=None)
                for r in prs}
            if form32 == "the f32 form":
                extra[f"{path}_path"]["source"] = (
                    "src/repro_torch/kernels/csrc/chain_f32.cu")
            extra[f"{path}_path"]["timed_as"] = (
                f"one launch of {form32}, f32 activations "
                + ("and int8 factors " if name.endswith("_q") else "")
                + f"(TF32 off; prev_ms: the cluster kernel), {what}")
        prs = [r for r in rs if r.get("path") == "vlm_prefill"]
        if prs:
            extra["vlm_prefill_path"] = {
                r["shape"]: {k: r.get(k) for k in (
                    "M", "form", "ms", "prev_ms", "prev_err", "dq_us",
                    "equal_to_unquantized", "same_bits", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "max_abs_err",
                    "norm_err", "cold_ms", "event_ms")} for r in prs}
            extra["vlm_prefill_path"].update(
                source=f"{LARGE_M_SOURCE} + src/repro_torch/kernels/csrc/"
                "chain_dequant.cu", launches=None, timed_as=(
                    f"one launch of the large-M form at M={VLM_PREFILL_M}, "
                    "the int8 VLM's blocking prefill of its largest prompt "
                    "(bf16, int8 factors written as bf16 by the "
                    "dequantizing pass, dq_us; prev_ms: the split form "
                    "forced); launches: 8 B3 k,v / 10 q,o, 10 gate,up, 5 "
                    "down B4 of the 36 a prefill of the serve_vlm_q run"))
        trows = [r for r in rs if r.get("path") == "train"
                 and "family" not in r]
        frows = [r for r in rs if "family" in r]
        if frows:
            extra["train_family_path"] = {
                r["shape"]: dict(
                    {k: r.get(k) for k in (
                        "dtype", "M", "form", "ms", "prev_ms", "prev_err",
                        "same_bits", "cold_ms", "event_ms", "plain_ms",
                        "library_ms", "bound_ms", "bound_by", "peak",
                        "bwd_ms", "bwd_frozen_ms", "grad_err",
                        "max_abs_err", "norm_err")}, family=r["family"],
                    launches=None) for r in frows}
            extra["train_family_path"]["timed_as"] = (
                "one launch at the family's widest chain shape and its "
                "training M (bf16), with its backward products; launches: "
                "the kernel's forwards per step of the train_<family> run; "
                "the (train, f32) rows at the f32 check step's M, through "
                "the f32 form (prev_ms: the cluster kernel); launches: that "
                "check step's f32 card run")
        if trows:
            tkeys = ("ms", "prev_ms", "plain_ms", "library_ms", "bound_ms",
                     "cold_ms", "library_cold_ms", "event_ms",
                     "library_event_ms", "bwd_ms", "bwd_frozen_ms")
            by_label = {label: next(r for r in trows if r["shape"] == label)
                        for label in TRAIN_LAUNCHES[name]}
            extra["train_path"] = {
                k: None if any(r[k] is None for r in by_label.values())
                else sum(n * by_label[label][k]
                         for label, n in TRAIN_LAUNCHES[name].items())
                for k in tkeys}
            extra["train_path"]["form"] = sorted(
                {r["form"] for r in by_label.values()})
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


def decompose(params, axes, branches: int, **lrd_kw):
    """The LRD surgery of the serve phases (``LRD`` with ``lrd_kw`` over
    it) on the card; returns (lrd, tree, report, seconds)."""
    import torch
    from repro_torch.configs.base import LRDConfig
    from repro_torch.core.surgery import decompose_model
    lrd = LRDConfig(**{**LRD, **lrd_kw}, branches=branches)
    t0 = time.perf_counter()
    with torch.inference_mode():
        p2, _, rep = decompose_model(params, axes, lrd)
    torch.cuda.synchronize()
    return lrd, p2, rep, time.perf_counter() - t0


def chain_launches(rep, shared: int = 1) -> dict[str, int]:
    """Chain-kernel launches per model segment that a surgery report
    implies: one per layer of every stacked SVD pair (B1) and branched
    linear (B2), one for an unstacked one (``shared`` for the hybrid's
    shared block, once per invocation); none for a routed expert bank
    (``moe_*``: plain batched products)."""
    out = {"lowrank_matmul": 0, "branched_matmul": 0}
    kernel = {"svd": "lowrank_matmul", "branched": "branched_matmul"}
    for d in rep.decisions:
        if d.kind in kernel and not d.label.startswith("moe_"):
            out[kernel[d.kind]] += (
                d.shape[0] if len(d.shape) == 3
                else shared if d.path.startswith("shared_attn/") else 1)
    return out


def rank_search(card: str, seed: int) -> list[dict]:
    """The search phase: for each of llama3.2-1b's linear shapes at each
    row count of :data:`SEARCH_M`, the rank that ``select_rank``'s search
    takes on the H100 cost model (as the surgery runs it) and the rank
    that :func:`algorithm1` takes on the timer measured on the card (bf16,
    CUDA events, the factors out of L2 before every call; twice, from
    other seeds: the measured search is noisy), and once more on the
    timer that leaves them in L2 (``cold=False``, for comparison); each
    timer's t(r) at those ranks, at the aligned and at the ratio rank;
    the measured t(r) of the chosen and the aligned rank from five fresh
    timers (the spread); and each search's own seconds.  Every rank must
    lie in the searched range [r_min, r_start] or be ORG.  The whole
    measured curves go to build/search_curves.json."""
    import torch
    from repro_torch.core import cost_model as cm
    from repro_torch.core import rank_selection as rs
    from repro_torch.core.svd import ratio_rank
    bf = torch.bfloat16
    rows, curves = [], {}
    for label, (c, s) in SEARCH_SHAPES.items():
        r0 = ratio_rank(c, s, LRD["compression"])
        start, r_min, step = rs.search_plan(r0)
        aligned = rs.align_rank(r0, LRD["rank_align"])
        for m in SEARCH_M:
            t0 = time.perf_counter()
            model_rank = rs.select_rank(c, s, compression=LRD["compression"],
                                        mode="search", m_tokens=m)
            model_s = time.perf_counter() - t0
            model_t = cm.make_model_timer(m, c, s)
            runs = []
            for run, cold in ((0, True), (1, True), (0, False)):
                t0 = time.perf_counter()
                timer = cm.make_measured_timer(m, c, s, dtype=bf,
                                               seed=seed + run, cold=cold)
                t_dense = cm.measured_dense_time(m, c, s, dtype=bf,
                                                 seed=seed + run, cold=cold)
                dec = rs.algorithm1(timer, t_dense, start, r_min, step=step)
                runs.append((dec, timer, time.perf_counter() - t0))
            (dec, timer, _), warm = runs[0], runs.pop()
            at = {"model": model_rank, "measured": dec.rank,
                  "aligned": aligned, "ratio": r0}
            us = lambda t, r: None if r == rs.ORG else t(r) * 1e6  # noqa
            spread = {k: sorted(cm.make_measured_timer(
                m, c, s, dtype=bf, seed=seed + 10 + i)(r) * 1e6
                for i in range(5))
                for k, r in (("measured", dec.rank), ("aligned", aligned))
                if r != rs.ORG}
            row = {"shape": label, "C": c, "S": s, "M": m,
                   "r_range": [r_min, start], "step": step,
                   "model_rank": model_rank,
                   "measured_ranks": [d.rank for d, _, _ in runs],
                   "model_us": {k: us(model_t, r) for k, r in at.items()},
                   "measured_us": {k: us(timer, r) for k, r in at.items()},
                   "warm_rank": warm[0].rank,
                   "warm_us": {k: us(warm[1], r) for k, r in at.items()},
                   "dense_us": {"model": cm.make_dense_time(m, c, s) * 1e6,
                                "measured": dec.t_dense * 1e6,
                                "warm": warm[0].t_dense * 1e6},
                   "spread_us": spread,
                   "search_s": {"model": model_s,
                                "measured": [t for _, _, t in runs],
                                "warm": warm[2]},
                   "card": card}
            log("search " + json.dumps(row))
            rows.append(row)
            curves[f"{label} M={m}"] = [
                {str(r): t(r) * 1e6 for r in d.searched}
                for d, t, _ in (*runs, warm)]
            for r in (model_rank, *row["measured_ranks"], warm[0].rank):
                if r != rs.ORG and not r_min <= r <= start:
                    raise SystemExit(f"search: rank {r} of {label} at M={m} "
                                     f"outside [{r_min}, {start}]")
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "search_curves.json").write_text(json.dumps(
        {"card": card, "timed_as": "t(r) in us of (x @ w0) @ w1, bf16, "
         "CUDA events around each of 5 calls after a warm-up, host ahead; "
         "two runs with the L2 flushed before every call, then one "
         "without the flush",
         "curves": curves}))
    return rows


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


def fresh_peak() -> int:
    """Collect the garbage of earlier phases, return the card's memory
    to the allocator and reset its peak; returns the bytes the
    collection freed (0 where no earlier phase left a tree in a
    reference cycle), so a phase's ``max_memory_allocated`` holds none
    of another phase's trees."""
    import gc
    import torch
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return before - torch.cuda.memory_allocated()


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

    freed = fresh_peak()
    at_start = torch.cuda.memory_allocated()
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
    # the counting wrapper closes over the engine: drop it, so the engine
    # and its trees go when this returns, without waiting for a GC pass
    del eng.runner.step
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
    #: the pool's recurrent state (SSM / hybrid), read and written whole
    #: by every decode step
    state = [leaf for top in eng.pool.cache.values()
             for n, leaf in top.items() if n in eng.model.state_leaves(1)]
    res = {**{k: engine_kw.get(k, "none")
              for k in ("quantize", "sparsify", "kv_quantize",
                        "act_quantize")},
           "kv_layout": eng.kv_layout, "requests": n_req, "new_tokens": new_tokens,
           "outputs": [r.output for r in reqs],
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
           "allocated_at_start": at_start, "freed_at_start": freed,
           "kv_bytes_per_step": eng.plan_summary["kv_bytes_per_step"],
           "state_bytes": sum(t.numel() * t.element_size() for t in state),
           "weight_bytes": eng.plan_summary["weight_bytes"],
           "quant_bytes": eng.plan_summary["quant_bytes"],
           "kv_cache_family": eng.plan_summary.get("kv_cache_family",
                                                   "none"),
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


# ---------------------------------------------------------------------------
# serve hardening and the router
# ---------------------------------------------------------------------------

#: the fault schedule of serve_faults (1-based consultations of each
#: point): NaN logits once on decode at slot 0, one corrupted int8 scale
#: row (the second stream landed), two refused slot allocations; one host
#: step slowed by 0.2 s three quarters into the run (the clean run's
#: segment count sets the index)
FAULT_SCHEDULE = dict(
    schedule={"nan_logits": [6], "block_scale": [2], "pool_alloc": [2, 3]},
    params={"nan_logits": {"seg": "decode", "slot": 0},
            "slow_step": {"seconds": 0.2}})
#: the dispatch (1-based entry-point consultation) the kernel_gate run
#: rejects: inside the first prefill chunk (112 dispatches)
GATE_AT = 50
#: serve_faults' engine: the bf16 tree over an int8 slot pool (B1 / B2 /
#: B5); serve_router's replicas: the bf16 tree over paged pools (B1 / B2
#: / B8)
FAULTS_SEGMENT = {"decode": {"lowrank_matmul": 32, "branched_matmul": 80,
                             "decode_attention_q": 16},
                  "prefill_chunk": {"lowrank_matmul": 32,
                                    "branched_matmul": 80}}
ROUTER_SEGMENT = {"decode": {"lowrank_matmul": 32, "branched_matmul": 80,
                             "decode_attention_paged": 16},
                  "prefill_chunk": {"lowrank_matmul": 32,
                                    "branched_matmul": 80}}


def _count_segments(eng, segs: list) -> None:
    """Wrap ``eng.runner.step`` to append ``(seg_kind, launches of every
    kernel)`` per model segment to ``segs`` (drop it with ``del
    eng.runner.step``)."""
    step = eng.runner.step

    def counted(tokens, positions, seg_kind, **kw):
        before = {k: launch_count(k) for k in KERNELS}
        out = step(tokens, positions, seg_kind, **kw)
        segs.append((seg_kind, {k: launch_count(k) - before[k]
                                for k in KERNELS}))
        return out
    eng.runner.step = counted


def _exact_segments(label: str, segs: list, expect: dict) -> dict:
    want = {kind: {k: counts.get(k, 0) for k in KERNELS}
            for kind, counts in expect.items()}
    wrong = [s for s in segs if s[1] != want[s[0]]]
    if wrong:
        raise SystemExit(f"{label}: segments launched other kernel counts "
                         f"than {want}: {wrong[:5]}")
    return {kind: sum(1 for s in segs if s[0] == kind) for kind in want}


def _engine_numbers(tp: dict) -> dict:
    inter = tp["per_class"]["interactive"]
    return {"decode_step_ms_mean": tp["decode_step_ms_mean"],
            "tokens_per_s": tp["tokens_per_s"],
            "itl_p99_ms": {p: c["itl_p99_ms"]
                           for p, c in tp["per_class"].items()},
            "ttft_p99_ms": inter["ttft_p99_ms"]}


def serve_faults(cfg, lrd, params, card: str, seed: int) -> dict:
    """The serve_faults phase: the bf16 tree over an int8 slot pool
    (B1 / B2 / B5), 8 greedy requests of 32-512 prompt and 32 new tokens,
    first clean, then with ``debug=True`` (the pool's integrity check
    after every step) under :data:`FAULT_SCHEDULE`, one request cancelled
    mid-flight and one with ``deadline_s=0``.  Every request must end
    with a status, at least one quarantined and one slow step, the pool
    empty after the drain, every survivor's stream the clean run's (a
    cut one's a prefix of it), every segment's launches exact; then a
    run whose ``kernel_gate`` rejects dispatch :data:`GATE_AT` must raise
    :class:`KernelRejected` with the earlier dispatches launched, that
    one not, and no plain version run."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.scheduler import STATUSES

    run = RunConfig(model=cfg, lrd=lrd)
    prompts = request_prompts(cfg, seed, 8, 32, 512)
    new = 32
    freed = fresh_peak()

    def engine(**kw):
        return ServeEngine(run, params, slots=8, max_seq=1024,
                           kv_quantize="int8", device="cuda", **kw)

    def requests():
        return [Request(uid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]

    out = {"card": card, "freed_at_start": freed}
    inj = None
    for label in ("clean", "faulted"):
        eng = engine(debug=label == "faulted", faults=inj)
        segs: list = []
        _count_segments(eng, segs)
        reqs = requests()
        if label == "faulted":
            reqs[7].deadline_s = 0.0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for r in reqs:
            eng.add_request(r)
        steps, cancelled = 0, None
        while eng.scheduler.busy():
            eng.step()
            steps += 1
            # cancel the newest stream that is decoding with 4 tokens
            live = [r for r in reqs if r.status is None
                    and len(r.output) >= 4]
            if label == "faulted" and cancelled is None and live:
                cancelled = live[-1].uid
                if not eng.cancel(cancelled):
                    raise SystemExit(f"serve_faults: cancel({cancelled}) "
                                     "found no request")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del eng.runner.step
        tp = eng.throughput()
        res = {"wall_s": wall, "steps": steps,
               "segments": _exact_segments(f"serve_faults {label}", segs,
                                           FAULTS_SEGMENT),
               "status_counts": tp["status_counts"],
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               **_engine_numbers(tp)}
        if label == "clean":
            if any(r.status != "finished" or len(r.output) != new
                   for r in reqs):
                raise SystemExit("serve_faults: the clean run did not "
                                 "finish every request")
            clean = {r.uid: r.output for r in reqs}
            sched = dict(FAULT_SCHEDULE["schedule"])
            sched["slow_step"] = [max(8, 3 * len(segs) // 4)]
            inj = FaultInjector(schedule=sched,
                                params=FAULT_SCHEDULE["params"])
        else:
            bad = [r.uid for r in reqs if r.status not in STATUSES]
            differ = [r.uid for r in reqs
                      if r.output != clean[r.uid][:len(r.output)]
                      or (r.status == "finished"
                          and r.output != clean[r.uid])]
            res.update(
                report=inj.report(), quarantined=tp["quarantined"],
                slow_steps=tp["slow_steps"], step_ewma_s=tp["step_ewma_s"],
                deadline_expired=tp["deadline_expired"],
                admit_failures=tp["admit_failures"], cancelled_uid=cancelled,
                integrity_checks=steps, used_bytes=eng.pool.used_bytes(),
                statuses={r.uid: r.status for r in reqs},
                survivors=sum(r.status == "finished" for r in reqs))
            if (bad or differ or tp["quarantined"] < 1
                    or tp["slow_steps"] < 1 or cancelled is None
                    or eng.pool.used_bytes() != 0
                    or reqs[7].status != "deadline_exceeded"
                    or not eng.pool.check_integrity()):
                raise SystemExit(
                    f"serve_faults: statuses {bad}, streams off the clean "
                    f"run {differ}, {json.dumps(res)}")
        out[label] = res
        del eng
    # the gate: one dispatch rejected, nothing launched for it, no plain
    # version run in its place
    plain = {n: 0 for n in dir(ref) if n.endswith("_ref")}
    saved = {n: getattr(ref, n) for n in plain}

    def counting(name):
        def call(*a, **kw):
            plain[name] += 1
            return saved[name](*a, **kw)
        return call
    eng = engine(faults=FaultInjector(schedule={"kernel_gate": [GATE_AT]}))
    eng.add_request(Request(uid=0, prompt=prompts[0], max_new_tokens=new))
    before = {k: launch_count(k) for k in KERNELS}
    for n in plain:
        setattr(ref, n, counting(n))
    try:
        eng.step()
        raise SystemExit("serve_faults: the kernel_gate did not raise")
    except ops.KernelRejected as e:
        rejected = e.kernel
    finally:
        for n, f in saved.items():
            setattr(ref, n, f)
    torch.cuda.synchronize()
    launched = {k: launch_count(k) - before[k] for k in KERNELS}
    out["kernel_gate"] = {"rejected": rejected, "at": GATE_AT,
                          "launched": {k: n for k, n in launched.items()
                                       if n},
                          "plain_calls": sum(plain.values()),
                          "report": eng.faults.report()}
    if (sum(launched.values()) != GATE_AT - 1 or any(plain.values())
            or ops.set_fault_injector(None) is not None):
        raise SystemExit(f"serve_faults: kernel_gate {out['kernel_gate']}")
    del eng
    log("serve_faults " + json.dumps(out))
    return out


def serve_router(cfg, lrd, params, card: str, seed: int) -> dict:
    """The serve_router phase: ``ServeRouter(replicas=2, devices=["cuda",
    "cuda"])`` over paged pools (B1 / B2 / B8), 12 greedy requests (8
    interactive, 4 batch; 32-512 prompt tokens, four of them on one
    256-token prefix, the last of those submitted once the first has a
    token; 32 new tokens) against one engine's run of the same requests.
    Once replica 0 has streams in flight its step raises: it must trip
    (``step_failures``) and be evacuated, every request finish with the
    single engine's stream, the radix hit, every segment's launches be
    exact, and both replicas serve one tree on the card with a pool
    each."""
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.router import ServeRouter

    run = RunConfig(model=cfg, lrd=lrd)
    kw = dict(slots=8, max_seq=1024, kv_layout="paged",
              kv_block_size=PAGED_BLOCK)
    prompts = request_prompts(cfg, seed, 12, 32, 512, shared=4)
    new, late = 32, 3
    freed = fresh_peak()

    def requests():
        return [Request(uid=i, prompt=p, max_new_tokens=new,
                        priority="batch" if i >= 8 else "interactive")
                for i, p in enumerate(prompts)]

    def drive(target, reqs, step, busy):
        for r in reqs:
            if r.uid != late:
                target.add_request(r)
        while not reqs[0].output:
            step()
        target.add_request(reqs[late])
        while busy():
            step()

    out = {"card": card, "freed_at_start": freed}
    eng = ServeEngine(run, params, device="cuda", **kw)
    one = requests()
    segs: list = []
    _count_segments(eng, segs)
    t0 = time.perf_counter()
    drive(eng, one, eng.step, eng.scheduler.busy)
    torch.cuda.synchronize()
    del eng.runner.step
    out["engine"] = {"wall_s": time.perf_counter() - t0,
                     "segments": _exact_segments("serve_router engine",
                                                 segs, ROUTER_SEGMENT),
                     **_engine_numbers(eng.throughput())}
    if any(r.status != "finished" for r in one):
        raise SystemExit("serve_router: the single engine did not finish")
    del eng
    torch.cuda.reset_peak_memory_stats()
    rt = ServeRouter(run, params, replicas=2, devices=["cuda", "cuda"],
                     slo_itl_ms=200.0, **kw)
    reps = rt.replicas
    leaf = [rep.engine.params["blocks"]["attn"]["k"]["w0"] for rep in reps]
    pools = [rep.engine.pool.cache["blocks"]["k"] for rep in reps]
    placed = {"tree_shared": leaf[0].data_ptr() == leaf[1].data_ptr(),
              "tree_on": str(leaf[1].device),
              "pools_on": [str(p.device) for p in pools],
              "pools_distinct": pools[0].data_ptr() != pools[1].data_ptr()}
    if not (placed["tree_shared"] and placed["pools_distinct"]
            and all(p.is_cuda for p in (*leaf, *pools))):
        raise SystemExit(f"serve_router: placement {placed}")
    segs = []
    for rep in reps:
        _count_segments(rep.engine, segs)
    two = requests()
    failed = {}

    def step():
        rt.step()
        sched = reps[0].engine.scheduler
        if not failed and (sched.prefilling or sched.live_slots()):
            failed["with_output"] = sum(
                bool(ps.req.output) for ps in sched.prefilling) + sum(
                bool(r and r.output) for r in sched.active)
            failed["in_flight"] = (len(sched.prefilling)
                                   + len(sched.live_slots()))
            reps[0].engine.step = lambda: (_ for _ in ()).throw(
                RuntimeError("replica 0 lost"))
    t0 = time.perf_counter()
    drive(rt, two, step, rt.busy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rep in reps:
        del rep.engine.runner.step
    tp = rt.throughput()
    differ = [r.uid for r, s in zip(two, one)
              if r.status != "finished" or r.output != s.output]
    prefix = reps[1].engine.pool.prefix_stats()
    out["router"] = {
        "wall_s": wall, "round_seconds": tp["round_seconds"],
        "rounds": tp["rounds"], "tokens_per_s": tp["tokens_per_s"],
        "itl_p99_ms": {p: c["itl_p99_ms"]
                       for p, c in tp["per_class"].items()},
        "segments": _exact_segments("serve_router", segs, ROUTER_SEGMENT),
        "failover": {**failed, "tripped": reps[0].guard.tripped,
                     "evacuated": reps[0].evacuated},
        "routed": [r["routed"] for r in tp["per_replica"]],
        "decode_step_ms_mean": [r["decode_step_ms_mean"]
                                for r in tp["per_replica"]],
        "prefix_stats": prefix, "placement": placed,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if (differ or reps[0].guard.tripped != "step_failures"
            or not reps[0].evacuated or prefix["prefix_block_hits"] <= 0):
        raise SystemExit(f"serve_router: streams off the engine's "
                         f"{differ}, {json.dumps(out['router'])}")
    log("serve_router " + json.dumps(out))
    return out


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


def _tree_to(tree, device: str, dtype=None):
    """A param (or gradient) tree on ``device``, its leaves in ``dtype``
    (``None``: their own) bar the int8 / e4m3 factors, which keep their
    storage; ``None`` leaves stay."""
    import torch
    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if tree is None:
        return None
    if tree.dtype in (torch.int8, torch.float8_e4m3fn):
        return tree.to(device)
    return tree.to(device, dtype)


def to_cpu_f32(tree):
    """A param (or gradient) tree on the CPU, float leaves widened to f32
    (int8 / e4m3 factors keep their storage, their f32 scales already
    are f32)."""
    import torch
    return _tree_to(tree, "cpu", torch.float32)


def cpu_reference(tree):
    """:func:`to_cpu_f32` with every int8 / fp8 and 2:4-packed factor
    restored once to a plain f32 factor (``expand_sparse``, ``(q.f32 *
    scale)``): the values the plain versions of the _q / _sq chains
    rebuild at every call, so the CPU's f32 logits are the same bits at
    the cost of the plain chains (check_vlm's CPU tree is made so too).
    Not for an activation-quantized run, whose chains need the int8
    factors."""
    import torch
    from repro_torch.quant.quantize import dequantize_tree
    from repro_torch.quant.sparse import desparsify_tree
    return dequantize_tree(desparsify_tree(to_cpu_f32(tree), torch.float32),
                           torch.float32)


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
    f32 on the CPU (its factors dequantized once, :func:`cpu_reference`;
    plain versions).  Both are fed the CPU's greedy tokens, so every step
    compares logits of the same context."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models.api import get_model
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n_tok)),
                           dtype=torch.long)
    m_gpu = get_model(cfg, "cuda")
    m_cpu = get_model(dataclasses.replace(cfg, dtype="float32"), "cpu")
    p_cpu = cpu_reference(params_q)
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
    versions; quantized and 2:4-packed factors restored once,
    :func:`cpu_reference`, but for an act-quant run).  Both are fed the
    CPU's greedy tokens, so every step
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
                                "cpu"), to_cpu_f32(params) if act_quantize
                      else cpu_reference(params))):
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


def check_surgery(label: str, rep, params, card: str, want: dict) -> None:
    """Print every surgery decision of a tree and hold the decomposed
    ones (and a branched linear's per-branch rank) to ``want`` (path ->
    (kind, rank)); every other linear must skip."""
    got = {}
    for d in rep.decisions:
        log(f"surgery {label}: {d.path} label={d.label} kind={d.kind} "
            f"shape={list(d.shape)} rank={d.rank} {d.reason} [{card}]")
        if d.kind != "skip":
            node = params
            for k in d.path.split("/"):
                node = node[k]
            got[d.path] = (d.kind, int(node["u"].shape[-1])
                           if "u" in node else d.rank)
    if got != want:
        raise SystemExit(f"{label} surgery decided {got}, want {want}")


def large_m_plans() -> None:
    """Print the large-M form's plan at each bf16 B1 / B2 shape the main
    path runs at M >= LARGE_M (the train step's, hubert's, the VLM's
    cross k / v, the searched k/v rank 191) and at each B3 / B4 shape (the
    int8 VLM's cross k / v and prefill rows, zamba2's at M = 512): per
    product its tile, ring depth, tile count and shared memory, and the
    copies, the factors the dequantizing pass writes and the scratch."""
    import torch
    from repro_torch.kernels import branched_matmul as bk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    calls = {**{f"B1 {k} M={TRAIN_M}": (TRAIN_M, *LOWRANK_SHAPES[k])
                for k in TRAIN_LAUNCHES["lowrank_matmul"]},
             **{f"B1 {k} M={HUBERT_M}": (HUBERT_M, *v)
                for k, v in HUBERT_LOWRANK_SHAPES.items()},
             **{f"B1 {k} M={VLM_CROSS_M}": (VLM_CROSS_M, *v)
                for k, v in VLM_LOWRANK_SHAPES.items()},
             f"B1 k,v r191 M={TRAIN_M}": (
                 TRAIN_M, *SEARCH_LOWRANK_SHAPES["k,v r191"]),
             **{f"B2 {k} M={TRAIN_M}": (TRAIN_M, c, n, r, r, s_)
                for k, (n, c, r, s_) in BRANCHED_SHAPES.items()},
             **{f"B2 {k} M={HUBERT_M}": (HUBERT_M, c, n, r, r, s_)
                for k, (n, c, r, s_) in HUBERT_BRANCHED_SHAPES.items()},
             **{f"B3 {k} M={m}": (m, *v) for k, v in
                VLM_LOWRANK_SHAPES.items()
                for m in (VLM_CROSS_M, VLM_PREFILL_M)},
             **{f"B4 {k} M={VLM_PREFILL_M}": (VLM_PREFILL_M, c, n, r, r, s_)
                for k, (n, c, r, s_) in VLM_BRANCHED_SHAPES.items()
                if k in VLM_PREFILL_SHAPES},
             **{f"B4 {k} M={SSM_M_CASES[-1]}": (SSM_M_CASES[-1], c, n, r, r,
                                                s_)
                for k, (n, c, r, s_) in ZAMBA_BRANCHED_SHAPES.items()}}
    for label, dims in calls.items():
        quant = label[:2] in ("B3", "B4")
        plan = bk.large_m_plan(dims, sms, quantized=quant)
        log(f"large-M plan {label}: " + "; ".join(
            f"{p.out} = {p.a} @ {p.b}: {p.bm}x{p.bn} tiles x "
            f"{len(p.tiles())}, {p.stages} stages "
            f"({(p.bm + p.bn) * bk.WG_BK * 2 * p.stages} B of ring)"
            for p in plan.products)
            + f"; copies {sorted(plan.copies - plan.dequant)}, dequantized "
            f"{sorted(plan.dequant)}, {plan.scratch_bytes} B of scratch "
            f"(LARGE_M {bk.LARGE_M_Q if quant else bk.LARGE_M})")


def f32_plans() -> None:
    """Print the f32 form's plan at each f32 B1 / B2 shape the kernels
    phase times (the VLM's, the fc's, the new B1 rows', the f32 train
    rows') and at each f32 B3 / B4 one (int8 factors: the fc's, the VLM's,
    llama's at M = 8 / 64, ranks 1,600): per product its tile, tile count,
    K slices, which operands go by 4-byte copies and which factors read
    quantized bytes, the factors dequantized first, and the scratch and
    tickets."""
    import torch
    from repro_torch.kernels import branched_matmul as bk
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    calls = {**{f"B2 {k} M={m}": (m, c, n, r, r, s_)
                for k, (n, c, r, s_) in VLM_F32_SHAPES.items()
                for m in VLM_F32_M},
             **{f"B1 {k} M={m}": (m, *v) for k, v in RESNET_FC.items()
                for m in RESNET_FC_M},
             **{f"B1 {k} M={m}": (m, *v)
                for k, (_, v, m) in F32_LOWRANK_ROWS.items()},
             **{f"B2 {k} M={TRAIN_FAMILY_CHECK_BATCH * TRAIN_FAMILY_RUNS[
                 key]['seq']}": (TRAIN_FAMILY_CHECK_BATCH
                                 * TRAIN_FAMILY_RUNS[key]["seq"], c, n, r, r,
                                 s_)
                for k, (key, (n, c, r, s_)) in TRAIN_FAMILY_F32_ROWS.items()},
             **{f"B3 {k} M={m}": (m, *v) for k, v in RESNET_FC.items()
                if k == "fc r335" for m in RESNET_FC_M},
             **{f"B3 {k} M={m}": (m, *v) for k, v in LOWRANK_SHAPES.items()
                for m in (8, 64)},
             **{f"B4 {k} M={m}": (m, c, n, r, r, s_)
                for k, (n, c, r, s_) in BRANCHED_SHAPES.items()
                for m in (8, 64)},
             **{f"B4 {k} M={m}": (m, c, n, r, r, s_)
                for k, (n, c, r, s_) in {**VLM_F32_SHAPES,
                                         **F32_WIDE_RANK}.items()
                for m in VLM_F32_M}}
    for label, dims in calls.items():
        plan = bk.f32_plan(dims, sms, 0 if label[:2] in ("B3", "B4")
                           else None)
        log(f"f32 plan {label}: " + "; ".join(
            f"{p.out} = {p.a} @ {p.b}: {p.bm}x{bk.F32_BN} tiles x "
            f"{len(p.tiles())}, {p.slices} K slices of "
            f"{p.ks}" + ("" if all(p.granules()) else
                         ", 4-byte copies of " + " ".join(
                             n for n, ok in zip((p.a, p.b), p.granules())
                             if not ok))
            + (", int8 bytes" if p.bq >= 0 else "")
            for p in plan.products)
            + (f"; dequantized first {sorted(plan.dequant)}"
               if plan.dequant else "")
            + f"; {plan.scratch_bytes} B of scratch, {plan.tickets} "
            "tickets")


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
    if "search" in phases:
        with Phase("search"):
            rank_search(card, seed)
    cfg, dense, axes = full_model(seed)
    lrd, p4, rep, surg_s = decompose(dense, axes, branches=4)
    log(f"surgery branches=4: {surg_s:.2f} s, "
        f"{json.dumps(rep.summary())} [{card}]")
    every = lambda counts: {"decode": counts,  # noqa: E731
                            "prefill_chunk": counts}
    if "serve" in phases:
        with Phase("serve"):
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
    if set(phases) & {"serve_search", "check_search"}:
        lrd_s, ps, rep_s, surg_s_s = decompose(dense, axes, branches=4,
                                               rank_mode="search")
        per_seg = chain_launches(rep_s)
        want = {k: sum(v.values()) for k, v in SEARCH_LAUNCHES.items()}
        searched = {
            "surgery_s": surg_s_s, "launches_per_segment": per_seg,
            "as_predicted": per_seg == want,
            "ranks": {d.path: [d.kind, d.rank] for d in rep_s.decomposed},
            "aligned_ranks": {d.path: [d.kind, d.rank]
                              for d in rep.decomposed},
            "summary": rep_s.summary()}
        log(f"surgery search branches=4: {json.dumps(searched)} [{card}]")
    if "serve_search" in phases:
        with Phase("serve_search"):
            from repro_torch.layers.plan import build_plan_tree, tree_summary
            res = serve(cfg, lrd_s, ps, n_req=8, prompt_lo=32,
                        prompt_hi=512, new_tokens=32, card=card, seed=seed,
                        expect=every(per_seg))
            res.update(searched, aligned_weight_bytes=tree_summary(
                build_plan_tree(p4))["weight_bytes"])
            log("serve_search " + json.dumps(
                {k: res[k] for k in ("weight_bytes", "aligned_weight_bytes",
                                     "launches_per_segment", "as_predicted",
                                     "ranks", "aligned_ranks", "card")}))
            serve_res["search"] = res
    if "check_search" in phases:
        with Phase("check_search"):
            steps = 16
            cross_check_staged(cfg, ps, card, seed, label="check_search",
                               steps=steps,
                               want={k: n * (steps + 1)
                                     for k, n in per_seg.items()})
    if set(phases) & {"serve_search", "check_search"}:
        del ps
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
    if "serve_faults" in phases:
        with Phase("serve_faults"):
            serve_res["faults"] = serve_faults(cfg, lrd, p4, card, seed)
    if "serve_router" in phases:
        with Phase("serve_router"):
            serve_res["router"] = serve_router(cfg, lrd, p4, card, seed)
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
    check_surgery("mla", rep, pm, card, MLA_SURGERY)
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
# the other configs: granite, mistral-nemo, minitron, moonshot (MoE),
# DeepSeek-V2 with its experts
# ---------------------------------------------------------------------------

def config_model(arch: str, depth: int, seed: int = 0):
    """The registered config ``arch`` at its published widths, cut to
    ``depth`` layers; random bf16 weights from ``seed``, on the card."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.models.api import get_model
    cfg = dataclasses.replace(registry.get(arch).full, num_layers=depth)
    g = torch.Generator(device="cuda").manual_seed(seed)
    params, axes = get_model(cfg, "cuda").init(g)
    torch.cuda.synchronize()
    return cfg, params, axes


def check_config_surgery(key: str, rep, params, card: str,
                         shared: int = 1) -> None:
    """:func:`check_surgery` of a :data:`CONFIG_RUNS` tree against
    :data:`CONFIG_SURGERY`, and the chain launches its decisions imply
    (the hybrid's shared block ``shared`` times) against
    :data:`CONFIG_CHAINS`."""
    check_surgery(key, rep, params, card, CONFIG_SURGERY[key])
    chain = chain_launches(rep, shared)
    if (chain["lowrank_matmul"], chain["branched_matmul"]) \
            != CONFIG_CHAINS[key]:
        raise SystemExit(f"{key} surgery implies {chain} a segment, want "
                         f"{CONFIG_CHAINS[key]}")


def _routing(got: list, want: list) -> dict:
    """Routing agreement of two runs' recorded top-k calls (``(idx,
    gates)`` per call, in call order; ``want`` the reference run): a
    (token, k) choice is equal where the token's k experts hold the
    expert (the set decides the routing: each expert gets the token with
    its gate whatever the rank order).  An unequal choice is a near tie
    where the reference's gates of the experts the two runs swapped lie
    within :data:`ROUTER_TIE` of each other.  Also counted: the tokens
    whose ranked order alone differs; and the first unequal choice, with
    both runs' gates of the experts involved."""
    if len(got) != len(want):
        return {"choices_equal": f"calls {len(got)} != {len(want)}",
                "choices_equal_share": 0.0, "beyond_near_ties": -1}
    same = total = reordered = ties = 0
    first = None
    for call, ((gi, gg), (wi, wg)) in enumerate(zip(got, want)):
        gs, ws = gi.sort(-1).values, wi.sort(-1).values
        eq = (gs[:, :, None] == ws[:, None, :]).any(-1)
        same += int(eq.sum())
        total += eq.numel()
        reordered += int(((gs == ws).all(-1) & (gi != wi).any(-1)).sum())
        for t in (~eq).any(-1).nonzero()[:, 0].tolist():
            mine = sorted(set(gi[t].tolist()) - set(wi[t].tolist()))
            theirs = sorted(set(wi[t].tolist()) - set(gi[t].tolist()))
            hi = max(float(wg[t, e]) for e in theirs)
            lo = min(float(wg[t, e]) for e in mine)
            if hi - lo <= ROUTER_TIE * hi:
                ties += len(mine)
            if first is None:
                ex = mine + theirs
                first = {"call": call, "token": t, "experts": ex,
                         "gates": [[float(gg[t, e]) for e in ex],
                                   [float(wg[t, e]) for e in ex]]}
    return {"choices_equal": f"{same}/{total}",
            "choices_equal_share": same / max(total, 1),
            "near_ties": ties, "beyond_near_ties": total - same - ties,
            "reordered_tokens": reordered, "first_unequal": first}


def _pooled_runs(sides: dict, toks: list, steps: int, vocab: int, *,
                 record: list | None = None) -> dict:
    """Prefill and ``steps`` greedy decode steps of a stream as the engine
    drives it with blocking admission, for each of ``sides`` (``{name:
    (model, params, kv_quantize)}``): a whole-prompt prefill of ``toks``
    into a staging cache of the pool's family, inserted into a one-slot
    pool, then decode over the pool; every side is fed the greedy tokens
    of the ``"cpu"`` side.  Returns ``{name: run}``: each run's pool, its
    logits at every step (the ``vocab`` real columns: a padded vocab's
    columns hold -1e30), the kernels it launched and its host seconds.
    What instrumentation appends to ``record`` while a side steps moves
    to that run's ``"recorded"``."""
    import torch
    from repro_torch.serve.pool import KVPoolManager
    from repro_torch.serve.runner import ModelRunner
    n_tok = len(toks)
    max_seq = n_tok + steps + 1
    runs = {}
    for name, (model, p, kvq) in sides.items():
        runs[name] = dict(
            pool=KVPoolManager(model, 1, max_seq, kv_quantize=kvq),
            runner=ModelRunner(model, p, max_seq=max_seq, kv_quantize=kvq),
            kvq=kvq, dev=model.device, logits=[], recorded=[], seconds=0.0,
            launches={k: 0 for k in KERNELS})

    def run(r, fn):
        t0 = time.perf_counter()
        before = {k: launch_count(k) for k in KERNELS}
        lg = fn(r)
        for k in KERNELS:
            r["launches"][k] += launch_count(k) - before[k]
        r["logits"].append(lg[0, -1, :vocab].float().cpu())
        r["seconds"] += time.perf_counter() - t0
        if record is not None:
            r["recorded"] += record
            record.clear()

    def prefill(r):
        r["pool"].allocate(0, n_tok)
        lg, staged = r["runner"].step(
            torch.tensor([toks], device=r["dev"]), None, "prefill",
            cache=r["runner"].new_stream_cache(r["kvq"]),
            last_pos=n_tok - 1)
        r["pool"].insert(staged, 0, n_tok)
        return lg

    with torch.inference_mode():
        for r in runs.values():
            run(r, prefill)
        for _ in range(steps):
            tok = int(runs["cpu"]["logits"][-1].argmax())

            def decode(r):
                lg, r["pool"].cache = r["runner"].step(
                    torch.tensor([[tok]], device=r["dev"]),
                    torch.as_tensor(r["pool"].positions, device=r["dev"]),
                    "decode", cache=r["pool"].cache)
                r["pool"].grow(0, token=tok)
                return lg
            for r in runs.values():
                run(r, decode)
    torch.cuda.synchronize()
    return runs


def _against(r: dict, c: dict) -> dict:
    """Run ``r``'s logits against run ``c``'s at every step (the largest
    difference over ``c``'s std, greedy agreement and its gaps) and the
    kernels ``r`` launched."""
    rels = [((a - b).abs().max() / b.std()).item()
            for a, b in zip(r["logits"], c["logits"])]
    gaps = {}
    for i, (a, b) in enumerate(zip(r["logits"], c["logits"])):
        gaps.update(_greedy_gap(i, a, b))
    return {"pool": r["kvq"] or "full width",
            "max_diff_over_std": max(rels), "per_step": rels,
            "greedy_agree": f"{len(rels) - len(gaps)}/{len(rels)}",
            "greedy_gap": gaps,
            "launches": {k: n for k, n in r["launches"].items() if n}}


def _exact_runs(label: str, runs: dict, names: tuple, chain: dict[str, int],
                attn: str | None, attn_layers: int, steps: int) -> None:
    """Each of the card's ``names`` runs launched exactly its segments'
    kernels: ``chain`` a segment, and ``attn`` once per attention layer
    (``attn_layers``) of every decode step over a quantized pool."""
    for name in names:
        want = {k: n * (steps + 1) for k, n in chain.items()}
        if runs[name]["kvq"] and attn:
            want[attn] = attn_layers * steps
        want = {k: want.get(k, 0) for k in KERNELS}
        if runs[name]["launches"] != want:
            raise SystemExit(f"{label} ({name}) launched "
                             f"{runs[name]['launches']}, want {want}")


def cross_check_moe(cfg, params, card: str, seed: int, *, label: str,
                    chain: dict[str, int], attn: str, kv_quantize: str,
                    n_tok: int = 64, steps: int = 16) -> dict:
    """:func:`_pooled_runs` of an MoE tree five ways: the tree in f32 on
    the card and on the CPU over the full-width pool (``f32``, ``cpu``),
    and in f32 and bf16 on the card and f32 on the CPU over the phase's
    ``kv_quantize`` pool (``f32_pool``, ``bf16``, ``cpu_pool``).  Every
    call of the dispatch's top-k (``repro_torch.layers.moe._topk``) is
    recorded.

    Gated: the card's f32 run picks every (token, k) expert of every MoE
    layer that the CPU's picks, bar near ties (:func:`_routing`,
    :data:`ROUTER_TIE`), and its logits stay within
    :data:`CHECK_TOL_F32` of the CPU logits' std at every step; each card
    run launches exactly its segments' kernels (:func:`_exact_runs`).
    Reported: the runs over the quantized pool against the CPU's over
    it -- the bf16 run's distance, greedy agreement and share of equal
    choices, and the f32 run's, where int8 roundings that the two f32
    runs take apart (a K / V value on a rounding boundary) move the
    logits and can tip a near-tied router score."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.layers import moe
    from repro_torch.models.api import get_model
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n_tok).tolist()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    fresh_peak()
    card32 = (get_model(cfg32, "cuda"),
              _tree_to(params, "cuda", torch.float32))
    cpu32 = (get_model(cfg32, "cpu"), to_cpu_f32(params))
    sides = {"cpu": (*cpu32, None), "f32": (*card32, None),
             "cpu_pool": (*cpu32, kv_quantize),
             "f32_pool": (*card32, kv_quantize),
             "bf16": (get_model(cfg, "cuda"), params, kv_quantize)}
    topk = moe._topk
    calls: list = []

    def counted_topk(gates, k):
        vals, idx = topk(gates, k)
        calls.append((idx.to("cpu"), gates.to("cpu", torch.float32)))
        return vals, idx

    moe._topk = counted_topk
    try:
        runs = _pooled_runs(sides, toks, steps, cfg.vocab_size, record=calls)
    finally:
        moe._topk = topk
    res = {"kv_quantize": kv_quantize, "tokens": n_tok,
           "decode_steps": steps, "tol": CHECK_TOL_F32,
           "topk_calls": len(runs["cpu"]["recorded"]),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "seconds": {n: r["seconds"] for n, r in runs.items()},
           "card": card}
    for name, ref_name in (("f32", "cpu"), ("f32_pool", "cpu_pool"),
                           ("bf16", "cpu_pool")):
        r, c = runs[name], runs[ref_name]
        res[name] = {**_against(r, c),
                     **_routing(r["recorded"], c["recorded"])}
    log(f"{label} " + json.dumps(res))
    f32 = res["f32"]
    if f32["beyond_near_ties"] != 0:
        raise SystemExit(f"{label}: the card's f32 run routed other experts "
                         f"than the CPU's ({f32['choices_equal']} equal, "
                         f"{f32['near_ties']} near ties)")
    if not f32["max_diff_over_std"] <= CHECK_TOL_F32:
        raise SystemExit(f"{label}: card f32 logits differ from the CPU f32 "
                         f"reference: {f32['max_diff_over_std']:.2e} > "
                         f"{CHECK_TOL_F32}")
    _exact_runs(label, runs, ("f32", "f32_pool", "bf16"), chain, attn,
                cfg.num_layers, steps)
    return res


#: prompt tokens of the recurrent checks: past the 256-token SSD chunk
#: (the inter-chunk recurrence runs) and not a multiple of it (the last
#: chunk is padded with dt = 0)
RECURRENT_CHECK_TOKENS = 300


def cross_check_recurrent(cfg, params, card: str, seed: int, *, label: str,
                          chain: dict[str, int], attn: str | None,
                          quantize: str = "none",
                          kv_quantize: str | None = None,
                          bf16_against: str = "cpu",
                          steps: int = 16) -> dict:
    """:func:`_pooled_runs` of an SSM or hybrid tree, with the factors
    quantized as the engine quantizes them (``quantize``): the tree in
    f32 on the card and on the CPU over the full-width pool (``f32``,
    ``cpu``); in bf16 on the card and, reported, on the CPU over the
    phase's ``kv_quantize`` pool (``bf16``, ``cpu_bf16``); and, where
    that pool is quantized, in f32 on the card and on the CPU over it
    (``f32_pool``, ``cpu_pool``).  The recurrent state stays in the model
    dtype, as the reference keeps it.

    Gated: the card's f32 logits within :data:`CHECK_TOL_F32` of the
    CPU's at every step; the card's bf16 logits within :data:`CHECK_TOL`
    of the CPU's f32 ones over the same pool (``bf16_against="cpu"``) or
    of the CPU's bf16 ones (``"cpu_bf16"``: where the CPU's bf16 run
    misses its f32 run as far as the card's does); the card's f32 run
    over a quantized pool within :data:`CHECK_TOL_POOL_F32` of the CPU's
    over it (int8 roundings that the two f32 runs take apart, a K / V
    value on a rounding boundary, move its logits); each card run
    launches exactly its segments' kernels (:func:`_exact_runs`)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import LRDConfig
    from repro_torch.models.api import get_model
    from repro_torch.quant.quantize import quantize_tree
    n_tok = RECURRENT_CHECK_TOKENS
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n_tok).tolist()
    fresh_peak()
    if quantize != "none":
        with torch.inference_mode():
            params = quantize_tree(params, quantize,
                                   targets=LRDConfig().quant_targets)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu32 = (get_model(cfg32, "cpu"), to_cpu_f32(params))
    card32 = (get_model(cfg32, "cuda"),
              _tree_to(params, "cuda", torch.float32))
    sides = {"cpu": (*cpu32, None), "f32": (*card32, None),
             "bf16": (get_model(cfg, "cuda"), params, kv_quantize),
             "cpu_bf16": (get_model(cfg, "cpu"), _tree_to(params, "cpu"),
                          kv_quantize)}
    pairs = [("f32", "cpu"), ("bf16", "cpu"), ("cpu_bf16", "cpu")]
    if kv_quantize:
        sides["cpu_pool"] = (*cpu32, kv_quantize)
        sides["f32_pool"] = (*card32, kv_quantize)
        pairs = [("f32", "cpu"), ("f32_pool", "cpu_pool"),
                 ("bf16", "cpu_pool"), ("cpu_bf16", "cpu_pool")]
    runs = _pooled_runs(sides, toks, steps, cfg.vocab_size)
    res = {"quantize": quantize, "kv_quantize": kv_quantize or "none",
           "tokens": n_tok, "decode_steps": steps,
           "tol": CHECK_TOL, "tol_f32": CHECK_TOL_F32,
           "tol_pool_f32": CHECK_TOL_POOL_F32,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "seconds": {n: r["seconds"] for n, r in runs.items()},
           "card": card}
    for name, ref_name in pairs:
        res[name] = {**_against(runs[name], runs[ref_name]),
                     "against": ref_name}
    res["bf16_vs_cpu_bf16"] = _against(
        runs["bf16"], runs["cpu_bf16"])["max_diff_over_std"]
    gated = (res["bf16"]["max_diff_over_std"] if bf16_against == "cpu"
             else res["bf16_vs_cpu_bf16"])
    res["bf16_gate"] = {"against": bf16_against, "reading": gated}
    log(f"{label} " + json.dumps(res))
    if not res["f32"]["max_diff_over_std"] <= CHECK_TOL_F32:
        raise SystemExit(f"{label}: card f32 logits differ from the CPU f32 "
                         f"reference: {res['f32']['max_diff_over_std']:.2e} "
                         f"> {CHECK_TOL_F32}")
    if kv_quantize and not (res["f32_pool"]["max_diff_over_std"]
                            <= CHECK_TOL_POOL_F32):
        raise SystemExit(f"{label}: card f32 logits over the {kv_quantize} "
                         f"pool differ from the CPU's over it: "
                         f"{res['f32_pool']['max_diff_over_std']:.2e} > "
                         f"{CHECK_TOL_POOL_F32}")
    if not gated <= CHECK_TOL:
        raise SystemExit(f"{label}: card bf16 logits differ from the CPU "
                         f"run {bf16_against!r}: {gated:.4f} > {CHECK_TOL}")
    groups = runs["bf16"]["pool"].model.n_groups
    _exact_runs(label, runs, tuple(n for n in ("f32", "f32_pool", "bf16")
                                   if n in runs),
                chain, attn, groups or cfg.num_layers, steps)
    return res


def run_config(key: str, phases: list[str], card: str, seed: int,
               serve_res: dict, train_res: dict) -> None:
    """``serve_<key>`` / ``check_<key>`` of one :data:`CONFIG_RUNS` tree:
    built, decomposed and checked against its surgery decisions, served
    with the exact launches of every segment, checked against the port's
    f32 CPU run (:func:`cross_check_staged` for the dense configs,
    :func:`cross_check_moe` for the MoE ones); then the family training
    pair that takes the tree over (:func:`train_served_tree`); freed when
    this returns."""
    import torch
    from repro_torch.models.api import get_model
    spec = CONFIG_RUNS[key]
    if not {f"serve_{key}", f"check_{key}"} & set(phases):
        return
    fresh_peak()
    t0 = time.perf_counter()
    cfg, dense, axes = config_model(spec["arch"], spec["depth"], seed)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    lrd, params, rep, surg_s = decompose(dense, axes, branches=4)
    del dense, axes
    torch.cuda.empty_cache()
    log(f"surgery {key} branches=4: init {init_s:.2f} s, surgery "
        f"{surg_s:.2f} s, peak {torch.cuda.max_memory_allocated()} B "
        f"(init {init_peak} B), {json.dumps(rep.summary())} [{card}]")
    groups = get_model(cfg, "cpu").n_groups
    check_config_surgery(key, rep, params, card, shared=groups)
    tag = "_q" if spec["engine"].get("quantize") == "int8" else ""
    chain = {k + tag: n for k, n in chain_launches(rep, groups).items() if n}
    attn = spec["attn"]
    #: attention layers a decode step runs (the hybrid's shared block once
    #: a group; none in mamba2)
    L = (groups if cfg.family == "hybrid" else 0 if attn is None
         else cfg.num_layers)
    blocking = cfg.family in ("moe", "ssm", "hybrid")
    decode = {**chain, **({attn: L} if attn else {})}
    if f"serve_{key}" in phases:
        with Phase(f"serve_{key}"):
            res = serve(cfg, lrd, params, n_req=8, prompt_lo=32,
                        prompt_hi=512, new_tokens=32, card=card, seed=seed,
                        shared=spec.get("shared", 0),
                        expect={"decode": decode,
                                "prefill" if blocking else "prefill_chunk":
                                    chain}, **spec["engine"])
            res.update(surgery_s=surg_s, init_s=init_s, config=spec["arch"],
                       depth=cfg.num_layers, admission="blocking"
                       if blocking else "continuous")
            serve_res[key] = res
            if res["state_bytes"]:
                log(f"serve_{key} recurrent state {res['state_bytes']} B, "
                    f"kv_bytes_per_step {res['kv_bytes_per_step']} B, "
                    f"weight_bytes {res['weight_bytes']} B [{card}]")
    if f"check_{key}" in phases:
        with Phase(f"check_{key}"):
            steps = 16
            want = {k: n * (steps + 1) for k, n in chain.items()}
            if attn:
                want[attn] = L * steps
            if cfg.family in ("ssm", "hybrid"):
                cross_check_recurrent(
                    cfg, params, card, seed, label=f"check_{key}",
                    chain=chain, attn=attn, steps=steps,
                    bf16_against=spec.get("bf16_against", "cpu"),
                    **spec["engine"])
            elif cfg.family == "moe":
                cross_check_moe(cfg, params, card, seed,
                                label=f"check_{key}", chain=chain, attn=attn,
                                kv_quantize=spec["engine"]["kv_quantize"],
                                steps=steps)
            else:
                fresh_peak()
                res = cross_check_staged(
                    cfg, params, card, seed, label=f"check_{key}",
                    want=want, steps=steps,
                    paged=spec["engine"].get("kv_layout") == "paged",
                    kv_quantize=spec["engine"].get("kv_quantize"))
                log(f"check_{key} max_memory_allocated "
                    f"{torch.cuda.max_memory_allocated()} [{card}]")
    served = [cfg, params, rep, init_s, surg_s]
    del params
    train_served_tree(key, phases, card, seed, train_res, served)


# ---------------------------------------------------------------------------
# the ResNets (paper Tables 1 and 3)
# ---------------------------------------------------------------------------

def resnet_fwd_flops(params, img_hw: int) -> float:
    """Forward FLOPs of one image through a (possibly decomposed or
    quantized) ResNet tree: this script's copy of the reference's
    ``benchmarks/common.py::fwd_flops_resnet``, read from the logical
    factor shapes of each subtree's plan (an int8 tree counts as its f32
    twin)."""
    from repro_torch.layers.plan import build_plan
    total = [0.0]

    def conv(p, hw: int, stride: int) -> int:
        out = hw // stride
        plan = build_plan(p)
        sh = {f.name: f.shape for f in plan.factors}
        if plan.kind == "dense":
            kh, kw, c, o = sh["w"]
            per = kh * kw * c * o
        elif plan.kind == "lowrank":
            c, r = sh["w0"]
            per = r * (c + sh["w1"][-1])
        elif plan.kind == "tucker_conv":
            c, r1 = sh["tucker_u"]
            kh, kw, _, r2 = sh["core"]
            per = c * r1 + kh * kw * r1 * r2 + r2 * sh["tucker_v"][-1]
        else:
            n, c, r1 = sh["u"]
            _, kh, kw, _, r2 = sh["core"]
            per = n * (c * r1 + kh * kw * r1 * r2 + r2 * sh["v"][-1])
        total[0] += 2.0 * out * out * per
        return out

    hw = conv(params["stem"], img_hw, 2) // 2          # stem, max pool
    si = 0
    while f"stage{si}" in params:
        stage = params[f"stage{si}"]
        bi = 0
        while f"block{bi}" in stage:
            blk = stage[f"block{bi}"]
            s = (1 if si == 0 else 2) if bi == 0 else 1
            conv(blk["conv1"], hw, 1)
            hw2 = conv(blk["conv2"], hw, s)
            conv(blk["conv3"], hw2, 1)
            if "downsample" in blk:
                conv(blk["downsample"], hw, s)
            hw, bi = hw2, bi + 1
        si += 1
    fc = build_plan(params["fc"])
    sh = {f.name: f.shape for f in fc.factors}
    total[0] += 2.0 * (sh["w"][0] * sh["w"][1] if fc.kind == "dense" else
                       sh["w0"][1] * (sh["w0"][0] + sh["w1"][1]))
    return total[0]


def resnet_trees(arch: str, names: tuple, seed: int) -> tuple:
    """resnet ``arch`` at full width and depth on the card (f32, random
    weights from ``seed``) and its trees of ``names``
    (:data:`RESNET_VARIANTS`), each decomposed on the card: returns
    (model, {name: dict(tree, report, surgery_s, expect)}), ``expect``
    the chain-kernel launches one forward must make, read from the
    surgery report's fc decision."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.models.api import get_model
    from repro_torch.models.resnet import merge_bottleneck
    from repro_torch.quant.quantize import quantize_tree
    model = get_model(registry.get(arch).full, "cuda")
    with torch.no_grad():
        params, axes = model.init(
            torch.Generator(device="cuda").manual_seed(seed))
    out = {"original": dict(tree=params, report=None, surgery_s=0.0,
                            expect={})}
    for name in names:
        over = RESNET_VARIANTS[name]
        if over is None:
            continue
        if name == "layer_freezing":
            out[name] = out["vanilla_lrd"]
            continue
        t0 = time.perf_counter()
        with torch.no_grad():
            if name == "vanilla_int8":
                base = out["vanilla_lrd"]
                tree, rep = quantize_tree(base["tree"], "int8"), base["report"]
            else:
                tree, _, rep = decompose_model(
                    params, axes, LRDConfig(**{**RESNET_LRD, **over}))
                if name == "layer_merging":
                    tree = merge_bottleneck(tree)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if name == "vanilla_int8":
            secs += out["vanilla_lrd"]["surgery_s"]
        fc = next(d for d in rep.decisions if d.path == "fc")
        kernel = "lowrank_matmul_q" if name == "vanilla_int8" \
            else "lowrank_matmul"
        out[name] = dict(tree=tree, report=rep, surgery_s=secs,
                         expect={kernel: 1} if fc.kind == "svd" else {})
    return model, out


def resnet_layers(tree) -> int:
    """Weighted layers as the paper counts them (convs and fc: a dense
    one 1, an SVD pair 2, a Tucker triple or branched Tucker 3), from
    each subtree's plan, so an int8 tree counts as its f32 twin (the
    models' ``layer_count`` reads the plain factor keys)."""
    from repro_torch.layers.plan import build_plan_tree, plan_leaves
    per = {"dense": 1, "lowrank": 2}
    return sum(per.get(p.kind, 3) for p in plan_leaves(build_plan_tree(tree)))


def _launches() -> dict[str, int]:
    return {k: launch_count(k) for k in KERNELS if launch_count(k)}


def _forward_times(model, tree, x, n: int) -> list[float]:
    """Seconds of ``n`` forwards of ``x``, each ending in a sync."""
    import torch
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        model.forward(tree, x)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def infer_resnet(arch: str, name: str, model, t: dict, card: str,
                 seed: int) -> dict:
    """One tree's Table 1 / Table 3 inference row (see the module
    docstring); every forward must launch exactly ``t["expect"]``."""
    import statistics
    import torch
    from repro_torch.quant.quantize import tree_bytes
    from repro_torch.tree import paths
    cfg, tree = model.cfg, t["tree"]
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    x = torch.randn((RESNET_BATCH, cfg.img_size, cfg.img_size, 3),
                    generator=g, device="cuda")
    x1 = x[:1].contiguous()
    at_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        reset_launches()
        y = model.forward(tree, x)
        torch.cuda.synchronize()
        first = _launches()
        _forward_times(model, tree, x, 3)
        reset_launches()
        secs = _forward_times(model, tree, x, RESNET_TIMED)
        timed = _launches()
        _forward_times(model, tree, x1, 3)
        secs1 = _forward_times(model, tree, x1, RESNET_TIMED)
    want = {k: n * RESNET_TIMED for k, n in t["expect"].items()}
    if first != t["expect"] or timed != want:
        raise SystemExit(f"infer_resnet {arch} {name}: a forward launched "
                         f"{first} (timed: {timed}), not {t['expect']}")
    if y.shape != (RESNET_BATCH, cfg.num_classes) or \
            not torch.isfinite(y).all():
        raise SystemExit(f"infer_resnet {arch} {name}: logits of shape "
                         f"{tuple(y.shape)} or not finite")
    mean = statistics.fmean(secs)
    res = {"arch": arch, "variant": name, "layers": resnet_layers(tree),
           "params": sum(v.numel() for p, v in paths(tree)
                         if not p[-1].endswith("_scale")),
           "weight_bytes": tree_bytes(tree),
           "gflops_fwd_224": resnet_fwd_flops(tree, cfg.img_size) / 1e9,
           "surgery_s": t["surgery_s"], "batch": RESNET_BATCH,
           "images_per_s": RESNET_BATCH / mean,
           "forward_ms_mean": mean * 1e3,
           "forward_ms_stdev": statistics.stdev(secs) * 1e3,
           "forward_ms_min": min(secs) * 1e3,
           "forward_ms_max": max(secs) * 1e3,
           "batch1_ms": statistics.fmean(secs1) * 1e3,
           "batch1_ms_stdev": statistics.stdev(secs1) * 1e3,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "allocated_at_start": at_start,
           "launches_per_forward": first, "card": card}
    if t["report"] is not None:
        kinds: dict[str, int] = {}
        for d in t["report"].decisions:
            kinds[f"{d.label}:{d.kind}"] = kinds.get(f"{d.label}:{d.kind}",
                                                     0) + 1
        fc = next(d for d in t["report"].decisions if d.path == "fc")
        res.update(decisions=kinds, fc_rank=fc.rank,
                   first_conv2_rank=next(
                       d.rank for d in t["report"].decisions
                       if d.path == "stage0/block0/conv2"))
    return res


def check_resnet(arch: str, name: str, model, tree, card: str, seed: int,
                 base_logits=None) -> tuple[dict, object]:
    """The card's f32 logits of ``tree`` against the port's CPU f32 run
    of the same tree, copied to the host: within ``CHECK_TOL_F32`` of the
    CPU logits' std (gated); top-1 agreement with the logit gap at each
    disagreement, and the distance from the original tree's card logits
    ``base_logits`` (reported).  Returns (result, card logits)."""
    import dataclasses
    import torch
    from repro_torch.models.api import get_model
    cfg = model.cfg
    n = RESNET_CHECK_IMAGES[arch]
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    x = torch.randn((n, cfg.img_size, cfg.img_size, 3), generator=g,
                    device="cuda")
    with torch.no_grad():
        lg = model.forward(tree, x).cpu()
        cpu = get_model(dataclasses.replace(cfg, dtype="float32"), "cpu")
        t0 = time.perf_counter()
        lc = cpu.forward(to_cpu_f32(tree), x.cpu())
        cpu_s = time.perf_counter() - t0
    rel = ((lg - lc).abs().max() / lc.std()).item()
    top_g, top_c = lg.argmax(-1), lc.argmax(-1)
    gaps = [(lc[i, top_c[i]] - lc[i, top_g[i]]).item()
            for i in range(n) if top_g[i] != top_c[i]]
    res = {"arch": arch, "variant": name, "images": n,
           "max_diff_over_std": rel, "tol": CHECK_TOL_F32,
           "top1_agree": int((top_g == top_c).sum()),
           "top1_gaps": gaps, "cpu_forward_s": cpu_s, "card": card}
    if base_logits is not None:
        res["from_original_over_std"] = (
            (lg - base_logits).abs().max() / base_logits.std()).item()
        res["top1_agree_original"] = int(
            (top_g == base_logits.argmax(-1)).sum())
    log("check_resnet " + json.dumps(res))
    if not rel <= CHECK_TOL_F32:
        raise SystemExit(f"check_resnet {arch} {name}: card logits "
                         f"{rel:.3e} std from the CPU's (tol "
                         f"{CHECK_TOL_F32})")
    return res, lg


def _finetune_setup(model, tree, freeze: bool, steps: int):
    """(params, opt state, step) of the example's ``finetune`` on a copy
    of ``tree``."""
    from repro_torch.configs.base import LRDConfig, RunConfig
    from repro_torch.core import freezing
    from repro_torch.train.optim import OptimConfig
    from repro_torch.train.steps import init_opt_state, make_train_step
    from repro_torch.tree import tree_map
    run = RunConfig(model=model.cfg, lrd=LRDConfig(enabled=True,
                                                   freeze=freeze))
    opt = OptimConfig(total_steps=steps, **RESNET_TRAIN_OPTIM)
    params = tree_map(lambda v: v.detach().clone(), tree)
    freezing.set_requires_grad(params, freeze=freeze)
    return (run, params, init_opt_state(model, run, params, opt),
            make_train_step(model, run, opt))


def train_resnet(name: str, model, t: dict, card: str, seed: int) -> dict:
    """RESNET_TRAIN_STEPS masked-AdamW steps of one resnet50 tree at
    batch 32 (``SyntheticImages``): every step launches exactly the
    tree's fc chain once (B1 forward of an SVD pair), the losses are
    finite, and under the freeze the frozen factors have no gradient
    (``requires_grad`` off, values unchanged)."""
    import statistics
    import torch
    from repro_torch.core.freezing import FROZEN_LEAVES
    from repro_torch.train.data import SyntheticImages
    from repro_torch.train.optim import optimizer_state_bytes
    from repro_torch.tree import paths
    freeze = name == "layer_freezing"
    freed = fresh_peak()
    at_start = torch.cuda.memory_allocated()
    _, params, state, step = _finetune_setup(model, t["tree"], freeze,
                                             RESNET_TRAIN_STEPS)
    frozen = {p: v.clone() for p, v in paths(params)
              if freeze and set(p) & FROZEN_LEAVES}
    data = SyntheticImages(model.cfg, RESNET_BATCH, seed)
    losses, secs, per_step = [], [], []
    for i in range(RESNET_TRAIN_STEPS):
        batch = {k: v.cuda() for k, v in data.batch(i).items()}
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        params, state, met = step(params, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(_launches())
        losses.append(float(met["loss"]))
    if any(c != t["expect"] for c in per_step):
        raise SystemExit(f"train_resnet {name}: steps launched {per_step}, "
                         f"not {t['expect']} each")
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"train_resnet {name}: non-finite loss {losses}")
    now = dict(paths(params))
    moved = [p for p, v in frozen.items()
             if now[p].requires_grad or not torch.equal(now[p], v)]
    if moved:
        raise SystemExit(f"train_resnet {name}: frozen factors trained: "
                         f"{moved[:3]}")
    res = {"variant": name, "freeze": freeze, "batch": RESNET_BATCH,
           "steps": RESNET_TRAIN_STEPS, "losses": losses,
           "step_ms_mean_2_5": statistics.fmean(secs[1:]) * 1e3,
           "step_ms_stdev_2_5": statistics.stdev(secs[1:]) * 1e3,
           "step_ms": [v * 1e3 for v in secs],
           "images_per_s": RESNET_BATCH / statistics.fmean(secs[1:]),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "allocated_at_start": at_start, "freed_at_start": freed,
           "optimizer_state_bytes": optimizer_state_bytes(state["adam"]),
           "frozen_leaves": len(frozen), "launches_per_step": t["expect"],
           "card": card}
    log("train_resnet " + json.dumps(res))
    return res


def check_train_resnet(name: str, model, t: dict, card: str,
                       seed: int) -> dict:
    """One step's loss and every gradient of one resnet50 tree at batch
    2 on the card against the same params and batch on the CPU in f32,
    within TRAIN_CHECK_TOL; the frozen factors have no gradient on
    either side."""
    import dataclasses
    import torch
    from repro_torch.core import freezing
    from repro_torch.models.api import get_model
    from repro_torch.train.data import SyntheticImages
    from repro_torch.train.steps import make_loss_fn, value_and_grad
    from repro_torch.tree import paths
    run, params, _, _ = _finetune_setup(model, t["tree"],
                                        name == "layer_freezing", 1)
    batch = SyntheticImages(model.cfg, RESNET_CHECK_TRAIN_BATCH,
                            seed).batch(0)
    reset_launches()
    lg, _, gg = value_and_grad(make_loss_fn(model, run), params,
                               {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    launches = _launches()
    gg = {p: g for p, g in paths(to_cpu_f32(gg))}
    with torch.no_grad():
        p_cpu = to_cpu_f32(params)
    freezing.set_requires_grad(p_cpu, freeze=run.lrd.freeze)
    cpu = get_model(dataclasses.replace(model.cfg, dtype="float32"), "cpu")
    t0 = time.perf_counter()
    lc, _, gc = value_and_grad(make_loss_fn(cpu, run), p_cpu, batch)
    cpu_s = time.perf_counter() - t0
    gc = dict(paths(gc))
    if {p for p, g in gg.items() if g is None} != \
            {p for p, g in gc.items() if g is None}:
        raise SystemExit(f"check_train_resnet {name}: the card and the CPU "
                         "leave other leaves without a gradient")
    errs = {"/".join(p): ((gg[p] - g).norm() / g.norm().clamp_min(1e-30)
                          ).item() for p, g in gc.items() if g is not None}
    loss_rel = abs(float(lg) - float(lc)) / abs(float(lc))
    res = {"variant": name, "batch": RESNET_CHECK_TRAIN_BATCH,
           "loss_card": float(lg), "loss_cpu": float(lc),
           "loss_rel": loss_rel, "grad_rel_l2_max": max(errs.values()),
           "grad_rel_l2_worst": sorted(errs.items(), key=lambda kv: -kv[1])[
               :5],
           "no_grad": sorted("/".join(p) for p, g in gc.items()
                             if g is None),
           "tol": TRAIN_CHECK_TOL, "launches": launches, "cpu_step_s": cpu_s,
           "card": card}
    log("check_train_resnet " + json.dumps(res))
    if launches != t["expect"]:
        raise SystemExit(f"check_train_resnet {name}: launched {launches}, "
                         f"not {t['expect']}")
    if not (loss_rel <= TRAIN_CHECK_TOL["loss"]
            and res["grad_rel_l2_max"] <= TRAIN_CHECK_TOL["grad"]):
        raise SystemExit(f"check_train_resnet {name}: the card's step "
                         f"differs from the CPU f32 step: loss "
                         f"{loss_rel:.2e}, gradients "
                         f"{res['grad_rel_l2_max']:.3e} (tol "
                         f"{TRAIN_CHECK_TOL})")
    return res


def run_resnet(phases: list[str], card: str, seed: int,
               resnet_res: dict) -> None:
    """The ResNet phases: resnet50's Table 3 trees, then resnet101's and
    resnet152's Table 1 trees, each arch's trees freed before the
    next's."""
    import torch
    infer, check = "infer_resnet" in phases, "check_resnet" in phases
    timer = {p: 0.0 for p in RESNET_PHASES}
    archs = [("resnet50", tuple(RESNET_VARIANTS))]
    if infer or check:
        archs += [(a, ("original", "vanilla_lrd")) for a in RESNET_TABLE1]
    for arch, names in archs:
        log(f"-- {arch}: {', '.join(names)}")
        t0 = time.perf_counter()
        model, trees = resnet_trees(arch, names, seed)
        surgery_s = time.perf_counter() - t0
        timer["infer_resnet" if infer else "check_resnet"] += surgery_s
        rows = resnet_res.setdefault(arch, {})
        base = None
        for name in names:
            if infer:
                t0 = time.perf_counter()
                rows.setdefault(name, {})["infer"] = r = infer_resnet(
                    arch, name, model, trees[name], card, seed)
                timer["infer_resnet"] += time.perf_counter() - t0
                orig = rows["original"]["infer"]
                r["speedup"] = r["images_per_s"] / orig["images_per_s"]
                r["batch1_speedup"] = orig["batch1_ms"] / r["batch1_ms"]
                log("infer_resnet " + json.dumps(r))
            if check:
                t0 = time.perf_counter()
                rows.setdefault(name, {})["check"], lg = check_resnet(
                    arch, name, model, trees[name]["tree"], card, seed,
                    base)
                base = lg if base is None else base
                timer["check_resnet"] += time.perf_counter() - t0
        if arch == "resnet50" and "train_resnet" in phases:
            t0 = time.perf_counter()
            for name in RESNET_TRAIN:
                rows.setdefault(name, {})["train"] = r = train_resnet(
                    name, model, trees[name], card, seed)
                r["speedup"] = (rows["original"]["train"]["step_ms_mean_2_5"]
                                / r["step_ms_mean_2_5"])
                log(f"train_resnet {name} speedup {r['speedup']:.4f}")
            timer["train_resnet"] += time.perf_counter() - t0
        if arch == "resnet50" and "check_train_resnet" in phases:
            t0 = time.perf_counter()
            for name in RESNET_CHECK_TRAIN:
                rows.setdefault(name, {})["check_train"] = \
                    check_train_resnet(name, model, trees[name], card, seed)
            timer["check_train_resnet"] += time.perf_counter() - t0
        log(f"{arch} max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} [{card}]")
        del model, trees
        torch.cuda.empty_cache()
    # the phases run interleaved, arch by arch: each one's seconds summed
    # (the surgeries counted in infer_resnet, or in check_resnet without
    # it)
    for p in RESNET_PHASES:
        if p in phases:
            log(f"== phase {p}: {timer[p]:.2f} s")


# ---------------------------------------------------------------------------
# the last two families: llama-3.2-vision (VLM) and hubert-xlarge (encoder)
# ---------------------------------------------------------------------------

def vlm_chains(rep) -> tuple[dict[str, int], dict[str, int]]:
    """Chain launches (:func:`chain_launches`) of a VLM prefill segment
    and of a decode step: the cross blocks' k / v run at prefill only
    (their image K/V is cached)."""
    cached = ("cross/cross_attn/k", "cross/cross_attn/v")
    decode = types.SimpleNamespace(decisions=[
        d for d in rep.decisions if d.path not in cached])
    return chain_launches(rep), chain_launches(decode)


def with_gate(tree, gate: float):
    """``tree`` with every cross block's gate at ``gate`` (a new top of
    the tree; every other leaf shared)."""
    import torch
    ca = tree["cross"]["cross_attn"]
    return {**tree, "cross": {**tree["cross"], "cross_attn": {
        **ca, "gate": torch.full_like(ca["gate"], gate)}}}


def cross_check_vlm(cfg, params, card: str, seed: int, *, label: str,
                    prefill: dict[str, int], decode: dict[str, int],
                    quantize: str = "none", kv_quantize: str | None = None,
                    n_tok: int = 64, steps: int = 16) -> dict:
    """The image path on the card: ``LMModel.prefill`` of ``n_tok``
    tokens with random image embeddings (std :data:`VLM_IMAGE_STD`, the
    seed) and ``steps`` greedy decode steps over a one-stream cache of
    the phase's pool, with the factors quantized as the engine quantizes
    them (``quantize``), every cross gate at :data:`VLM_GATE`, three
    ways fed the CPU run's greedy tokens: the tree in f32 on the CPU
    (``cpu``), in bf16 on the card (``bf16``), and in bf16 on the card
    with the gates at 0 (``bf16_gate0``: a fresh tree's, where the cross
    attention adds nothing); an unquantized tree also in f32 on the card
    (``f32``, ``f32_gate0``: the f32 form of B1 / B2).  Each card run's
    decode steps are timed on the host clock, synchronised around each
    (``decode_ms``: the mean of steps 2 on).  The CPU run takes int8
    factors dequantized once to f32: the values the plain versions of
    B3 / B4 form from them at every call, so the same function at a
    quarter of the time.

    Gated: the card's bf16 logits within :data:`CHECK_TOL` of the CPU's
    std at every step, its f32 logits within :data:`CHECK_TOL_F32`; the
    gate-0 run's distance from the gated one (``image_effect``, two card
    runs that differ in the gates alone) above :data:`CHECK_TOL_F32`;
    each card run launches exactly ``prefill`` once and ``decode`` a
    step (B5 on the self layers of an int8 pool included)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.base import LRDConfig
    from repro_torch.models.api import get_model
    from repro_torch.quant.quantize import dequantize_tree, quantize_tree
    fresh_peak()
    if quantize != "none":
        with torch.inference_mode():
            params = quantize_tree(params, quantize,
                                   targets=LRDConfig().quant_targets)
    cpu_tree = dequantize_tree(to_cpu_f32(params), torch.float32)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, n_tok).tolist()
    img = torch.randn(
        (1, cfg.num_image_tokens, cfg.vision_d_model or cfg.d_model),
        generator=torch.Generator().manual_seed(seed)) * VLM_IMAGE_STD
    card_m = get_model(cfg, "cuda")
    card_img = img.to("cuda", card_m.dtype)
    sides = {"cpu": (get_model(dataclasses.replace(cfg, dtype="float32"),
                               "cpu"), with_gate(cpu_tree, VLM_GATE), img),
             "bf16": (card_m, with_gate(params, VLM_GATE), card_img),
             "bf16_gate0": (card_m, with_gate(params, 0.0), card_img)}
    if quantize == "none":
        f32_m = get_model(dataclasses.replace(cfg, dtype="float32"), "cuda")
        f32_tree = _tree_to(params, "cuda", torch.float32)
        f32_img = img.to("cuda")
        sides.update(f32=(f32_m, with_gate(f32_tree, VLM_GATE), f32_img),
                     f32_gate0=(f32_m, with_gate(f32_tree, 0.0), f32_img))
    runs: dict[str, dict] = {}
    with torch.inference_mode():
        for name, (m, p, im) in sides.items():
            dev, plan = m.device, m.cache_plan(kv_quantize)
            before = {k: launch_count(k) for k in KERNELS}
            t0 = time.perf_counter()
            cache = m.init_cache(1, n_tok + steps + 1, kv_quantize)
            lg, cache = m.prefill(
                p, {"tokens": torch.tensor([toks], device=dev),
                    "image_embeds": im}, cache, cache_plan=plan)
            logits = [lg[0, -1, :cfg.vocab_size].float().cpu()]
            fed = runs["cpu"]["fed"] if runs else []
            step_s = []
            for i in range(steps):
                if not runs:
                    fed.append(int(logits[-1].argmax()))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                ts = time.perf_counter()
                lg, cache = m.decode_step(
                    p, torch.tensor([[fed[i]]], device=dev),
                    torch.tensor([n_tok + i], device=dev), cache,
                    cache_plan=plan)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                step_s.append(time.perf_counter() - ts)
                logits.append(lg[0, -1, :cfg.vocab_size].float().cpu())
            runs[name] = dict(
                logits=logits, fed=fed, kvq=kv_quantize,
                seconds=time.perf_counter() - t0,
                decode_ms=1e3 * sum(step_s[1:]) / max(1, len(step_s) - 1),
                launches={k: launch_count(k) - before[k] for k in KERNELS})
            del cache
    res = {"quantize": quantize, "kv_quantize": kv_quantize or "none",
           "tokens": n_tok, "image_tokens": cfg.num_image_tokens,
           "decode_steps": steps, "gate": VLM_GATE, "tol": CHECK_TOL,
           "bf16": _against(runs["bf16"], runs["cpu"]),
           "gate0_vs_cpu": _against(runs["bf16_gate0"],
                                    runs["cpu"])["max_diff_over_std"],
           "image_effect": _against(runs["bf16_gate0"],
                                    runs["bf16"])["max_diff_over_std"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "seconds": {n: r["seconds"] for n, r in runs.items()},
           "decode_ms": {n: r["decode_ms"] for n, r in runs.items()
                         if n != "cpu"},
           "card": card}
    if "f32" in runs:
        res.update(f32=_against(runs["f32"], runs["cpu"]),
                   tol_f32=CHECK_TOL_F32,
                   image_effect_f32=_against(
                       runs["f32_gate0"], runs["f32"])["max_diff_over_std"])
    log(f"{label} " + json.dumps(res))
    if "f32" in runs:
        log(f"{label} f32 decode step {runs['f32']['decode_ms']:.3f} ms "
            f"(host clock, mean of steps 2-{steps}; bf16 "
            f"{runs['bf16']['decode_ms']:.3f}), f32 logits "
            f"{res['f32']['max_diff_over_std']:.3e} std from the CPU's "
            f"(tol {CHECK_TOL_F32}), image effect {res['image_effect']:.4f} "
            f"std (bf16) / {res['image_effect_f32']:.4f} (f32) [{card}]")
    reading = res["bf16"]["max_diff_over_std"]
    if not reading <= CHECK_TOL:
        raise SystemExit(f"{label}: card bf16 logits differ from the CPU f32 "
                         f"reference: {reading:.4f} > {CHECK_TOL}")
    if "f32" in res and not res["f32"]["max_diff_over_std"] <= CHECK_TOL_F32:
        raise SystemExit(f"{label}: card f32 logits differ from the CPU f32 "
                         f"reference: {res['f32']['max_diff_over_std']:.2e} > "
                         f"{CHECK_TOL_F32}")
    if not res["image_effect"] > CHECK_TOL_F32:
        raise SystemExit(f"{label}: the image path moves the logits by "
                         f"{res['image_effect']:.2e} std, no more than "
                         f"CHECK_TOL_F32 ({CHECK_TOL_F32})")
    want = {k: n for k, n in prefill.items()}
    for k, n in decode.items():
        want[k] = want.get(k, 0) + n * steps
    want = {k: want.get(k, 0) for k in KERNELS}
    for name in set(runs) - {"cpu"}:
        if runs[name]["launches"] != want:
            raise SystemExit(f"{label} ({name}) launched "
                             f"{runs[name]['launches']}, want {want}")
    return res


def run_vlm(phases: list[str], card: str, seed: int,
            serve_res: dict, train_res: dict) -> None:
    """``serve_vlm`` / ``check_vlm`` (bf16 factors, bf16 slot pool) and
    ``serve_vlm_q`` / ``check_vlm_q`` (int8 factors, int8 slot pool) of
    llama-3.2-vision-90b at its published widths, cut to
    :data:`VLM_DEPTH` layers: built, decomposed and held to
    :data:`VLM_SURGERY` on the card, served by blocking admission with
    the exact launches of every segment, checked against the port's CPU
    f32 run (:func:`cross_check_vlm`); then ``check_train_vlm`` /
    ``train_vlm`` on the same tree (:func:`train_served_tree`); freed
    when this returns."""
    import torch
    from repro_torch.quant.quantize import tree_bytes
    t_all = time.perf_counter()
    fresh_peak()
    t0 = time.perf_counter()
    cfg, dense, axes = config_model(VLM_ARCH, VLM_DEPTH, seed)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    dense_bytes = tree_bytes(dense)
    lrd, params, rep, surg_s = decompose(dense, axes, branches=4)
    del dense, axes
    torch.cuda.empty_cache()
    log(f"surgery vlm branches=4: init {init_s:.2f} s, surgery "
        f"{surg_s:.2f} s, dense tree {dense_bytes} B, peak "
        f"{torch.cuda.max_memory_allocated()} B (init {init_peak} B), "
        f"{json.dumps(rep.summary())} [{card}]")
    check_surgery("vlm", rep, params, card, VLM_SURGERY)
    prefill, decode = vlm_chains(rep)
    if (tuple(prefill.values()), tuple(decode.values())) != (
            VLM_CHAINS["prefill"], VLM_CHAINS["decode"]):
        raise SystemExit(f"vlm surgery implies {prefill} a prefill and "
                         f"{decode} a decode step, want {VLM_CHAINS}")
    n_self = VLM_DEPTH - VLM_DEPTH // cfg.cross_attn_every
    #: the image K/V of the 8-slot pool (model dtype in either pool)
    cross_bytes = (2 * (VLM_DEPTH // cfg.cross_attn_every) * 8
                   * cfg.num_image_tokens * cfg.num_kv_heads
                   * cfg.resolved_head_dim * 2)
    for tag, engine in (("", {}), ("_q", dict(quantize="int8",
                                              kv_quantize="int8"))):
        pf = {k + tag: n for k, n in prefill.items()}
        dec = {k + tag: n for k, n in decode.items()}
        if tag:
            dec["decode_attention_q"] = n_self
        if f"serve_vlm{tag}" in phases:
            with Phase(f"serve_vlm{tag}"):
                res = serve(cfg, lrd, params, n_req=8, prompt_lo=32,
                            prompt_hi=512, new_tokens=32, card=card,
                            seed=seed, expect={"decode": dec,
                                               "prefill": pf}, **engine)
                res.update(surgery_s=surg_s, init_s=init_s,
                           config=VLM_ARCH, depth=VLM_DEPTH,
                           admission="blocking",
                           dense_weight_bytes=dense_bytes,
                           cross_kv_bytes=cross_bytes)
                serve_res["vlm" + tag] = res
                log(f"serve_vlm{tag} kv_bytes_per_step "
                    f"{res['kv_bytes_per_step']} B ({cross_bytes} B of "
                    f"them the image K/V), weight_bytes "
                    f"{res['weight_bytes']} B [{card}]")
        if f"check_vlm{tag}" in phases:
            with Phase(f"check_vlm{tag}"):
                cross_check_vlm(cfg, params, card, seed,
                                label=f"check_vlm{tag}", prefill=pf,
                                decode=dec,
                                quantize=engine.get("quantize", "none"),
                                kv_quantize=engine.get("kv_quantize"))
    log(f"vlm phases {time.perf_counter() - t_all:.2f} s [{card}]")
    served = [cfg, params, rep, init_s, surg_s]
    del params
    train_served_tree("vlm", phases, card, seed, train_res, served)


def _hubert_logits(model, tree, batch, vocab: int):
    """``make_forward_step``'s logits of ``batch`` over the real
    vocabulary (the padded columns hold -1e30), on the host in f32."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.train.steps import make_forward_step
    fwd = make_forward_step(model, RunConfig(model=model.cfg))
    return fwd(tree, batch)[..., :vocab].float().cpu()


def run_hubert(phases: list[str], card: str, seed: int,
               hubert_res: dict) -> None:
    """``infer_hubert`` / ``check_hubert``: hubert-xlarge at full width
    and depth, random bf16 weights from the seed, decomposed on the card
    with ``LRD`` at branches=4 and held to :data:`HUBERT_SURGERY`;
    ``make_forward_step`` (the encoder's entry point) over
    :data:`HUBERT_CLIPS` clips of :data:`HUBERT_FRAMES` frames (M =
    :data:`HUBERT_M` rows through every linear), the dense tree timed
    before the surgery; the check against the port's CPU f32 run."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models.api import get_model, synth_inputs
    from repro_torch.quant.quantize import tree_bytes
    from repro_torch.train.steps import make_forward_step
    t_all = time.perf_counter()
    fresh_peak()
    t0 = time.perf_counter()
    cfg, dense, axes = config_model(HUBERT_ARCH, 48, seed)
    init_s = time.perf_counter() - t0
    model = get_model(cfg, "cuda")
    batch = synth_inputs(cfg, ShapeConfig("infer_hubert", HUBERT_FRAMES,
                                          HUBERT_CLIPS, "prefill"),
                         torch.Generator(device="cuda").manual_seed(seed))
    fwd = make_forward_step(model, RunConfig(model=cfg))

    def times(tree) -> list[float]:
        out = []
        for _ in range(HUBERT_TIMED):
            t0 = time.perf_counter()
            fwd(tree, batch)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out
    infer = "infer_hubert" in phases
    if infer:
        for _ in range(2):
            fwd(dense, batch)
        dense_s = times(dense)
    dense_bytes = tree_bytes(dense)
    lrd, params, rep, surg_s = decompose(dense, axes, branches=4)
    del dense, axes
    torch.cuda.empty_cache()
    log(f"surgery hubert branches=4: init {init_s:.2f} s, surgery "
        f"{surg_s:.2f} s, {json.dumps(rep.summary())} [{card}]")
    check_surgery("hubert", rep, params, card, HUBERT_SURGERY)
    chain = chain_launches(rep)
    if (chain["lowrank_matmul"], chain["branched_matmul"]) != HUBERT_CHAINS:
        raise SystemExit(f"hubert surgery implies {chain} a forward, want "
                         f"{HUBERT_CHAINS}")
    if infer:
        with Phase("infer_hubert"):
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            y = fwd(params, batch)
            torch.cuda.synchronize()
            first = _launches()
            fwd(params, batch)
            reset_launches()
            secs = times(params)
            timed = _launches()
            if first != chain or timed != {k: n * HUBERT_TIMED
                                           for k, n in chain.items()}:
                raise SystemExit(f"infer_hubert: a forward launched {first} "
                                 f"(timed: {timed}), not {chain}")
            if y.shape != (HUBERT_CLIPS, HUBERT_FRAMES, model.padded_vocab) \
                    or not torch.isfinite(y[..., :cfg.vocab_size]).all():
                raise SystemExit(f"infer_hubert: logits of shape "
                                 f"{tuple(y.shape)} or not finite")
            mean, dmean = statistics.fmean(secs), statistics.fmean(dense_s)
            res = {"config": HUBERT_ARCH, "layers": cfg.num_layers,
                   "clips": HUBERT_CLIPS, "frames": HUBERT_FRAMES,
                   "rows": HUBERT_M, "forward_ms_mean": mean * 1e3,
                   "forward_ms_stdev": statistics.stdev(secs) * 1e3,
                   "frames_per_s": HUBERT_M / mean,
                   "dense_forward_ms_mean": dmean * 1e3,
                   "dense_forward_ms_stdev": statistics.stdev(dense_s) * 1e3,
                   "dense_frames_per_s": HUBERT_M / dmean,
                   "speedup": dmean / mean,
                   "weight_bytes": tree_bytes(params),
                   "dense_weight_bytes": dense_bytes,
                   "surgery_s": surg_s, "init_s": init_s,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "launches_per_forward": first, "card": card}
            hubert_res["infer"] = res
            log("infer_hubert " + json.dumps(res))
    if "check_hubert" in phases:
        with Phase("check_hubert"):
            one = {k: v[:HUBERT_CHECK_CLIPS] for k, v in batch.items()}
            cpu = get_model(dataclasses.replace(cfg, dtype="float32"), "cpu")
            card32 = get_model(dataclasses.replace(cfg, dtype="float32"),
                               "cuda")
            fresh_peak()
            reset_launches()
            lg = _hubert_logits(model, params, one, cfg.vocab_size)
            bf16_launches = _launches()
            lg32 = _hubert_logits(card32, _tree_to(params, "cuda",
                                                   torch.float32),
                                  one, cfg.vocab_size)
            f32_launches = {k: n - bf16_launches.get(k, 0)
                            for k, n in _launches().items()}
            t0 = time.perf_counter()
            lc = _hubert_logits(cpu, to_cpu_f32(params),
                                {k: v.cpu() for k, v in one.items()},
                                cfg.vocab_size)
            cpu_s = time.perf_counter() - t0
            res = {"clips": HUBERT_CHECK_CLIPS, "frames": HUBERT_FRAMES,
                   "tol": CHECK_TOL, "tol_f32": CHECK_TOL_F32,
                   "cpu_forward_s": cpu_s, "card": card}
            for name, got, n in (("bf16", lg, bf16_launches),
                                 ("f32", lg32, f32_launches)):
                res[name] = {
                    "max_diff_over_std": ((got - lc).abs().max()
                                          / lc.std()).item(),
                    "argmax_agree_share": (got.argmax(-1) == lc.argmax(-1))
                    .float().mean().item(), "launches": n}
            res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            hubert_res["check"] = res
            log("check_hubert " + json.dumps(res))
            for name, tol in (("f32", CHECK_TOL_F32), ("bf16", CHECK_TOL)):
                if not res[name]["max_diff_over_std"] <= tol:
                    raise SystemExit(
                        f"check_hubert: card {name} logits differ from the "
                        f"CPU f32 reference: "
                        f"{res[name]['max_diff_over_std']:.3e} > {tol}")
                if res[name]["launches"] != chain:
                    raise SystemExit(f"check_hubert ({name}) launched "
                                     f"{res[name]['launches']}, not {chain}")
    if "profile_hubert" in phases:
        with Phase("profile_hubert"):
            for _ in range(2):
                fwd(params, batch)
            reset_launches()
            res = _profiled(lambda: fwd(params, batch), PROFILE_STEPS)
            if _launches() != {k: n * PROFILE_STEPS for k, n in chain.items()}:
                raise SystemExit(f"profile_hubert: {PROFILE_STEPS} forwards "
                                 f"launched {_launches()}, not {chain} each")
            res.update(config=HUBERT_ARCH, rows=HUBERT_M,
                       launches_per_forward=chain, card=card)
            hubert_res["profile"] = res
            log("profile_hubert " + json.dumps(res))
    log(f"hubert phases {time.perf_counter() - t_all:.2f} s [{card}]")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_launches(model, rep, seq: int) -> dict[str, int]:
    """Chain-kernel forwards in one train step (remat "none") of a tree
    whose surgery ``rep`` reports: each decomposed linear's once
    (:func:`chain_launches`; the hybrid's shared block once a group), and
    a decomposed unembed once per cross-entropy chunk in the forward and
    again in the backward, which recomputes each chunk's logits
    (``models/lm.py::_chunked_ce``)."""
    from repro_torch.models.lm import CE_CHUNK_SEQ
    out = chain_launches(rep, getattr(model, "n_groups", 1))
    kernel = {"svd": "lowrank_matmul", "branched": "branched_matmul"}
    head = next((d for d in rep.decisions if d.path == "unembed"
                 and d.kind in kernel), None)
    if head is not None:
        chunk = min(CE_CHUNK_SEQ, seq)
        chunks = seq // chunk if seq % chunk == 0 else 1
        out[kernel[head.kind]] += 2 * chunks - 1
    return {k: n for k, n in out.items() if n}


def train_run(cfg, card: str, seed: int, *, label: str, lrd, remat: str,
              steps: int, expect: dict[str, int], falls: bool, data=None,
              batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
              params=None, parallel: dict | None = None,
              mesh=None) -> dict:
    """``steps`` steps of the port's ``train()`` on the card (bf16; by
    default ByteTextLM at TRAIN_BATCH x TRAIN_SEQ and a tree ``train()``
    builds and decomposes from the seed, else ``data`` at ``batch`` x
    ``seq`` and ``params``, trained in place; ``parallel``: more
    ``ParallelConfig`` fields, ``mesh``: ``train()``'s) and the checks:
    every step launches exactly ``expect`` (kernel -> forwards; a kernel
    not named must not launch), every loss is finite, and with ``falls``
    the last loss is below the first.  The counts are set to 0 just before
    ``train()`` and read at the start of every step (its ``fault_hook``)
    and just after."""
    import statistics
    import torch
    from repro_torch.configs.base import ParallelConfig, RunConfig
    from repro_torch.train.data import ByteTextLM
    from repro_torch.train.loop import train
    from repro_torch.train.optim import OptimConfig
    run = RunConfig(model=cfg, lrd=lrd, parallel=ParallelConfig(
        remat=remat, **(parallel or {})), seed=seed)
    if data is None:
        data = ByteTextLM(cfg, batch=batch, seq_len=seq)
    marks: list[dict[str, int]] = []

    def mark(step: int) -> None:
        marks.append({k: launch_count(k) for k in KERNELS})

    freed = fresh_peak()
    at_start = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.perf_counter()
    r = train(run, data, num_steps=steps,
              optim_cfg=OptimConfig(total_steps=steps, **TRAIN_OPTIM),
              fault_hook=mark, log_every=0, log_fn=log, device="cuda",
              params=params, mesh=mesh)
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
           "remat": remat, "steps": steps, "batch": batch, "seq": seq,
           "depth": cfg.num_layers, "loss_first": r.losses[0],
           "loss_last": r.losses[-1], "losses": r.losses,
           "step_ms_median": med * 1e3, "first_step_ms": secs[0] * 1e3,
           "step_ms": [t * 1e3 for t in secs],
           "tokens_per_s": batch * seq / med,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "allocated_at_start": at_start, "freed_at_start": freed,
           "optimizer_state_bytes": r.stats["optimizer_state_bytes"],
           "trainable_params": r.stats["trainable_params"],
           "frozen_params": r.stats["frozen_params"],
           "launches_per_step": expect,
           "launches": {k: launch_count(k) for k in expect},
           "wall_s": wall, "card": card}
    if mesh is not None:
        res["param_shard_bytes"] = r.stats["param_shard_bytes"]
    log("train " + json.dumps(res))
    return res


def _flat_grads(tree) -> dict:
    from repro_torch.tree import paths
    return {"/".join(p): v for p, v in paths(tree)}


def _train_step_on(cfg, params, batch: dict, device: str, dtype: str,
                   run) -> tuple:
    """One ``value_and_grad`` step of the loss of ``params`` (already on
    ``device`` in ``dtype``, the freeze set) on ``batch`` moved there:
    (loss, gradients flat by path on the CPU in f32, seconds)."""
    import dataclasses
    import torch
    from repro_torch.models.api import get_model
    from repro_torch.train.steps import make_loss_fn, value_and_grad
    model = get_model(dataclasses.replace(cfg, dtype=dtype), device)
    on = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    t0 = time.perf_counter()
    loss, _, grads = value_and_grad(make_loss_fn(model, run), params, on)
    if device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return float(loss), _flat_grads(to_cpu_f32(grads)), secs


def _grad_against(loss: float, grads: dict, loss_ref: float,
                  ref: dict) -> dict:
    """The relative loss difference and every gradient's relative L2
    distance (||got - ref|| / ||ref||) from the reference step's."""
    if {k for k, g in grads.items() if g is None} != \
            {k for k, g in ref.items() if g is None}:
        raise SystemExit("check_train: the card and the CPU leave other "
                         "leaves without a gradient")
    errs = {k: ((grads[k] - g).norm() / g.norm().clamp_min(1e-30)).item()
            for k, g in ref.items() if g is not None}
    return {"loss": loss, "loss_rel": abs(loss - loss_ref) / abs(loss_ref),
            "grad_rel_l2": errs, "grad_rel_l2_max": max(errs.values()),
            "worst_leaf": max(errs, key=errs.get)}


def check_train_step(cfg, params, batch: dict, card: str, seed: int, *,
                     label: str, gate: str = "bfloat16",
                     expect: dict[str, int] | None = None,
                     image_share: bool = False) -> dict:
    """One step's loss and every trainable leaf's gradient of the frozen
    tree ``params`` (on the card, bf16) on ``batch``: on the card in bf16
    (kernels), and in f32 too where ``gate`` is f32, against the same
    params and batch on the CPU in f32 (plain versions).  The card run in
    ``gate`` must launch exactly ``expect`` (where given) and stay within
    TRAIN_CHECK_TOL of the CPU's (the loss within 1e-2 relative, every
    gradient within 0.05 relative L2); the other card run is reported.
    The frozen factors have no gradient on any side.  ``image_share``
    (the VLM): the bf16 card step again with zero image embeddings, and
    the share of the cross block's gradient that the image path carries,
    ||g - g(zero images)|| / ||g|| over its trainable leaves."""
    import torch
    from repro_torch.configs.base import LRDConfig, RunConfig
    from repro_torch.core import freezing
    run = RunConfig(model=cfg, lrd=LRDConfig(**LRD, branches=4,
                                             freeze=True), seed=seed)
    freezing.set_requires_grad(params, freeze=True)
    res = {"label": label, "gate": gate, "tol": TRAIN_CHECK_TOL,
           "depth": cfg.num_layers,
           "batch": {k: list(torch.as_tensor(v).shape)
                     for k, v in batch.items()}, "card": card}
    card_runs = {}
    for dname in ("bfloat16",) + (("float32",) if gate == "float32"
                                  else ()):
        tree = params if dname == "bfloat16" else freezing.set_requires_grad(
            _tree_to(params, "cuda", torch.float32), freeze=True)
        fresh_peak()
        reset_launches()
        lg, gg, secs = _train_step_on(cfg, tree, batch, "cuda", dname, run)
        launches = {k: launch_count(k) for k in KERNELS if launch_count(k)}
        card_runs[dname] = (lg, gg)
        res[f"card_{dname}"] = {"seconds": secs, "launches": launches,
                                "max_memory_allocated":
                                    torch.cuda.max_memory_allocated()}
        if dname == gate and expect is not None and launches != expect:
            raise SystemExit(f"{label}: the {dname} card step launched "
                             f"{launches}, not {expect}")
        del tree
    if image_share:
        zero = dict(batch, image_embeds=torch.zeros_like(
            torch.as_tensor(batch["image_embeds"])))
        _, g0, _ = _train_step_on(cfg, params, zero, "cuda", "bfloat16", run)
        gg = card_runs["bfloat16"][1]
        keys = [k for k in gg if k.startswith("cross/") and gg[k] is not None
                and gg[k].ndim >= 2]
        num = sum(float((gg[k] - g0[k]).norm() ** 2) for k in keys)
        den = sum(float(gg[k].norm() ** 2) for k in keys)
        res["image_share"] = math.sqrt(num / den)
        res["image_share_leaves"] = {
            k: float((gg[k] - g0[k]).norm() / gg[k].norm().clamp_min(1e-30))
            for k in keys}
    t0 = time.perf_counter()
    with torch.no_grad():
        p_cpu = to_cpu_f32(params)
    freezing.set_requires_grad(p_cpu, freeze=True)
    torch.cuda.empty_cache()
    to_cpu_s = time.perf_counter() - t0
    lc, gc, cpu_s = _train_step_on(cfg, p_cpu, batch, "cpu", "float32", run)
    del p_cpu
    t0 = time.perf_counter()
    for dname, (lg, gg) in card_runs.items():
        res[f"card_{dname}"].update(_grad_against(lg, gg, lc, gc))
    res.update(loss_cpu=lc, cpu_step_s=cpu_s, to_cpu_s=to_cpu_s,
               compare_s=time.perf_counter() - t0,
               no_grad=sorted(k for k, g in gc.items() if g is None))
    got = res[f"card_{gate}"]
    log(f"{label} " + json.dumps(res))
    if not (got["loss_rel"] <= TRAIN_CHECK_TOL["loss"]
            and got["grad_rel_l2_max"] <= TRAIN_CHECK_TOL["grad"]):
        raise SystemExit(f"{label}: the card's {gate} step differs from "
                         f"the CPU f32 step: loss {got['loss_rel']:.2e}, "
                         f"gradients {got['grad_rel_l2_max']:.3e} at "
                         f"{got['worst_leaf']} (tol {TRAIN_CHECK_TOL})")
    return res


def check_train(cfg, card: str, seed: int) -> dict:
    """:func:`check_train_step` of the frozen branches=4 llama tree at
    full depth on ByteTextLM's first batch (TRAIN_BATCH x TRAIN_SEQ), bf16
    card against f32 CPU."""
    import torch
    from repro_torch.configs.base import LRDConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.models.api import get_model
    from repro_torch.train.data import ByteTextLM
    lrd = LRDConfig(**LRD, branches=4, freeze=True)
    m_gpu = get_model(cfg, "cuda")
    with torch.no_grad():
        params, axes = m_gpu.init(
            torch.Generator(device="cuda").manual_seed(seed))
        params, _, _ = decompose_model(params, axes, lrd)
    batch = ByteTextLM(cfg, TRAIN_BATCH, TRAIN_SEQ).batch(0)
    return check_train_step(cfg, params, batch, card, seed,
                            label="check_train")


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
    if "profile_train" in phases:
        with Phase("profile_train"):
            train_res["profile"] = profile_train(cfg, card, seed, chain)


def profile_train(cfg, card: str, seed: int, chain: dict[str, int]
                  ) -> dict:
    """Where one frozen fine-tuning step's time goes (ROADMAP B-8's
    first ask): the full-width branches=4 llama tree, decomposed and
    frozen as the train phase's, one ``make_train_step`` step (forward,
    backward, AdamW) on ByteTextLM's first batch (TRAIN_BATCH x
    TRAIN_SEQ), :func:`_profiled` over PROFILE_STEPS steps after two warm
    ones; every step launches exactly ``chain``."""
    import torch
    from repro_torch.configs.base import LRDConfig, RunConfig
    from repro_torch.core import freezing
    from repro_torch.core.surgery import decompose_model
    from repro_torch.models.api import get_model
    from repro_torch.train.data import ByteTextLM
    from repro_torch.train.optim import OptimConfig
    from repro_torch.train.steps import init_opt_state, make_train_step
    lrd = LRDConfig(**LRD, branches=4, freeze=True)
    run = RunConfig(model=cfg, lrd=lrd, seed=seed)
    model = get_model(cfg, "cuda")
    with torch.no_grad():
        params, axes = model.init(
            torch.Generator(device="cuda").manual_seed(seed))
        params, _, _ = decompose_model(params, axes, lrd)
    freezing.set_requires_grad(params, freeze=True)
    opt_cfg = OptimConfig(total_steps=TRAIN_STEPS, **TRAIN_OPTIM)
    state = [params, init_opt_state(model, run, params, opt_cfg)]
    train_step = make_train_step(model, run, opt_cfg)
    batch = {k: torch.as_tensor(v).to("cuda") for k, v in
             ByteTextLM(cfg, TRAIN_BATCH, TRAIN_SEQ).batch(0).items()}

    def step():
        state[0], state[1], metrics = train_step(state[0], state[1], batch)
        float(metrics["loss"])
    for _ in range(2):
        step()
    reset_launches()
    res = _profiled(step, PROFILE_STEPS)
    if _launches() != {k: n * PROFILE_STEPS for k, n in chain.items()}:
        raise SystemExit(f"profile_train: {PROFILE_STEPS} steps launched "
                         f"{_launches()}, not {chain} each")
    res.update(label="frozen", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               launches_per_step=chain, card=card)
    log("profile_train " + json.dumps(res))
    return res


#: the mesh phase: one NCCL rank (a FileStore in a temporary directory
#: joins it) on a (1, 1, 1) ("pod", "data", "model") mesh, and the
#: ParallelConfig fields the mesh path reads; its train steps, and its
#: gate: the loss and every gradient within this relative distance of the
#: run without a mesh (one rank changes no arithmetic)
MESH_PARALLEL = dict(fsdp=True, shard_vocab=True, multi_pod=True,
                     grad_compression_rank=4)
MESH_STEPS = 2
MESH_TOL = 1e-6


def _mesh_grads(cfg, lrd, mesh, seed: int) -> dict:
    """One step's synced gradients (``make_synced_grads``, PowerSGD over
    ``pod`` included) of the frozen branches=4 llama tree on ByteTextLM's
    first batch, with and without ``mesh``: their loss and every
    gradient's relative L2 distance."""
    import torch
    from repro_torch.configs.base import ParallelConfig, RunConfig
    from repro_torch.core import freezing
    from repro_torch.core.surgery import decompose_model
    from repro_torch.models.api import get_model
    from repro_torch.parallel import placement
    from repro_torch.parallel.sharding import make_param_shardings
    from repro_torch.train.data import ByteTextLM
    from repro_torch.train.optim import OptimConfig
    from repro_torch.train.steps import init_opt_state, make_synced_grads
    run = RunConfig(model=cfg, lrd=lrd,
                    parallel=ParallelConfig(**MESH_PARALLEL), seed=seed)
    model = get_model(cfg, "cuda")
    with torch.no_grad():
        params, axes = model.init(
            torch.Generator(device="cuda").manual_seed(seed))
        params, axes, _ = decompose_model(params, axes, lrd)
    freezing.set_requires_grad(params, freeze=True)
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             ByteTextLM(cfg, TRAIN_BATCH, TRAIN_SEQ).batch(0).items()}
    got = {}
    for name, m in (("mesh", mesh), ("none", None)):
        tree = params if m is None else placement.place(
            params, make_param_shardings(m, params, axes, run.parallel))
        state = init_opt_state(model, run, tree, OptimConfig())
        loss, _, grads, _ = make_synced_grads(model, run, m)(tree, state,
                                                            batch)
        got[name] = (float(loss), _flat_grads(grads))
        del tree, state, grads
    (lm, gm), (ln, gn) = got["mesh"], got["none"]
    if {k for k, g in gm.items() if g is None} != \
            {k for k, g in gn.items() if g is None}:
        raise SystemExit("mesh: the mesh leaves other leaves without a "
                         "gradient")
    errs = {k: ((gm[k].float() - g.float()).norm()
                / g.float().norm().clamp_min(1e-30)).item()
            for k, g in gn.items() if g is not None}
    return {"loss_mesh": lm, "loss": ln, "loss_rel": abs(lm - ln) / abs(ln),
            "grad_rel_l2_max": max(errs.values()),
            "worst_leaf": max(errs, key=errs.get), "gradients": len(errs)}


def run_mesh(card: str, seed: int, served_q: dict | None) -> dict:
    """The ``mesh`` phase: a process group of one NCCL rank and a (1, 1,
    1) ("pod", "data", "model") mesh from ``launch/mesh.py``.  Train:
    llama3.2-1b at full width (the train phase's frozen branches=4 tree
    and batch) under :data:`MESH_PARALLEL`, :data:`MESH_STEPS` steps of
    ``train(..., mesh=)`` and the same steps without the mesh, exact B1 /
    B2 launches in both; the losses, and one step's synced gradients
    (:func:`_mesh_grads`), within :data:`MESH_TOL` of the run without.
    Serve: serve_q's int8 tree (quantized before it is placed) on the
    mesh over the int8 slot pool, exact launches, greedy streams
    token-identical to serve_q's (to a run without the mesh where
    serve_q did not run).  One rank holds the mesh code path and the
    kernels under it on the card; collectives across ranks are held on
    the CPU (``tests/test_torch_mesh_train.py``)."""
    import os
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import LRDConfig, ParallelConfig
    from repro_torch.configs import registry
    from repro_torch.core.surgery import decompose_model
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import placement
    from repro_torch.parallel.sharding import make_param_shardings
    from repro_torch.quant.quantize import quantize_tree
    cfg = registry.get("llama3.2-1b").full
    frozen = LRDConfig(**LRD, branches=4, freeze=True)
    chain = {k: sum(v.values()) for k, v in TRAIN_LAUNCHES.items()}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one rank, local
    store = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        res = {"mesh": {"shape": [1, 1, 1], "axes": ["pod", "data", "model"],
                        "backend": dist.get_backend()},
               "parallel": MESH_PARALLEL, "card": card}
        runs = {name: train_run(
            cfg, card, seed, label=f"mesh phase, {name}", lrd=frozen,
            remat="none", steps=MESH_STEPS, expect=chain, falls=False,
            parallel=MESH_PARALLEL, mesh=m)
            for name, m in (("on the mesh", mesh), ("no mesh", None))}
        on, off = runs["on the mesh"], runs["no mesh"]
        res["train"] = {
            "losses": on["losses"], "losses_no_mesh": off["losses"],
            "loss_rel_max": max(abs(a - b) / abs(b) for a, b in
                                zip(on["losses"], off["losses"])),
            "step_ms": on["step_ms"], "step_ms_no_mesh": off["step_ms"],
            "launches_per_step": on["launches_per_step"],
            "param_shard_bytes": on["param_shard_bytes"],
            "max_memory_allocated": on["max_memory_allocated"],
            "max_memory_allocated_no_mesh": off["max_memory_allocated"]}
        res["grads"] = _mesh_grads(cfg, frozen, mesh, seed)
        fresh_peak()
        _, dense, axes = full_model(seed)
        with torch.inference_mode():
            p4, axes4, _ = decompose_model(dense, axes,
                                           LRDConfig(**LRD, branches=4))
            del dense
            pq, axq = quantize_tree(p4, "int8", targets=frozen.quant_targets,
                                    axes=axes4)
            del p4
            placed = placement.place(pq, make_param_shardings(
                mesh, pq, axq, ParallelConfig(**MESH_PARALLEL)))
        lrd = LRDConfig(**LRD, branches=4)
        qchain = {"lowrank_matmul_q": 32, "branched_matmul_q": 80}
        expect = {"decode": {**qchain, "decode_attention_q": 16},
                  "prefill_chunk": qchain}
        serve_kw = dict(n_req=8, prompt_lo=32, prompt_hi=512, new_tokens=32,
                        card=card, seed=seed, expect=expect,
                        kv_quantize="int8")
        served = serve(cfg, lrd, placed, **serve_kw)
        del placed
        if served_q is None:
            served_q = serve(cfg, lrd, pq, quantize="int8", **serve_kw)
            against = "a run without the mesh"
        else:
            against = "serve_q"
        del pq
        greedy = range(0, len(served["outputs"]), 2)    # temperature 0
        same = [served["outputs"][i] == served_q["outputs"][i]
                for i in greedy]
        res["serve"] = {
            "against": against, "greedy_identical": f"{sum(same)}/"
            f"{len(same)}", "all_identical": served["outputs"]
            == served_q["outputs"],
            **{k: served[k] for k in (
                "decode_step_ms_mean", "tokens_per_s", "ttft_mean_s",
                "weight_bytes", "kv_bytes_per_step", "launches",
                "max_memory_allocated")},
            "decode_step_ms_mean_against": served_q["decode_step_ms_mean"]}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    log("mesh " + json.dumps(res))
    if not res["train"]["loss_rel_max"] <= MESH_TOL:
        raise SystemExit(f"mesh: the losses on the mesh differ from the run "
                         f"without: {res['train']}")
    grads = res["grads"]
    if not (grads["loss_rel"] <= MESH_TOL
            and grads["grad_rel_l2_max"] <= MESH_TOL):
        raise SystemExit(f"mesh: the synced gradients on the mesh differ "
                         f"from the run without: {grads}")
    if not all(same):
        raise SystemExit(f"mesh: greedy streams on the mesh differ from "
                         f"{against}'s: {res['serve']['greedy_identical']}")
    return res


#: the roofline phase: 8 greedy requests of one 64-token prefill chunk
#: each on the bf16 slot pool of the branches=4 llama tree, and the
#: uncounted step timed this many times
ROOFLINE_PROMPT = 64
ROOFLINE_NEW = 16
ROOFLINE_TIMED = 20
#: the dryrun phase's cells: llama3.2-1b (shape, multi-pod), one child
#: process each, run side by side
DRYRUN_CELLS = (("decode_32k", False), ("decode_32k", True),
                ("train_4k", False), ("train_4k", True))
DRYRUN_TIMEOUT = 600


def _fake_like(obj):
    """``obj`` with every tensor replaced by an empty CPU tensor of its
    shape, strides and dtype (fake under the caller's ``FakeTensorMode``);
    dicts, lists and tuples walked, other leaves kept."""
    import torch
    if isinstance(obj, torch.Tensor):
        return torch.empty_strided(obj.shape, obj.stride(), dtype=obj.dtype,
                                   device="cpu")
    if isinstance(obj, dict):
        return {k: _fake_like(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_fake_like(v) for v in obj)
    return obj


def _costs_row(costs) -> dict:
    return {"flops": costs.flops, "hbm_bytes": costs.hbm_bytes,
            "collective_bytes": costs.collective_bytes,
            "kernels": {k: list(v) for k, v in costs.kernel_detail.items()}}


def run_roofline(card: str, seed: int) -> dict:
    """The ``roofline`` phase: the whole-step count of
    ``analysis/roofline.py`` on the card.  The full-width llama3.2-1b
    tree (bf16, branches=4, as the serve phase's) serves 8 greedy
    requests of one :data:`ROOFLINE_PROMPT`-token prefill chunk each on
    the slot pool, twice: once plainly, once with a ``StepCounter``
    around the first prefill chunk and the first decode step with all 8
    slots live.  The streams must be token-identical and the counted
    segments' B1 / B2 launches exact (and equal to the kernels the
    counter charged).  Each counted call is replayed through the same
    runner on the CPU, on fake tensors of its arguments' shapes, strides
    and dtypes (the plain path): its FLOPs, bytes and kernel charges must
    equal the card's exactly.  The same call is then timed without the
    counter (:data:`ROOFLINE_TIMED` runs, CUDA events): the bound (the
    larger of the compute and memory terms on the H100 spec) over the
    median measured time is the step's roofline share; counted over
    model FLOPs (2 N a token, N the dense tree's matmul values) beside
    it."""
    import statistics
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis.roofline import StepCounter, roofline
    from repro_torch.configs.base import RunConfig
    from repro_torch.models.api import get_model
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, dense, axes = full_model(seed)
    lrd, params, rep, _ = decompose(dense, axes, branches=4)
    del dense
    chain = {k: n for k, n in chain_launches(rep).items() if n}
    prompts = request_prompts(cfg, seed, 8, ROOFLINE_PROMPT,
                              ROOFLINE_PROMPT)

    def drive(count: bool):
        eng = ServeEngine(RunConfig(model=cfg, lrd=lrd), params, slots=8,
                          max_seq=1024, device="cuda",
                          prefill_chunk=ROOFLINE_PROMPT)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=ROOFLINE_NEW,
                        temperature=0.0) for i, p in enumerate(prompts)]
        step, seen = eng.runner.step, {}

        def wrapped(tokens, positions, seg_kind, **kw):
            if not count or seg_kind in seen or (
                    seg_kind == "decode"
                    and not all(r.output for r in reqs)):
                return step(tokens, positions, seg_kind, **kw)
            torch.cuda.synchronize()
            reset_launches()
            with StepCounter() as c:
                out = step(tokens, positions, seg_kind, **kw)
            torch.cuda.synchronize()
            seen[seg_kind] = dict(
                costs=c.costs, call=(tokens, positions, kw),
                launches={k: launch_count(k) for k in KERNELS
                          if launch_count(k)})
            return out
        eng.runner.step = wrapped
        for r in reqs:
            eng.add_request(r)
        eng.run_until_done()
        return eng, step, [list(r.output) for r in reqs], seen

    _, _, plain_out, _ = drive(False)
    eng, step, out, seen = drive(True)
    if out != plain_out:
        raise SystemExit("roofline: the streams with the counter differ "
                         "from the streams without it")
    runner = eng.runner
    card_model, card_params = runner.model, runner.params
    runner.model = get_model(cfg, "cpu")
    res = {"card": card, "streams_identical": True,
           "requests": len(prompts), "prompt": ROOFLINE_PROMPT,
           "new_tokens": ROOFLINE_NEW}
    try:
        for kind in ("prefill_chunk", "decode"):
            if kind not in seen:
                raise SystemExit(f"roofline: no {kind} segment was counted")
            rec = seen[kind]
            if rec["launches"] != chain:
                raise SystemExit(f"roofline: {kind} launched "
                                 f"{rec['launches']}, expected {chain}")
            charged = {k: v[0] for k, v in rec["costs"].kernel_detail.items()}
            if charged != chain:
                raise SystemExit(f"roofline: {kind} charged {charged}, "
                                 f"launched {chain}")
            tokens, positions, kw = rec["call"]
            with FakeTensorMode():
                runner.params = _fake_like(card_params)
                fargs = _fake_like((tokens, positions, kw))
                with StepCounter() as cpu:
                    step(fargs[0], fargs[1], kind, **fargs[2])
            runner.params = card_params
            got, want = _costs_row(rec["costs"]), _costs_row(cpu.costs)
            if got != want:
                raise SystemExit(f"roofline: {kind} counted {got} on the "
                                 f"card and {want} on the CPU")
            runner.model = card_model
            times = []
            for _ in range(ROOFLINE_TIMED):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                torch.cuda.synchronize()
                a.record()
                step(tokens, positions, kind, **kw)
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            runner.model = get_model(cfg, "cpu")
            rows = tokens.numel()
            model_flops = cfg.flops_per_token() / 3.0 * rows
            roof = roofline(rec["costs"], n_devices=1,
                            model_flops_global=model_flops)
            bound_ms = max(roof.compute_s, roof.memory_s) * 1e3
            ms = statistics.median(times)
            res[kind] = dict(
                got, rows=rows, cpu_equal=True, launches=rec["launches"],
                model_flops=model_flops,
                counted_over_model=rec["costs"].flops / model_flops,
                compute_ms=roof.compute_s * 1e3,
                memory_ms=roof.memory_s * 1e3, bound_ms=bound_ms,
                bound_by=("operations" if roof.compute_s >= roof.memory_s
                          else "bytes"),
                ms_median=ms, ms_min=min(times), ms_max=max(times),
                runs=len(times), bound_over_measured=bound_ms / ms)
    finally:
        runner.model, runner.params = card_model, card_params
    log("roofline " + json.dumps(res))
    return res


def run_dryrun(card: str) -> dict:
    """The ``dryrun`` phase: ``python -m repro_torch.launch.dryrun --arch
    llama3.2-1b`` for each of :data:`DRYRUN_CELLS`, one child process
    each, side by side, on this machine (fake process groups of 256 /
    512 ranks, fake CPU tensors).  Each must end ``status: "ok"`` with
    CUDA never initialised in the child; each cell's bottleneck,
    useful-FLOPs ratio, collective bytes and peak bytes are logged."""
    import os
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    try:
        for shape, mp in DRYRUN_CELLS:
            out = os.path.join(tmp, f"{shape}_{'mp' if mp else 'sp'}.json")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", "llama3.2-1b", "--shape", shape, "--out", out]
            procs.append((shape, mp, out, subprocess.Popen(
                cmd + (["--multi-pod"] if mp else []), env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True)))
        res = {"card": card, "cells": []}
        for shape, mp, out, proc in procs:
            try:
                _, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise SystemExit(f"dryrun: {shape} ({mp=}) timed out")
            if proc.returncode != 0 or not os.path.exists(out):
                raise SystemExit(f"dryrun: {shape} ({mp=}) failed "
                                 f"(rc {proc.returncode}): {err[-3000:]}")
            with open(out) as f:
                cell = json.load(f)
            if cell["status"] != "ok" or cell["cuda_initialized"]:
                raise SystemExit(f"dryrun: {shape} ({mp=}): status "
                                 f"{cell['status']}, CUDA initialised "
                                 f"{cell['cuda_initialized']}")
            r, co = cell["roofline"], cell["costs"]
            row = {"shape": shape, "mesh": cell["mesh"],
                   "n_devices": cell["n_devices"],
                   "bottleneck": r["bottleneck"],
                   "useful_flops_ratio": r["useful_flops_ratio"],
                   "compute_s": r["compute_s"], "memory_s": r["memory_s"],
                   "collective_s": r["collective_s"],
                   "flops_per_device": co["flops_per_device"],
                   "hbm_bytes_per_device": co["hbm_bytes_per_device"],
                   "collective_bytes_per_device":
                       co["collective_bytes_per_device"],
                   "collective_groups": co["collective_groups"],
                   "peak_bytes": cell["memory"]["peak_bytes"],
                   "fits_hbm": cell["memory"]["fits_hbm"],
                   "trace_s": cell["trace_s"], "total_s": cell["total_s"],
                   "cuda_initialized": cell["cuda_initialized"]}
            res["cells"].append(row)
            log("dryrun " + json.dumps(row))
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def family_data(cfg, spec: dict):
    """A family's training data at ``batch`` x ``seq``: SyntheticLM frames
    for the encoder, ByteTextLM tokens otherwise (with the random image
    embeddings of ``synth_inputs`` for the VLM)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.data import (ByteTextLM, SyntheticLM,
                                        WithImageEmbeds)
    if cfg.family == "encoder":
        return SyntheticLM(cfg, ShapeConfig("train", spec["seq"],
                                            spec["batch"], "train"))
    data = ByteTextLM(cfg, batch=spec["batch"], seq_len=spec["seq"])
    return WithImageEmbeds(data, cfg) if cfg.family == "vlm" else data


def _clone(tree):
    """A copy of a tree's tensors made outside inference mode (a serve
    phase's tree is made under it, and autograd refuses such tensors)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def train_served_tree(tree_of: str, phases: list[str], card: str,
                      seed: int, train_res: dict, served: list) -> None:
    """The family training pairs whose ``tree_of`` is ``tree_of``, on the
    tree its serve phases built: ``served`` = [cfg, params, surgery
    report, init seconds, surgery seconds], emptied here (the caller
    keeps no reference, so the served tree goes once it is copied)."""
    for key, spec in TRAIN_FAMILY_RUNS.items():
        if (spec.get("tree_of") == tree_of and key not in train_res
                and {f"check_train_{key}", f"train_{key}"} & set(phases)):
            cfg, params, rep, init_s, surg_s = served
            served.clear()
            if cfg.num_layers != spec["depth"]:
                raise SystemExit(f"train_{key}: the served tree has "
                                 f"{cfg.num_layers} layers, not "
                                 f"{spec['depth']}")
            tree = [cfg, _clone(params), rep, init_s, surg_s]
            del params
            run_train_family(key, phases, card, seed, train_res, tree)


def run_train_family(key: str, phases: list[str], card: str, seed: int,
                     train_res: dict, tree: list | None = None) -> None:
    """``check_train_<key>`` then ``train_<key>`` of one
    :data:`TRAIN_FAMILY_RUNS` tree (the freeze on; the VLM's gates at
    ``VLM_GATE``): ``tree`` ([cfg, params, surgery report, init seconds,
    surgery seconds], emptied here) or built and decomposed on the card
    here; checked on the first batch, then trained in place; freed when
    this returns."""
    import torch
    from repro_torch.configs.base import LRDConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.models.api import get_model
    spec = TRAIN_FAMILY_RUNS[key]
    names = (f"check_train_{key}", f"train_{key}")
    if not set(names) & set(phases):
        return
    lrd = LRDConfig(**LRD, branches=4, freeze=True)
    if tree:
        cfg, params, rep, init_s, surg_s = tree
        tree.clear()
        source = f"the tree of the {spec['tree_of']} serve phases"
    else:
        fresh_peak()
        t0 = time.perf_counter()
        cfg, dense, axes = config_model(spec["arch"], spec["depth"], seed)
        init_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.no_grad():
            params, _, rep = decompose_model(dense, axes, lrd)
        torch.cuda.synchronize()
        surg_s = time.perf_counter() - t0
        del dense, axes
        source = "built here"
    if cfg.family == "vlm":
        params = with_gate(params, VLM_GATE)
    expect = train_launches(get_model(cfg, "cpu"), rep, spec["seq"])
    log(f"surgery train_{key} ({spec['arch']}, {cfg.num_layers} layers; "
        f"{source}) branches=4, freeze: init {init_s:.2f} s, surgery "
        f"{surg_s:.2f} s, {json.dumps(rep.summary())}; launches a step "
        f"{expect} [{card}]")
    data = family_data(cfg, spec)
    res = train_res.setdefault(key, {"surgery_s": surg_s, "init_s": init_s,
                                     "tree": source, "expect": expect})
    if names[0] in phases:
        with Phase(names[0]):
            first = data.batch(0)
            batch = {k: v[:TRAIN_FAMILY_CHECK_BATCH]
                     for k, v in first.items()}
            res["check"] = check_train_step(
                cfg, params, batch, card, seed, label=names[0],
                gate=spec["check"], expect=expect,
                image_share=cfg.family == "vlm")
    if names[1] in phases:
        with Phase(names[1]):
            res["train"] = train_run(
                cfg, card, seed, label=key, lrd=lrd, remat="none",
                steps=TRAIN_FAMILY_STEPS, expect=expect, falls=False,
                data=data, batch=spec["batch"], seq=spec["seq"],
                params=params)
    del params
    torch.cuda.empty_cache()


def _chain_kinds(rep) -> set[str]:
    """The chain kernels a tree's linears launch: B1 for an SVD pair, B2
    for a branched linear, outside the routed expert banks (plain batched
    products) and the convolutions (cuDNN)."""
    kernel = {"svd": "lowrank_matmul", "branched": "branched_matmul"}
    return {kernel[d.kind] for d in rep.decisions if d.kind in kernel
            and not d.label.startswith(("moe_", "conv"))}


def run_launch(card: str, seed: int, launch_res: dict) -> None:
    """The ``launch`` phase: the port's train and serve launchers on the
    card, called in-process as ``python -m repro_torch.launch.train`` /
    ``serve`` would run them (their ``main(argv)``)."""
    import contextlib
    import io
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import LRDConfig
    from repro_torch.core.surgery import decompose_model
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.models.api import get_model

    def launched() -> dict[str, int]:
        return {k: launch_count(k) for k in KERNELS if launch_count(k)}

    def call(main, argv: list[str]):
        out = io.StringIO()
        fresh_peak()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            got = main(argv)
        torch.cuda.synchronize()
        lines = out.getvalue().strip().splitlines()
        return got, lines, launched(), time.perf_counter() - t0

    for arch in registry.names():
        cfg = registry.get(arch).smoke
        # the kernels the smoke tree's linears must launch, from the same
        # surgery on the CPU (the launcher's LRD for --smoke)
        params, axes = get_model(cfg, "cpu").init(
            torch.Generator().manual_seed(seed))
        _, _, rep = decompose_model(params, axes, LRDConfig(
            enabled=True, rank_mode="aligned", freeze=True, branches=4,
            min_dim=32))
        want = _chain_kinds(rep)
        out, lines, got, secs = call(ltrain.main, ["--arch", arch,
                                                   *LAUNCH_SMOKE])
        losses = out["result"].losses
        res = {"arch": arch, "losses": losses, "launches": got,
               "last_line": lines[-1], "seconds": secs,
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        launch_res[f"train {arch} smoke"] = res
        log("launch " + json.dumps(res))
        if not (lines[-1].startswith("[done] step=2 loss=")
                and all(math.isfinite(x) for x in losses)):
            raise SystemExit(f"launch: the train launcher on {arch} --smoke "
                             f"ended {lines[-1]!r}, losses {losses}")
        if set(got) != want:
            raise SystemExit(f"launch: {arch} --smoke launched {got}, want "
                             f"every one of {sorted(want)} and no other")
    # the registered parallel("train") runs remat "full": every block's
    # forward again in backward
    remat = registry.get("llama3.2-1b").parallel("train").remat
    chain = {k: LAUNCH_FULL_STEPS * (2 if remat == "full" else 1)
             * sum(v.values()) for k, v in TRAIN_LAUNCHES.items()}
    out, lines, got, secs = call(ltrain.main, [
        "--arch", "llama3.2-1b", "--steps", str(LAUNCH_FULL_STEPS), "--lrd",
        "aligned", "--freeze", "--branches", "4"])
    r = out["result"]
    res = {"arch": "llama3.2-1b", "losses": r.losses, "launches": got,
           "step_ms": [t * 1e3 for t in r.stats["step_seconds"]],
           "last_line": lines[-1], "seconds": secs,
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    launch_res["train llama3.2-1b"] = res
    log("launch " + json.dumps(res))
    if got != chain or not all(math.isfinite(x) for x in r.losses) \
            or not lines[-1].startswith(f"[done] step={LAUNCH_FULL_STEPS} "):
        raise SystemExit(f"launch: the full-width train launcher launched "
                         f"{got} (want {chain}), ended {lines[-1]!r}")
    eng, lines, got, secs = call(lserve.main, [
        "--arch", "llama3.2-1b", "--requests", str(LAUNCH_SERVE_REQUESTS)])
    tp = eng.throughput()
    res = {"arch": "llama3.2-1b", "launches": got, "seconds": secs,
           "status_counts": tp["status_counts"],
           "tokens_per_s": tp["tokens_per_s"],
           "decode_step_ms_mean": tp["decode_step_ms_mean"],
           "lrd": lines[0], "max_memory_allocated":
               torch.cuda.max_memory_allocated()}
    launch_res["serve llama3.2-1b"] = res
    log("launch " + json.dumps(res))
    if (tp["status_counts"] != {"finished": LAUNCH_SERVE_REQUESTS}
            or set(got) != {"lowrank_matmul"}
            or not lines[-1].startswith("[throughput] ")):
        raise SystemExit(f"launch: the serve launcher launched {got}, "
                         f"finished {tp['status_counts']}")
    del eng
    try:
        call(lserve.main, ["--arch", "hubert-xlarge"])
    except SystemExit as e:
        refused = str(e)
    else:
        refused = None
    log(f"launch serve hubert-xlarge: {refused!r} [{card}]")
    if refused is None or "encoder-only" not in refused:
        raise SystemExit("launch: the serve launcher did not refuse "
                         "hubert-xlarge")
    launch_res["serve hubert-xlarge"] = {"refused": refused}


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
        # the MoE checks hold the f32 trees on the host beside the card's
        mem = next((ln.split(":", 1)[1].strip() for ln in
                    Path("/proc/meminfo").read_text().splitlines()
                    if ln.startswith("MemTotal:")), "unknown")
        log(f"host MemTotal: {mem}")

    kernels = None
    if set(phases) & {"build", "kernels", *LLAMA_PHASES, *MLA_PHASES,
                      *CONFIG_PHASES, *RESNET_PHASES, *VLM_PHASES,
                      *HUBERT_PHASES, *TRAIN_PHASES, *TRAIN_FAMILY_PHASES,
                      "mesh", "roofline", "launch"}:
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
                heights = build.chain_heights(getattr(torch, dt))
                for m in (8, 64):
                    lr = {k: build.chain_bm(m, lambda bm, r=r: int(
                        lib.lrk_lowrank_smem(code, bm, r)), heights)
                        for k, (_, r, _) in LOWRANK_SHAPES.items()}
                    br = {k: build.chain_bm(m, lambda bm, n=n, r=r: int(
                        lib.lrk_branched_smem(code, bm, n, r, r)), heights)
                        for k, (n, _, r, _) in {
                            **BRANCHED_SHAPES, **DEEPSEEK_BRANCHED_SHAPES,
                            **(VLM_F32_SHAPES if code == 0 else {})}.items()}
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
            large_m_plans()
            f32_plans()
            attention_splits()

    if "kernels" in phases:
        with Phase("kernels"):
            kernels = check_kernels(card, only)

    serve_res: dict[str, dict] = {}
    train_res: dict[str, dict] = {}
    if set(phases) & set(LLAMA_PHASES):
        run_llama(phases, card, args.seed, serve_res)
        # the llama trees go with run_llama's frame
        torch.cuda.empty_cache()
    if set(phases) & set(MLA_PHASES):
        run_mla(phases, card, args.seed, serve_res)
        torch.cuda.empty_cache()
    for key in CONFIG_RUNS:
        run_config(key, phases, card, args.seed, serve_res, train_res)
        torch.cuda.empty_cache()
    resnet_res: dict[str, dict] = {}
    if set(phases) & set(RESNET_PHASES):
        run_resnet(phases, card, args.seed, resnet_res)
    if set(phases) & set(VLM_PHASES):
        run_vlm(phases, card, args.seed, serve_res, train_res)
        torch.cuda.empty_cache()
    hubert_res: dict[str, dict] = {}
    if set(phases) & set(HUBERT_PHASES):
        run_hubert(phases, card, args.seed, hubert_res)
        torch.cuda.empty_cache()
    if set(phases) & set(TRAIN_PHASES):
        run_train(phases, card, args.seed, train_res)
        torch.cuda.empty_cache()
    if "mesh" in phases:
        with Phase("mesh"):
            train_res["mesh"] = run_mesh(card, args.seed,
                                         serve_res.get("quantized"))
        torch.cuda.empty_cache()
    if "roofline" in phases:
        with Phase("roofline"):
            run_roofline(card, args.seed)
        torch.cuda.empty_cache()
    if "dryrun" in phases:
        with Phase("dryrun"):
            run_dryrun(card)
    for key in TRAIN_FAMILY_RUNS:
        # the pairs whose serve phases did not run build their own tree
        if key not in train_res:
            run_train_family(key, phases, card, args.seed, train_res)
            torch.cuda.empty_cache()
    launch_res: dict[str, dict] = {}
    if "launch" in phases:
        with Phase("launch"):
            run_launch(card, args.seed, launch_res)

    if kernels is not None:
        for k in kernels:
            run = serve_res.get(RUN_OF[k["name"]])
            if run is not None:
                k["launches"] = run["launches"][k["name"]]
            if "search_path" in k and "search" in serve_res:
                k["search_path"]["launches"] = \
                    serve_res["search"]["launches"][k["name"]]
            if "train_path" in k and "frozen" in train_res:
                k["train_path"]["launches"] = \
                    train_res["frozen"]["launches"][k["name"]]
            for label, row in k.get("train_family_path", {}).items():
                if not isinstance(row, dict):
                    continue
                fam = train_res.get(row["family"], {})
                if row.get("dtype") == "float32":
                    if "card_float32" in fam.get("check", {}):
                        row["launches"] = fam["check"]["card_float32"][
                            "launches"].get(k["name"], 0)
                elif "train" in fam:
                    row["launches"] = fam["train"]["launches_per_step"].get(
                        k["name"], 0)
            vrun = serve_res.get("vlm_q" if k["name"].endswith("_q")
                                 else "vlm")
            if "vlm_path" in k and vrun is not None:
                k["vlm_path"]["launches"] = vrun["launches"][k["name"]]
            if "hubert_path" in k and "infer" in hubert_res:
                k["hubert_path"]["launches"] = hubert_res["infer"][
                    "launches_per_forward"].get(k["name"], 0)
            tree_of = {"fc r335": "vanilla_int8"
                       if k["name"] == "lowrank_matmul_q" else "vanilla_lrd",
                       "fc r256": "optimized_ranks"}
            for row_key, row in k.get("resnet_path", {}).items():
                infer = resnet_res.get("resnet50", {}).get(
                    tree_of.get(row_key.split(" M=")[0]), {}).get("infer")
                if isinstance(row, dict) and infer is not None:
                    row["launches"] = infer["launches_per_forward"].get(
                        k["name"], 0)
        log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
