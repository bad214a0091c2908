"""Configuration dataclasses for the PyTorch port.

The port keeps its own copies of the reference package's config objects
(the same field names and defaults, for the fields this slice reads):

* :class:`ModelConfig` — architecture hyper-parameters.
* :class:`LRDConfig` — the paper's technique: which layers to decompose,
  how ranks are chosen, branching.  It has no ``use_pallas`` field: the
  port dispatches each decomposed linear by the device its input lives
  on (a CUDA tensor launches the hand-written kernel, a CPU tensor takes
  the kernel's plain PyTorch version).
* :class:`ParallelConfig` — the reference's mesh and sharding knobs, every
  field taken; ``remat``, ``grad_accum`` and ``grad_compression_rank``
  act everywhere, the sharding fields where a mesh is given
  (``parallel/sharding.py`` resolves them, ``parallel/placement.py``
  places the tree) and are inert without one, as in the reference.
* :class:`ShapeConfig` — one input-shape cell (sequence, batch, kind),
  the four assigned cells (:data:`SHAPES`) and which apply to an
  architecture (:func:`applicable_shapes`, :func:`skip_reason`).
* :class:`RunConfig` — model + lrd + parallel + seed.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

FAMILY_DENSE = "dense"
FAMILY_MOE = "moe"
FAMILY_VLM = "vlm"
FAMILY_HYBRID = "hybrid"
FAMILY_SSM = "ssm"
FAMILY_ENCODER = "encoder"
FAMILY_RESNET = "resnet"

FAMILIES = (
    FAMILY_DENSE, FAMILY_MOE, FAMILY_VLM, FAMILY_HYBRID,
    FAMILY_SSM, FAMILY_ENCODER, FAMILY_RESNET,
)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture definition (the reference's field names and
    defaults): the fields of every family the reference registers (dense,
    MLA, MoE, the SSM, the hybrid, the VLM, the encoder and the
    ResNets)."""

    name: str = "tiny"
    family: str = FAMILY_DENSE

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 512
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"
    attn_logit_softcap: float = 0.0

    # MoE.
    moe_num_experts: int = 0           # 0 -> dense FFN
    moe_top_k: int = 2
    moe_num_shared: int = 0            # always-on shared experts
    moe_d_ff: int = 0                  # expert hidden dim (0 -> d_ff)
    moe_every: int = 1                 # MoE FFN every k-th layer (1 = all)
    moe_first_dense: int = 0           # first k layers use dense FFN
    moe_capacity_factor: float = 1.25
    moe_dispatch_groups: int = 0       # 0 = global dispatch

    # Multi-head Latent Attention (deepseek-v2 style).
    mla: bool = False
    q_lora_rank: int = 0               # 0 -> q projected from x directly
    kv_lora_rank: int = 0              # width of the cached latent
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # SSM (mamba2 / SSD).
    ssm_state: int = 0                 # N (state dim); 0 -> no SSM
    ssm_expand: int = 2                # d_inner = expand * d_model
    ssm_heads: int = 0                 # 0 -> d_inner // 64
    ssm_chunk: int = 256               # SSD chunk length
    ssm_conv_width: int = 4

    # Hybrid (zamba2-style shared attention block).
    hybrid_attn_every: int = 6         # shared attn block applied every k layers

    # VLM (llama-3.2-vision-style cross attention).
    cross_attn_every: int = 0          # 0 -> no cross-attn layers
    num_image_tokens: int = 1601       # stub frontend output length
    vision_d_model: int = 0            # 0 -> d_model

    # Encoder-only (hubert) specifics.
    is_encoder: bool = False           # bidirectional attention, no KV cache
    frontend_dim: int = 0              # stub frame embedding (0 -> d_model)

    # ResNet family (the paper's own benchmark architecture).
    resnet_stage_blocks: Sequence[int] = ()
    resnet_width: int = 64
    num_classes: int = 1000
    img_size: int = 224

    dtype: str = "bfloat16"            # activation / param dtype
    pad_vocab: bool = True             # pad vocab to a multiple of 128,
                                       # padded logits masked

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    @property
    def attention_free(self) -> bool:
        return self.family == FAMILY_SSM

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the 500k-context decode cell?"""
        return self.family in (FAMILY_SSM, FAMILY_HYBRID)

    @property
    def has_decode(self) -> bool:
        return not (self.is_encoder or self.family == FAMILY_RESNET)

    def param_count(self, active_only: bool = False) -> int:
        """Exact parameter count of the port's own tree, built on the
        ``meta`` device (shapes only, no values).  ``active_only`` scales
        the routed MoE expert banks by top_k / num_experts (shared experts
        stay fully active)."""
        return _param_count_cached(self, active_only)

    def matmul_param_count(self, active_only: bool = True) -> int:
        """Params in matmuls per token: without the embedding *gather*
        table (a tied table counts once: it is the unembed)."""
        total = self.param_count(active_only=active_only)
        if self.family == FAMILY_RESNET:
            return total
        if not self.tie_embeddings:
            total -= self.vocab_size * self.d_model
        return total

    def flops_per_token(self, active_only: bool = True) -> float:
        """~6 * N_active per training token (forward and backward); /3
        for a forward."""
        return 6.0 * self.matmul_param_count(active_only=active_only)


@functools.lru_cache(maxsize=None)
def _param_count_cached(cfg: ModelConfig, active_only: bool) -> int:
    from repro_torch.models.api import get_model  # lazy: avoids a cycle
    from repro_torch.tree import paths
    params, _ = get_model(cfg, "meta").init(None)
    total = expert = 0
    for path, leaf in paths(params):
        total += leaf.numel()
        if "experts" in path:
            expert += leaf.numel()
    if active_only and cfg.moe_num_experts:
        total -= expert
        total += int(expert * cfg.moe_top_k / cfg.moe_num_experts)
    return int(total)


RANK_MODE_RATIO = "ratio"        # rank from the compression ratio (Eq. 7)
RANK_MODE_ALIGNED = "aligned"    # ratio rank snapped down to the tile
RANK_MODE_SEARCH = "search"      # Algorithm 1 on the cost-model timer


@dataclass(frozen=True)
class LRDConfig:
    """The paper's LRD technique, as a config (the reference's field
    names and defaults, minus the fields nothing reads: ``use_pallas``,
    ``energy`` and ``merge``; layer merging is the explicit calls of
    :mod:`repro_torch.core.merging`)."""

    enabled: bool = False
    compression: float = 2.0          # target per-layer compression ratio
    rank_mode: str = RANK_MODE_ALIGNED  # RANK_MODE_RATIO | _ALIGNED |
                                        # _SEARCH
    rank_align: int = 128             # "aligned" snaps ranks down to this
    rank_min_frac: float = 0.25       # Algorithm 1's floor: R_min = frac * R
    min_dim: int = 256                # don't decompose layers smaller than this
    targets: Sequence[str] = (        # which logical layers to decompose
        "attn_q", "attn_k", "attn_v", "attn_o",
        "ffn_up", "ffn_gate", "ffn_down",
        "moe_up", "moe_gate", "moe_down",
        "unembed", "ssm_in", "ssm_out",
        "conv", "conv1x1", "fc",
    )
    freeze: bool = False              # §2.2 freeze the teacher-derived
                                      # factors (w0; u, v) in fine-tuning
    branches: int = 1                 # branched (block-diagonal) LRD; 1 = off
    # Serve-time factor quantization (repro_torch.quant): "none" | "int8"
    # (per-channel symmetric) | "fp8" (e4m3), of the factor keys below.
    quantize: str = "none"
    quant_targets: Sequence[str] = (  # which factor keys to quantize
        "w0", "w1", "u", "xc", "v", "tucker_u", "core", "tucker_v",
    )
    # Runtime KV pool: "none" | "int8" (per-(slot, head, channel) scales,
    # per-(block, head, channel) on the paged pool).
    kv_quantize: str = "none"
    # Per-token int8 activations on prefill and chunked-prefill segments
    # (the *_qa kernels): "none" | "int8"; needs quantize="int8".
    act_quantize: str = "none"
    # 2:4 sparsity of the factors (repro_torch.quant.sparse): "none" |
    # "2:4", composable with `quantize` (the packed values take the
    # quantized dtype).  The branched core xc is not targeted by default.
    sparsify: str = "none"
    sparse_targets: Sequence[str] = ("w0", "w1", "u", "v")
    # Continuous-batching serve stack: tokens per chunked-prefill segment
    # and the per-step token budget (0 = engine defaults).
    prefill_chunk: int = 0
    step_token_budget: int = 0
    # KV pool memory layout: "slot" (one contiguous region per stream) or
    # "paged" (fixed-size blocks behind per-slot block tables with radix
    # prefix sharing), and the paged pool's tokens per block (0 = 16).
    kv_layout: str = "slot"
    kv_block_size: int = 0


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh + sharding strategy (the reference's field names and
    defaults).  ``remat``, ``grad_accum`` and ``grad_compression_rank``
    act with or without a mesh.  The sharding fields (``fsdp``,
    ``shard_vocab``, ``shard_rank``, ``seq_shard``, ``decode_seq_shard``,
    ``multi_pod``) act through a mesh, as the reference's do
    (``repro/train/loop.py:65-67``, ``parallel/sharding.py``): they pick
    each leaf's placement (``make_param_shardings``) and the activation,
    input and cache rules; without a mesh they are inert."""

    multi_pod: bool = False
    fsdp: bool = False
    seq_shard: bool = False
    remat: str = "none"               # "none" | "dots" | "full"
    grad_accum: int = 1               # microbatch steps per optimizer step
    grad_compression_rank: int = 0    # 0 = off; PowerSGD rank otherwise
    shard_vocab: bool = True
    decode_seq_shard: bool = False
    shard_rank: bool = False

    def __post_init__(self):
        if self.remat not in ("none", "dots", "full"):
            raise ValueError(f"unknown remat {self.remat!r}")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES: Mapping[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def applicable_shapes(model: ModelConfig) -> list[ShapeConfig]:
    """The shape cells defined for this architecture."""
    out = [TRAIN_4K, PREFILL_32K]
    if model.has_decode:
        out.append(DECODE_32K)
        if model.subquadratic:
            out.append(LONG_500K)
    return out


def skip_reason(model: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.kind == "decode" and not model.has_decode:
        return "encoder-only: no decode step"
    if shape.name == "long_500k" and not model.subquadratic:
        return "pure full-attention arch: 500k decode cell skipped per spec"
    return None


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    lrd: LRDConfig = LRDConfig()
    parallel: ParallelConfig = ParallelConfig()
    seed: int = 0

    def replace(self, **kw: Any) -> "RunConfig":
        return dataclasses.replace(self, **kw)
