"""Configuration dataclasses for the PyTorch port.

The port keeps its own copies of the reference package's config objects
(the same field names and defaults, for the fields this slice reads):

* :class:`ModelConfig` — architecture hyper-parameters.
* :class:`LRDConfig` — the paper's technique: which layers to decompose,
  how ranks are chosen, branching.  It has no ``use_pallas`` field: the
  port dispatches each decomposed linear by the device its input lives
  on (a CUDA tensor launches the hand-written kernel, a CPU tensor takes
  the kernel's plain PyTorch version).
* :class:`ParallelConfig` — the reference's mesh and sharding knobs; the
  port takes the single-device ones (``remat``, ``grad_accum``,
  ``grad_compression_rank``) and refuses the others (ROADMAP A14).
* :class:`ShapeConfig` — one input-shape cell (sequence, batch, kind).
* :class:`RunConfig` — model + lrd + parallel + seed.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

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
    defaults).  The fields of the dense family, MLA and MoE are here (the
    MoE fields are not read yet: the MoE layer comes with ROADMAP A13, as
    do the SSM, VLM, encoder and ResNet fields)."""

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

    # MoE (served with ROADMAP A13).
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

    is_encoder: bool = False

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
    def has_decode(self) -> bool:
        return not (self.is_encoder or self.family == FAMILY_RESNET)


@dataclass(frozen=True)
class LRDConfig:
    """The paper's LRD technique, as a config (the reference's field
    names and defaults, minus ``use_pallas`` and the fields of ROADMAP
    A2: ``rank_min_frac``, ``energy``, ``merge``)."""

    enabled: bool = False
    compression: float = 2.0          # target per-layer compression ratio
    rank_mode: str = "aligned"        # "ratio" | "aligned" ("search" waits
                                      # for the cost model, ROADMAP A2)
    rank_align: int = 128             # "aligned" snaps ranks down to this
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
    defaults).  The port trains on one device: ``remat``, ``grad_accum``
    and ``grad_compression_rank`` are taken; any other field at a value
    other than its default raises (meshes and sharding come with ROADMAP
    item A14)."""

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
        for f in dataclasses.fields(self):
            if (f.name not in ("remat", "grad_accum", "grad_compression_rank")
                    and getattr(self, f.name) != f.default):
                raise NotImplementedError(
                    f"ParallelConfig.{f.name}={getattr(self, f.name)!r}: "
                    "meshes and sharding come with ROADMAP item A14")


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    lrd: LRDConfig = LRDConfig()
    parallel: ParallelConfig = ParallelConfig()
    seed: int = 0

    def replace(self, **kw: Any) -> "RunConfig":
        return dataclasses.replace(self, **kw)
