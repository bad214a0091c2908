"""Configuration dataclasses for the PyTorch port.

The port keeps its own copies of the reference package's config objects
(the same field names and defaults, for the fields this slice reads):

* :class:`ModelConfig` — architecture hyper-parameters.
* :class:`LRDConfig` — the paper's technique: which layers to decompose,
  how ranks are chosen, branching.  It has no ``use_pallas`` field: the
  port dispatches each decomposed linear by the device its input lives
  on (a CUDA tensor launches the hand-written kernel, a CPU tensor takes
  the kernel's plain PyTorch version).
* :class:`RunConfig` — model + lrd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

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
    defaults).  Only the fields the dense family reads are here; those of
    the other families (MoE, MLA, SSM, VLM, encoder, ResNet) come with
    their slices (ROADMAP A10, A13)."""

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
    moe_num_experts: int = 0           # 0 -> dense FFN
    mla: bool = False
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
    def has_decode(self) -> bool:
        return not (self.is_encoder or self.family == FAMILY_RESNET)


@dataclass(frozen=True)
class LRDConfig:
    """The paper's LRD technique, as a config (the reference's field
    names and defaults, minus ``use_pallas``)."""

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
    branches: int = 1                 # branched (block-diagonal) LRD; 1 = off
    # Serve-time compression the slice does not serve yet: the engine
    # raises NotImplementedError naming the ROADMAP item when one is set.
    quantize: str = "none"            # A6
    kv_quantize: str = "none"         # A7
    act_quantize: str = "none"        # A8
    sparsify: str = "none"            # A11
    kv_layout: str = "slot"           # A9 ("paged")
    # Continuous-batching serve stack: tokens per chunked-prefill segment
    # and the per-step token budget (0 = engine defaults).
    prefill_chunk: int = 0
    step_token_budget: int = 0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    lrd: LRDConfig = LRDConfig()
