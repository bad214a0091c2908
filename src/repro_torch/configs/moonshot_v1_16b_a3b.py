"""moonshot-v1-16b-a3b — Kimi/Moonlight MoE LM.

[hf:moonshotai/Moonlight-16B-A3B; hf-verified tier]
48L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=163840, MoE 64
routed experts top-6 (+2 shared, per the HF reference config).
"""
from repro_torch.configs.base import FAMILY_MOE, ModelConfig, ParallelConfig
from repro_torch.configs.registry import ArchEntry, register

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family=FAMILY_MOE,
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=163840,
    moe_num_experts=64,
    moe_top_k=6,
    moe_num_shared=2,
    # grouped dispatch: taken where the tokens split into 16 groups of
    # at least E tokens each (training batches; never a serve segment)
    moe_dispatch_groups=16,
    rope_theta=50000.0,
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    family=FAMILY_MOE,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=96,
    moe_d_ff=96,
    vocab_size=256,
    moe_num_experts=8,
    moe_top_k=2,
    moe_num_shared=1,
)


def _parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(seq_shard=True, fsdp=True, remat="full")
    if kind == "prefill":
        return ParallelConfig(seq_shard=True)
    return ParallelConfig(decode_seq_shard=True)


register(ArchEntry(
    name="moonshot-v1-16b-a3b", full=FULL, smoke=SMOKE, parallel=_parallel,
    notes="MoE: LRD targets the expert banks (batched over layers and "
          "experts), the shared experts and the dense projections; vocab "
          "163840 is the largest LRD win (163840x2048 unembed -> rank-512 "
          "pair is 7.9x smaller).",
))
