"""zamba2-1.2b — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf-verified tier]
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
A single *shared* attention+MLP block is applied every ``hybrid_attn_every``
mamba layers (weights reused each invocation — Zamba's signature trick).
"""
from repro_torch.configs.base import FAMILY_HYBRID, ModelConfig, ParallelConfig
from repro_torch.configs.registry import ArchEntry, register

FULL = ModelConfig(
    name="zamba2-1.2b",
    family=FAMILY_HYBRID,
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_chunk=256,
    hybrid_attn_every=6,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family=FAMILY_HYBRID,
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_chunk=32,
    hybrid_attn_every=2,
    tie_embeddings=True,
)


def _parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(seq_shard=True, remat="full")
    if kind == "prefill":
        return ParallelConfig(seq_shard=True)
    return ParallelConfig(decode_seq_shard=True)


register(ArchEntry(
    name="zamba2-1.2b", full=FULL, smoke=SMOKE, parallel=_parallel,
    notes="Hybrid: the shared attention block decomposes once (its factors "
          "serve every invocation, each with its own KV entry).",
))
