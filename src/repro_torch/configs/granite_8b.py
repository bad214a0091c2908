"""granite-8b — llama-architecture code model.

[arXiv:2405.04324; hf-verified tier]
36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.configs.base import (FAMILY_DENSE, ModelConfig,
                                      ParallelConfig)
from repro_torch.configs.registry import ArchEntry, register

FULL = ModelConfig(
    name="granite-8b",
    family=FAMILY_DENSE,
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10000000.0,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family=FAMILY_DENSE,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
)


def _parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(seq_shard=True, remat="full")
    if kind == "prefill":
        return ParallelConfig(seq_shard=True)
    return ParallelConfig(decode_seq_shard=True)


register(ArchEntry(
    name="granite-8b", full=FULL, smoke=SMOKE, parallel=_parallel,
    notes="long_500k skipped: pure full attention.",
))
