"""mistral-nemo-12b — dense 128k-context decoder.

[hf:mistralai/Mistral-Nemo-Base-2407; hf-verified tier]
40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.
"""
from repro_torch.configs.base import (FAMILY_DENSE, ModelConfig,
                                      ParallelConfig)
from repro_torch.configs.registry import ArchEntry, register

FULL = ModelConfig(
    name="mistral-nemo-12b",
    family=FAMILY_DENSE,
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
)

SMOKE = ModelConfig(
    name="mistral-nemo-smoke",
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
        return ParallelConfig(seq_shard=True, remat="full", fsdp=True)
    if kind == "prefill":
        return ParallelConfig(seq_shard=True)
    return ParallelConfig(decode_seq_shard=True)


register(ArchEntry(
    name="mistral-nemo-12b", full=FULL, smoke=SMOKE, parallel=_parallel,
    notes="long_500k skipped: pure full attention.",
))
