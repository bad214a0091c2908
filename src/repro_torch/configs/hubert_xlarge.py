"""hubert-xlarge — encoder-only audio backbone (w2v2 architecture).

[arXiv:2106.07447; unverified tier]
48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (target units).
Encoder-only: bidirectional attention, no KV cache, no decode step.
The conv waveform frontend is a stub: ``synth_inputs`` provides
precomputed frame embeddings (B, T, frontend_dim).
"""
from repro_torch.configs.base import (FAMILY_ENCODER, ModelConfig,
                                      ParallelConfig)
from repro_torch.configs.registry import ArchEntry, register

FULL = ModelConfig(
    name="hubert-xlarge",
    family=FAMILY_ENCODER,
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    is_encoder=True,
    act="gelu",
    frontend_dim=1280,
)

SMOKE = ModelConfig(
    name="hubert-smoke",
    family=FAMILY_ENCODER,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=64,
    is_encoder=True,
    act="gelu",
    frontend_dim=64,
)


def _parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(seq_shard=True, remat="full")
    return ParallelConfig(seq_shard=True)


register(ArchEntry(
    name="hubert-xlarge", full=FULL, smoke=SMOKE, parallel=_parallel,
    notes="decode_32k/long_500k skipped: encoder-only. vocab=504 pads to "
          "512. head_dim=80 is not a multiple of 128: rank-selection demo "
          "case.",
))
