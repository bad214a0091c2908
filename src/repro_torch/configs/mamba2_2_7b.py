"""mamba2-2.7b — pure SSM (SSD / state-space duality) LM.

[arXiv:2405.21060; unverified tier]
64L d_model=2560 (attention-free) vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, 80 SSD heads of 64.
"""
from repro_torch.configs.base import FAMILY_SSM, ModelConfig, ParallelConfig
from repro_torch.configs.registry import ArchEntry, register

FULL = ModelConfig(
    name="mamba2-2.7b",
    family=FAMILY_SSM,
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_conv_width=4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family=FAMILY_SSM,
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm_state=16,
    ssm_expand=2,
    ssm_chunk=32,
    tie_embeddings=True,
)


def _parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(seq_shard=True, remat="full")
    if kind == "prefill":
        return ParallelConfig(seq_shard=True)
    return ParallelConfig(decode_seq_shard=True)


register(ArchEntry(
    name="mamba2-2.7b", full=FULL, smoke=SMOKE, parallel=_parallel,
    notes="Attention-free: the recurrent state is O(1) in the sequence. "
          "LRD targets the in/out projections; the depthwise conv1d is "
          "already diagonal (not decomposable).",
))
