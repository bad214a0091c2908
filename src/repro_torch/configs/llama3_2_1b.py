"""llama3.2-1b — small dense llama3.

[hf:meta-llama/Llama-3.2-1B; unverified tier]
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import FAMILY_DENSE, ModelConfig
from repro_torch.configs.registry import ArchEntry, register

FULL = ModelConfig(
    name="llama3.2-1b",
    family=FAMILY_DENSE,
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    tie_embeddings=True,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke",
    family=FAMILY_DENSE,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    tie_embeddings=True,
)

register(ArchEntry(name="llama3.2-1b", full=FULL, smoke=SMOKE,
                   notes="Smallest dense llama; the port's main path."))
