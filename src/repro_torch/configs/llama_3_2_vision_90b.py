"""llama-3.2-vision-90b — VLM decoder with interleaved cross-attention.

[hf:meta-llama/Llama-3.2-11B-Vision (scaled); unverified tier]
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Every 5th layer is a cross-attention layer over precomputed image patch
embeddings (the modality frontend is a stub: ``synth_inputs`` provides
(B, n_img_tokens, d) embeddings).
"""
from repro_torch.configs.base import FAMILY_VLM, ModelConfig, ParallelConfig
from repro_torch.configs.registry import ArchEntry, register

FULL = ModelConfig(
    name="llama-3.2-vision-90b",
    family=FAMILY_VLM,
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1601,
    rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    family=FAMILY_VLM,
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=256,
    cross_attn_every=5,
    num_image_tokens=17,
)


def _parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(seq_shard=True, fsdp=True, remat="full")
    if kind == "prefill":
        return ParallelConfig(fsdp=True, seq_shard=True)
    return ParallelConfig(fsdp=True, decode_seq_shard=True)


register(ArchEntry(
    name="llama-3.2-vision-90b", full=FULL, smoke=SMOKE, parallel=_parallel,
    notes="Backbone only: image embeddings arrive precomputed, and the "
          "serve engine prefills every request with zero embeddings, as "
          "the reference's does. long_500k skipped: pure full attention.",
))
