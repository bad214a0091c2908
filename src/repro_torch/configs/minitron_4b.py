"""minitron-4b — pruned Nemotron.

[arXiv:2407.14679; hf-verified tier]
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.

24 query heads over 8 KV heads: a GQA group of 3 query heads.  The MLP is
the gelu one (``act="gelu"``: no gate projection).
"""
from repro_torch.configs.base import (FAMILY_DENSE, ModelConfig,
                                      ParallelConfig)
from repro_torch.configs.registry import ArchEntry, register

FULL = ModelConfig(
    name="minitron-4b",
    family=FAMILY_DENSE,
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    act="gelu",            # nemotron uses squared-relu; gelu is our stand-in
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="minitron-smoke",
    family=FAMILY_DENSE,
    num_layers=2,
    d_model=48,
    num_heads=3,           # keep the non-divisible head count in the smoke
    num_kv_heads=1,
    head_dim=16,
    d_ff=144,
    vocab_size=256,
    act="gelu",
)


def _parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(seq_shard=True, remat="full")
    if kind == "prefill":
        return ParallelConfig(seq_shard=True)
    return ParallelConfig(decode_seq_shard=True)


register(ArchEntry(
    name="minitron-4b", full=FULL, smoke=SMOKE, parallel=_parallel,
    notes="vocab 256000 dominates params (786M embed+unembed of ~4B): the "
          "paper's unembed LRD is maximal here. long_500k skipped: full attn.",
))
