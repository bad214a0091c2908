"""deepseek-v2-236b — MLA + fine-grained MoE.

[arXiv:2405.04434; hf-verified tier]
60L d_model=5120 128H d_ff(expert)=1536 vocab=102400, MoE 160 routed top-6 +
2 shared; MLA kv_lora=512, q_lora=1536, qk_rope=64, qk_nope=128, v_head=128.

MLA is the paper's layer-merging technique hard-coded: K and V are stored
as one rank-512 joint factor (the latent), so LRD targets the o
projection, the FFNs and the unembedding, and the ``mla_*`` projections
stay dense under the default targets.  ``FULL`` is served as it stands:
an unstacked first layer with the dense FFN of ``d_ff``, then stacked MoE
layers (160 routed experts of ``moe_d_ff``, top 6, 2 shared).  A
dense-family MLA stack (``dataclasses.replace(FULL, family="dense",
moe_num_experts=0, moe_first_dense=0)``: every layer the first layer's
dense FFN) serves too.
"""
from repro_torch.configs.base import FAMILY_MOE, ModelConfig, ParallelConfig
from repro_torch.configs.registry import ArchEntry, register

FULL = ModelConfig(
    name="deepseek-v2-236b",
    family=FAMILY_MOE,
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,            # dense FFN used for the first layer (per HF config)
    moe_d_ff=1536,
    vocab_size=102400,
    moe_num_experts=160,
    moe_top_k=6,
    moe_num_shared=2,
    moe_dispatch_groups=16,
    moe_first_dense=1,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family=FAMILY_MOE,
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    moe_d_ff=48,
    vocab_size=256,
    moe_num_experts=8,
    moe_top_k=2,
    moe_num_shared=1,
    moe_first_dense=1,
    mla=True,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_rope_dim=8,
    qk_nope_dim=16,
    v_head_dim=16,
)


def _parallel(kind: str) -> ParallelConfig:
    if kind == "train":
        return ParallelConfig(seq_shard=True, fsdp=True, remat="full",
                              grad_accum=1)
    if kind == "prefill":
        return ParallelConfig(fsdp=True, seq_shard=True)
    # 236B bf16 does not fit 16-way TP: decode also shards expert ffn over
    # `data` (2D weight sharding), see parallel/sharding.py.
    return ParallelConfig(fsdp=True, decode_seq_shard=True)


register(ArchEntry(
    name="deepseek-v2-236b", full=FULL, smoke=SMOKE, parallel=_parallel,
    notes="MLA == the paper's layer merging; MoE with a dense first "
          "layer."))
